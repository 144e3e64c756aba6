"""Inference engine: continuous batching with a prefill/decode split
(port of qqq_tpu/serve/engine.py, single device).

* ``max_batch`` decode slots; every tick decodes ``steps_per_tick`` tokens
  (fewer near a row's budget or the cache's end) for all slots at once,
  each step's token feeding the next (inactive rows compute and are
  ignored, as in JAX's scan);
* on the card a tick is one replay of a CUDA graph (serve/tick_graph.py),
  captured at its first use and kept per (steps, sampling branch, GEMM
  route flag): JAX's one jitted program a tick.  The tick's small inputs
  travel as one packed host→device copy into the graph's static tensors,
  and its tokens and log-probabilities come back in one copy.  Prefill
  stays eager;
* continuous batching is the host loop of :meth:`Engine.run`: a freed slot
  admits the next pending request at the next scheduling round;
* the KV cache is INT8 by default and is updated in place.

Two KV layouts, as in JAX:

* **slot mode** (default): a fixed (max_batch, max_len) cache; prompts
  prefill whole, padded to a bucket; same-bucket pending requests prefill
  together in power-of-two sub-batches into a bucket-sized scratch cache,
  whose rows are then copied into their slots;
* **paged mode** (``paged=True``): a pool of ``num_blocks`` blocks of
  ``block_size`` tokens shared by all slots (serve/paged_kv.py), with
  per-slot block tables grown on demand, so KV memory follows the tokens
  in flight.  A request claims a slot at once and prefills
  ``prefill_chunk`` tokens per scheduling round, up to ``prefill_batch``
  slots per (R, C) dispatch, straight into its blocks; when the pool runs
  dry the latest-admitted request is preempted (its blocks free, and it
  re-enters the queue to re-prefill prompt + generated tokens: the vLLM
  recompute policy).

Both run the JAX engine's default GEMM fusion (``fuse=True``: gate/up
through the GLU-fused kernel).  Chunked prefill in slot mode, the prefix
cache, speculative decoding and meshes keep the JAX engine's argument
names and raise ``NotImplementedError``; so do requests that ask for
penalties, logit bias, guided choice, seeds or top-N logprobs.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from qqq_tpu_torch.kernels import w4a8_gemm
from qqq_tpu_torch.models import llama as M
from qqq_tpu_torch.models.config import ModelConfig
from qqq_tpu_torch.serve import kv_cache, paged_kv
from qqq_tpu_torch.serve.sampling import (
    SamplingParams, chosen_logprob, sample_batched, sampling_branch,
)
from qqq_tpu_torch.serve.tick_graph import TickGraph
from qqq_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Request:
    prompt_tokens: List[int]
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # filled by the engine:
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    #: raw-model log P(token | prefix) for each entry of ``output_tokens``
    token_logprobs: List[float] = dataclasses.field(default_factory=list)
    done: bool = False
    #: "stop" (EOS / stop token), "length" (max_new_tokens or out of cache
    #: room) or "error" (prompt too long or empty) once ``done``
    finish_reason: Optional[str] = None
    #: set when the engine preempts the request (paged mode, pool dry): the
    #: token stream to re-prefill on re-admission (prompt + generated so
    #: far), so that generation continues where it left off
    _resume: Optional[List[int]] = None
    #: tokens of ``output_tokens`` already counted in ``generated_tokens``
    _emitted: int = 0
    # latency bookkeeping (monotonic seconds, filled by the engine)
    t_enqueue: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        """Seconds from enqueue to the first delivered token (None when no
        token survived: an instant EOS)."""
        if self.t_enqueue is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_enqueue


#: max requests prefilled in one dispatch
_PREFILL_BATCH = 8

#: rows of the packed per-tick input (JAX: Engine._TICK_ROWS without the
#: penalty and seed planes): tokens, cache_len, active, temperature, top_k,
#: top_p, min_p; the floats ride bitcast as int32
_TICK_ROWS = 7


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


def _later_slice(name: str) -> NotImplementedError:
    return NotImplementedError(f"{name} is not ported yet")


class Engine:
    def __init__(
        self,
        params: Dict[str, Any],
        config: ModelConfig,
        *,
        max_batch: int = 8,
        max_len: int = 2048,
        kv_quantized: bool = True,
        prefill_buckets=(128, 512, 2048),
        steps_per_tick: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        mesh=None,
        fuse: bool = True,
        prefill_batch: Optional[int] = None,
        prefill_chunk: int = 0,
        spec_ngram: int = 0,
        spec_k: int = 4,
        prefix_cache: bool = False,
        paged: bool = False,
        block_size: int = 128,
        num_blocks: Optional[int] = None,
        device=None,
    ):
        """Arguments keep the JAX engine's names and meaning.  ``device``
        defaults to the CUDA card (``"cpu"`` runs the plain versions);
        ``params`` must already live there.  ``fuse`` applies
        :func:`~qqq_tpu_torch.models.llama.fuse_inference_params` (gate/up
        → the GLU-fused kernel; a no-op for dense params), as JAX does
        without a mesh.

        ``paged=True`` serves from a block pool (see the module docstring).
        ``max_len`` must be a multiple of ``block_size``; ``prefill_chunk``
        defaults to the widest chunk ≤ 512 that divides ``max_len`` and is
        a whole number of blocks; ``num_blocks`` (null block included)
        defaults to ``1 + max_batch · max_len / block_size``, which never
        preempts — size it down to oversubscribe."""
        del spec_k  # meaningful only with speculative decoding
        if steps_per_tick < 1:
            raise ValueError(f"steps_per_tick {steps_per_tick} < 1")
        for on, name in ((mesh is not None, "mesh"),
                         (prefill_chunk and not paged,
                          "chunked prefill in slot mode (prefill_chunk "
                          "without paged)"),
                         (spec_ngram, "speculative decoding (spec_ngram)"),
                         (prefix_cache, "prefix_cache")):
            if on:
                raise _later_slice(name)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        if fuse:
            params = M.fuse_inference_params(params, config)
        self.params = params
        self.config = config
        self.max_batch = max_batch
        self.max_len = max_len
        self.steps_per_tick = steps_per_tick
        self.dtype = dtype
        self.kv_quantized = kv_quantized
        self.prefill_buckets = tuple(
            b for b in prefill_buckets if b <= max_len
        ) or (max_len,)
        self.paged = paged
        if paged:
            if max_len % block_size:
                raise ValueError(f"max_len {max_len} must be a multiple of "
                                 f"block_size {block_size}")
            if not prefill_chunk:
                # the widest chunk ≤ 512 that divides max_len and is a whole
                # number of blocks (JAX: chunk width is dispatch width)
                c = min(512, max_len)
                while c > block_size and (max_len % c or c % block_size):
                    c -= block_size
                prefill_chunk = max(c, block_size)
            if max_len % prefill_chunk:
                raise ValueError(f"max_len {max_len} must be a multiple of "
                                 f"prefill_chunk {prefill_chunk}")
            self.block_size = block_size
            #: per-slot virtual-block capacity (max_len tokens)
            self._nbmax = max_len // block_size
            if num_blocks is None:
                num_blocks = 1 + max_batch * self._nbmax
            self.num_blocks = num_blocks
            self.allocators = [paged_kv.BlockAllocator(num_blocks)]
            #: (max_batch, nbmax) pool block per (slot, virtual block); 0 =
            #: the null block
            self.tables = np.zeros((max_batch, self._nbmax), np.int32)
            #: device copy of ``tables``, copied into again only when dirty:
            #: one tensor for the engine's life, which the graphs read
            self._tables_dev = torch.zeros((max_batch, self._nbmax),
                                           dtype=torch.int32,
                                           device=self.device)
            self._tables_dirty = True
            self.slot_blocks: List[List[int]] = [[] for _ in range(max_batch)]
            self.caches = paged_kv.init(config, num_blocks, block_size,
                                        quantized=kv_quantized, dtype=dtype,
                                        device=self.device)
        else:
            self.caches = kv_cache.init(config, max_batch, max_len,
                                        quantized=kv_quantized, dtype=dtype,
                                        device=self.device)
        self.prefill_chunk = prefill_chunk
        if prefill_batch is None:
            # each admitted row costs a bucket-sized KV scratch across every
            # layer; cap the group so the scratch stays under
            # QQQ_TPU_PREFILL_SCRATCH_MB (default 1536).  Sized by the
            # largest bucket the engine can actually use, or the chunk
            # (JAX: engine.py:321-332).
            budget = int(os.environ.get(
                "QQQ_TPU_PREFILL_SCRATCH_MB", "1536")) << 20
            bucket = max(self.prefill_buckets[-1], prefill_chunk)
            scale_bytes = 4 if kv_quantized else 0
            store_bytes = 1 if kv_quantized else dtype.itemsize
            per_row = (config.num_hidden_layers * config.num_key_value_heads
                       * bucket * 2
                       * (config.head_dim * store_bytes + scale_bytes))
            prefill_batch = min(_PREFILL_BATCH,
                                max(1, budget // max(per_row, 1)))
        self.prefill_batch = max(1, prefill_batch)
        # slot state (host)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_len = np.zeros(max_batch, np.int32)
        self.slot_last_tok = np.zeros(max_batch, np.int32)
        #: slot → prompt tokens not yet prefilled (paged mode); a slot
        #: present here is mid-prefill and excluded from decode
        self.slot_prefill: Dict[int, List[int]] = {}
        #: admission order per slot: preemption evicts the latest admitted
        self._admit_seq = 0
        self.slot_seq = [0] * max_batch
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        #: the decode tick's packed inputs (_TICK_ROWS, max_batch) on the
        #: device, one tensor for the engine's life, and the (pinned, on the
        #: card) host buffer that each tick fills and copies into it
        self._tick_in = torch.zeros((_TICK_ROWS, max_batch),
                                    dtype=torch.int32, device=self.device)
        self._tick_host = self._tick_in
        if self.device.type == "cuda":
            self._tick_host = torch.zeros_like(self._tick_in, device="cpu",
                                              pin_memory=True)
        #: (steps, sampling branch, FUSE_ACT_QUANT) → the captured tick
        self._graphs: Dict[tuple, TickGraph] = {}
        self._graph_stream = None  # the side stream of warm-ups and captures
        #: run the decode tick eagerly on the card too: for comparisons
        #: with the captured tick only (the CPU never captures)
        self._eager_tick = False
        self._pending: List[Request] = []
        self.stats = {
            "prefills": 0, "prefill_tokens": 0, "prefill_chunks": 0,
            "prefill_dispatches": 0,
            "generated_tokens": 0, "decode_ticks": 0, "preemptions": 0,
            "prefill_s": 0.0, "decode_s": 0.0,
            # decode steps (a tick fuses up to steps_per_tick), ticks
            # replayed from a captured graph, graphs captured and the
            # seconds of the ticks that captured (their eager run included)
            "decode_steps": 0, "graph_replays": 0, "graph_captures": 0,
            "graph_capture_s": 0.0,
            # (rows, bucket or chunk) of each prefill dispatch, in order
            "prefill_shapes": [],
        }

    # -- device work -------------------------------------------------------

    @staticmethod
    def _sampling_planes(rows: List[Optional[Request]]):
        """(temperature, top_k, top_p, min_p) host arrays, one entry a row;
        a ``None`` row is greedy."""
        n = len(rows)
        temp = np.zeros((n,), np.float32)
        topk = np.zeros((n,), np.int32)
        topp = np.ones((n,), np.float32)
        minp = np.zeros((n,), np.float32)
        for i, r in enumerate(rows):
            if r is None:
                continue
            sp = r.sampling
            temp[i], topk[i], topp[i], minp[i] = (
                sp.temperature, sp.top_k, sp.top_p, sp.min_p)
        return temp, topk, topp, minp

    def _sample(self, last: torch.Tensor, rows: List[Optional[Request]]):
        """A prefill's first tokens: (tokens, logprobs) as host arrays — one
        device→host copy; ``None`` rows are masked to token 0."""
        planes = self._sampling_planes(rows)
        tok = sample_batched(
            last, self.generator,
            *(torch.from_numpy(a).to(self.device) for a in planes),
            branch=sampling_branch(*planes))
        active = torch.from_numpy(
            np.array([r is not None for r in rows])).to(self.device)
        tok = torch.where(active, tok, 0)
        both = torch.stack([tok.to(torch.float32),
                            chosen_logprob(last, tok)]).cpu().numpy()
        return both[0].astype(np.int32), both[1]

    @torch.inference_mode()
    def _admit_batch(self, reqs: List[Request], slots: List[int],
                     bucket: int) -> None:
        """Prefill ``reqs`` together (B = len(reqs)) into a bucket-sized
        scratch cache and copy each row's KV into its slot."""
        t0 = time.perf_counter()
        pb = len(reqs)
        toks = np.zeros((pb, bucket), np.int64)
        lens = np.zeros((pb,), np.int64)
        for i, r in enumerate(reqs):
            n = len(r.prompt_tokens)
            toks[i, :n] = r.prompt_tokens
            lens[i] = n
        caches1 = kv_cache.init(self.config, pb, bucket,
                                quantized=self.kv_quantized, dtype=self.dtype,
                                device=self.device)
        lens_d = torch.from_numpy(lens).to(self.device)
        logits, _ = M.forward(
            self.params, self.config, torch.from_numpy(toks).to(self.device),
            caches=caches1,
            cache_len=torch.zeros((pb,), dtype=torch.int32,
                                  device=self.device),
            logits_at=lens_d - 1,
        )
        firsts, lps = self._sample(logits[:, 0, :], reqs)
        slot_idx = torch.tensor(slots, device=self.device)
        for big, small in zip(self.caches, caches1):
            for name, buf in big.items():
                buf[slot_idx, :, :bucket] = small[name]
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_shapes"].append((pb, bucket))
        self.stats["prefill_s"] += time.perf_counter() - t0
        for i, (req, slot) in enumerate(zip(reqs, slots)):
            first = int(firsts[i])
            req.output_tokens.append(first)
            req.token_logprobs.append(float(lps[i]))
            self.slot_req[slot] = req
            self.slot_len[slot] = int(lens[i])
            self.slot_last_tok[slot] = first
            self.stats["prefills"] += 1
            self.stats["prefill_tokens"] += int(lens[i])
            self._maybe_finish(slot)
            self._emit(req)

    @torch.inference_mode()
    def _prefill_chunk_paged(self, rows: List[Optional[int]]) -> None:
        """One (R, C) chunked-prefill dispatch, R = len(rows): each slot's
        next ``prefill_chunk`` prompt tokens at its ``slot_len``, written
        straight into its blocks through its table row; ``None`` rows ride
        along on a null table.  The padded tail of a chunk is written too:
        positions past the allocated blocks land in the null block, the
        rest are rewritten by the next chunk or decode step before anything
        attends to them.  A slot whose prompt this chunk completes samples
        its first token (JAX: _prefill_chunk_paged :835 and the dispatch
        half of _progress_chunk_prefills_paged :1693)."""
        t0 = time.perf_counter()
        C, R = self.prefill_chunk, len(rows)
        toks = np.zeros((R, C), np.int64)
        ks = np.zeros((R,), np.int32)
        tns = np.ones((R,), np.int64)
        tabs = np.zeros((R, self._nbmax), np.int32)
        reqs: List[Optional[Request]] = [None] * R
        finals = [False] * R
        for i, slot in enumerate(rows):
            if slot is None:
                continue
            part = self.slot_prefill[slot][:C]
            toks[i, :len(part)] = part
            ks[i] = self.slot_len[slot]
            tns[i] = len(part)
            tabs[i] = self.tables[slot]
            reqs[i] = self.slot_req[slot]
            finals[i] = len(self.slot_prefill[slot]) <= C
        dev = self.device
        logits, _ = M.forward(
            self.params, self.config, torch.from_numpy(toks).to(dev),
            caches=self.caches, cache_len=torch.from_numpy(ks).to(dev),
            logits_at=torch.from_numpy(tns - 1).to(dev),
            block_tables=torch.from_numpy(tabs).to(dev),
        )
        if any(finals):  # only a final chunk's token is ever read
            firsts, lps = self._sample(
                logits[:, 0, :],
                [r if f else None for r, f in zip(reqs, finals)])
        elif dev.type == "cuda":
            # no token to fetch: wait here so that the chunk's device time
            # lands in prefill_s, not in the next decode tick's decode_s
            torch.cuda.synchronize(dev)
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_shapes"].append((R, C))
        self.stats["prefill_s"] += time.perf_counter() - t0
        for i, slot in enumerate(rows):
            if slot is None:
                continue
            self.slot_len[slot] = ks[i] + tns[i]
            self.slot_prefill[slot] = self.slot_prefill[slot][C:]
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_tokens"] += int(tns[i])
            if finals[i]:
                del self.slot_prefill[slot]
                self._finish_chunk_prefill(slot, reqs[i], int(firsts[i]),
                                           float(lps[i]))

    def _finish_chunk_prefill(self, slot: int, req: Request, first: int,
                              lp: float) -> None:
        """Final-chunk bookkeeping (JAX :1555, without penalties): install
        the sampled token and hand the slot to decode."""
        req._resume = None
        req.output_tokens.append(first)
        req.token_logprobs.append(lp)
        self.slot_last_tok[slot] = first
        self.stats["prefills"] += 1
        self._maybe_finish(slot)
        self._emit(req)

    def _decode_steps(self, n: int, branch: str) -> torch.Tensor:
        """``n`` decode steps across all slots from the static tick inputs
        (JAX: _decode_multi's scan body): each step's sampled token is the
        next step's input, inactive rows are masked to token 0, and
        ``cache_len + 1`` is carried.  Returns (2, max_batch, n) f32:
        tokens and their log-probabilities.  This is what a graph
        captures."""
        buf = self._tick_in
        tok = buf[0].to(torch.int64)
        cache_len = buf[1]
        active = buf[2] != 0
        temp, topp, minp = (buf[r].view(torch.float32) for r in (3, 5, 6))
        topk = buf[4]
        tables = self._tables_dev if self.paged else None
        toks, lps = [], []
        for _ in range(n):
            logits, _ = M.forward(
                self.params, self.config, tok[:, None], caches=self.caches,
                cache_len=cache_len, block_tables=tables)
            last = logits[:, -1, :]
            nxt = torch.where(active, sample_batched(
                last, self.generator, temp, topk, topp, minp, branch=branch),
                0)
            toks.append(nxt)
            lps.append(chosen_logprob(last, nxt))
            tok = nxt.to(torch.int64)
            cache_len = cache_len + 1
        return torch.stack([torch.stack(toks, 1).to(torch.float32),
                            torch.stack(lps, 1)])

    def _run_tick(self, n: int, branch: str) -> torch.Tensor:
        """:meth:`_decode_steps` eagerly on the CPU (and with
        ``_eager_tick``); on the card by replaying the graph of this
        (steps, branch, GEMM route flag), which the first such tick
        captures after running eagerly on the capture stream: that run
        does every kernel's first-call host work."""
        if self.device.type != "cuda" or self._eager_tick:
            return self._decode_steps(n, branch)
        key = (n, branch, w4a8_gemm.FUSE_ACT_QUANT)
        graph = self._graphs.get(key)
        if graph is not None:
            self.stats["graph_replays"] += 1
            return graph.replay()
        t0 = time.perf_counter()
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        stream, main = self._graph_stream, torch.cuda.current_stream()
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            out = self._decode_steps(n, branch)
        main.wait_stream(stream)
        self._graphs[key] = TickGraph(
            lambda: self._decode_steps(n, branch), self.generator, stream)
        self.stats["graph_captures"] += 1
        self.stats["graph_capture_s"] += time.perf_counter() - t0
        return out

    def _pack_tick(self, active: np.ndarray,
                   rows: List[Optional[Request]]) -> str:
        """Fill the tick's host buffer (JAX: _pack_tick_args) and return
        the sampling branch of the active rows."""
        h = self._tick_host.numpy()
        h[0] = self.slot_last_tok
        h[1] = self.slot_len
        h[2] = active
        temp, topk, topp, minp = self._sampling_planes(rows)
        h[3] = temp.view(np.int32)
        h[4] = topk
        h[5] = topp.view(np.int32)
        h[6] = minp.view(np.int32)
        return sampling_branch(temp, topk, topp, minp)

    @torch.inference_mode()
    def _decode_tick(self, active: np.ndarray, n: int = 1) -> None:
        """``n`` fused decode steps across all slots (inactive rows are
        masked), then the emit loop of JAX's run (:2066-2080): a row that
        finishes mid-chunk drops the rest of its chunk.  In paged mode the
        masked rows still write their K/V from ``slot_len`` on through
        their table row: an empty slot's table is all null, and a
        mid-prefill slot's positions are rewritten by its next chunk."""
        t0 = time.perf_counter()
        rows = [r if active[i] else None for i, r in enumerate(self.slot_req)]
        branch = self._pack_tick(active, rows)
        if self._tick_host is not self._tick_in:
            self._tick_in.copy_(self._tick_host, non_blocking=True)
        if self.paged and self._tables_dirty:
            self._tables_dev.copy_(torch.from_numpy(self.tables))
            self._tables_dirty = False
        both = self._run_tick(n, branch).cpu().numpy()  # one copy back
        toks, lps = both[0].astype(np.int32), both[1]
        self.stats["decode_ticks"] += 1
        self.stats["decode_steps"] += n
        self.stats["decode_s"] += time.perf_counter() - t0
        for slot, req in enumerate(self.slot_req):
            if req is None or not active[slot]:
                continue
            for t in range(n):
                if self.slot_req[slot] is None:
                    break  # finished mid-chunk: drop the overshoot
                tok = int(toks[slot, t])
                req.output_tokens.append(tok)
                req.token_logprobs.append(float(lps[slot, t]))
                self.slot_len[slot] += 1
                self.slot_last_tok[slot] = tok
                self._maybe_finish(slot)
            self._emit(req)

    def _chunk_len(self, active: np.ndarray) -> int:
        """Steps of the next tick (JAX :1984-1999): ``steps_per_tick``,
        clamped by each active row's room and ``max_new_tokens`` budget,
        and by each masked row's room (its writes must stay inside the
        cache)."""
        chunk = self.steps_per_tick
        for slot, req in enumerate(self.slot_req):
            if not active[slot]:
                chunk = max(1, min(chunk,
                                   self.max_len - int(self.slot_len[slot])))
                continue
            room = self.max_len - int(self.slot_len[slot]) - 1
            budget = req.sampling.max_new_tokens - len(req.output_tokens)
            chunk = max(1, min(chunk, room, budget))
        return chunk

    # -- host-side scheduling ---------------------------------------------

    def add_request(self, req: Request) -> None:
        """Queue a request for the next :meth:`run`."""
        unsupported = req.sampling.later_slice_features()
        if unsupported:
            raise _later_slice("sampling with " + ", ".join(unsupported))
        if req.t_enqueue is None:
            req.t_enqueue = time.monotonic()
        self._pending.append(req)

    def run(self, requests: List[Request]) -> List[Request]:
        """Run until every request completes (continuous batching loop)."""
        for r in requests:
            self.add_request(r)
        while self._pending or any(r is not None for r in self.slot_req):
            self._reject_unservable()
            if self.paged:
                self._admit_chunked()
                self._progress_chunk_prefills_paged()
                self._grow_for_decode()
            else:
                self._admit_whole()
            active = np.array(
                [r is not None and i not in self.slot_prefill
                 for i, r in enumerate(self.slot_req)], bool)
            if active.any():
                self._decode_tick(active, self._chunk_len(active))
        return requests

    def _reject_unservable(self) -> None:
        """Finish the pending requests that can never run: no tokens asked
        ("length"), an empty prompt, one too long for ``max_len`` or the
        largest bucket, or in paged mode one whose KV cannot fit the pool
        even with every other request preempted ("error"; a preempted
        request that grew past that has run out of room: "length")."""
        keep = []
        for r in self._pending:
            stream = r._resume or r.prompt_tokens
            if r.sampling.max_new_tokens <= 0:
                # prefill always samples one token, which would leak out
                r.done, r.finish_reason = True, "length"
            elif (not stream or len(stream) + 1 > self.max_len
                  or (not self.paged
                      and len(stream) > self.prefill_buckets[-1])
                  or (self.paged
                      and -(-(len(stream) + 1) // self.block_size)
                      > self.num_blocks - 1)):
                r.done = True
                r.finish_reason = "length" if r._resume else "error"
            else:
                keep.append(r)
        self._pending = keep

    def _admit_whole(self) -> None:
        """Slot mode: admit pending requests into free slots; same-bucket
        requests prefill together (the group may jump an earlier request of
        another bucket within one admission round)."""
        while self._pending and None in self.slot_req:
            free = [i for i, r in enumerate(self.slot_req) if r is None]
            bucket = _bucket(len(self._pending[0].prompt_tokens),
                             self.prefill_buckets)
            group, rest = [], []
            for r in self._pending:
                if (len(group) < len(free)
                        and _bucket(len(r.prompt_tokens),
                                    self.prefill_buckets) == bucket):
                    group.append(r)
                else:
                    rest.append(r)
            self._pending = rest
            while group:
                pb = min(self.prefill_batch,
                         1 << (len(group).bit_length() - 1))
                self._admit_batch(group[:pb], free[:pb], bucket)
                group, free = group[pb:], free[pb:]

    def _admit_chunked(self) -> None:
        """Paged mode: each pending request claims the first free slot at
        once; :meth:`_progress_chunk_prefills_paged` then prefills its
        prompt (a preempted one's prompt + generated tokens) chunk by
        chunk."""
        while self._pending and None in self.slot_req:
            req = self._pending.pop(0)
            slot = self.slot_req.index(None)
            self.slot_req[slot] = req
            self._admit_seq += 1
            self.slot_seq[slot] = self._admit_seq
            self.slot_len[slot] = 0
            self.slot_prefill[slot] = list(req._resume or req.prompt_tokens)

    def _progress_chunk_prefills_paged(self) -> None:
        """Advance every mid-prefill slot by one chunk: up to
        ``prefill_batch`` slots per dispatch, rows rounded up to a power of
        two (padding rows ride on a null table), rounds repeating until each
        slot advanced once.  Growing a slot's blocks may preempt another
        slot of the same round, which then drops out of it (JAX :1693)."""
        C = self.prefill_chunk
        progressed: set = set()
        while True:
            picks = [s for s in sorted(self.slot_prefill)
                     if s not in progressed][:self.prefill_batch]
            if not picks:
                break
            g = min(1 << max(0, len(picks) - 1).bit_length(),
                    self.prefill_batch)
            rows: List[Optional[int]] = picks + [None] * (g - len(picks))
            progressed.update(picks)
            for i, slot in enumerate(rows):
                if slot is None or slot not in self.slot_prefill:
                    rows[i] = None  # empty, or preempted by an earlier row
                    continue
                part = self.slot_prefill[slot][:C]
                if not self._ensure_blocks(
                        slot, int(self.slot_len[slot]) + len(part)):
                    self._finish_out_of_room(slot)
                    rows[i] = None
            # a later row's growth may have preempted an earlier row
            rows = [s if s in self.slot_prefill else None for s in rows]
            if any(s is not None for s in rows):
                self._prefill_chunk_paged(rows)

    def _grow_for_decode(self) -> None:
        """Grow every decoding slot's table to cover this tick's writes, up
        to ``steps_per_tick`` of them, up front (JAX :1950-1962); a
        preemption frees some other slot, which then drops out of the
        tick."""
        for slot, r in enumerate(self.slot_req):
            if r is not None and slot not in self.slot_prefill:
                if not self._ensure_blocks(
                        slot, min(int(self.slot_len[slot])
                                  + self.steps_per_tick, self.max_len)):
                    self._finish_out_of_room(slot)

    # -- paged block management (host side) --------------------------------

    def _release_blocks(self, slot: int) -> None:
        self.allocators[0].free(self.slot_blocks[slot])
        self.slot_blocks[slot] = []
        self.tables[slot, :] = 0
        self._tables_dirty = True

    def _preempt(self, protect: int) -> bool:
        """Free the latest-admitted request other than ``protect`` and
        requeue it at the front with its resume stream (prompt +
        generated): the oldest requests keep their blocks, and greedy
        streams are unchanged, since re-prefill rebuilds the same KV."""
        cands = [i for i, r in enumerate(self.slot_req)
                 if r is not None and i != protect]
        if not cands:
            return False
        victim = max(cands, key=lambda i: self.slot_seq[i])
        req = self.slot_req[victim]
        self.slot_prefill.pop(victim, None)
        req._resume = list(req.prompt_tokens) + list(req.output_tokens)
        self._pending.insert(0, req)
        self._release_blocks(victim)
        self.slot_req[victim] = None
        self.slot_len[victim] = 0
        self.stats["preemptions"] += 1
        return True

    def _ensure_blocks(self, slot: int, upto: int) -> bool:
        """Grow ``slot``'s table to cover positions [0, upto), preempting
        other requests while the pool is dry.  False when even that cannot
        make room; the caller then finishes the request with "length"."""
        have = len(self.slot_blocks[slot])
        need = min(-(-upto // self.block_size), self._nbmax) - have
        if need <= 0:
            return True
        while self.allocators[0].available < need:
            if not self._preempt(protect=slot):
                return False
        got = self.allocators[0].alloc(need)
        self.slot_blocks[slot].extend(got)
        self.tables[slot, have:have + need] = got
        self._tables_dirty = True
        return True

    def _finish_out_of_room(self, slot: int) -> None:
        """Close ``slot``'s request when the pool cannot grow its KV any
        further: reason "length", keeping the output generated so far."""
        req = self.slot_req[slot]
        self.slot_prefill.pop(slot, None)
        req.done, req.finish_reason = True, "length"
        self._free_slot(slot)

    def _emit(self, req: Request) -> None:
        """Count the tokens that survived :meth:`_maybe_finish` (an EOS or
        stop token it popped never counts) and stamp the first one's time;
        a resumed request keeps its own (JAX: _emit, without the on_token
        hook)."""
        while req._emitted < len(req.output_tokens):
            req._emitted += 1
            self.stats["generated_tokens"] += 1
            if req.t_first_token is None:
                req.t_first_token = time.monotonic()

    def _free_slot(self, slot: int) -> None:
        req = self.slot_req[slot]
        req.t_done = time.monotonic()
        if req.t_first_token is None and req.output_tokens:
            # finished on its first token (max_new_tokens=1): the _emit that
            # would stamp it runs after this
            req.t_first_token = req.t_done
        self.slot_len[slot] = 0
        self.slot_req[slot] = None
        if self.paged:
            self._release_blocks(slot)

    def _maybe_finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        sp = req.sampling
        last = req.output_tokens[-1]
        hit_stop = ((sp.eos_token_id is not None and last == sp.eos_token_id)
                    or last in sp.stop_token_ids)
        out_of_room = self.slot_len[slot] + 1 >= self.max_len
        if hit_stop or out_of_room \
                or len(req.output_tokens) >= sp.max_new_tokens:
            if hit_stop:
                req.output_tokens.pop()  # don't emit the EOS/stop token
                req.token_logprobs.pop()
            req.done = True
            req.finish_reason = "stop" if hit_stop else "length"
            self._free_slot(slot)


def generate(
    params: Dict[str, Any],
    config: ModelConfig,
    prompts: List[List[int]],
    sampling: Optional[SamplingParams] = None,
    **engine_kw,
) -> List[List[int]]:
    """One-shot batch generation."""
    sampling = sampling or SamplingParams()
    eng = Engine(params, config, **engine_kw)
    reqs = [Request(prompt_tokens=p, sampling=sampling) for p in prompts]
    eng.run(reqs)
    return [r.output_tokens for r in reqs]
