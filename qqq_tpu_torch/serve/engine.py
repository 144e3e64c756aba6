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
through the GLU-fused kernel) and every per-request sampling feature:
penalties, logit bias, guided choice, seeds and top-N logprobs, the first
token included.  Their per-row planes ride in the tick's packed input,
the (B, V) generated-token counts and prompt masks are device tensors
that the tick updates in place, and what JAX makes static (penalties,
bias width, guided width, seeds, N) keys the captured graphs, so the
common greedy tick keeps its graph and does no extra work.

Serving hooks, as in JAX: ``on_token(req, token)`` fires for every
delivered token, :meth:`Engine.cancel` finishes a request at its last
delivered token, :meth:`Engine.add_request` is safe from any thread (an
inbox drained each scheduling round), :meth:`Engine.submit_call` runs a
function on the thread of :meth:`Engine.run` between rounds (the HTTP
server scores prompts that way, so no other thread touches the card while
a graph is captured), and :meth:`Engine.latency_summary` reports TTFT and
TPOT percentiles.

Chunked prefill in slot mode, the prefix cache, speculative decoding and
meshes keep the JAX engine's argument names and raise
``NotImplementedError``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from qqq_tpu_torch.kernels import w4a8_gemm
from qqq_tpu_torch.models import llama as M
from qqq_tpu_torch.models.config import ModelConfig
from qqq_tpu_torch.serve import kv_cache, paged_kv
from qqq_tpu_torch.serve.sampling import (
    SamplingParams, apply_allowed_mask, apply_logit_bias, apply_penalties,
    bias_arrays, chosen_logprob, penalty_arrays, sample_batched,
    sampling_branch, top_logprobs,
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
    #: with ``sampling.top_logprobs`` = N > 0: per generated token, the N
    #: highest raw logprobs as [(token_id, logprob), ...]; else empty
    top_logprobs: List[List[Tuple[int, float]]] = dataclasses.field(
        default_factory=list)
    done: bool = False
    #: "stop" (EOS / stop token / completed guided choice / cancel),
    #: "length" (max_new_tokens or out of cache room) or "error" (prompt
    #: too long or empty) once ``done``
    finish_reason: Optional[str] = None
    #: set by :meth:`Engine.cancel`: the request finishes at the last token
    #: delivered
    cancelled: bool = False
    #: set when the engine preempts the request (paged mode, pool dry): the
    #: token stream to re-prefill on re-admission (prompt + generated so
    #: far), so that generation continues where it left off
    _resume: Optional[List[int]] = None
    #: tokens of ``output_tokens`` already delivered (counted in
    #: ``generated_tokens`` and passed to ``on_token``)
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

    @property
    def tpot(self) -> Optional[float]:
        """Mean seconds per output token after the first."""
        if (self.t_first_token is None or self.t_done is None
                or len(self.output_tokens) < 2):
            return None
        return ((self.t_done - self.t_first_token)
                / (len(self.output_tokens) - 1))


#: max requests prefilled in one dispatch
_PREFILL_BATCH = 8

#: rows of the packed per-tick input (JAX: Engine._TICK_ROWS): tokens,
#: cache_len, active, temperature, top_k, top_p, min_p, presence,
#: frequency, repetition, seeded, seed, generation index; the floats ride
#: bitcast as int32
_TICK_ROWS = 13


@dataclasses.dataclass(frozen=True, order=True)
class TickExtras:
    """What a tick's sampling does beyond the plain sampler, decided on the
    host (JAX's static arguments) and part of its graph's key: penalties
    over the device counts, the padded width of the logit-bias and guided
    planes (0 → none), seeded rows, and top-N logprobs (0 → none)."""
    penalties: bool = False
    bias_k: int = 0
    allow_k: int = 0
    seeded: bool = False
    n_top: int = 0


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
        #: per-slot generated-token counts and prompt-token masks (B, V),
        #: the penalties' state: written at admission for penalized rows,
        #: counted into by every tick that has a penalized row (in place:
        #: the graphs read these tensors)
        V = config.vocab_size
        self.counts = torch.zeros((max_batch, V), dtype=torch.int32,
                                  device=self.device)
        self.rep_mask = torch.zeros((max_batch, V), dtype=torch.bool,
                                    device=self.device)
        #: ("bias" | "allow", K) → (host buffer, device tensor) of the
        #: tick's padded per-row planes, each made once at first use
        self._planes: Dict[Tuple[str, int], Tuple[torch.Tensor,
                                                  torch.Tensor]] = {}
        #: (steps, sampling branch, FUSE_ACT_QUANT, TickExtras) → the
        #: captured tick
        self._graphs: Dict[tuple, TickGraph] = {}
        self._graph_stream = None  # the side stream of warm-ups and captures
        #: run the decode tick eagerly on the card too: for comparisons
        #: with the captured tick only (the CPU never captures)
        self._eager_tick = False
        #: the queue of the thread in :meth:`run`; other threads submit
        #: through ``_inbox`` (add_request) and ``_jobs`` (submit_call),
        #: both drained at the top of every scheduling round
        self._pending: List[Request] = []
        self._inbox: List[Request] = []
        self._jobs: List[Tuple[Callable[[], Any],
                               concurrent.futures.Future]] = []
        self._inbox_lock = threading.Lock()
        #: (ttft, tpot) of the last ≤ 1000 finished requests
        self._latency: List[Tuple[float, Optional[float]]] = []
        #: on_token(req, token): called for every delivered token (an EOS
        #: or stop token is never delivered), on the thread of run()
        self.on_token: Optional[Callable[[Request, int], None]] = None
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

    # -- per-row sampling planes (host) -------------------------------------

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

    @staticmethod
    def _seed_arrays(rows: List[Optional[Request]]):
        """(seeded, seed, generation index) int32 host arrays for the rows
        that sample with a seed (JAX: _seed_arrays), or None when no row
        does; the index makes a seeded request's i-th token draw the same
        noise in every batch, slot and mode."""
        n = len(rows)
        out = np.zeros((3, n), np.int32)
        for i, r in enumerate(rows):
            if r is not None and r.sampling.seed is not None \
                    and r.sampling.temperature > 0.0:
                out[:, i] = (1, r.sampling.seed & 0x7FFFFFFF,
                             len(r.output_tokens))
        return out if out[0].any() else None

    def _allowed_arrays(self, rows: List[Optional[Request]]):
        """(n, K) allowed token ids of the guided rows (pads = vocab size,
        K the largest set rounded up to a power of two), or None when no
        row is guided (JAX: _allowed_arrays).  A candidate consistent with
        the row's output contributes its next token; at a completed
        candidate EOS joins the set."""
        V = self.config.vocab_size
        sets: List[set] = []
        for r in rows:
            s: set = set()
            if r is not None and r.sampling.guided_choice:
                out = tuple(r.output_tokens)
                m = len(out)
                complete = False
                for cand in r.sampling.guided_choice:
                    cand = tuple(cand)
                    if len(cand) > m and cand[:m] == out:
                        s.add(int(cand[m]))
                    elif cand == out:
                        complete = True
                if complete and r.sampling.eos_token_id is not None:
                    s.add(int(r.sampling.eos_token_id))
            sets.append(s)
        if not any(r is not None and r.sampling.guided_choice for r in rows):
            return None
        kmax = max(1, max(len(s) for s in sets))
        ids = np.full((len(rows), 1 << (kmax - 1).bit_length()), V, np.int32)
        for i, s in enumerate(sets):
            ids[i, :len(s)] = sorted(s)
        return ids

    def _prefill_pen(self, rows: List[Optional[Request]]):
        """(counts, prompt mask, presence, frequency, repetition) host
        arrays for a prefill's sample, or None when no row is penalized
        (JAX: _prefill_pen): a resumed row's counts are its output so far,
        the mask covers the prompt when the repetition penalty is set."""
        if not any(r is not None and r.sampling.has_penalties for r in rows):
            return None
        V = self.config.vocab_size
        counts = np.zeros((len(rows), V), np.int32)
        pmask = np.zeros((len(rows), V), bool)
        for i, r in enumerate(rows):
            if r is None or not r.sampling.has_penalties:
                continue
            if r.output_tokens:
                counts[i] = np.bincount(r.output_tokens, minlength=V)[:V]
            if r.sampling.repetition_penalty != 1.0 and r.prompt_tokens:
                pmask[i, r.prompt_tokens] = True
        pens = penalty_arrays([r.sampling if r is not None else None
                               for r in rows])
        return (counts, pmask) + pens

    @staticmethod
    def _ntop(rows: List[Optional[Request]]) -> int:
        """The widest top-N asked by the rows (0: none)."""
        return max((r.sampling.top_logprobs for r in rows if r is not None),
                   default=0)

    @staticmethod
    def _top_list(req: Request, ids, vals) -> List[Tuple[int, float]]:
        m = req.sampling.top_logprobs
        return [(int(t), float(v)) for t, v in zip(ids[:m], vals[:m])]

    @staticmethod
    def _alter_logits(last: torch.Tensor, pen=None, bias=None, allow=None):
        """The logit-altering stack of a sample (JAX: _decode_step and
        _prefill_sample_logits): penalties, then bias, then the guided
        mask; each ``None`` is skipped."""
        if pen is not None:
            last = apply_penalties(last, *pen)
        if bias is not None:
            last = apply_logit_bias(last, *bias)
        if allow is not None:
            last = apply_allowed_mask(last, allow)
        return last

    # -- device work -------------------------------------------------------

    def _sample(self, last: torch.Tensor, rows: List[Optional[Request]]):
        """A prefill's first tokens, through the same stack as a decode
        step (penalties with host-built counts, bias, guided mask, seeds):
        (tokens, logprobs, (top ids, top values) or None) as host arrays,
        one device→host copy; ``None`` rows are masked to token 0."""
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        planes = self._sampling_planes(rows)
        pen = self._prefill_pen(rows)
        if pen is not None:
            pen = tuple(put(a) for a in pen)
        bias = bias_arrays([r.sampling if r is not None else None
                            for r in rows])
        bias = None if bias[0] is None else tuple(put(a) for a in bias)
        allow = self._allowed_arrays(rows)
        seeds = self._seed_arrays(rows)
        x = self._alter_logits(last, pen, bias,
                               None if allow is None else put(allow))
        seeded = () if seeds is None else (put(seeds[0] != 0),
                                           put(seeds[1]), put(seeds[2]))
        tok = sample_batched(x, self.generator, *(put(a) for a in planes),
                             *seeded, branch=sampling_branch(*planes))
        tok = torch.where(put(np.array([r is not None for r in rows])),
                          tok, 0)
        parts = [tok.to(torch.float32), chosen_logprob(last, tok)]
        n_top = self._ntop(rows)
        if n_top:
            vals, ids = top_logprobs(last, n_top)
            parts += [*ids.T.to(torch.float32), *vals.T]
        both = torch.stack(parts).cpu().numpy()  # one copy back
        tops = (both[2:2 + n_top].T, both[2 + n_top:].T) if n_top else None
        return both[0].astype(np.int32), both[1], tops

    def _install_penalty_state(self, slot: int, req: Request,
                               first: int) -> None:
        """A penalized request entering decode: its slot's counts become
        its output so far plus its first token (a resumed request's carry
        over), and its prompt mask is set when the repetition penalty is
        (JAX: the admission branches of _admit_batch and
        _finish_chunk_prefill)."""
        sp = req.sampling
        if not sp.has_penalties:
            return
        V = self.config.vocab_size
        row = np.bincount(req.output_tokens + [first], minlength=V)[:V]
        self.counts[slot].copy_(torch.from_numpy(row.astype(np.int32)))
        if sp.repetition_penalty != 1.0:
            mask = np.zeros((V,), bool)
            mask[req.prompt_tokens] = True
            self.rep_mask[slot].copy_(torch.from_numpy(mask))

    def _start_decode(self, slot: int, req: Request, first: int, lp: float,
                      tops_row) -> None:
        """Install a prefill's sampled first token and hand the slot to
        decode (JAX: the tail of _admit_batch and _finish_chunk_prefill)."""
        self._install_penalty_state(slot, req, first)
        req.output_tokens.append(first)
        req.token_logprobs.append(lp)
        if tops_row is not None and req.sampling.top_logprobs:
            req.top_logprobs.append(self._top_list(req, *tops_row))
        self.slot_last_tok[slot] = first
        self.stats["prefills"] += 1
        self._maybe_finish(slot)
        self._emit(req)
        self._release_if_cancelled(slot)

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
        firsts, lps, tops = self._sample(logits[:, 0, :], reqs)
        slot_idx = torch.tensor(slots, device=self.device)
        for big, small in zip(self.caches, caches1):
            for name, buf in big.items():
                buf[slot_idx, :, :bucket] = small[name]
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_shapes"].append((pb, bucket))
        self.stats["prefill_s"] += time.perf_counter() - t0
        for i, (req, slot) in enumerate(zip(reqs, slots)):
            self.slot_req[slot] = req
            self.slot_len[slot] = int(lens[i])
            self.stats["prefill_tokens"] += int(lens[i])
            self._start_decode(slot, req, int(firsts[i]), float(lps[i]),
                               None if tops is None
                               else (tops[0][i], tops[1][i]))

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
            firsts, lps, tops = self._sample(
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
                reqs[i]._resume = None
                self._start_decode(slot, reqs[i], int(firsts[i]),
                                   float(lps[i]), None if tops is None
                                   else (tops[0][i], tops[1][i]))

    def _plane(self, kind: str, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(host buffer, device tensor) of a padded per-row plane: "bias"
        (2, B, K) int32 (ids; values bitcast) or "allow" (B, K) int32.  One
        pair per (kind, K) for the engine's life: the graphs read the
        device tensor."""
        key = (kind, K)
        if key not in self._planes:
            shape = ((2, self.max_batch, K) if kind == "bias"
                     else (self.max_batch, K))
            dev = torch.zeros(shape, dtype=torch.int32, device=self.device)
            host = dev
            if self.device.type == "cuda":
                host = torch.zeros(shape, dtype=torch.int32, pin_memory=True)
            self._planes[key] = (host, dev)
        return self._planes[key]

    def _decode_steps(self, n: int, branch: str,
                      ex: TickExtras) -> torch.Tensor:
        """``n`` decode steps across all slots from the static tick inputs
        (JAX: _decode_multi's scan body over _decode_step): the extras'
        stack on each step's logits, each step's sampled token the next
        step's input and counted into ``counts``, inactive rows masked to
        token 0, ``cache_len + 1`` carried.  Returns (2 + 2N, max_batch, n)
        f32: tokens, their log-probabilities, then with N = ``ex.n_top``
        the top ids and top values.  This is what a graph captures."""
        buf = self._tick_in
        tok = buf[0].to(torch.int64)
        cache_len = buf[1]
        active = buf[2] != 0
        temp, topp, minp, pres, freq, rep = (
            buf[r].view(torch.float32) for r in (3, 5, 6, 7, 8, 9))
        topk = buf[4]
        pen = ((self.counts, self.rep_mask, pres, freq, rep)
               if ex.penalties else None)
        bias = None
        if ex.bias_k:
            planes = self._plane("bias", ex.bias_k)[1]
            bias = (planes[0], planes[1].view(torch.float32))
        allow = self._plane("allow", ex.allow_k)[1] if ex.allow_k else None
        tables = self._tables_dev if self.paged else None
        steps = []
        for s in range(n):
            logits, _ = M.forward(
                self.params, self.config, tok[:, None], caches=self.caches,
                cache_len=cache_len, block_tables=tables)
            last = logits[:, -1, :]
            x = self._alter_logits(last, pen, bias, allow)
            seeded = ((buf[10] != 0, buf[11], buf[12] + s) if ex.seeded
                      else ())
            nxt = torch.where(active, sample_batched(
                x, self.generator, temp, topk, topp, minp, *seeded,
                branch=branch), 0)
            if ex.penalties:  # the sampled token is now generated
                self.counts.scatter_add_(1, nxt.to(torch.int64)[:, None],
                                         active.to(torch.int32)[:, None])
            parts = [nxt.to(torch.float32), chosen_logprob(last, nxt)]
            if ex.n_top:
                vals, ids = top_logprobs(last, ex.n_top)
                parts += [*ids.T.to(torch.float32), *vals.T]
            steps.append(torch.stack(parts))
            tok = nxt.to(torch.int64)
            cache_len = cache_len + 1
        return torch.stack(steps, -1)

    def _run_tick(self, n: int, branch: str, ex: TickExtras) -> torch.Tensor:
        """:meth:`_decode_steps` eagerly on the CPU (and with
        ``_eager_tick``); on the card by replaying the graph of this
        (steps, branch, GEMM route flag, extras), which the first such tick
        captures after running eagerly on the capture stream: that run
        does every kernel's first-call host work."""
        if self.device.type != "cuda" or self._eager_tick:
            return self._decode_steps(n, branch, ex)
        key = (n, branch, w4a8_gemm.FUSE_ACT_QUANT, ex)
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
            out = self._decode_steps(n, branch, ex)
        main.wait_stream(stream)
        self._graphs[key] = TickGraph(
            lambda: self._decode_steps(n, branch, ex), self.generator, stream)
        self.stats["graph_captures"] += 1
        self.stats["graph_capture_s"] += time.perf_counter() - t0
        return out

    def _pack_tick(self, active: np.ndarray,
                   rows: List[Optional[Request]]) -> Tuple[str, TickExtras]:
        """Fill the tick's host buffers (JAX: _pack_tick_args) and copy
        them into the tick's device tensors; return the sampling branch and
        the extras of the active rows."""
        h = self._tick_host.numpy()
        h[:] = 0
        h[0] = self.slot_last_tok
        h[1] = self.slot_len
        h[2] = active
        temp, topk, topp, minp = self._sampling_planes(rows)
        pres, freq, rep = penalty_arrays(
            [r.sampling if r is not None else None for r in rows])
        for i, a in zip((3, 4, 5, 6, 7, 8, 9),
                        (temp, topk, topp, minp, pres, freq, rep)):
            h[i] = a.view(np.int32)
        seeds = self._seed_arrays(rows)
        if seeds is not None:
            h[10:13] = seeds
        copies = [(self._tick_host, self._tick_in)]
        bias_ids, bias_vals = bias_arrays(
            [r.sampling if r is not None else None for r in rows])
        if bias_ids is not None:
            host, dev = self._plane("bias", bias_ids.shape[1])
            host.numpy()[0] = bias_ids
            host.numpy()[1] = bias_vals.view(np.int32)
            copies.append((host, dev))
        allow = self._allowed_arrays(rows)
        if allow is not None:
            host, dev = self._plane("allow", allow.shape[1])
            host.numpy()[:] = allow
            copies.append((host, dev))
        for host, dev in copies:
            if host is not dev:
                dev.copy_(host, non_blocking=True)
        ex = TickExtras(
            penalties=any(r is not None and r.sampling.has_penalties
                          for r in rows),
            bias_k=0 if bias_ids is None else bias_ids.shape[1],
            allow_k=0 if allow is None else allow.shape[1],
            seeded=seeds is not None, n_top=self._ntop(rows))
        return sampling_branch(temp, topk, topp, minp), ex

    @torch.inference_mode()
    def _decode_tick(self, active: np.ndarray, n: int = 1) -> None:
        """``n`` fused decode steps across all slots (inactive rows are
        masked), then the emit loop of JAX's run (:2064-2083): a row that
        finishes mid-chunk drops the rest of its chunk.  In paged mode the
        masked rows still write their K/V from ``slot_len`` on through
        their table row: an empty slot's table is all null, and a
        mid-prefill slot's positions are rewritten by its next chunk."""
        t0 = time.perf_counter()
        rows = [r if active[i] else None for i, r in enumerate(self.slot_req)]
        branch, ex = self._pack_tick(active, rows)
        if self.paged and self._tables_dirty:
            self._tables_dev.copy_(torch.from_numpy(self.tables))
            self._tables_dirty = False
        out = self._run_tick(n, branch, ex).cpu().numpy()  # one copy back
        toks, lps = out[0].astype(np.int32), out[1]
        top_ids, top_vals = out[2:2 + ex.n_top], out[2 + ex.n_top:]
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
                if ex.n_top and req.sampling.top_logprobs:
                    req.top_logprobs.append(self._top_list(
                        req, top_ids[:, slot, t], top_vals[:, slot, t]))
                self.slot_len[slot] += 1
                self.slot_last_tok[slot] = tok
                self._maybe_finish(slot)
            self._emit(req)
            self._release_if_cancelled(slot)

    def _chunk_len(self, active: np.ndarray) -> int:
        """Steps of the next tick (JAX :1984-1999): ``steps_per_tick``,
        1 while a guided row is active (its mask follows each token),
        clamped by each active row's room and ``max_new_tokens`` budget,
        and by each masked row's room (its writes must stay inside the
        cache)."""
        chunk = self.steps_per_tick
        if any(active[i] and r.sampling.guided_choice
               for i, r in enumerate(self.slot_req) if r is not None):
            chunk = 1
        for slot, req in enumerate(self.slot_req):
            if not active[slot]:
                chunk = max(1, min(chunk,
                                   self.max_len - int(self.slot_len[slot])))
                continue
            room = self.max_len - int(self.slot_len[slot]) - 1
            budget = req.sampling.max_new_tokens - len(req.output_tokens)
            chunk = max(1, min(chunk, room, budget))
        return chunk

    @torch.inference_mode()
    def score_prompt(self, tokens: List[int]) -> List[Optional[float]]:
        """log P(tokens[i] | tokens[:i]) per prompt token, None at index 0
        (the ``echo`` scoring path; JAX :929): one forward over the padded
        prefill bucket that touches no cache or slot.  It runs on the
        calling thread; a server calls it through :meth:`submit_call`, so
        that it runs on the thread of :meth:`run`."""
        n = len(tokens)
        if n < 1:
            return []
        bucket = _bucket(n, self.prefill_buckets)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = tokens
        toks_d = torch.from_numpy(toks).to(self.device)
        logits, _ = M.forward(self.params, self.config, toks_d)
        lsm = torch.log_softmax(logits[0, :n - 1].to(torch.float32), dim=-1)
        lp = torch.gather(lsm, -1, toks_d[0, 1:n, None])[:, 0]
        return [None] + [float(x) for x in lp.cpu()]

    # -- host-side scheduling ---------------------------------------------

    def add_request(self, req: Request) -> None:
        """Submit a request; safe from any thread while :meth:`run` is live
        (it drains the inbox at its next scheduling round)."""
        if req.t_enqueue is None:
            req.t_enqueue = time.monotonic()
        with self._inbox_lock:
            self._inbox.append(req)

    def submit_call(self, fn: Callable[[], Any]
                    ) -> concurrent.futures.Future:
        """Run ``fn()`` on the thread of :meth:`run`, between two
        scheduling rounds; safe from any thread.  The future holds its
        result or exception.  This keeps every use of the card on one
        thread, so that no other thread's work can land inside a graph
        capture."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._inbox_lock:
            self._jobs.append((fn, fut))
        return fut

    def cancel(self, req: Request) -> None:
        """Finish ``req`` at its last delivered token: its slot frees at
        the next tick boundary, and a pending request is dropped before
        its prefill.  Safe from any thread, an ``on_token`` hook
        included."""
        req.cancelled = True

    def latency_summary(self) -> Dict[str, Optional[float]]:
        """p50 / p95 TTFT and TPOT (seconds) over the last ≤ 1000 finished
        requests."""
        def pct(vals, q):
            vals = sorted(v for v in vals if v is not None)
            if not vals:
                return None
            return vals[min(len(vals) - 1, int(q * len(vals)))]

        ttfts = [t for t, _ in self._latency]
        tpots = [p for _, p in self._latency]
        return {
            "requests": len(self._latency),
            "ttft_p50_s": pct(ttfts, 0.50), "ttft_p95_s": pct(ttfts, 0.95),
            "tpot_p50_s": pct(tpots, 0.50), "tpot_p95_s": pct(tpots, 0.95),
        }

    def _drain_inbox(self) -> None:
        """Move submitted requests to the queue and run submitted calls."""
        with self._inbox_lock:
            self._pending.extend(self._inbox)
            self._inbox.clear()
            jobs, self._jobs = self._jobs, []
        for fn, fut in jobs:
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — the caller's
                fut.set_exception(e)

    def run(self, requests: List[Request]) -> List[Request]:
        """Run until every request completes (continuous batching loop);
        requests and calls submitted meanwhile from other threads join."""
        now = time.monotonic()
        for r in requests:
            if r.t_enqueue is None:
                r.t_enqueue = now
        self._pending.extend(requests)
        while (self._pending or self._inbox or self._jobs
               or any(r is not None for r in self.slot_req)):
            self._drain_inbox()
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
        """Finish the pending requests that can never run: cancelled
        ("stop"), no tokens asked ("length"), an empty prompt, one too
        long for ``max_len`` or the largest bucket, or in paged mode one
        whose KV cannot fit the pool even with every other request
        preempted ("error"; a preempted request that grew past that has run
        out of room: "length")."""
        keep = []
        for r in self._pending:
            stream = r._resume or r.prompt_tokens
            if r.cancelled:
                r.done, r.finish_reason = True, "stop"
            elif r.sampling.max_new_tokens <= 0:
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
                if self.slot_req[slot].cancelled:
                    del self.slot_prefill[slot]
                    self._release_if_cancelled(slot)
                    rows[i] = None
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
        self._emit(req)

    def _emit(self, req: Request) -> None:
        """Deliver the tokens that survived :meth:`_maybe_finish` (an EOS
        or stop token it popped is never delivered): count each, stamp the
        first one's time (a resumed request keeps its own) and pass it to
        ``on_token``.  If the hook cancels the request, the tokens past the
        one it last saw are dropped (JAX: _emit)."""
        while req._emitted < len(req.output_tokens):
            tok = req.output_tokens[req._emitted]
            req._emitted += 1
            self.stats["generated_tokens"] += 1
            if req.t_first_token is None:
                req.t_first_token = time.monotonic()
            if self.on_token is not None:
                self.on_token(req, tok)
            if req.cancelled:
                del req.output_tokens[req._emitted:]
                del req.token_logprobs[req._emitted:]
                del req.top_logprobs[req._emitted:]
                return

    def _free_slot(self, slot: int) -> None:
        req = self.slot_req[slot]
        req.t_done = time.monotonic()
        if req.t_first_token is None and req.output_tokens:
            # finished on its first token (max_new_tokens=1): the _emit that
            # would stamp it runs after this
            req.t_first_token = req.t_done
        if req.ttft is not None:
            self._latency.append((req.ttft, req.tpot))
            del self._latency[:-1000]
        self.slot_len[slot] = 0
        self.slot_req[slot] = None
        if self.paged:
            self._release_blocks(slot)

    def _release_if_cancelled(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is not None and req.cancelled:
            req.done, req.finish_reason = True, "stop"
            self._free_slot(slot)

    def _maybe_finish(self, slot: int) -> None:
        """Finish ``slot``'s request on an EOS or stop token (popped, with
        its logprobs), a completed guided choice that no candidate extends
        (kept: it is part of the answer), its token budget or the cache's
        end."""
        req = self.slot_req[slot]
        sp = req.sampling
        out = req.output_tokens
        last = out[-1]
        hit_stop = ((sp.eos_token_id is not None and last == sp.eos_token_id)
                    or last in sp.stop_token_ids)
        guided_done = False
        if sp.guided_choice and not hit_stop:
            m = len(out)
            guided_done = (any(list(c) == out for c in sp.guided_choice)
                           and not any(len(c) > m and list(c[:m]) == out
                                       for c in sp.guided_choice))
        out_of_room = self.slot_len[slot] + 1 >= self.max_len
        if hit_stop or guided_done or out_of_room \
                or len(out) >= sp.max_new_tokens:
            if hit_stop:
                out.pop()  # don't emit the EOS/stop token
                req.token_logprobs.pop()
                if req.top_logprobs:
                    req.top_logprobs.pop()
            req.done = True
            req.finish_reason = ("stop" if hit_stop or guided_done
                                 else "length")
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
