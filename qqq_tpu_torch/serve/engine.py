"""Inference engine: slot-based continuous batching with a prefill/decode
split (port of qqq_tpu/serve/engine.py, slot mode).

* ``max_batch`` fixed decode slots; every tick decodes one token for all
  slots at once (inactive rows compute and are ignored, as in JAX);
* prompts prefill whole, padded to a bucket; same-bucket pending requests
  prefill together in power-of-two sub-batches into a bucket-sized scratch
  cache, whose rows are then copied into their slots;
* continuous batching is the host loop of :meth:`Engine.run`: a freed slot
  admits the next pending request at the next scheduling round;
* the KV cache is INT8 by default and is updated in place.

This port has the slot-mode engine, with the JAX engine's default GEMM
fusion (``fuse=True``: gate/up through the GLU-fused kernel), and nothing
around it.  Chunked prefill, the prefix cache, speculative decoding, the
paged pool, meshes and the multi-step decode scan keep the JAX engine's
argument names and raise ``NotImplementedError``; so do requests that ask
for penalties, logit bias, guided choice, seeds or top-N logprobs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from qqq_tpu_torch.models import llama as M
from qqq_tpu_torch.models.config import ModelConfig
from qqq_tpu_torch.serve import kv_cache
from qqq_tpu_torch.serve.sampling import (
    SamplingParams, chosen_logprob, sample_batched,
)
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
    # latency bookkeeping (monotonic seconds, filled by the engine)
    t_enqueue: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        """Seconds from enqueue to the first sampled token."""
        if self.t_enqueue is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_enqueue


#: max requests prefilled in one dispatch
_PREFILL_BATCH = 8
#: bound on the prefill scratch KV of one admission group, in bytes
_PREFILL_SCRATCH_BYTES = 1536 << 20


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


def _later_slice(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{name} is not ported yet; this slice serves slot mode only"
    )


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
        without a mesh."""
        del spec_k, block_size  # meaningful only with the features below
        for on, name in ((steps_per_tick != 1, "steps_per_tick > 1"),
                         (mesh is not None, "mesh"),
                         (prefill_chunk, "chunked prefill (prefill_chunk)"),
                         (spec_ngram, "speculative decoding (spec_ngram)"),
                         (prefix_cache, "prefix_cache"),
                         (paged or num_blocks is not None, "the paged pool")):
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
        self.dtype = dtype
        self.kv_quantized = kv_quantized
        self.prefill_buckets = tuple(
            b for b in prefill_buckets if b <= max_len
        ) or (max_len,)
        self.caches = kv_cache.init(config, max_batch, max_len,
                                    quantized=kv_quantized, dtype=dtype,
                                    device=self.device)
        if prefill_batch is None:
            # each admitted row costs a bucket-sized KV scratch across every
            # layer; cap the group so the scratch stays under the budget.
            # Sized by the largest bucket the engine can actually use.
            bucket = self.prefill_buckets[-1]
            scale_bytes = 4 if kv_quantized else 0
            store_bytes = 1 if kv_quantized else dtype.itemsize
            per_row = (config.num_hidden_layers * config.num_key_value_heads
                       * bucket * 2
                       * (config.head_dim * store_bytes + scale_bytes))
            prefill_batch = min(_PREFILL_BATCH,
                                max(1, _PREFILL_SCRATCH_BYTES // per_row))
        self.prefill_batch = max(1, prefill_batch)
        # slot state (host)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_len = np.zeros(max_batch, np.int32)
        self.slot_last_tok = np.zeros(max_batch, np.int32)
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self._pending: List[Request] = []
        self.stats = {
            "prefills": 0, "prefill_tokens": 0, "prefill_dispatches": 0,
            "generated_tokens": 0, "decode_ticks": 0,
            "prefill_s": 0.0, "decode_s": 0.0,
            # (rows, bucket) of each prefill dispatch, in order
            "prefill_shapes": [],
        }

    # -- device work -------------------------------------------------------

    def _sampling_tensors(self, rows: List[Optional[Request]]):
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
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (temp, topk, topp, minp))

    def _sample(self, last: torch.Tensor, rows: List[Optional[Request]]):
        """(tokens, logprobs) as host arrays — one device→host copy."""
        tok = sample_batched(last, self.generator,
                             *self._sampling_tensors(rows))
        active = torch.tensor([r is not None for r in rows],
                              device=self.device)
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
        now = time.monotonic()
        for i, (req, slot) in enumerate(zip(reqs, slots)):
            first = int(firsts[i])
            req.output_tokens.append(first)
            req.token_logprobs.append(float(lps[i]))
            req.t_first_token = now
            self.slot_req[slot] = req
            self.slot_len[slot] = int(lens[i])
            self.slot_last_tok[slot] = first
            self.stats["prefills"] += 1
            self.stats["prefill_tokens"] += int(lens[i])
            self.stats["generated_tokens"] += 1
            self._maybe_finish(slot)

    @torch.inference_mode()
    def _decode_tick(self, active: np.ndarray) -> None:
        """One decode step across all slots (inactive rows are masked)."""
        t0 = time.perf_counter()
        tokens = torch.from_numpy(self.slot_last_tok.astype(np.int64))
        cache_len = torch.from_numpy(self.slot_len.copy())
        logits, _ = M.forward(
            self.params, self.config, tokens.to(self.device)[:, None],
            caches=self.caches, cache_len=cache_len.to(self.device),
        )
        rows = [r if active[i] else None for i, r in enumerate(self.slot_req)]
        toks, lps = self._sample(logits[:, -1, :], rows)
        self.stats["decode_ticks"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0
        for slot, req in enumerate(self.slot_req):
            if req is None or not active[slot]:
                continue
            tok = int(toks[slot])
            req.output_tokens.append(tok)
            req.token_logprobs.append(float(lps[slot]))
            self.slot_len[slot] += 1
            self.slot_last_tok[slot] = tok
            self.stats["generated_tokens"] += 1
            self._maybe_finish(slot)

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
            keep = []
            for r in self._pending:
                if r.sampling.max_new_tokens <= 0:
                    # prefill always samples one token, which would leak out
                    r.done, r.finish_reason = True, "length"
                elif (not r.prompt_tokens
                      or len(r.prompt_tokens) + 1 > self.max_len
                      or len(r.prompt_tokens) > self.prefill_buckets[-1]):
                    r.done, r.finish_reason = True, "error"
                else:
                    keep.append(r)
            self._pending = keep
            # admit pending requests into free slots; same-bucket requests
            # prefill together (the group may jump an earlier request of
            # another bucket within one admission round)
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
            active = np.array([r is not None for r in self.slot_req], bool)
            if active.any():
                self._decode_tick(active)
        return requests

    def _free_slot(self, slot: int) -> None:
        self.slot_req[slot].t_done = time.monotonic()
        self.slot_len[slot] = 0
        self.slot_req[slot] = None

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
