#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qqq_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. build the CUDA kernels from the sources in this checkout, printing
   ``-Xptxas -v`` (registers, shared memory, spills) of each entry of the
   tensor-core kernels (slot flash, g128 requant, the per-channel GEMM's
   weight stream and wgmma tiles, the exact g128 GEMMs' weight stream:
   plain, GLU and activation-quant-fused) and of the split decode;
2. check each of the sixteen kernels (and the int8-QKᵀ route of slot and
   paged flash, ``qk_int8=True``, beside their default route: q's codes
   and row scales bit-equal to the plain version's at every case, and a
   control case whose q has an outlier channel, where the bf16 route's
   output must fail the int8 route's check) against its
   plain PyTorch version on the card at the Llama-2-7B and Llama-3.1-8B
   shapes of the served paths
   (the GEMMs, the activation-quant-fused ones included (at M = 1, 4 and
   64, the per-channel one also at 8), and the KV writes bit-exact, requant
   also at ragged M
   and N, the per-channel GEMM and GLU
   at rows on both sides of their regime switch (the weight stream, the
   int8 wgmma tiles) and timed at run 3b's decode and prefill rows and in
   each regime, forced, at the rows around the switch, the
   paged writes outside the null block; the GLU-fused GEMMs and the
   attention kernels within two bf16 ulps of the largest output, slot and
   paged flash and the three
   decode kernels per row of their output, slot flash also after cached
   keys, paged flash also bit-equal to slot flash on the gathered pool,
   the whole-cache, S-tiled and paged decode (one split-key kernel) also
   at g = 16, the S-tiled and paged decode also with one long row beside
   one-key rows, the whole-cache decode also at hd = 256 (g = 4 and 16)
   and at Qwen2-0.5B's attention geometry, the S-tiled decode also at that
   geometry whose tile is half the cache; the paged ones over scrambled
   block tables), and time it beside its bound, its
   plain version and a one-call PyTorch yardstick that the port never
   calls (the KV writes also by their device time alone: 20 launches in
   one CUDA graph, replayed; the slot write bit-exact at hd 64, 96, 128
   and 256 from bf16 and f32 inputs);
3. serve 4 requests through the port's Engine, with its default arguments
   (gate/up GLU-fused), on full-width, full-depth Llama-2-7B (random weights
   from a seeded generator): RTN-packed in groups of 128, the JAX package's
   headline quantization, (a) over the INT8 slot cache, (f) the same with
   ``FUSE_ACT_QUANT`` set (the decode linears on the activation-quant-fused
   kernel; tokens must equal (a)'s), (c) paged over the INT8 block pool
   (chunked prefill) and (d) paged over a pool too small for the traffic,
   which must preempt; then (b) per channel over the slot cache and (g) (b)
   with ``FUSE_ACT_QUANT``; then (e) full Llama-3.1-8B (GQA, llama3 RoPE
   scaling, built by ``ModelConfig.from_hf``), g128, over a 32768-token
   slot cache, with a 12000-token prompt: every decode tick on the S-tiled
   decode kernel.  Every decode tick replays a captured CUDA graph (the
   first tick of each graph runs eagerly and captures it); each run logs
   its replays, its graphs, and ms per tick, ms per generated token and
   decode tok/s.  3a runs again with every tick eager (tokens must equal
   the captured run's), and 3a and 3c again with 8 decode steps fused in
   each tick (``steps_per_tick=8``; tokens must equal the one-step runs').
   The int8-QKᵀ route, off by default as in JAX, is on no served path: its
   launches come from one call of each flash wrapper with
   ``qk_int8=True`` (phase 2q).
   Each run checks every kernel's launch count against what its
   dispatches and decode steps imply;
4. teacher-force a 2-layer cut of the g128 weights on the card and on the
   CPU (plain versions), over the slot cache and over the paged pool, and
   the same for a 2-layer cut of Llama-3.1-8B over a 16384-token slot cache
   (the S-tiled decode on the card, its plain version on the CPU), and
   compare the logits step by step;
5. serve a saved checkpoint: 3a's weights written with ``save_quantized``
   (under ``build/``, removed at the end) and read back onto the card with
   ``load_any`` (every tensor bit-equal; write and read GB/s logged); 3a's
   requests on the loaded params (tokens equal to 3a's); then the loaded
   checkpoint over HTTP (``cli/serve.make_server`` on 127.0.0.1, the
   default Engine): greedy ``/generate`` equal to a direct run, requests
   with penalties, a logit bias, a guided choice, top-N logprobs and a
   seed (its tokens equal in two batches; the seeded noise, JAX's threefry
   stream, equal on the card and the CPU: bits and uniforms bit for bit), ``/v1/completions`` streamed as
   SSE equal to the plain reply, echo scoring, one cancel; graphs keyed by
   the sampling extras must replay, every kernel count must be as expected,
   and each graph's replay is timed.  2-layer full-width cuts of the g128
   and per-channel weights go through the reference QQQ's Marlin layout
   and back (codes and scales as stored);
6. the rest of the scheduler on 3a's weights, each run against the same
   traffic without the feature (its requests asking for their top 2
   logprobs: tokens equal up to the first difference, and there the
   feature's token is one of the reference's top 2): (a) chunked prefill
   in slot mode (chunks of 512 written and attended in place through
   the paged kernels over the slot cache read as a pool), 3a's requests
   and an 1800-token prompt that arrives mid-run, whose chunks the
   decoding rows' tokens interleave; (b) the slot prefix cache, a second
   chat turn reusing 512 tokens (TTFT with and without); (c) the paged
   prefix cache, a 512-token system prompt shared by 4 requests (3 hits
   of 4 blocks), then a 14-block pool that must evict cached blocks, the
   pool whole after every run; (d) prompt-lookup speculation, slot and
   paged: drafts verified by replays of the verify's captured graph,
   tokens equal to an eager run's; one verify replay timed against one
   plain tick's, decode tok/s with speculation on and off;
7. QQQ calibration on the card (no kernel of its own: dense PyTorch ops,
   f32 products without TF32), on 16 synthetic samples of 2048 tokens
   (the reference calibrates on 128: a cut for time): (a) a seeded random
   bf16 HF directory of Llama-2-7B's width, 2 layers deep, through
   ``python -m qqq_tpu_torch.cli.quantize``: rotation + g128 + the MSE
   grid, os+ smoothing + per channel, each again with ``--pack_only``
   (bit-identical), the Marlin format, and GPTQ alone with ``--offload``
   (bit-identical to the resident run); each checkpoint loaded with
   ``load_any`` and decoded through the Engine; (b) the library at full
   depth: a 2-layer f32 cut rotated must keep its logits (2e-3 of their
   largest), then ``fuse_layer_norms`` → ``rotate_model`` →
   ``apply_gptq`` (g128, MSE grid, act-order), whose loss must lie below
   the Hessian-weighted error of round-to-nearest on GPTQ's own scales in
   every layer; GPTQ on the
   card against the CPU at (4096, 11008) and (11008, 4096) from card
   Hessians; the final logits of GPTQ and RTN against the dense model;
   the packed result serves 3a's requests with every launch count as
   implied.  Seconds of each step and the peak device memory are logged;
8. evaluation (run after phase 6, on phase 5's checkpoint): (a)
   ``python -m qqq_tpu_torch.cli.eval --eval_ppl --allow_synthetic
   --max_windows 4`` at seqlen 2048 (its ``main`` in this process, the
   launch counts read around it: the requant GEMM, 7 a layer a window);
   (b) the same windows through the dense bf16 weights of the same seed
   (the quantization gap); (c) a 2-layer cut's window logits, card against
   CPU (relative RMS, as phase 4);
   (d) ``loglikelihood_batch`` against ``loglikelihood`` pair by pair;
9. parallelism (see :func:`phase9`);
10. the device timer (run last, where no launch count is read: its captures
   call the kernel wrappers): ``qqq_tpu_torch.utils.measure_op`` beside
   ``Timer.device_ms`` and ``Timer.ms`` at #2 (4, 11008, 4096), #3 (512,
   11008, 4096), #14 (B = 2, T = S = 2048) and an identity op (the
   timer's own cost); ``measure_op`` within 0.5-2x of ``device_ms`` where
   that is over 0.1 ms, and raising on an op that reads a value back.

The last lines are a ``{"kernels": [...]}`` report, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the qqq_tpu_torch package beside this file, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent

# Llama-2-7B geometry (the repo's headline configuration)
V, H, I, L, NH, NKV, HD = 32000, 4096, 11008, 32, 32, 32, 128
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, data sheet
#: the sources whose entries phase 1 names: the tensor-core kernels (the
#: per-channel GEMM's two regimes and the exact g128 GEMMs' weight stream
#: among them) and the split decode
NAMED_SOURCES = ("w4a8_gemm", "w4a8_group", "w4a8_fused", "w4a8_requant",
                 "flash_attention", "split_decode_attention")
# the paged pool of the served runs: 128-token blocks, 16 per slot
# (max_len 2048), 65 blocks = max_batch 4 × 16 + the null block
BS, NBMAX, NB_POOL = 128, 16, 65
INT8_OPS_PER_S = 1979e12       # dense int8 tensor cores
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor cores
ATTN_ULPS = 2                  # attention kernels vs plain: bf16 ulps
GLU_F32_TOL = 2.0 ** -20       # GLU kernels vs plain at f32 output, × max|ref|

#: meta-llama/Llama-3.1-8B config.json (the fields ModelConfig.from_hf reads)
LLAMA31_8B = {
    "model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
    "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
    "max_position_embeddings": 131072, "tie_word_embeddings": False,
    "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
}
H3, I3, NKV3 = 4096, 14336, 8
L31_MAX_LEN = 32768            # the 3e slot cache: past the 8192 switch


def log(msg: str) -> None:
    print(msg, flush=True)


def import_port():
    sys.path.insert(0, str(HERE))
    import qqq_tpu_torch

    where = pathlib.Path(qqq_tpu_torch.__file__).resolve()
    if HERE not in where.parents:
        raise RuntimeError(f"qqq_tpu_torch imported from {where}, not from "
                           f"this checkout ({HERE})")


class Timer:
    """Median CUDA-event time of single launches, L2 flushed before each,
    after a warm-up call (first-use costs: module loads, library set-up).
    A function whose first timed call takes over 50 ms is timed twice more
    (over 500 ms: that call alone), so that the plain versions at the
    long-context shapes stay inside the run's time."""

    def __init__(self, dev):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def _once(self, fn) -> float:
        self.flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        fn()
        first = self._once(fn)
        if first > 500:
            return first
        if first > 50:
            return statistics.median([first, self._once(fn),
                                      self._once(fn)])
        for _ in range(warmup - 2):
            fn()
        return statistics.median([self._once(fn) for _ in range(iters)])

    @staticmethod
    def device_ms(fn, n: int = 20, reps: int = 5) -> float:
        """The kernel's own device time: ``n`` calls of ``fn`` captured in
        one CUDA graph, replayed ``reps`` times after a warm-up replay, each
        replay timed by CUDA events; the median over ``n``.  No host work
        and no launch latency between the kernels; the L2 stays warm (the
        same buffers every call).  ``fn`` runs once first, outside the
        capture (library load and binding)."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / n)
        del graph
        return statistics.median(times)


def bound_ms(nbytes: float, ops: float = 0.0,
             peak_ops: float = BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulp_tol(ref: torch.Tensor) -> float:
    """ATTN_ULPS bf16 ulps at the largest magnitude of ``ref``."""
    return ATTN_ULPS * 2.0 ** -7 * float(ref.float().abs().max())


def ulp_rows(out: torch.Tensor, ref: torch.Tensor):
    """Each row of the last dimension held to ATTN_ULPS bf16 ulps of its own
    largest |ref|, so that a row of small outputs (a long cache) is not
    judged at the scale of a large one.  Returns (max |diff|, the worst
    row's |diff| over its bound); the rows agree when the ratio is ≤ 1."""
    d = (out.float() - ref.float()).abs().amax(dim=-1)
    tol = ATTN_ULPS * 2.0 ** -7 * ref.float().abs().amax(dim=-1)
    ratio = torch.where(d > 0, d / tol, torch.zeros_like(d))
    return float(d.max()), float(ratio.max())


#: the W4A8 GEMM family: wrapper name → (CUDA source, TPU kernel replaced)
GEMM_KERNELS = {
    "w4a8_gemm_channel": ("qqq_tpu_torch/csrc/w4a8_gemm.cu",
                          "qqq_tpu/kernels/w4a8_gemm.py:124"),
    "w4a8_glu_channel": ("qqq_tpu_torch/csrc/w4a8_gemm.cu",
                         "qqq_tpu/kernels/w4a8_gemm.py:283"),
    "w4a8_gemm_group": ("qqq_tpu_torch/csrc/w4a8_group.cu",
                        "qqq_tpu/kernels/w4a8_gemm.py:161"),
    "w4a8_glu_group": ("qqq_tpu_torch/csrc/w4a8_group.cu",
                       "qqq_tpu/kernels/w4a8_gemm.py:362"),
    "w4a8_gemm_requant": ("qqq_tpu_torch/csrc/w4a8_requant.cu",
                          "qqq_tpu/kernels/w4a8_gemm.py:81"),
    "w4a8_glu_requant": ("qqq_tpu_torch/csrc/w4a8_requant.cu",
                         "qqq_tpu/kernels/w4a8_gemm.py:326"),
    "w4a8_gemm_fused_channel": ("qqq_tpu_torch/csrc/w4a8_fused.cu",
                                "qqq_tpu/kernels/w4a8_gemm.py:207"),
    "w4a8_gemm_fused_group": ("qqq_tpu_torch/csrc/w4a8_fused.cu",
                              "qqq_tpu/kernels/w4a8_gemm.py:239"),
}
PLAIN_SHAPES = [(H, H), (H, I), (I, H)]  # q/k/v/o, (unfused) gate/up, down
GLU_SHAPES = [(H, 2 * I)]                # fused gate/up
# Llama-3.1-8B: q/o, k/v, down; fused gate/up
L31_SHAPES = [(H3, H3), (H3, NKV3 * HD), (I3, H3)]
L31_GLU_SHAPES = [(H3, 2 * I3)]
#: the per-channel kernels' rows: both sides of each regime switch (the
#: weight stream below kernels/w4a8_gemm.py:CHANNEL_TILES_MIN_M, the int8
#: wgmma tiles from it; whole and ragged 16-row and 256-row tiles), as the
#: card tests take them, and the served ones
CHANNEL_MS = (1, 4, 16, 17, 64, 65, 128, 256, 512, 513, 4096)
#: the served rows of run 3b's per-channel dispatches: decode at batch 4,
#: one row of slot bucket 128, one of bucket 512, two of bucket 2048
CHANNEL_SERVED_MS = (4, 128, 512, 4096)
#: per kernel: the rows M it is checked at (those the served runs give it:
#: decode at batch 1 and 4 (the g128 GLU also at 8, the Engine's default
#: max_batch), one row of slot bucket 128, one of bucket 512, two of bucket
#: 2048, and the paged runs' (2, 512) chunk dispatches, M = 1024, plus M =
#: 2048 for the requant GEMM), its (K, N) shapes, the (M, K, N) its report
#: row shows, and the rows it is timed at (None: all)
GEMM_CHECKS = {
    "w4a8_gemm_channel": (CHANNEL_MS, PLAIN_SHAPES, (4, I, H),
                          CHANNEL_SERVED_MS),
    "w4a8_glu_channel": (CHANNEL_MS, GLU_SHAPES, (4, H, 2 * I),
                         CHANNEL_SERVED_MS),
    "w4a8_gemm_group": ((1, 4, 128), PLAIN_SHAPES, (4, I, H), None),
    "w4a8_glu_group": ((1, 4, 8, 128), GLU_SHAPES, (4, H, 2 * I), None),
    # and ragged row tiles of the 256-row tensor-core kernels: M = 513, 1000
    "w4a8_gemm_requant": ((512, 513, 1000, 1024, 2048, 4096), PLAIN_SHAPES,
                          (512, I, H), None),
    "w4a8_glu_requant": ((512, 513, 1024, 4096), GLU_SHAPES,
                         (512, H, 2 * I), None),
}
#: the per-channel kernels' report rows besides the decode one: each served
#: prefill row at the (K, N) that run 3b gives it (q/k/v/o and down; the
#: fused gate/up)
CHANNEL_PREFILL_ROWS = {
    "w4a8_gemm_channel": [(M, K, N) for M in CHANNEL_SERVED_MS[1:]
                          for K, N in ((H, H), (I, H))],
    "w4a8_glu_channel": [(M, H, 2 * I) for M in CHANNEL_SERVED_MS[1:]],
}
#: the rows at which each per-channel kernel is timed in each regime, forced,
#: to place its switch (kernels/w4a8_gemm.py:CHANNEL_TILES_MIN_M and
#: GLU_CHANNEL_TILES_MIN_M) where the two times cross
CROSSOVER_MS = (8, 16, 32, 64, 128, 256)
#: the same at the Llama-3.1-8B shapes of every dispatch of run 3e and of
#: its phase-4 cut: the exact kernels at decode (M = 1 in phase 4, 4 in 3e;
#: the GLU also at 8) and at bucket 128 (M = 128), the requant ones at
#: buckets 512, 2048 and 16384 (one row each); logged only
L31_GEMM_CHECKS = {
    "w4a8_gemm_group": ((1, 4, 128), L31_SHAPES, None, None),
    "w4a8_glu_group": ((1, 4, 8, 128), L31_GLU_SHAPES, None, None),
    "w4a8_gemm_requant": ((512, 2048, 16384), L31_SHAPES, None, None),
    "w4a8_glu_requant": ((512, 2048, 16384), L31_GLU_SHAPES, None, None),
}
#: run 3e's prefill dispatches of slot flash: one row of each bucket
L31_FLASH_CASES = ((1, 128), (1, 512), (1, 2048), (1, 16384))
#: slot flash after cached keys: (B, T, S, cache lengths), T not a multiple
#: of the kernel's 64-row block
FLASH_OFFSET_CASES = ((2, 300, 2048, (0, 1500)),)
#: Qwen2-0.5B's attention geometry (14 heads, 2 kv heads, hd 64) over a
#: 32768-token slot cache: JAX's S-tiled tile is 16384 keys
QWEN2_ATTN = dict(nh=14, nkv=2, hd=64, S=32768, clen=(1, 9001, 16385, 32768))
#: the shard shapes one rank of a model axis of 2 hands the GEMMs
#: (Llama-2-7B; phase 9b serves at them): q/k/v (4096, 2048), o (2048,
#: 4096), gate/up (4096, 5504), down (5504, 4096): 43 groups of 128
TP2_SHAPES = [(H, H // 2), (H // 2, H), (H, I // 2), (I // 2, H)]
#: rows as in GEMM_CHECKS (the GEMMs run unfused under a mesh): decode at
#: batch 1 and 4, one row of buckets 128 and 512 (per channel: both
#: regimes), timed at the report row only
TP2_GEMM_CHECKS = {
    "w4a8_gemm_channel": ((4, 128, 512), TP2_SHAPES, (4, I // 2, H), (4,)),
    "w4a8_gemm_group": ((1, 4, 128), TP2_SHAPES, (4, I // 2, H), (4,)),
    "w4a8_gemm_requant": ((512, 1024), TP2_SHAPES, (512, I // 2, H),
                          (512,)),
}
#: Llama-3.1-8B at TP = 2: q (4096, 2048), k/v (4096, 512), o (2048, 4096),
#: gate/up (4096, 7168), down (7168, 4096); logged only
L31_TP2_GEMM_CHECKS = {
    "w4a8_gemm_group": ((4,), [(H3, H3 // 2), (H3, NKV3 * HD // 2),
                               (H3 // 2, H3), (H3, I3 // 2), (I3 // 2, H3)],
                        None, ()),
    "w4a8_gemm_requant": ((512,), [(H3, I3 // 2), (I3 // 2, H3)], None, ()),
}
#: (K, N) of the fused GEMMs: Llama-2-7B's q/k/v/o and down (runs 3f, 3g)
#: and Llama-3.1-8B's k/v and down (its q/o are (4096, 4096) too)
FUSED_SHAPES = [(H, H), (I, H), (H3, NKV3 * HD), (I3, H3)]
#: the rows each fused GEMM is checked and timed at: decode at batch 4 (runs
#: 3f, 3g), batch 1, the largest M that w4a8_linear sends it (64) and, for
#: the per-channel one, batch 8 (one whole 8-row block of bf16 x)
FUSED_MS = {"w4a8_gemm_fused_channel": (1, 4, 8, 64),
            "w4a8_gemm_fused_group": (1, 4, 64)}


def _dequant_weight(w, s):
    """bf16 (K, N) weights of packed codes and per-channel (N,) or g128
    (K/128, N) scales, for the library yardstick."""
    from qqq_tpu_torch.core.packing import unpack_int4

    q = unpack_int4(w).float()
    if s.dim() == 1:
        return (q * s).to(torch.bfloat16)
    K, N = q.shape
    return (q.reshape(s.shape[0], K // s.shape[0], N)
            * s.float()[:, None, :]).reshape(K, N).to(torch.bfloat16)


def _glu_halves(wd):
    """Gate and up columns of a GLU-interleaved (K, 2I) weight."""
    from qqq_tpu_torch.kernels.w4a8_gemm import GLU_INTERLEAVE

    K, n2 = wd.shape
    t = wd.reshape(K, n2 // (2 * GLU_INTERLEAVE), 2, GLU_INTERLEAVE)
    return (t[:, :, 0].reshape(K, n2 // 2).contiguous(),
            t[:, :, 1].reshape(K, n2 // 2).contiguous())


def check_gemm_family(dev, gen, timer, checks=GEMM_CHECKS):
    """Each W4A8 GEMM kernel of ``checks`` against its plain version at the
    main path's shapes: bit-exact, except that the GLU kernels' epilogue
    (another exp than PyTorch's sigmoid) is held to two bf16 ulps of the
    largest output at bf16 output and, so that an epilogue that rounded gate
    and up to bf16 before silu·mul would show, to GLU_F32_TOL·max|ref| at
    f32 output.  Timed (at every row, or at the rows ``checks`` names)
    beside its bound, its plain version and bf16 ``torch.matmul`` on the
    dequantized weights (for GLU: two matmuls and ``silu·mul``).  Returns
    the report row of each kernel whose ``at`` shape is given, with the
    per-channel kernels' served prefill rows (CHANNEL_PREFILL_ROWS) under
    ``"prefill"``."""
    import torch.nn.functional as F

    from qqq_tpu_torch.kernels import w4a8_gemm as k

    rows = {}
    for name, (m_list, shapes, at, timed) in checks.items():
        fn = k.KERNEL_WRAPPERS[name]
        plain_fn = getattr(k, name + "_plain")
        glu = "_glu_" in name
        per_channel = name.endswith("_channel")
        err, row, prefill = 0.0, None, []
        for M in m_list:
            for K, N in shapes:
                a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                                  dtype=torch.int8)
                s_tok = torch.rand((M, 1), generator=gen, device=dev) * 0.05 \
                    + 1e-3
                w = torch.randint(-2**31, 2**31 - 1, (K // 8, N), generator=gen,
                                  device=dev, dtype=torch.int32)
                if per_channel:
                    s = torch.rand((N,), generator=gen, device=dev) * 0.01 + 1e-4
                else:  # g128 scales stored in bf16, as the pipeline stores them
                    s = (torch.rand((K // 128, N), generator=gen, device=dev)
                         * 0.01 + 1e-4).to(torch.bfloat16)
                args = (a, s_tok, w, s)
                out = fn(*args)
                ref = plain_fn(*args)
                torch.cuda.synchronize()
                d = (out.float() - ref.float()).abs().max().item()
                err = max(err, d)
                if glu:
                    ok, what = d <= ulp_tol(ref), f"max |diff| {d:.3g}"
                else:
                    ok, what = torch.equal(out, ref), "bit-exact"
                if not ok:
                    raise AssertionError(f"{name} M={M} K={K} N={N}: "
                                         f"{what}, bound "
                                         f"{'2 ulps' if glu else 'bit-exact'}")
                if glu:
                    out32 = fn(*args, torch.float32)
                    ref32 = plain_fn(*args, torch.float32)
                    torch.cuda.synchronize()
                    d32 = (out32 - ref32).abs().max().item()
                    tol32 = GLU_F32_TOL * ref32.abs().max().item()
                    del out32, ref32
                    if not d32 <= tol32:
                        raise AssertionError(f"{name} M={M} K={K} N={N} f32 "
                                             f"out: max |diff| {d32:.3g} > "
                                             f"{tol32:.3g}")
                    what += f" (f32 out: {d32:.3g}, bound {tol32:.3g})"
                if timed is not None and M not in timed:
                    log(f"  {name} M={M:4d} K={K:5d} N={N:5d}: {what}")
                    del a, w, out, ref
                    continue
                x = (a.float() * s_tok).to(torch.bfloat16)
                wd = _dequant_weight(w, s)
                if glu:
                    wg, wu = _glu_halves(wd)
                    del wd
                    lib_fn = lambda: F.silu(x @ wg) * (x @ wu)  # noqa: E731
                else:
                    lib_fn = lambda: torch.matmul(x, wd)  # noqa: E731
                ms = timer.ms(lambda: fn(*args))
                plain = timer.ms(lambda: plain_fn(*args))
                lib = timer.ms(lib_fn)
                n_out = N // 2 if glu else N
                nbytes = (M * K + M * 4 + K * N // 2 + s.numel() * s.element_size()
                          + M * n_out * 2)
                b, by = bound_ms(nbytes, 2.0 * M * N * K, INT8_OPS_PER_S)
                log(f"  {name} M={M:4d} K={K:5d} N={N:5d}: {what}; "
                    f"{ms:.4f} ms (bound {b:.4f} by {by}, plain {plain:.4f}, "
                    f"bf16 matmul {lib:.4f})")
                timing = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=b, bound_by=by,
                              shape=f"M={M} K={K} N={N}")
                if (M, K, N) == at:
                    row = timing
                if (M, K, N) in CHANNEL_PREFILL_ROWS.get(name, ()):
                    prefill.append(timing)
                del a, w, x, out, ref, lib_fn
        if row is not None:
            row["max_abs_err"] = err
            if prefill:
                row["prefill"] = prefill
            rows[name] = row
        torch.cuda.empty_cache()
    return rows


def check_channel_crossover(dev, gen, timer):
    """The per-channel GEMM (at both (K, N) of run 3b) and its GLU at each
    row of CROSSOVER_MS in each regime, forced through the route's
    ``regime``: checked against the plain version as in check_gemm_family
    (bf16 out) and timed.  Returns, per kernel, its rows: (M, K, N), both
    times and the regime the wrapper picks there."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    rows = {}
    for name, shapes in (("w4a8_gemm_channel", PLAIN_SHAPES),
                         ("w4a8_glu_channel", GLU_SHAPES)):
        fn = k.KERNEL_WRAPPERS[name]
        plain_fn = getattr(k, name + "_plain")
        glu = "_glu_" in name
        rows[name] = []
        for K, N in shapes:
            w = torch.randint(-2**31, 2**31 - 1, (K // 8, N), generator=gen,
                              device=dev, dtype=torch.int32)
            s = torch.rand((N,), generator=gen, device=dev) * 0.01 + 1e-4
            for M in CROSSOVER_MS:
                a = torch.randint(-128, 128, (M, K), generator=gen,
                                  device=dev, dtype=torch.int8)
                s_tok = torch.rand((M, 1), generator=gen, device=dev) * 0.05 \
                    + 1e-3
                ref = plain_fn(a, s_tok, w, s)
                row = dict(M=M, K=K, N=N, picked=k.channel_regime(M, glu))
                for regime in ("stream", "tiles"):
                    def call():
                        return k._channel(fn, a, s_tok, w, s, torch.bfloat16,
                                          glu, regime=regime)
                    out = call()
                    torch.cuda.synchronize()
                    d = (out.float() - ref.float()).abs().max().item()
                    if not (d <= ulp_tol(ref) if glu
                            else torch.equal(out, ref)):
                        raise AssertionError(
                            f"{name} M={M} K={K} N={N} {regime}: max |diff| "
                            f"{d:.3g}, bound "
                            f"{'2 ulps' if glu else 'bit-exact'}")
                    row[f"{regime}_ms"] = timer.ms(call)
                    del out
                log(f"  {name} M={M:4d} K={K:5d} N={N:5d} forced: stream "
                    f"{row['stream_ms']:.4f} ms, tiles {row['tiles_ms']:.4f} "
                    f"ms (the wrapper picks {row['picked']})")
                rows[name].append(row)
                del a, s_tok, ref
            del w, s
        torch.cuda.empty_cache()
    return rows


def check_fused(dev, gen, timer):
    """The activation-quant-fused GEMMs at the rows of FUSED_MS and every
    (K, N) the served runs give them: bit-exact against their plain
    versions, from bf16 activations with a few outliers; timed beside the
    bound (x, weights and scales read once, the output written once), the
    plain version and bf16 ``torch.matmul`` on the dequantized weights.
    The report row is M = 4 (decode at batch 4) at (I, H)."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    rows = {}
    for name, m_list in FUSED_MS.items():
        fn, plain_fn = k.KERNEL_WRAPPERS[name], getattr(k, name + "_plain")
        row = None
        for M, (K, N) in ((M, sh) for M in m_list for sh in FUSED_SHAPES):
            x = torch.randn((M, K), generator=gen, device=dev)
            x[:, ::997] *= 20  # outlier channels, as LLM activations have
            x = x.to(torch.bfloat16)
            w = torch.randint(-2**31, 2**31 - 1, (K // 8, N), generator=gen,
                              device=dev, dtype=torch.int32)
            if name.endswith("_channel"):
                s = torch.rand((N,), generator=gen, device=dev) * 0.01 + 1e-4
            else:
                s = (torch.rand((K // 128, N), generator=gen, device=dev)
                     * 0.01 + 1e-4).to(torch.bfloat16)
            args = (x, w, s)
            out, ref = fn(*args), plain_fn(*args)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                d = (out.float() - ref.float()).abs().max().item()
                raise AssertionError(f"{name} M={M} K={K} N={N}: not "
                                     f"bit-exact (max |diff| {d:.3g})")
            wd = _dequant_weight(w, s)
            ms = timer.ms(lambda: fn(*args))
            plain = timer.ms(lambda: plain_fn(*args))
            lib = timer.ms(lambda: torch.matmul(x, wd))
            nbytes = (M * K * 2 + K * N // 2 + s.numel() * s.element_size()
                      + M * N * 2)
            b, by = bound_ms(nbytes, 2.0 * M * N * K, INT8_OPS_PER_S)
            log(f"  {name} M={M:2d} K={K:5d} N={N:5d}: bit-exact; {ms:.4f} "
                f"ms (bound {b:.4f} by {by}, plain {plain:.4f}, bf16 matmul "
                f"{lib:.4f})")
            if (M, K, N) == (4, I, H):
                row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                           bound_by=by, max_abs_err=0.0,
                           shape=f"M={M} K={K} N={N} bf16 x")
            del x, w, wd, out, ref
        rows[name] = row
    return rows


#: head dims and input dtypes at which the slot write is held bit-exact
KV_WRITE_HDS = (64, 96, 128, 256)
KV_WRITE_DTYPES = (torch.bfloat16, torch.float32)


def check_kv_write(dev, gen, timer, B=4, S=2048, nkv=NKV):
    """The slot write (#9: ``write_kernel`` over ``SlotDest``) at B rows over
    an (nkv, S) cache, bit-exact at every head dim of KV_WRITE_HDS from bf16
    and f32 inputs, with rows at cache_len 0, S - 1 and past S (the clamp);
    timed at hd = 128 from bf16, the served path's."""
    from qqq_tpu_torch.kernels.kv_write import (
        slot_decode_write_int8, slot_decode_write_int8_plain,
    )

    clen = torch.tensor([0, 700, S - 1, S + 5], dtype=torch.int32,
                        device=dev)[:B]
    err = 0.0
    for hd in KV_WRITE_HDS:
        for dtype in KV_WRITE_DTYPES:
            kc = torch.randint(-128, 128, (B, nkv, S, hd), generator=gen,
                               device=dev, dtype=torch.int8)
            vc = kc.flip(0).contiguous()
            ks = torch.rand((B, nkv, S), generator=gen, device=dev)
            vs = ks.flip(0).contiguous()
            kn = torch.randn((B, 1, nkv, hd), generator=gen,
                             device=dev).to(dtype)
            vn = torch.randn((B, 1, nkv, hd), generator=gen,
                             device=dev).to(dtype)
            kn[0, 0, 3] = 0  # all-zero head row: the tiny-scale guard
            bufs = [kc, ks, vc, vs]
            mine = [t.clone() for t in bufs]
            plain = [t.clone() for t in bufs]
            slot_decode_write_int8(*mine, kn, vn, clen)
            slot_decode_write_int8_plain(*plain, kn, vn, clen)
            torch.cuda.synchronize()
            for name, x, y in zip(("k", "k_scale", "v", "v_scale"), mine,
                                  plain):
                err = max(err, (x.float() - y.float()).abs().max().item())
                if not torch.equal(x, y):
                    raise AssertionError(
                        f"slot_decode_write_int8 hd={hd} {dtype}: {name} "
                        "not bit-exact")
            if hd == HD and dtype == torch.bfloat16:
                timed = (mine, plain, kn, vn)
            del kc, vc, ks, vs, bufs
    mine, plain, kn, vn = timed
    ms = timer.ms(lambda: slot_decode_write_int8(*mine, kn, vn, clen))
    dev_ms = timer.device_ms(lambda: slot_decode_write_int8(*mine, kn, vn,
                                                            clen))
    plain_ms = timer.ms(lambda: slot_decode_write_int8_plain(*plain, kn, vn,
                                                             clen))
    nbytes = 2 * B * nkv * HD * 2 + B * 4 + 2 * B * nkv * (HD + 4)
    b, by = bound_ms(nbytes)
    log(f"  slot_decode_write_int8 B={B} nkv={nkv} S={S}: bit-exact at hd "
        f"{KV_WRITE_HDS} from bf16 and f32, cache_len {clen.tolist()}; hd "
        f"{HD} bf16: {ms:.4f} ms with the wrapper, device {dev_ms:.4f} ms "
        f"(graph of 20) (bound {b:.6f} by {by}, plain {plain_ms:.4f})")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b, bound_by=by, max_abs_err=err,
                shape=f"B={B} nkv={nkv} S={S} bf16 K/V")


def _dequant(c, s):
    return (c.float() * s[..., None]).to(torch.bfloat16)


#: the whole-cache decode's extra geometries, each (nh, nkv, hd, S, cache
#: lengths) below the 8192 switch: g = 4 and g = 16 at hd = 256 and the
#: same lengths, and Qwen2-0.5B's heads
DECODE_EXTRA = ((8, 2, 256, 4096, (1, 4096, 2001, 129)),
                (32, 2, 256, 4096, (1, 4096, 2001, 129)),
                (QWEN2_ATTN["nh"], QWEN2_ATTN["nkv"], QWEN2_ATTN["hd"], 8192,
                 (1, 3001, 8192, 5000)))


def check_decode(dev, gen, timer, heads=(NH, NKV), extra=DECODE_EXTRA):
    """The whole-cache decode (the split kernel with the JAX kernel's f32
    numerics) at B = 1 and 4 over Llama-2-7B's slot cache of 1024, 2048
    (the main path's max_len, prompt-like lengths: the report row) and
    4096 keys, then :data:`DECODE_EXTRA`; each (row, head) within two bf16
    ulps of its own largest output (:func:`ulp_rows`), timed beside its
    bound, its plain version and SDPA on the dequantized bf16 K/V (kv heads
    repeated, masked)."""
    import torch.nn.functional as F

    from qqq_tpu_torch.kernels.attention import (
        decode_attention_int8, decode_attention_int8_plain,
    )

    cases = [(B, *heads, HD, S, None) for B, S in (
        (1, 1024), (4, 1024), (1, 2048), (4, 2048), (1, 4096), (4, 4096))]
    cases += [(4, nh, nkv, hd, S, clen)
              for nh, nkv, hd, S, clen in extra]
    report, err = None, 0.0
    for B, nh, nkv, hd, S, clen in cases:
        if clen is not None:
            clen = torch.tensor(clen, dtype=torch.int32, device=dev)
        elif S == 2048:  # the main path's max_len, prompt-like lengths
            clen = torch.tensor([164, 364, 664, 964][:B], dtype=torch.int32,
                                device=dev)
        else:
            clen = torch.randint(S // 2, S + 1, (B,), generator=gen,
                                 device=dev, dtype=torch.int32)
        q = torch.randn((B, nh, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        kc = torch.randint(-128, 128, (B, nkv, S, hd), generator=gen,
                           device=dev, dtype=torch.int8)
        vc = torch.randint(-128, 128, (B, nkv, S, hd), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((B, nkv, S), generator=gen, device=dev) * 0.02 + 1e-3
        vs = torch.rand((B, nkv, S), generator=gen, device=dev) * 0.02 + 1e-3
        args = (q, kc, ks, vc, vs, clen)
        out = decode_attention_int8(*args)
        ref = decode_attention_int8_plain(*args)
        torch.cuda.synchronize()
        e, worst = ulp_rows(out, ref)
        what = (f"decode_attention_int8 B={B} nh={nh} nkv={nkv} hd={hd} "
                f"S={S} cache_len {clen.tolist()}")
        if not worst <= 1:
            raise AssertionError(f"{what}: a (row, head) differs by "
                                 f"{worst:.3g} times its bound of "
                                 f"{ATTN_ULPS} bf16 ulps")
        err = max(err, e)
        g = nh // nkv
        kd = _dequant(kc, ks).repeat_interleave(g, dim=1)
        vd = _dequant(vc, vs).repeat_interleave(g, dim=1)
        mask = (torch.arange(S, device=dev)[None, :]
                < clen[:, None])[:, None, None, :]
        ms = timer.ms(lambda: decode_attention_int8(*args))
        plain = timer.ms(lambda: decode_attention_int8_plain(*args))
        lib = timer.ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kd, vd, attn_mask=mask))
        n_pos = int(clen.clamp(max=S).sum())
        nbytes = n_pos * nkv * (hd + 4) * 2 + 2 * B * nh * hd * 2 + B * 4
        b, by = bound_ms(nbytes, 4.0 * nh * hd * n_pos)
        log(f"  {what}: max |diff| {e:.3g} (worst (row, head) {worst:.3g} "
            f"of its bound); {ms:.4f} ms (bound {b:.4f} by {by}, plain "
            f"{plain:.4f}, sdpa {lib:.4f})")
        if (B, nh, S) == (4, heads[0], 2048):
            report = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                          bound_by=by, shape=f"B=4 nh={nh} nkv={nkv} S=2048, "
                          "cache_len 164/364/664/964")
        del kc, vc, kd, vd
    report["max_abs_err"] = err
    return report


def flash_bound(nbytes: float, pairs: int, qk_int8: bool):
    """The flash kernels' bound: the bytes at the HBM rate against QKᵀ and
    P·V, 2·hd operations each per visible (query, key) pair, both at the
    bf16 rate or, with ``qk_int8``, QKᵀ at the int8 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * HD * pairs * 1e3 * (
        1 / BF16_FLOPS_PER_S
        + 1 / (INT8_OPS_PER_S if qk_int8 else BF16_FLOPS_PER_S))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: the flash wrappers' two QKᵀ routes, by report row (slot, paged): the
#: bf16 tensor cores (the default) and the int8 ones (``qk_int8=True``,
#: counted in each wrapper's ``qk_int8_launches`` too)
FLASH_ROUTES = {False: ("flash_attention_int8",
                        "paged_flash_attention_int8"),
                True: ("flash_attention_int8 qk_int8",
                       "paged_flash_attention_int8 qk_int8")}


def check_q_codes(q, what):
    """The int8 route's quantization of q (``quantize_q_int8``, the kernel
    that the route launches ahead of flash) bit-equal to the plain
    version's: codes and row scales, so that the s32 scores are too."""
    from qqq_tpu_torch.kernels.attention import (
        quantize_q_int8, quantize_q_int8_plain,
    )

    codes, qs = quantize_q_int8(q)
    codes_p, qs_p = quantize_q_int8_plain(q)
    if not (torch.equal(codes, codes_p) and torch.equal(qs, qs_p)):
        raise AssertionError(
            f"{what}: quantize_q_int8 differs from its plain version in "
            f"{int((codes != codes_p).sum())} codes and "
            f"{int((qs != qs_p).sum())} row scales")


def check_flash(dev, gen, timer, cases=((2, 128), (2, 512), (2, 2048)),
                nkv=NKV, report_at=(2, 512), qk_int8=False, nh=NH):
    """Slot flash at each case of ``cases``: (B, T) with T = S (a fresh
    bucket-sized prefill cache, cache_len 0), or (B, T, S, cache lengths),
    each row of the output within two bf16 ulps of its own largest value
    (:func:`ulp_rows`: a causal prefill's first row sees one key and would
    set a whole-output bound far above the long rows); with ``qk_int8`` the
    int8-QKᵀ route too, checked and timed beside the default route, its q
    codes and row scales bit-equal to the plain version's, and the bf16
    route's output held to the int8 route's plain version as well (logged:
    how far the rule separates the routes on this data).
    Yardstick: SDPA on the dequantized bf16 K/V, kv heads repeated for GQA,
    causal (with the cache offset as a mask where cache_len > 0).  Returns
    each route's report row at ``report_at``, by wrapper name."""
    import torch.nn.functional as F

    from qqq_tpu_torch.kernels.attention import (
        flash_attention_int8, flash_attention_int8_plain,
    )

    routes = (False, True) if qk_int8 else (False,)
    reports, errs = {}, dict.fromkeys(routes, 0.0)
    for case in cases:
        B, T = case[:2]
        S, clens = case[2:] if len(case) > 2 else (T, (0,) * B)
        clen = torch.tensor(clens, dtype=torch.int32, device=dev)
        q = torch.randn((B, nh, T, HD), generator=gen, device=dev).to(
            torch.bfloat16)
        kc, ks, vc, vs = _rand_slot_cache(dev, gen, B, S, nkv)
        args = (q, kc, ks, vc, vs, clen)
        what = f"B={B} T={T} S={S} nh={nh} nkv={nkv} cache_len {clens}"
        checked, outs, refs = {}, {}, {}
        for qk in routes:
            outs[qk] = flash_attention_int8(*args, qk_int8=qk)
            refs[qk] = flash_attention_int8_plain(*args, True, qk)
            torch.cuda.synchronize()
            e, worst = ulp_rows(outs[qk], refs[qk])
            if not worst <= 1:
                raise AssertionError(
                    f"flash_attention_int8 (qk_int8={qk}) {what}: a row "
                    f"differs by {worst:.3g} times its bound of {ATTN_ULPS} "
                    "bf16 ulps")
            errs[qk] = max(errs[qk], e)
            checked[qk] = (e, worst)
        if qk_int8:
            check_q_codes(q, f"flash_attention_int8 qk_int8 {what}")
            cross = ulp_rows(outs[False], refs[True])[1]
            log(f"  {what}: q codes and row scales bit-equal to the plain "
                f"version's; the bf16 route's output at {cross:.3g} of the "
                "int8 route's bound")
        del outs, refs
        kd = _dequant(kc, ks).repeat_interleave(nh // nkv, dim=1)
        vd = _dequant(vc, vs).repeat_interleave(nh // nkv, dim=1)
        if any(clens) or S != T:
            qpos = clen[:, None] + torch.arange(T, device=dev)[None, :]
            mask = (torch.arange(S, device=dev)[None, None, :]
                    <= qpos[:, :, None])[:, None]
            lib = timer.ms(lambda: F.scaled_dot_product_attention(
                q, kd, vd, attn_mask=mask))
            del mask
        else:
            lib = timer.ms(lambda: F.scaled_dot_product_attention(
                q, kd, vd, is_causal=True))
        # visible (query, key) pairs and live keys
        pairs = nh * sum(T * c + T * (T + 1) // 2 for c in clens)
        keys = sum(c + T for c in clens)
        nbytes = 2 * B * nh * T * HD * 2 + keys * nkv * (HD + 4) * 2 + B * 4
        times = {}
        for qk in routes:
            ms = timer.ms(lambda: flash_attention_int8(*args, qk_int8=qk))
            plain = timer.ms(lambda: flash_attention_int8_plain(*args, True,
                                                                qk))
            times[qk] = ms
            b, by = flash_bound(nbytes, pairs, qk)
            e, worst = checked[qk]
            log(f"  flash_attention_int8{' qk_int8' if qk else ''} B={B} "
                f"T={T} S={S} nh={nh} nkv={nkv} cache_len {clens}: max |diff| "
                f"{e:.3g} (worst row {worst:.3g} of its bound); {ms:.4f} ms "
                f"(bound {b:.4f} by {by}, plain {plain:.4f}, sdpa {lib:.4f}"
                + (f", the bf16 route {times[False]:.4f}" if qk else "")
                + ")")
            if (B, T) == report_at and len(case) == 2:
                reports[FLASH_ROUTES[qk][0]] = dict(
                    ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                    bound_by=by, shape=f"B={B} T=S={T} causal, clen 0"
                    + ("" if nh == NH else f", nh={nh} nkv={nkv}"))
        del kc, vc, kd, vd
        torch.cuda.empty_cache()
    for qk, report in zip(routes, (reports.get(FLASH_ROUTES[r][0])
                                   for r in routes)):
        if report is not None:
            report["max_abs_err"] = errs[qk]
    return reports

def _flash_decode_cases(dev, gen, timer, nh, nkv, hd, S, clens):
    """The S-tiled decode at B = 4 over one random slot cache of S keys and
    JAX's tile, for each tuple of cache lengths in ``clens``: each (row,
    head) within two bf16 ulps of its own largest output (:func:`ulp_rows`),
    timed beside its bound, its plain version and SDPA on the dequantized
    bf16 live K/V (kv heads repeated, masked).  Returns a report dict per
    tuple."""
    import torch.nn.functional as F

    from qqq_tpu_torch.kernels.attention import (
        decode_workspace_bytes, flash_decode_attention_int8,
        flash_decode_attention_int8_plain, flash_decode_tile,
    )

    B, g = 4, nh // nkv
    tile = flash_decode_tile(nkv, S, hd, g)
    ws = decode_workspace_bytes(B, nh, nkv, S, hd, tile)
    kc = torch.randint(-128, 128, (B, nkv, S, hd), generator=gen,
                       device=dev, dtype=torch.int8)
    vc = torch.randint(-128, 128, (B, nkv, S, hd), generator=gen,
                       device=dev, dtype=torch.int8)
    ks = torch.rand((B, nkv, S), generator=gen, device=dev) * 0.02 + 1e-3
    vs = torch.rand((B, nkv, S), generator=gen, device=dev) * 0.02 + 1e-3
    out_rows = {}
    for clen in clens:
        cl = torch.tensor(clen, dtype=torch.int32, device=dev)
        q = torch.randn((B, nh, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        args = (q, kc, ks, vc, vs, cl)
        out = flash_decode_attention_int8(*args)
        ref = flash_decode_attention_int8_plain(*args)
        torch.cuda.synchronize()
        e, worst = ulp_rows(out, ref)
        what = (f"flash_decode_attention_int8 B={B} nh={nh} nkv={nkv} "
                f"hd={hd} S={S} tile {tile} cache_len {clen}")
        if not worst <= 1:
            raise AssertionError(f"{what}: a (row, head) differs by "
                                 f"{worst:.3g} times its bound of "
                                 f"{ATTN_ULPS} bf16 ulps")
        ms = timer.ms(lambda: flash_decode_attention_int8(*args))
        plain = timer.ms(lambda: flash_decode_attention_int8_plain(*args))
        live = max(clen)
        kd = _dequant(kc[:, :, :live], ks[:, :, :live]).repeat_interleave(
            g, dim=1)
        vd = _dequant(vc[:, :, :live], vs[:, :, :live]).repeat_interleave(
            g, dim=1)
        mask = (torch.arange(live, device=dev)[None, :]
                < cl[:, None])[:, None, None, :]
        lib = timer.ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kd, vd, attn_mask=mask))
        del kd, vd, mask
        n_pos = sum(clen)
        nbytes = n_pos * nkv * (hd + 4) * 2 + 2 * B * nh * hd * 2 + B * 4
        b, by = bound_ms(nbytes, 4.0 * nh * hd * n_pos)
        log(f"  {what} ({ws}-byte workspace): max |diff| {e:.3g} (worst "
            f"(row, head) {worst:.3g} of its bound); {ms:.4f} ms (bound "
            f"{b:.4f} by {by}, plain {plain:.4f}, sdpa {lib:.4f})")
        out_rows[clen] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
            max_abs_err=e, shape=f"B={B} nh={nh} nkv={nkv} S={S}, "
            f"cache_len {list(clen)}")
    del kc, vc
    torch.cuda.empty_cache()
    return out_rows


def check_flash_decode(dev, gen, timer):
    """The S-tiled decode at Llama-3.1-8B's shape over run 3e's 32768-token
    slot cache (32 heads, 8 kv heads; JAX's tile, 2048 keys): cache lengths
    of 1 key, on a tile boundary, past the 8192 switch mid-tile and the
    whole cache; those of the served run's last tick (the report row); one
    long row beside rows of one key; then g = 16 (32 heads over 2 kv
    heads) at the served lengths."""
    from qqq_tpu_torch.kernels.attention import flash_decode_tile

    S = L31_MAX_LEN
    tile = flash_decode_tile(NKV3, S, HD, NH // NKV3)
    served = tuple(n + 63 for n in L31_PROMPT_LENS)  # its last tick
    cases = _flash_decode_cases(dev, gen, timer, NH, NKV3, HD, S, (
        (1, 3 * tile, 9001, S), served, (1, 1, 12063, 1)))
    g16 = _flash_decode_cases(dev, gen, timer, 32, 2, HD, S, (served,))
    report = cases[served]
    report["max_abs_err"] = max(r["max_abs_err"]
                                for r in (*cases.values(), *g16.values()))
    return report


def check_flash_decode_qwen2(dev, gen, timer):
    """The S-tiled decode at Qwen2-0.5B's attention geometry
    (:data:`QWEN2_ATTN`, B = 4, bf16 q): JAX's tile is 16384 keys, 128
    chunks whose maxima meet in one running maximum; then g = 16 (32 heads
    over 2 kv heads) at the same width and lengths.  Logged beside the
    bound, the plain version and SDPA; not a report row."""
    nh, nkv, hd, S = (QWEN2_ATTN[k] for k in ("nh", "nkv", "hd", "S"))
    clen = QWEN2_ATTN["clen"]
    _flash_decode_cases(dev, gen, timer, nh, nkv, hd, S, (clen,))
    _flash_decode_cases(dev, gen, timer, 32, 2, hd, S, (clen,))


def _scrambled_tables(dev, rows: int, seed: int):
    """``rows`` tables of NBMAX distinct pool blocks in a shuffled,
    non-monotone order, as a busy allocator leaves them."""
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(NB_POOL - 1, generator=g)[:rows * NBMAX] + 1
    return perm.reshape(rows, NBMAX).to(torch.int32).to(dev)


def _rand_slot_cache(dev, gen, B, S, nkv=NKV):
    """A Llama-2-7B layer's slot cache of B rows and S keys: (k codes, k
    scales, v codes, v scales), drawn as :func:`check_flash` draws them."""
    kc = torch.randint(-128, 128, (B, nkv, S, HD), generator=gen,
                       device=dev, dtype=torch.int8)
    vc = torch.randint(-128, 128, (B, nkv, S, HD), generator=gen,
                       device=dev, dtype=torch.int8)
    ks = torch.rand((B, nkv, S), generator=gen, device=dev) * 0.02 + 1e-3
    vs = torch.rand((B, nkv, S), generator=gen, device=dev) * 0.02 + 1e-3
    return kc, ks, vc, vs


def _rand_pool(dev, gen, nkv=NKV):
    """A Llama-2-7B layer's pool: 65 blocks × 32 kv heads (or ``nkv``) ×
    128 × 128."""
    kp = torch.randint(-128, 128, (NB_POOL, nkv, BS, HD), generator=gen,
                       device=dev, dtype=torch.int8)
    vp = torch.randint(-128, 128, (NB_POOL, nkv, BS, HD), generator=gen,
                       device=dev, dtype=torch.int8)
    ks = torch.rand((NB_POOL, nkv, BS), generator=gen, device=dev) * 0.02 \
        + 1e-3
    vs = torch.rand((NB_POOL, nkv, BS), generator=gen, device=dev) * 0.02 \
        + 1e-3
    return [kp, ks, vp, vs]


def check_paged_writes(dev, gen, timer):
    """Both paged writes against their plain versions, bit-exact on every
    block but the null one: decode at B = 4 with cache lengths near 2000
    that end mid-block; a chunk of T = 512 at R = 2 rows, one straddling
    five blocks after 300 cached keys, one running past its table (its
    tail lands in the null block)."""
    from qqq_tpu_torch.kernels import kv_write as kw

    rows = {}
    for name, B, T, clen in (
        ("paged_decode_write_int8", 4, 1, (1990, 2001, 1937, 2040)),
        ("paged_chunk_write_int8", 2, 512, (300, 1800)),
    ):
        fn, plain = getattr(kw, name), getattr(kw, name + "_plain")
        pool = _rand_pool(dev, gen)
        tables = _scrambled_tables(dev, B, seed=B)
        cl = torch.tensor(clen, dtype=torch.int32, device=dev)
        kn = torch.randn((B, T, NKV, HD), generator=gen, device=dev).to(
            torch.bfloat16)
        vn = torch.randn((B, T, NKV, HD), generator=gen, device=dev).to(
            torch.bfloat16)
        kn[0, 0, 3] = 0  # all-zero head row: the tiny-scale guard
        mine = [t.clone() for t in pool]
        ref = [t.clone() for t in pool]
        fn(*mine, kn, vn, tables, cl)
        plain(*ref, kn, vn, tables, cl)
        torch.cuda.synchronize()
        err = 0.0
        for buf, x, y in zip(("k", "k_scale", "v", "v_scale"), mine, ref):
            err = max(err, (x[1:].float() - y[1:].float()).abs().max().item())
            if not torch.equal(x[1:], y[1:]):
                raise AssertionError(f"{name}: {buf} not bit-exact outside "
                                     "the null block")
        ms = timer.ms(lambda: fn(*mine, kn, vn, tables, cl))
        dev_ms = timer.device_ms(lambda: fn(*mine, kn, vn, tables, cl))
        plain_ms = timer.ms(lambda: plain(*ref, kn, vn, tables, cl))
        # bf16 rows in, one table entry per touched block, codes + scales out
        touched = sum(-(-(c % BS + T) // BS) for c in clen)
        nbytes = 2 * B * T * NKV * HD * 2 + B * 4 + touched * 4 \
            + 2 * B * T * NKV * (HD + 4)
        b, by = bound_ms(nbytes)
        log(f"  {name} B={B} T={T} cache_len {clen}: bit-exact outside the "
            f"null block; {ms:.4f} ms with the wrapper, device "
            f"{dev_ms:.4f} ms (graph of 20) (bound {b:.6f} by {by}, plain "
            f"{plain_ms:.4f})")
        rows[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                          library_ms=None,
                          bound_ms=b, bound_by=by, max_abs_err=err,
                          shape=f"B={B} T={T} cache_len {list(clen)}, "
                                "scrambled tables")
        del pool, mine, ref
    return rows


def _gathered_bf16(pool, tables):
    """The pool's K/V through the tables, dequantized to bf16: the library
    yardstick's operands (B, nkv, NBMAX·BS, hd)."""
    from qqq_tpu_torch.serve.paged_kv import gather

    kp, ks, vp, vs = pool
    return (_dequant(gather(kp, tables), gather(ks, tables)),
            _dequant(gather(vp, tables), gather(vs, tables)))


def check_paged_flash(dev, gen, timer):
    """Paged flash at the served chunk (R = 2 rows of T = 512) over
    scrambled tables, after 300 and 1400 cached keys (the chunk attends to
    earlier blocks), and one row of a fresh prompt, by both QKᵀ routes
    (bf16, and int8 with ``qk_int8``): each output row within two bf16 ulps
    of its own largest value (:func:`ulp_rows`), and bit-equal to slot
    flash of the same route on the pool gathered through the tables (the
    two differ only in where a key row is read; that kernel's time is
    logged beside it).  Yardstick: SDPA with the causal offset mask on the
    gathered K/V.  The int8 route's q codes and row scales are held
    bit-equal to the plain version's.  Returns each route's report row, by
    name."""
    import torch.nn.functional as F

    from qqq_tpu_torch.kernels.attention import (
        flash_attention_int8, paged_flash_attention_int8,
        paged_flash_attention_int8_plain,
    )
    from qqq_tpu_torch.serve.paged_kv import gather

    reports, errs = {}, {False: 0.0, True: 0.0}
    T = 512
    for clen in ((300, 1400), (0,)):
        R = len(clen)
        pool = _rand_pool(dev, gen)
        tables = _scrambled_tables(dev, R, seed=10 + R)
        cl = torch.tensor(clen, dtype=torch.int32, device=dev)
        q = torch.randn((R, NH, T, HD), generator=gen, device=dev).to(
            torch.bfloat16)
        args = (q, *pool, tables, cl)
        slot_args = (q, *(gather(t, tables) for t in pool), cl)
        checked = {}
        check_q_codes(q, f"paged_flash_attention_int8 qk_int8 cache_len "
                         f"{clen}")
        for qk in (False, True):
            out = paged_flash_attention_int8(*args, qk_int8=qk)
            ref = paged_flash_attention_int8_plain(*args, True, qk)
            slot = flash_attention_int8(*slot_args, qk_int8=qk)
            torch.cuda.synchronize()
            e, worst = ulp_rows(out, ref)
            if not worst <= 1:
                raise AssertionError(
                    f"paged_flash_attention_int8 (qk_int8={qk}) cache_len "
                    f"{clen}: a row differs by {worst:.3g} times its bound "
                    f"of {ATTN_ULPS} bf16 ulps")
            if not torch.equal(out, slot):
                raise AssertionError(
                    f"paged_flash_attention_int8 (qk_int8={qk}) cache_len "
                    f"{clen}: not bit-equal to flash_attention_int8 on the "
                    "gathered pool")
            errs[qk] = max(errs[qk], e)
            checked[qk] = (e, worst)
            del out, ref, slot
        kd, vd = _gathered_bf16(pool, tables)
        key = torch.arange(NBMAX * BS, device=dev)
        qpos = cl[:, None] + torch.arange(T, device=dev)[None, :]  # (R, T)
        mask = (key[None, None, :] <= qpos[:, :, None])[:, None]
        lib = timer.ms(lambda: F.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask))
        pairs = NH * sum(T * c + T * (T + 1) // 2 for c in clen)
        keys = sum(c + T for c in clen)
        nbytes = (2 * R * NH * T * HD * 2 + keys * NKV * (HD + 4) * 2
                  + R * 4 + sum(-(-(c + T) // BS) for c in clen) * 4)
        times = {}
        for qk in (False, True):
            ms = timer.ms(lambda: paged_flash_attention_int8(*args,
                                                             qk_int8=qk))
            slot_ms = timer.ms(lambda: flash_attention_int8(*slot_args,
                                                            qk_int8=qk))
            plain = timer.ms(lambda: paged_flash_attention_int8_plain(
                *args, True, qk))
            times[qk] = ms
            b, by = flash_bound(nbytes, pairs, qk)
            e, worst = checked[qk]
            log(f"  paged_flash_attention_int8{' qk_int8' if qk else ''} "
                f"R={R} T={T} cache_len {clen}: max |diff| {e:.3g} (worst "
                f"row {worst:.3g} of its bound), bit-equal to slot flash on "
                f"the gathered pool; {ms:.4f} ms (bound {b:.4f} by {by}, "
                f"slot flash on the gathered pool {slot_ms:.4f}, plain "
                f"{plain:.4f}, sdpa {lib:.4f}"
                + (f", the bf16 route {times[False]:.4f}" if qk else "")
                + ")")
            name = FLASH_ROUTES[qk][1]
            if name not in reports:
                reports[name] = dict(
                    ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                    bound_by=by, shape=f"R={R} T={T} causal, cache_len "
                    f"{list(clen)}, scrambled tables")
        del pool, kd, vd, slot_args
    for qk in (False, True):
        reports[FLASH_ROUTES[qk][1]]["max_abs_err"] = errs[qk]
    return reports


#: the control's outlier channel: channel 5 of every q row times 8, as an
#: activation outlier would be; the int8 step of the other channels grows
#: with it, and the two QKᵀ routes part well past the two-ulp rule
QK_CONTROL_OUTLIER = 8.0


def check_qk_int8_control(dev, gen):
    """A case that a kernel ignoring ``qk_int8`` (bf16 QKᵀ on either flag)
    could not pass: slot flash at B = 2, T = S = 512 and paged flash at R =
    2, T = 512 after 300 and 1400 cached keys, with q's channel 5 scaled by
    ``QK_CONTROL_OUTLIER``.  Each route within two bf16 ulps of its own
    plain version per row (:func:`ulp_rows`), the int8 route's q codes and
    row scales bit-equal to the plain version's, and the bf16 route's
    output past that rule against the int8 route's plain version (the
    control: the rule tells the routes apart).  Runs on any device."""
    from qqq_tpu_torch.kernels.attention import (
        flash_attention_int8, flash_attention_int8_plain,
        paged_flash_attention_int8, paged_flash_attention_int8_plain,
    )

    T = 512
    slot = (lambda q, qk: flash_attention_int8(*q, qk_int8=qk),
            lambda q, qk: flash_attention_int8_plain(*q, True, qk))
    paged = (lambda q, qk: paged_flash_attention_int8(*q, qk_int8=qk),
             lambda q, qk: paged_flash_attention_int8_plain(*q, True, qk))
    for name, (fn, plain), clen, rest in (
            ("flash_attention_int8", slot, (0, 0),
             _rand_slot_cache(dev, gen, 2, T)),
            ("paged_flash_attention_int8", paged, (300, 1400),
             (*_rand_pool(dev, gen), _scrambled_tables(dev, 2, seed=12)))):
        q = torch.randn((2, NH, T, HD), generator=gen, device=dev)
        q[..., 5] *= QK_CONTROL_OUTLIER
        q = q.to(torch.bfloat16)
        args = (q, *rest, torch.tensor(clen, dtype=torch.int32, device=dev))
        what = (f"{name}, q channel 5 x {QK_CONTROL_OUTLIER:g}, cache_len "
                f"{clen}")
        check_q_codes(q, what)
        out = {qk: fn(args, qk) for qk in (False, True)}
        ref = {qk: plain(args, qk) for qk in (False, True)}
        own = {qk: ulp_rows(out[qk], ref[qk])[1] for qk in (False, True)}
        cross = ulp_rows(out[False], ref[True])[1]
        log(f"  control, {what}: each route's worst row at {own[False]:.3g} "
            f"(bf16) / {own[True]:.3g} (int8) of the rule against its own "
            f"plain version; the bf16 route's against the int8 route's "
            f"plain version at {cross:.3g}")
        if not max(own.values()) <= 1:
            raise AssertionError(f"control, {what}: a route differs from "
                                 f"its plain version ({own})")
        if not cross > 1:
            raise AssertionError(f"control, {what}: the bf16 route passes "
                                 f"the int8 route's check ({cross:.3g})")


def drive_qk_int8_route(dev, gen):
    """The int8-QKᵀ route's own path.  It is off by default, as in JAX, so
    no served run takes it: one call of each flash wrapper with
    ``qk_int8=True`` at the report shapes (slot B = 2, T = S = 512; paged R
    = 2, T = 512 after 300 and 1400 cached keys), every count set to 0 just
    before and read just after.  Returns the route's launches by report
    row."""
    from qqq_tpu_torch.kernels import attention

    T = 512
    q = torch.randn((2, NH, T, HD), generator=gen, device=dev).to(
        torch.bfloat16)
    slot_cache = _rand_slot_cache(dev, gen, 2, T)
    kc, ks, vc, vs = _rand_pool(dev, gen)
    wrappers = (attention.flash_attention_int8,
                attention.paged_flash_attention_int8)
    fns = kernel_fns()
    for fn, _, _ in fns.values():
        fn.launches = 0
    for fn in wrappers:
        fn.qk_int8_launches = 0
    attention.flash_attention_int8(
        q, *slot_cache, torch.zeros((2,), dtype=torch.int32, device=dev),
        qk_int8=True)
    attention.paged_flash_attention_int8(
        q, kc, ks, vc, vs, _scrambled_tables(dev, 2, seed=12),
        torch.tensor((300, 1400), dtype=torch.int32, device=dev),
        qk_int8=True)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, (fn, _, _) in fns.items()}
    route = {row: fn.qk_int8_launches
             for row, fn in zip(FLASH_ROUTES[True], wrappers)}
    expect = {**dict.fromkeys(launches, 0),
              **dict.fromkeys(FLASH_ROUTES[False], 1)}
    if launches != expect or set(route.values()) != {1}:
        raise AssertionError(f"the qk_int8 route's calls launched {launches},"
                             f" on the route {route}")
    log(f"phase 2q: the int8-QKᵀ route through its entry points: {route}")
    return route

def check_paged_decode(dev, gen, timer, nh=NH, cases=None):
    """Paged decode at B = 4 over scrambled tables of all 64 blocks: cache
    lengths near 2000 ending mid-block (the report row), one long row
    beside rows of one key, then g = 16 (32 heads over a pool of 2 kv
    heads) at the first lengths; each (row, head) within two bf16 ulps of
    its own largest output (:func:`ulp_rows`).  Yardstick: SDPA on the
    gathered K/V (kv heads repeated)."""
    import torch.nn.functional as F

    from qqq_tpu_torch.kernels.attention import (
        paged_decode_attention_int8, paged_decode_attention_int8_plain,
    )

    B = 4
    tables = _scrambled_tables(dev, B, seed=20)
    served = (1990, 2001, 1937, 2040)
    report, err = None, 0.0
    for nkv, clen in cases or ((NKV, served), (NKV, (1, 2040, 1, 1)),
                               (2, served)):
        pool = _rand_pool(dev, gen, nkv)
        cl = torch.tensor(clen, dtype=torch.int32, device=dev)
        q = torch.randn((B, nh, HD), generator=gen, device=dev).to(
            torch.bfloat16)
        args = (q, *pool, tables, cl)
        out = paged_decode_attention_int8(*args)
        ref = paged_decode_attention_int8_plain(*args)
        torch.cuda.synchronize()
        e, worst = ulp_rows(out, ref)
        what = (f"paged_decode_attention_int8 B={B} nh={nh} nkv={nkv} cache_len "
                f"{clen}")
        if not worst <= 1:
            raise AssertionError(f"{what}: a (row, head) differs by "
                                 f"{worst:.3g} times its bound of "
                                 f"{ATTN_ULPS} bf16 ulps")
        err = max(err, e)
        kd, vd = (x.repeat_interleave(nh // nkv, dim=1)
                  for x in _gathered_bf16(pool, tables))
        mask = (torch.arange(NBMAX * BS, device=dev)[None, :]
                < cl[:, None])[:, None, None, :]
        ms = timer.ms(lambda: paged_decode_attention_int8(*args))
        plain = timer.ms(lambda: paged_decode_attention_int8_plain(*args))
        lib = timer.ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kd, vd, attn_mask=mask))
        n_pos = sum(clen)
        nbytes = (n_pos * nkv * (HD + 4) * 2 + 2 * B * nh * HD * 2 + B * 4
                  + sum(-(-c // BS) for c in clen) * 4)
        b, by = bound_ms(nbytes, 4.0 * nh * HD * n_pos)
        log(f"  {what}: max |diff| {e:.3g} (worst (row, head) {worst:.3g} "
            f"of its bound); {ms:.4f} ms (bound {b:.4f} by {by}, plain "
            f"{plain:.4f}, sdpa {lib:.4f})")
        if report is None:
            report = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                          bound_by=by, shape=f"B={B} cache_len "
                          f"{list(clen)}, scrambled tables"
                          + ("" if nh == NH else f", nh={nh} nkv={nkv}"))
        del pool, kd, vd
    report["max_abs_err"] = err
    return report


#: the KV writes and attention kernels: wrapper name → (CUDA source, TPU
#: kernel replaced)
KV_ATTN_KERNELS = {
    "slot_decode_write_int8": ("qqq_tpu_torch/csrc/kv_write.cu",
                               "qqq_tpu/kernels/kv_write.py:36"),
    "decode_attention_int8": ("qqq_tpu_torch/csrc/split_decode_attention.cu",
                              "qqq_tpu/kernels/attention.py:33"),
    "flash_decode_attention_int8": (
        "qqq_tpu_torch/csrc/split_decode_attention.cu",
        "qqq_tpu/kernels/attention.py:757"),
    "flash_attention_int8": ("qqq_tpu_torch/csrc/flash_attention.cu",
                             "qqq_tpu/kernels/attention.py:89"),
    "paged_decode_write_int8": ("qqq_tpu_torch/csrc/kv_write.cu",
                                "qqq_tpu/kernels/kv_write.py:158"),
    "paged_chunk_write_int8": ("qqq_tpu_torch/csrc/kv_write.cu",
                               "qqq_tpu/kernels/kv_write.py:183"),
    "paged_flash_attention_int8": ("qqq_tpu_torch/csrc/flash_attention.cu",
                                   "qqq_tpu/kernels/attention.py:404"),
    "paged_decode_attention_int8": (
        "qqq_tpu_torch/csrc/split_decode_attention.cu",
        "qqq_tpu/kernels/attention.py:543"),
}
#: the qk_int8 branch of #14 and #15 (its s8 QKᵀ at :133-146, :157-168):
#: report row → (CUDA source, TPU kernel replaced)
QK_INT8_KERNELS = dict(zip(FLASH_ROUTES[True], (
    ("qqq_tpu_torch/csrc/flash_attention.cu",
     "qqq_tpu/kernels/attention.py:133"),
    ("qqq_tpu_torch/csrc/flash_attention.cu",
     "qqq_tpu/kernels/attention.py:410"))))


def kernel_fns():
    """Every kernel wrapper of the served paths → (wrapper, CUDA source, TPU
    kernel replaced)."""
    from qqq_tpu_torch.kernels import counted_wrappers

    where = {**GEMM_KERNELS, **KV_ATTN_KERNELS}
    return {name: (fn, *where[name])
            for name, fn in counted_wrappers().items()}


PROMPT_LENS = (100, 300, 600, 900)
BUCKETS = (128, 512, 2048)
MAX_BATCH = 4
#: decode steps fused in each tick of the multi-step runs (3a and 3c)
MULTI_STEPS = 8
#: run 3e: prompt lengths (one per bucket), buckets and slot-cache length
L31_PROMPT_LENS = (100, 400, 1500, 12000)
L31_BUCKETS = (128, 512, 2048, 16384)
LLAMA2_TRAFFIC = (PROMPT_LENS, BUCKETS, 2048)
L31_TRAFFIC = (L31_PROMPT_LENS, L31_BUCKETS, L31_MAX_LEN)


PAGED_KERNELS = ("paged_decode_write_int8", "paged_chunk_write_int8",
                 "paged_flash_attention_int8", "paged_decode_attention_int8")
_G128_GEMMS = ("w4a8_gemm_group", "w4a8_glu_group", "w4a8_gemm_requant",
               "w4a8_glu_requant")
#: the GEMM kernels each served run must launch at least once, by scheme;
#: the KV kernels it must launch are slot_kernels() or PAGED_KERNELS, and
#: with FUSE_ACT_QUANT the scheme's fused kernel too
SCHEME_KERNELS = {
    "g128": _G128_GEMMS,
    "per-channel": ("w4a8_gemm_channel", "w4a8_glu_channel"),
}
FUSED_KERNEL = {"g128": "w4a8_gemm_fused_group",
                "per-channel": "w4a8_gemm_fused_channel"}


def slot_kernels(max_len: int):
    """The slot path's KV kernels: write, decode attention (whole-cache up
    to the JAX switch, S-tiled past it, at hd = 128) and prefill flash."""
    long = max_len * (HD + 8) > 8192 * (128 + 8)
    return ("slot_decode_write_int8",
            "flash_decode_attention_int8" if long else "decode_attention_int8",
            "flash_attention_int8")


def prefill_dispatches(eng, since=0):
    """(M, T) of each prefill dispatch in the engine's dispatch log from
    record ``since`` (its ``seq``) on, as its scheduler chose them: T the
    bucket of a whole-prompt dispatch or the chunk, M its rows · T."""
    return [(r["padded"], eng.prefill_chunk or r["padded"] // r["heads"])
            for r in eng.dispatch_log
            if r["kind"] == "prefill" and r["seq"] >= since]


def expected_launches(scheme, n_layers, dispatches, ticks, paged=False,
                      max_len=2048, fused=False, scores=(), chunked=False,
                      verifies=(), glu=True):
    """Launches per kernel that a served run implies (``ticks``: its decode
    steps, a replayed graph's counted as launched; ``scores``: the (M, T)
    of cache-free scoring forwards, which run the linears only;
    ``verifies``: the (M, T) of speculative verify forwards, M = max_batch
    · T, T = 1 + spec_k).  Per layer and forward pass: four linears
    (q/k/v/o) and down_proj on the plain GEMM, gate/up on the GLU GEMM,
    one KV write and one attention (slot or paged; decode or prefill).
    g128: the requant route for prefill dispatches of M ≥ 512 rows (T ≥ 64
    always holds for the buckets and chunks here), the exact route for the
    rest, the verifies and decode.  A prefill dispatch over the slot cache
    takes the slot flash (its write is an indexed copy), but with
    ``chunked`` (chunked prefill in slot mode) the paged chunk write and
    paged flash over the cache read as a pool; a verify takes those two in
    either mode, never the decode kernels.  With ``fused``
    (FUSE_ACT_QUANT), the five plain linears of each decode tick (M = 4)
    take the scheme's fused kernel; the GLU and every prefill dispatch
    (M ≥ 128) do not.  Without ``glu`` (unfused params, as under a mesh)
    all seven linears take the plain GEMM and the GLU kernels none."""
    if fused and (verifies or not glu):
        raise ValueError("the verify's linears under FUSE_ACT_QUANT are not "
                         "counted here")
    dispatches_kv, dispatches = dispatches, (list(dispatches) + list(scores)
                                             + list(verifies))
    n_big = sum(1 for m, t in dispatches if m >= 512 and t >= 64)
    small = len(dispatches) - n_big + ticks
    plain_ticks = 0 if fused else ticks  # ticks on the two-step route
    exp = dict.fromkeys(kernel_fns(), 0)
    lin, n_glu = (5, n_layers) if glu else (7, 0)
    if scheme == "g128":
        exp.update(w4a8_gemm_group=lin * n_layers
                   * (small - ticks + plain_ticks),
                   w4a8_glu_group=n_glu * small,
                   w4a8_gemm_requant=lin * n_layers * n_big,
                   w4a8_glu_requant=n_glu * n_big)
    else:
        passes = len(dispatches) + ticks
        exp.update(w4a8_gemm_channel=lin * n_layers
                   * (passes - ticks + plain_ticks),
                   w4a8_glu_channel=n_glu * passes)
    if fused:
        exp[FUSED_KERNEL[scheme]] = 5 * n_layers * ticks
    pooled = (len(dispatches_kv) if paged or chunked else 0) + len(verifies)
    exp.update(paged_chunk_write_int8=n_layers * pooled,
               paged_flash_attention_int8=n_layers * pooled)
    if paged:
        exp.update(paged_decode_write_int8=n_layers * ticks,
                   paged_decode_attention_int8=n_layers * ticks)
    else:
        write, decode, flash = slot_kernels(max_len)
        exp.update({write: n_layers * ticks, decode: n_layers * ticks,
                    flash: 0 if chunked else n_layers * len(dispatches_kv)})
    return exp


def serve(dev, params, config, scheme, paged=False, num_blocks=None,
          traffic=LLAMA2_TRAFFIC, fused=False, steps_per_tick=1,
          eager=False, engine_kw=None, keep=None, new_tokens=64):
    """Serve 4 requests through ``Engine`` with default arguments (gate/up
    GLU-fused; ``paged`` over the block pool, of ``num_blocks`` blocks or
    the Engine's default; ``steps_per_tick`` decode steps fused a tick):
    ``traffic`` = (prompt lengths, buckets, max_len), 64 greedy new tokens
    each.  With ``fused``, ``FUSE_ACT_QUANT`` is set for the run and
    restored after it.  Every decode tick must replay a captured CUDA graph
    (but the first of each graph, which runs eagerly and captures); with
    ``eager`` the engine's private switch runs every tick eagerly instead.
    Every kernel count is set to 0 just before the run and read just after;
    each must equal what the run's dispatches and decode steps imply.
    ``engine_kw`` adds Engine arguments: ``fuse=False`` or a ``mesh``
    (unfused, as JAX is under a mesh; under a gloo mesh every tick runs
    eagerly and its time is host-staged, not a speed).  ``keep`` (a list)
    receives the requests.  Returns the counts, the first prompt, the
    output tokens and the engine."""
    from qqq_tpu_torch.kernels import w4a8_gemm
    from qqq_tpu_torch.serve.engine import Engine, Request
    from qqq_tpu_torch.serve.sampling import SamplingParams

    prompt_lens, buckets, max_len = traffic
    vocab = config.vocab_size
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, vocab, size=n)]
               for n in prompt_lens]
    kw = dict(engine_kw or {})
    glu = kw.get("mesh") is None and kw.get("fuse", True)
    if paged:
        eng = Engine(params, config, max_batch=MAX_BATCH, max_len=max_len,
                     paged=True, num_blocks=num_blocks, device=dev,
                     steps_per_tick=steps_per_tick, **kw)
    else:
        eng = Engine(params, config, max_batch=MAX_BATCH, max_len=max_len,
                     prefill_buckets=buckets, device=dev,
                     steps_per_tick=steps_per_tick, **kw)
    eng._eager_tick = eager
    eager = eager or not eng._capture
    if glu != all("gate_up_glu" in layer for layer in eng.params["layers"]):
        raise AssertionError(f"Engine({kw}) did{'' if glu else ' not'} "
                             "fuse gate/up")
    reqs = [Request(prompt_tokens=p,
                    sampling=SamplingParams(max_new_tokens=new_tokens))
            for p in prompts]
    if keep is not None:
        keep.extend(reqs)
    fns = kernel_fns()
    for fn, _, _ in fns.values():
        fn.launches = 0
    w4a8_gemm.FUSE_ACT_QUANT = fused
    try:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        w4a8_gemm.FUSE_ACT_QUANT = False
    launches = {name: fn.launches for name, (fn, _, _) in fns.items()}
    st = eng.stats
    for r in reqs:
        if len(r.output_tokens) != new_tokens or not all(
                0 <= t < vocab for t in r.output_tokens):
            raise AssertionError(f"request of {len(r.prompt_tokens)} tokens "
                                 f"returned {len(r.output_tokens)} tokens")
    ticks, replays = st["decode_ticks"], st["graph_replays"]
    if eager and (replays or eng._graphs):
        raise AssertionError("the eager run replayed or captured a graph")
    if not eager and (replays == 0
                      or replays + st["graph_captures"] != ticks):
        raise AssertionError(f"{ticks} decode ticks but {replays} graph "
                             f"replays and {st['graph_captures']} captures")
    dispatches = prefill_dispatches(eng)
    expect = expected_launches(scheme, config.num_hidden_layers, dispatches,
                               st["decode_steps"], paged=paged,
                               max_len=max_len, fused=fused, glu=glu)
    must_run = (tuple(k for k in SCHEME_KERNELS[scheme]
                      if glu or "_glu_" not in k)
                + (PAGED_KERNELS if paged else slot_kernels(max_len))
                + ((FUSED_KERNEL[scheme],) if fused else ()))
    tick = "eager" if eager else "captured"
    mesh = kw.get("mesh")
    label = (f"{scheme}{' paged' if paged else ''}"
             f"{' FUSE_ACT_QUANT' if fused else ''}, {tick} tick, "
             f"steps_per_tick {steps_per_tick}"
             + ("" if mesh is None else
                f", mesh data {mesh.shape['data']} x model "
                f"{mesh.shape['model']} ({mesh.backend}), rank {mesh.rank}"))
    for name, n in launches.items():
        if n != expect[name]:
            raise AssertionError(f"{label}: {name}: {n} launches on the "
                                 f"served path, expected {expect[name]}")
        if n == 0 and name in must_run:
            raise AssertionError(f"{label}: {name} never launched on the "
                                 f"served path (M, T) = {dispatches}")
    decode_tokens = st["generated_tokens"] - len(reqs)
    log(f"  served {len(reqs)} requests (prompts {prompt_lens}, {new_tokens} "
        f"new tokens, depth {config.num_hidden_layers}, {label}, fuse={glu}, "
        f"max_len {max_len}"
        + (f", block_size {eng.block_size}, chunk {eng.prefill_chunk}, "
           f"num_blocks {eng.num_blocks}, prefill_batch "
           f"{eng.prefill_batch}" if paged else "")
        + f") in {wall:.3f} s: {st['prefill_dispatches']} prefill "
        f"dispatches (M, T) = {dispatches} in {st['prefill_s']:.3f} s, "
        f"{ticks} decode ticks ({st['decode_steps']} steps) in "
        f"{st['decode_s']:.3f} s"
        + (f", {st['preemptions']} preemptions" if paged else ""))
    log(f"  TTFT per request (s): "
        + ", ".join(f"{r.ttft:.3f}" for r in reqs))
    if not eager:
        # the replays alone: every tick but each graph's first, which ran
        # eagerly and captured it (n steps for a graph of n)
        replay_s = st["decode_s"] - st["graph_capture_s"]
        replay_steps = st["decode_steps"] - sum(k[0] for k in eng._graphs)
        log(f"  graphs: {len(eng._graphs)} held (steps, sampling branch, "
            f"FUSE_ACT_QUANT) {sorted(eng._graphs)}, {replays} replays, "
            f"{st['graph_captures']} ticks eager before their capture, "
            f"{st['graph_capture_s']:.3f} s in those ticks; the replays "
            f"alone: {1e3 * replay_s / replays:.3f} ms per tick, "
            f"{1e3 * replay_s / replay_steps:.3f} ms per step")
    staged = mesh is not None and mesh.backend == "gloo"
    log(f"  decode ({tick} tick, steps_per_tick {steps_per_tick}"
        + (", host-staged gloo collectives: not a speed" if staged else "")
        + f"): {1e3 * st['decode_s'] / ticks:.3f} ms per tick, "
        f"{1e3 * st['decode_s'] / decode_tokens:.3f} ms per generated token, "
        f"{decode_tokens / st['decode_s']:.1f} tok/s over all slots")
    log(f"  launches on the served path: {json.dumps(launches)}")
    log(f"  tokens: {json.dumps([r.output_tokens for r in reqs])}")
    return launches, prompts[0], [r.output_tokens for r in reqs], eng


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree_map(fn, v) for v in x]
    return None if x is None else fn(x)


#: card vs CPU logits: relative RMS difference ||card − cpu|| / ||cpu||,
#: held at every step
CARD_VS_CPU_TOL = 0.10


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def card_vs_cpu(dev, params, config, prompt, max_len=256, batched=True):
    """Teacher-force the card's greedy tokens through a 2-layer cut of the
    same weights, GLU-fused as the engine fuses them, on the card (kernels)
    and on the CPU (plain versions), over a slot cache of ``max_len``, and
    compare the logits of the prefill (1 row of bucket 128: M = 128, the
    exact g128 kernels) and of 4 decode steps (the exact kernels at M = 1,
    and the whole-cache or, past the switch, the S-tiled decode kernel);
    then, with ``batched``, of a batched prefill of 4 rows of bucket 128 (M
    = 512, T = 128: the requant kernels).

    Tolerance: the GEMM and the KV write give the same bits on both sides
    (phase 2), but RoPE's cos/sin and the attention kernels' sums differ in
    the last bits.  Each INT8 quantizer of a layer (the activations in front
    of q/k/v, o, gate/up and down, and the KV cache) turns such a difference
    into a whole-step code flip where a value sat near a rounding boundary,
    and the flips feed the next quantizer.  Within a layer or two the two
    runs' rounding decorrelates, and they differ by the quantization noise
    itself: a few percent.  A third run, the CPU again with 1% of the
    embedding entries one bf16 ulp off, shows how far such last-bit
    differences carry, beside each step.  A fault in a kernel or its
    indexing moves the logits by O(100%); the bound of 10% relative RMS
    sits between the two."""
    from qqq_tpu_torch.models import forward, fuse_inference_params
    from qqq_tpu_torch.serve import kv_cache

    cfg2 = dataclasses.replace(config, num_hidden_layers=2)
    cut = fuse_inference_params({**params, "layers": params["layers"][:2]},
                                cfg2)
    cpu = _tree_map(lambda t: t.cpu(), cut)
    emb = cpu["embed"]
    nudge = torch.rand(emb.shape, generator=torch.Generator().manual_seed(1))
    bits = emb.view(torch.int16) + (nudge < 0.01).to(torch.int16)
    nudged = {**cpu, "embed": bits.view(emb.dtype)}
    del nudge, bits
    n, bucket, steps = len(prompt), 128, 4
    V = config.vocab_size
    toks = torch.zeros((1, bucket), dtype=torch.int64)
    toks[0, :n] = torch.tensor(prompt)
    host = torch.device("cpu")
    sides = {}
    for name, d, p in (("card", dev, cut), ("cpu", host, cpu),
                       ("nudged", host, nudged)):
        caches = kv_cache.init(cfg2, 1, max_len, quantized=True, device=d)
        lg, _ = forward(p, cfg2, toks.to(d), caches=caches,
                        cache_len=torch.zeros((1,), dtype=torch.int32,
                                              device=d),
                        logits_at=torch.tensor([n - 1], device=d))
        sides[name] = (p, d, caches, [lg[0, -1].cpu()])
    fed = []
    fns = kernel_fns()
    for fn, _, _ in fns.values():
        fn.launches = 0
    for step in range(steps):
        tok = int(sides["card"][3][-1].argmax())
        fed.append(tok)
        for p, d, caches, out in sides.values():
            lg, _ = forward(p, cfg2, torch.tensor([[tok]], device=d),
                            caches=caches,
                            cache_len=torch.tensor([n + step],
                                                   dtype=torch.int32,
                                                   device=d))
            out.append(lg[0, -1].cpu())
    decode = slot_kernels(max_len)[1]
    if fns[decode][0].launches != 2 * steps:
        raise AssertionError(f"the card's decode steps launched {decode} "
                             f"{fns[decode][0].launches} times, expected "
                             f"{2 * steps}")
    agree, worst = 0, 0.0
    for i, (a, b, c) in enumerate(zip(*(sides[k][3] for k in
                                        ("card", "cpu", "nudged")))):
        if not (torch.isfinite(a).all() and a.shape == (V,)):
            raise AssertionError(f"step {i}: card logits not finite or of "
                                 "the wrong shape")
        rel = _rel_rms(a, b)
        worst = max(worst, rel)
        same = bool(a.argmax() == b.argmax())
        agree += same
        log(f"  step {i} ({'prefill' if i == 0 else 'decode'}): card vs CPU "
            f"{rel:.3%} RMS (max |diff| {float((a - b).abs().max()):.4g}, "
            f"max |logit| {float(b.abs().max()):.4g}); CPU vs nudged CPU "
            f"{_rel_rms(c, b):.3%} RMS; argmax "
            f"{'agrees' if same else 'differs'}")
        if rel > CARD_VS_CPU_TOL:
            raise AssertionError(f"step {i}: card vs CPU logits differ by "
                                 f"{rel:.3%} RMS > {CARD_VS_CPU_TOL:.0%}")
    log(f"  token agreement card vs CPU: {agree}/{steps + 1} (teacher-forced "
        f"tokens {fed}, decode on {decode}, max_len {max_len}); worst "
        f"{worst:.3%} RMS, bound {CARD_VS_CPU_TOL:.0%}")
    if not batched:
        return

    # a batched prefill of M = 4·128 rows, T = 128: the requant kernels
    rng = np.random.default_rng(1)
    lens = (100, 128, 64, 117)
    toks = torch.zeros((len(lens), bucket), dtype=torch.int64)
    for i, m in enumerate(lens):
        toks[i, :m] = torch.from_numpy(rng.integers(0, V, size=m))
    fns = kernel_fns()
    out = {}
    for name, d, p in (("card", dev, cut), ("cpu", host, cpu),
                       ("nudged", host, nudged)):
        for fn, _, _ in fns.values():
            fn.launches = 0
        caches = kv_cache.init(cfg2, len(lens), bucket, quantized=True,
                               device=d)
        lg, _ = forward(p, cfg2, toks.to(d), caches=caches,
                        cache_len=torch.zeros((len(lens),), dtype=torch.int32,
                                              device=d),
                        logits_at=torch.tensor(lens, device=d) - 1)
        out[name] = lg[:, 0].float().cpu()
        if name == "card":
            ran = sorted(k for k, (fn, _, _) in fns.items() if fn.launches)
            if not {"w4a8_gemm_requant", "w4a8_glu_requant"} <= set(ran):
                raise AssertionError(f"batched prefill ran {ran}, not the "
                                     "requant kernels")
    log(f"  batched prefill, 4 rows of bucket 128 (M = 512, T = 128; card "
        f"kernels {ran}):")
    for i in range(len(lens)):
        a, b, c = (out[k][i] for k in ("card", "cpu", "nudged"))
        if not (torch.isfinite(a).all() and a.shape == (V,)):
            raise AssertionError(f"batched row {i}: card logits not finite "
                                 "or of the wrong shape")
        rel = _rel_rms(a, b)
        log(f"    row {i} ({lens[i]} tokens): card vs CPU {rel:.3%} RMS (max "
            f"|diff| {float((a - b).abs().max()):.4g}); CPU vs nudged CPU "
            f"{_rel_rms(c, b):.3%} RMS; argmax "
            f"{'agrees' if a.argmax() == b.argmax() else 'differs'}")
        if rel > CARD_VS_CPU_TOL:
            raise AssertionError(f"batched row {i}: card vs CPU logits "
                                 f"differ by {rel:.3%} RMS > "
                                 f"{CARD_VS_CPU_TOL:.0%}")


def card_vs_cpu_paged(dev, params, config, prompt):
    """Phase 4 over the paged pool: teacher-force the same 2-layer cut
    through one paged chunk prefill (one row of the 512-token chunk, M =
    512: the requant kernels, paged chunk write and paged flash) and 4
    paged decode steps (the exact kernels, paged decode write and paged
    decode attention), over scrambled tables, on the card and on the CPU,
    and hold each step to the same 10% relative RMS as the slot path, the
    nudged CPU beside it (see :func:`card_vs_cpu`)."""
    from qqq_tpu_torch.models import forward, fuse_inference_params
    from qqq_tpu_torch.serve import paged_kv

    cfg2 = dataclasses.replace(config, num_hidden_layers=2)
    cut = fuse_inference_params({**params, "layers": params["layers"][:2]},
                                cfg2)
    cpu = _tree_map(lambda t: t.cpu(), cut)
    emb = cpu["embed"]
    nudge = torch.rand(emb.shape, generator=torch.Generator().manual_seed(1))
    bits = emb.view(torch.int16) + (nudge < 0.01).to(torch.int16)
    nudged = {**cpu, "embed": bits.view(emb.dtype)}
    del nudge, bits
    n, chunk, steps = len(prompt), 512, 4
    toks = torch.zeros((1, chunk), dtype=torch.int64)
    toks[0, :n] = torch.tensor(prompt)
    tables = _scrambled_tables(torch.device("cpu"), 1, seed=30)
    host = torch.device("cpu")
    fns = kernel_fns()
    sides = {}
    for name, d, p in (("card", dev, cut), ("cpu", host, cpu),
                       ("nudged", host, nudged)):
        for fn, _, _ in fns.values():
            fn.launches = 0
        pool = paged_kv.init(cfg2, NB_POOL, BS, quantized=True, device=d)
        tab = tables.to(d)
        lg, _ = forward(p, cfg2, toks.to(d), caches=pool,
                        cache_len=torch.zeros((1,), dtype=torch.int32,
                                              device=d),
                        logits_at=torch.tensor([n - 1], device=d),
                        block_tables=tab)
        sides[name] = (p, d, pool, tab, [lg[0, -1].cpu()])
        if name == "card":
            ran = {k for k, (fn, _, _) in fns.items() if fn.launches}
            if not {"paged_chunk_write_int8", "paged_flash_attention_int8",
                    "w4a8_gemm_requant", "w4a8_glu_requant"} <= ran:
                raise AssertionError(f"paged chunk prefill ran {ran}")
    fed = []
    for step in range(steps):
        tok = int(sides["card"][4][-1].argmax())
        fed.append(tok)
        for name, (p, d, pool, tab, out) in sides.items():
            if name == "card":
                for fn, _, _ in fns.values():
                    fn.launches = 0
            lg, _ = forward(p, cfg2, torch.tensor([[tok]], device=d),
                            caches=pool,
                            cache_len=torch.tensor([n + step],
                                                   dtype=torch.int32,
                                                   device=d),
                            block_tables=tab)
            out.append(lg[0, -1].cpu())
            if name == "card":
                ran = {k for k, (fn, _, _) in fns.items() if fn.launches}
                if not {"paged_decode_write_int8",
                        "paged_decode_attention_int8"} <= ran:
                    raise AssertionError(f"paged decode step ran {ran}")
    agree, worst = 0, 0.0
    for i, (a, b, c) in enumerate(zip(*(sides[k][4] for k in
                                        ("card", "cpu", "nudged")))):
        if not (torch.isfinite(a).all() and a.shape == (V,)):
            raise AssertionError(f"paged step {i}: card logits not finite "
                                 "or of the wrong shape")
        rel = _rel_rms(a, b)
        worst = max(worst, rel)
        same = bool(a.argmax() == b.argmax())
        agree += same
        log(f"  paged step {i} ({'chunk prefill' if i == 0 else 'decode'}):"
            f" card vs CPU {rel:.3%} RMS (max |diff| "
            f"{float((a - b).abs().max()):.4g}, max |logit| "
            f"{float(b.abs().max()):.4g}); CPU vs nudged CPU "
            f"{_rel_rms(c, b):.3%} RMS; argmax "
            f"{'agrees' if same else 'differs'}")
        if rel > CARD_VS_CPU_TOL:
            raise AssertionError(f"paged step {i}: card vs CPU logits differ "
                                 f"by {rel:.3%} RMS > {CARD_VS_CPU_TOL:.0%}")
    log(f"  paged token agreement card vs CPU: {agree}/{steps + 1} "
        f"(teacher-forced tokens {fed}); worst {worst:.3%} RMS, bound "
        f"{CARD_VS_CPU_TOL:.0%}")


def random_packed_params(dev, config, group_size):
    """Random weights from a seeded generator, RTN-packed on the card."""
    from qqq_tpu_torch.models import init_params, quantize_params_rtn

    t0 = time.perf_counter()
    params = quantize_params_rtn(
        init_params(config, torch.Generator(device=dev).manual_seed(0),
                    dtype=torch.bfloat16, device=dev), config, group_size)
    torch.cuda.synchronize()
    packed = sum(l[n]["w_packed"].numel() * 4 for l in params["layers"]
                 for n in ("q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj"))
    log(f"  random weights made and RTN-packed (group_size {group_size}) on "
        f"the card in {time.perf_counter() - t0:.1f} s: {packed / 1e9:.2f} GB "
        f"packed")
    torch.cuda.empty_cache()
    return params


# ---------------------------------------------------------------------------
# phase 5: the served checkpoint

#: new tokens of each request over HTTP
HTTP_NEW = 32
#: where phase 5 writes its checkpoints (inside the checkout, git-ignored);
#: removed at the end of the run
CKPT_DIR = HERE / "build" / "chip_smoke_checkpoints"
#: 3a's weights as phase 5 saves them (phase 8 evaluates them)
CKPT_G128 = CKPT_DIR / "llama2_7b_g128"


def save_and_load(dev, params, config):
    """``save_quantized`` the served params to ``CKPT_G128`` (kept for
    phase 8; the run removes ``CKPT_DIR`` at its end) and ``load_any`` them
    back onto the card: every tensor's dtype, shape and bits must be
    equal."""
    from qqq_tpu_torch.cli.eval import load_any
    from qqq_tpu_torch.models.loader import _flatten, save_quantized

    path = CKPT_G128
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_quantized(str(path), params, config,
                   {"quant_method": "qqq", "wbits": 4, "group_size": 128})
    write_s = time.perf_counter() - t0
    nbytes = (path / "model.safetensors").stat().st_size
    t0 = time.perf_counter()
    loaded, cfg = load_any(str(path), torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    if cfg != config:
        raise AssertionError(f"the loaded config {cfg} is not {config}")
    want, got = _flatten(params), _flatten(loaded)
    if set(want) != set(got):
        raise AssertionError(f"tensors differ: {set(want) ^ set(got)}")
    for k, t in want.items():
        u = got[k]
        if (u.dtype != t.dtype or u.shape != t.shape or u.device != t.device
                or not torch.equal(u.view(torch.uint8), t.view(torch.uint8))):
            raise AssertionError(f"{k}: loaded {u.dtype} {tuple(u.shape)} "
                                 f"on {u.device} differs from the saved one")
    log(f"  saved {len(want)} tensors, {nbytes / 1e9:.3f} GB, with "
        f"save_quantized in {write_s:.3f} s ({nbytes / 1e9 / write_s:.3f} "
        f"GB/s, card → file) and loaded them with load_any in {read_s:.3f} "
        f"s ({nbytes / 1e9 / read_s:.3f} GB/s, file → card): every tensor "
        f"bit-equal")
    return loaded, cfg  # the checkpoint stays for phase 8


def check_marlin(dev, params, config, group_size):
    """A 2-layer, full-width cut of the served weights written in the
    reference QQQ's Marlin layout (``save_marlin_checkpoint``) and read
    back (``load_qqq_hf_checkpoint``): the codes, and the per-channel
    scales, bit-equal to the originals; g128 scales equal to the fp16
    double scales the format stores, ``f16(s / s_extra) · s_extra`` with
    ``s_extra = max_k |s · q| / 127`` per column, recomputed here."""
    from qqq_tpu_torch.core.packing import unpack_int4
    from qqq_tpu_torch.models.marlin_compat import (
        load_qqq_hf_checkpoint, save_marlin_checkpoint,
    )

    cfg = dataclasses.replace(config, num_hidden_layers=2)
    cut = {**params, "layers": params["layers"][:2]}
    path = CKPT_DIR / f"marlin_{group_size}"
    t0 = time.perf_counter()
    save_marlin_checkpoint(str(path), cut, cfg, group_size=group_size)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, got_cfg = load_qqq_hf_checkpoint(str(path), device=dev)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    if got_cfg != cfg:
        raise AssertionError(f"Marlin config {got_cfg} is not {cfg}")
    worst = 0.0
    for i in range(2):
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                     "up_proj", "down_proj"):
            a, b = cut["layers"][i][name], got["layers"][i][name]
            if not torch.equal(a["w_packed"], b["w_packed"]):
                raise AssertionError(f"layer {i} {name}: Marlin codes differ")
            if group_size == -1:
                ok = torch.equal(a["s_channel"], b["s_channel"])
            else:
                s = a["s_group"].to(torch.float32)
                q = unpack_int4(a["w_packed"]).to(torch.float32)
                amax = (s.repeat_interleave(128, 0) * q).abs().amax(0)
                s_extra = torch.where(amax == 0, torch.ones_like(amax),
                                      amax) / torch.full_like(amax, 127.0)
                want = (s / s_extra).to(torch.float16).to(torch.float32) \
                    * s_extra
                ok = torch.equal(b["s_group"], want)
                worst = max(worst, float(((b["s_group"] - s).abs()
                                          / s.abs()).max()))
            if not ok:
                raise AssertionError(f"layer {i} {name}: Marlin scales differ")
    nbytes = (path / "model.safetensors").stat().st_size
    log(f"  Marlin layout ({'per channel' if group_size == -1 else 'g128'}, "
        f"2-layer full-width cut, {nbytes / 1e9:.3f} GB): written in "
        f"{write_s:.3f} s, read back and repacked on the card in "
        f"{read_s:.3f} s; codes bit-equal"
        + (", scales bit-equal" if group_size == -1 else
           f", scales equal to their fp16 double scales (largest change "
           f"from the bf16 originals {worst:.3e} relative)"))
    shutil.rmtree(path)


def _http(base, path, body=None, stream=False):
    """POST ``body`` (GET without one) and return the JSON reply, or the
    list of SSE events (``[DONE]`` last) when ``stream``."""
    import urllib.request

    req = urllib.request.Request(
        base + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if not stream:
            return json.loads(r.read())
        events = []
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(line[len("data: "):])
        return events


def _concurrently(base, calls):
    """Send every (name, path, body, stream) at once, each from its own
    thread; returns name → (reply, client seconds)."""
    import threading

    out, errors = {}, []

    def go(name, path, body, stream):
        t0 = time.perf_counter()
        try:
            out[name] = (_http(base, path, body, stream),
                         time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append((name, e))

    threads = [threading.Thread(target=go, args=c) for c in calls]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    if errors:
        raise AssertionError(f"HTTP requests failed: {errors}")
    return out


def serve_http(dev, params, config, prompts):
    """Serve the loaded checkpoint over HTTP (``make_server`` on
    127.0.0.1:0 over the default Engine, ``max_batch=4``) and check every
    reply: greedy ``/generate`` alone against a direct one-request run;
    then concurrently penalties, a logit bias, a guided choice, top-N
    logprobs, a seeded sampled request (sent again in a second batch: the
    same tokens), ``/v1/completions`` streamed as SSE and not, and echo
    scoring (against a direct ``score_prompt``); one request cancelled
    through the worker.  Every kernel count is set to 0 just before the
    traffic and must equal what its prefill dispatches, decode steps and
    scoring forwards imply; graphs keyed by the extras' planes must have
    replayed.  No other thread uses the card while the server runs."""
    import threading

    from qqq_tpu_torch.cli.serve import make_server
    from qqq_tpu_torch.serve.engine import Engine, Request, TickExtras
    from qqq_tpu_torch.serve.sampling import SamplingParams

    p0, p1, p2, p3 = prompts
    ref = Engine(params, config, max_batch=MAX_BATCH, device=dev)
    direct = Request(p0, SamplingParams(max_new_tokens=HTTP_NEW))
    ref.run([direct])
    score_ref = ref.score_prompt(p1)
    del ref
    torch.cuda.empty_cache()
    first = direct.output_tokens[0]
    # one first token, then a fork whose short branch a bias bans: the row
    # runs six ticks with its guided plane, five of them one wide
    guided = [p3[1:9], [p3[1], p3[9]]]
    gen = "/generate"
    cmpl = "/v1/completions"
    seeded = {"prompt_tokens": p2, "max_new_tokens": HTTP_NEW,
              "temperature": 0.8, "top_k": 50, "seed": 1234}
    completion = {"prompt": p3, "max_tokens": HTTP_NEW, "temperature": 0.0,
                  "logprobs": 1}
    batch_a = [
        ("penalties", gen, {"prompt_tokens": p1, "max_new_tokens": HTTP_NEW,
                            "presence_penalty": 1.0,
                            "frequency_penalty": 0.5,
                            "repetition_penalty": 1.3}, False),
        ("bias", gen, {"prompt_tokens": p0, "max_new_tokens": HTTP_NEW,
                       "logit_bias": {str(first): -100, "7": 5.0}}, False),
        ("guided", gen, {"prompt_tokens": p3, "max_new_tokens": HTTP_NEW,
                         "guided_choice": guided,
                         "logit_bias": {str(p3[9]): -100}}, False),
        ("top", gen, {"prompt_tokens": p1, "max_new_tokens": HTTP_NEW,
                      "top_logprobs": 3, "logprobs": True}, False),
        ("seeded", gen, seeded, False),
        ("sse", cmpl, {**completion, "stream": True}, True),
        ("completion", cmpl, completion, False),
        ("echo", cmpl, {"prompt": p1, "max_tokens": 0, "echo": True,
                        "logprobs": 1}, False),
    ]
    batch_b = [("seeded", gen, seeded, False),
               ("greedy", gen, {"prompt_tokens": p3,
                                "max_new_tokens": HTTP_NEW}, False)]

    eng = Engine(params, config, max_batch=MAX_BATCH, device=dev)
    server, worker = make_server(eng, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    fns = kernel_fns()
    for fn, _, _ in fns.values():
        fn.launches = 0
    try:
        t0 = time.perf_counter()
        alone = _concurrently(base, [("greedy", gen, {
            "prompt_tokens": p0, "max_new_tokens": HTTP_NEW}, False)])
        a = _concurrently(base, batch_a)
        b = _concurrently(base, batch_b)
        cancelled = Request(p0, SamplingParams(max_new_tokens=HTTP_NEW))
        worker.submit(cancelled)
        while cancelled._emitted < 4 and not cancelled.done:
            time.sleep(0.001)
        worker.cancel(cancelled)
        worker.wait(cancelled)
        wall = time.perf_counter() - t0
        stats = _http(base, "/stats")
        health = _http(base, "/health")
    finally:
        server.shutdown()
        worker.stop()
        thread.join(60)
    if worker.error is not None:
        raise AssertionError(f"the engine worker failed: {worker.error!r}")
    launches = {name: fn.launches for name, (fn, _, _) in fns.items()}
    st = eng.stats

    def toks(name, batch=a):
        return batch[name][0]["output_tokens"]

    if alone["greedy"][0]["output_tokens"] != direct.output_tokens:
        raise AssertionError("greedy /generate differs from the direct run")
    if first in toks("bias"):
        raise AssertionError("logit_bias -100 did not ban its token")
    if toks("guided") != guided[0]:
        raise AssertionError(f"guided reply {toks('guided')} is not "
                             f"{guided[0]}")
    # greedy: the chosen token is a top-1 entry (bf16 logits tie often, and
    # argmax and top-k may break a tie differently), at its logprob
    top = a["top"][0]
    for i, (pos, lp, t) in enumerate(zip(top["top_logprobs"],
                                         top["token_logprobs"],
                                         top["output_tokens"])):
        best = [tok for tok, v in pos if v == pos[0][1]]
        if len(pos) != 3 or abs(pos[0][1] - lp) > 1e-6 or t not in best:
            raise AssertionError(f"top_logprobs at {i}: {pos}, chosen {t} "
                                 f"at {lp}")
    if len(top["top_logprobs"]) != HTTP_NEW:
        raise AssertionError("top_logprobs: one list per token expected")
    if toks("seeded") != toks("seeded", b):
        raise AssertionError("the seeded request gave other tokens in the "
                             "second batch")
    events = a["sse"][0]
    if events[-1] != "[DONE]":
        raise AssertionError("the SSE stream did not end in [DONE]")
    final = json.loads(events[-2])["choices"][0]
    whole = a["completion"][0]["choices"][0]
    if (final["logprobs"]["tokens"] != whole["logprobs"]["tokens"]
            or len(events) != HTTP_NEW + 2
            or final["finish_reason"] != whole["finish_reason"]):
        raise AssertionError("the SSE stream differs from the reply")
    scores = a["echo"][0]["choices"][0]["logprobs"]["token_logprobs"]
    diff = max(abs(x - y) for x, y in zip(scores[1:], score_ref[1:]))
    if scores[0] is not None or len(scores) != len(p1) or diff > 1e-4:
        raise AssertionError(f"echo scores differ from score_prompt's by "
                             f"{diff}")
    if not (cancelled.cancelled and cancelled.finish_reason == "stop"
            and 4 <= len(cancelled.output_tokens) < HTTP_NEW):
        raise AssertionError(f"cancel: {cancelled.finish_reason}, "
                             f"{len(cancelled.output_tokens)} tokens")
    for name, (reply, _) in {**a, **b}.items():
        if name in ("sse", "completion", "echo"):
            continue
        out = reply["output_tokens"]
        if not out or not all(0 <= t < config.vocab_size for t in out):
            raise AssertionError(f"{name}: tokens {out}")
    extras = {k: g.replays for k, g in eng._graphs.items()
              if k[3] != TickExtras()}
    if not any(extras.values()):
        raise AssertionError(f"no graph with extras replayed: {extras}")
    dispatches = prefill_dispatches(eng)
    bucket = next(x for x in eng.prefill_buckets if x >= len(p1))
    expect = expected_launches("g128", config.num_hidden_layers, dispatches,
                               st["decode_steps"], scores=[(bucket, bucket)])
    for name, n in launches.items():
        if n != expect[name]:
            raise AssertionError(f"HTTP: {name}: {n} launches, expected "
                                 f"{expect[name]}")
    must = _G128_GEMMS + slot_kernels(eng.max_len)
    if any(launches[k] == 0 for k in must):
        raise AssertionError(f"HTTP: a kernel of the path never launched: "
                             f"{launches}")
    log(f"  over HTTP ({base}, Engine defaults, max_batch {MAX_BATCH}): 1 "
        f"greedy /generate alone (tokens equal to the direct run), then "
        f"{len(batch_a)} requests at once (penalties, logit_bias, "
        f"guided_choice, top_logprobs 3, seeded sampling, /v1/completions "
        f"SSE = non-streamed, echo scoring within {diff:.2e} of "
        f"score_prompt), then {len(batch_b)} (the seeded request again: the "
        f"same tokens), then one cancelled through the worker after "
        f"{len(cancelled.output_tokens)} tokens, in {wall:.3f} s")
    log(f"  client seconds per request: " + ", ".join(
        f"{n} {s:.3f}" for n, (_, s) in
        [("alone", alone["greedy"])] + list(a.items())
        + [(f"{n} (2nd batch)", v) for n, v in b.items()]))
    log(f"  engine: {st['prefill_dispatches']} prefill dispatches (M, T) = "
        f"{dispatches} in {st['prefill_s']:.3f} s, {st['decode_ticks']} "
        f"decode ticks in {st['decode_s']:.3f} s "
        f"({1e3 * st['decode_s'] / st['decode_ticks']:.3f} ms a tick), "
        f"{st['graph_replays']} replays of {len(eng._graphs)} graphs, "
        f"{st['graph_captures']} captures in {st['graph_capture_s']:.3f} s; "
        f"health {health['status']}")
    log(f"  graphs with extras (steps, branch, flag, extras) → replays: "
        + "; ".join(f"{k[0]}, {k[1]}, {k[2]}, {k[3]} → {n}"
                    for k, n in sorted(extras.items())))
    log(f"  TTFT / TPOT per finished request (s): " + ", ".join(
        f"{t:.4f} / " + ("-" if p is None else f"{p:.5f}")
        for t, p in eng._latency))
    log(f"  latency_summary: {json.dumps(eng.latency_summary())}; /stats "
        f"agrees: {stats['ttft_p50_s'] == eng.latency_summary()['ttft_p50_s']}")
    log(f"  launches over HTTP (as expected): {json.dumps(launches)}")
    # each graph's replay alone, after the traffic (the engine is done):
    # the plain greedy tick's against those with the extras' planes
    replay_ms = {}
    for key, graph in sorted(eng._graphs.items()):
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        replay_ms[key] = statistics.median(times)
    log("  one replay, CUDA-event median of 20 (ms): " + "; ".join(
        f"{k[1]} {k[3]} {ms:.4f}" for k, ms in replay_ms.items()))


# ---------------------------------------------------------------------------
# phase 6: chunked prefill in slot mode, the prefix caches, speculation

#: phase 6's chunk (6a, 6b), and its speculation (6d): 1-gram lookups, up
#: to 4 drafted tokens verified a tick.  Seeded random weights copy
#: nothing: their greedy tokens spread over the vocabulary (255 distinct
#: of 3a's 256) and flip when one prompt token 50 back changes, so no
#: 2-gram ever recurs (not on 3a's prompts, a repeated block, nor a
#: prompt holding its own continuation); a 1-gram lookup drafts whenever
#: a token recurs, which a prompt of many distinct tokens makes common
CHUNK6, SPEC_NGRAM, SPEC_K = 512, 1, 4
#: 6a's late prompt, 6c's shared system prompt and tails, and 6d's prompt
#: of distinct tokens (room left for 64 new ones and a verify's 1 + k)
LONG6, SYSTEM6, TAIL6, RICH6 = 1800, 512, 100, 1900


def drive(eng, reqs, scheme, label, later=(), eager=False, must_run=()):
    """Serve ``reqs`` through ``eng`` (``later`` submitted when the first
    of ``reqs`` delivers its first token): every kernel count set to 0
    just before the run and read just after, each equal to what the run's
    prefill dispatches, decode steps and verifies imply (the engine's
    counts before the run taken off) and those of ``must_run`` non-zero;
    every decode tick, verifies included, a graph replay but each graph's
    first (``eager``: none).  Returns the run's launches and the (request
    index, prefill chunks so far) of every delivered token and the run's
    decode tok/s."""
    everyone = list(reqs) + list(later)
    pending = list(later)
    events = []

    def hook(req, tok):
        events.append((next(i for i, r in enumerate(everyone) if r is req),
                       eng.stats["prefill_chunks"]))
        if pending and req is reqs[0]:
            for r in pending:
                eng.add_request(r)
            pending.clear()

    eng.on_token = hook
    eng._eager_tick = eager
    st = eng.stats
    before = dict(st)
    since = eng.dispatch_log[-1]["seq"] + 1 if eng.dispatch_log else 0
    fns = kernel_fns()
    for fn, _, _ in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    eng.run(list(reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, (fn, _, _) in fns.items()}
    d = {k: st[k] - before[k] for k in st}
    if pending or not all(r.done for r in everyone):
        raise AssertionError(f"{label}: a request did not finish")
    ticks, replays = d["decode_ticks"], d["graph_replays"]
    if eager and (replays or eng._graphs):
        raise AssertionError(f"{label}: the eager run replayed a graph")
    if not eager and (replays == 0
                      or replays + d["graph_captures"] != ticks):
        raise AssertionError(f"{label}: {ticks} decode ticks but {replays} "
                             f"replays and {d['graph_captures']} captures")
    dispatches = prefill_dispatches(eng, since)
    T = 1 + eng.spec_k
    expect = expected_launches(
        scheme, eng.config.num_hidden_layers, dispatches,
        d["decode_steps"], paged=eng.paged, max_len=eng.max_len,
        chunked=bool(eng.prefill_chunk) and not eng.paged,
        verifies=[(eng.max_batch * T, T)] * d["spec_ticks"])
    for name, n in launches.items():
        if n != expect[name]:
            raise AssertionError(f"{label}: {name}: {n} launches, expected "
                                 f"{expect[name]}")
        if n == 0 and name in must_run:
            raise AssertionError(f"{label}: {name} never launched")
    decode_tokens = d["generated_tokens"] - len(everyone)
    log(f"  {label}: {len(everyone)} requests in {wall:.3f} s: "
        f"{d['prefill_dispatches']} prefill dispatches (M, chunk or "
        f"bucket) = {dispatches} in {d['prefill_s']:.3f} s, "
        f"{d['prefill_chunks']} chunks; {ticks} decode ticks "
        f"({d['spec_ticks']} verifies, {d['decode_steps']} plain steps) in "
        f"{d['decode_s']:.3f} s, {replays} replays: "
        f"{1e3 * d['decode_s'] / ticks:.3f} ms per tick, "
        f"{decode_tokens / d['decode_s']:.1f} decode tok/s, "
        f"{ticks / decode_tokens:.3f} ticks per decode token"
        + (f"; {d['spec_drafted']} drafted, {d['spec_accepted']} accepted "
           f"({d['spec_accepted'] / max(d['spec_drafted'], 1):.3f})"
           if eng.spec_ngram else "")
        + (f"; {d['prefix_hits']} prefix hits, "
           f"{d['prefix_tokens_reused']} tokens reused"
           if eng.prefix_cache else "")
        + (f"; {d['preemptions']} preemptions" if eng.paged else ""))
    log(f"    TTFT per request (s): "
        + ", ".join(f"{r.ttft:.4f}" for r in everyone))
    log(f"    launches: {json.dumps({k: v for k, v in launches.items() if v})}")
    return launches, events, decode_tokens / d["decode_s"]


#: the near-tie rule: at the first position where a feature run's tokens
#: leave the reference run's, the feature's token must be one of the
#: reference's NEAR_TIE_TOP most likely there (0.8% of Llama-2's
#: vocabulary).  Random weights give flat distributions (top logprobs near
#: -6 against log(1/32000) = -10.4, the top eight within 0.6 nats) and,
#: over 32 layers of INT8 requantization, amplify a last-bit difference
#: (other GEMM routes; a verify's flash where decode takes the split
#: kernel) into logit moves of up to a nat: on the H100 the feature's
#: token ranked 2nd to 21st there, up to 0.91 nats below the top.  An
#: acceptance off by one or a stale block emits the token of another
#: context, which ranks anywhere in the vocabulary.
NEAR_TIE_TOP = 256


def near_tie(label, feature, reference):
    """The feature run's tokens against the reference run's (same traffic
    without the feature, its requests asking for their NEAR_TIE_TOP top
    logprobs): equal up to the first position that differs, and there the
    feature's token is one of the reference's NEAR_TIE_TOP.  The two runs'
    numerics differ legitimately, so nothing past that position is held.
    Logged: the reference's top-1/top-2 gap there, the feature token's
    rank and distance below the top, the largest difference of a chosen
    token's logprob between the runs before it, and the share of equal
    positions."""
    equal = total = 0
    notes = []
    for i, (f, r) in enumerate(zip(feature, reference)):
        a, b = f.output_tokens, r.output_tokens
        n = min(len(a), len(b))
        first = next((p for p in range(n) if a[p] != b[p]), None)
        drift = max((abs(x - y) for x, y in zip(f.token_logprobs[:first],
                                                r.token_logprobs)),
                    default=0.0)
        if first is None:
            if len(a) != len(b):
                raise AssertionError(f"{label}: request {i}: {len(a)} "
                                     f"tokens against {len(b)}")
            notes.append(f"{i}: equal (logprob drift {drift:.5f})")
        else:
            top = r.top_logprobs[first]
            ids = [t for t, _ in top]
            if a[first] not in ids:
                raise AssertionError(
                    f"{label}: request {i} differs at token {first}: "
                    f"{a[first]} (logprob {f.token_logprobs[first]:.5f} in "
                    f"the feature run) is not in the reference's top "
                    f"{NEAR_TIE_TOP}, {top[:4]} ...")
            k = ids.index(a[first])
            notes.append(f"{i}: first difference at {first}, top-2 gap "
                         f"{top[0][1] - top[1][1]:.5f}, the feature's token "
                         f"ranked {k + 1}, {top[0][1] - top[k][1]:.5f} "
                         f"below the top (logprob drift before it "
                         f"{drift:.5f})")
        equal += sum(x == y for x, y in zip(a, b))
        total += n
    log(f"  {label} against the reference: {equal}/{total} positions equal "
        f"({equal / total:.3f}); " + "; ".join(notes))


def _requests(prompts, n_top=0, **sp):
    from qqq_tpu_torch.serve.engine import Request
    from qqq_tpu_torch.serve.sampling import SamplingParams

    return [Request(p, SamplingParams(max_new_tokens=64, top_logprobs=n_top,
                                      **sp)) for p in prompts]


def phase6(dev, params, config, prompts):
    """6a-6d (see the module docstring) on 3a's g128 weights; each feature
    run against a reference run of the same traffic without the
    feature."""
    from qqq_tpu_torch.serve.engine import Engine

    g128_kernels = SCHEME_KERNELS["g128"]
    pool_kernels = ("paged_chunk_write_int8", "paged_flash_attention_int8")
    slot = dict(max_batch=MAX_BATCH, max_len=2048, device=dev)
    rng = np.random.default_rng(6)
    vocab = config.vocab_size

    log(f"phase 6a: chunked prefill in slot mode (chunk {CHUNK6}): 3a's "
        f"requests and a {LONG6}-token prompt that arrives once the first "
        "of them has its first token; max_batch 5 (3a's four fill 4)")
    long = [int(t) for t in rng.integers(0, vocab, LONG6)]
    kw6a = dict(slot, max_batch=MAX_BATCH + 1)
    eng = Engine(params, config, prefill_chunk=CHUNK6, prefill_batch=2,
                 **kw6a)
    feat, feat_late = _requests(prompts), _requests([long])
    _, events, _ = drive(eng, feat, "g128", "6a chunked", later=feat_late,
                      must_run=g128_kernels + pool_kernels)
    base = sum(-(-n // CHUNK6) for n in PROMPT_LENS)
    n_long = -(-LONG6 // CHUNK6)
    # rounds 1-2: slots (0, 1), (2, 3), then (2, 3) with the late prompt's
    # first chunk alone; then one dispatch per remaining chunk
    want = (base + n_long, 2 + 2 + n_long - 1)
    got = (eng.stats["prefill_chunks"], eng.stats["prefill_dispatches"])
    if got != want:
        raise AssertionError(f"6a: (chunks, dispatches) {got}, expected "
                             f"{want}")
    between = {c for i, c in events if i != len(prompts)}
    gaps = set(range(base + 1, base + n_long))
    if not gaps <= between:
        raise AssertionError(f"6a: no decode token delivered after the late "
                             f"prompt's chunks {sorted(gaps - between)}")
    log(f"  the decoding rows delivered tokens after each of the late "
        f"prompt's chunks 1..{n_long - 1} (chunk counts {sorted(gaps)})")
    del eng
    ref = Engine(params, config, prefill_buckets=BUCKETS, **kw6a)
    ref_reqs, ref_late = (_requests(prompts, NEAR_TIE_TOP),
                          _requests([long], NEAR_TIE_TOP))
    drive(ref, ref_reqs, "g128", "6a reference (whole-bucket prefill)",
          later=ref_late)
    near_tie("6a", feat + feat_late, ref_reqs + ref_late)
    del ref

    log(f"phase 6b: the slot prefix cache (chunk {CHUNK6}): turn 2 = turn "
        "1 + its reply + 100 new tokens")
    eng = Engine(params, config, prefill_chunk=CHUNK6, prefix_cache=True,
                 **slot)
    turn1 = _requests([prompts[-1]])
    drive(eng, turn1, "g128", "6b turn 1", must_run=pool_kernels)
    turn2 = (prompts[-1] + turn1[0].output_tokens
             + [int(t) for t in rng.integers(0, vocab, 100)])
    feat = _requests([turn2])
    drive(eng, feat, "g128", "6b turn 2, cached")
    kept = len(prompts[-1]) + len(turn1[0].output_tokens) - 1
    want = min(kept, len(turn2) - 1) // CHUNK6 * CHUNK6
    got = (eng.stats["prefix_hits"], eng.stats["prefix_tokens_reused"])
    if got != (1, want):
        raise AssertionError(f"6b: (hits, reused) {got}, expected "
                             f"(1, {want})")
    del eng
    # the same history without the cache: turn 1 (warm-up), then turn 2
    ref = Engine(params, config, prefill_chunk=CHUNK6, **slot)
    drive(ref, _requests([prompts[-1]]), "g128", "6b turn 1, no prefix cache")
    ref_reqs = _requests([turn2], NEAR_TIE_TOP)
    drive(ref, ref_reqs, "g128", "6b turn 2, no prefix cache")
    log(f"  turn 2 ({len(turn2)} tokens): 1 hit, {want} tokens reused; TTFT "
        f"{feat[0].ttft:.4f} s with the cache, {ref_reqs[0].ttft:.4f} s "
        "without")
    near_tie("6b", feat, ref_reqs)
    del ref

    log(f"phase 6c: the paged prefix cache (block_size {BS}): a "
        f"{SYSTEM6}-token system prompt shared by 4 requests with "
        f"{TAIL6}-token tails; 3 arrive after the first one's first token")
    system = [int(t) for t in rng.integers(0, vocab, SYSTEM6)]

    def shared(sys_prompt, n_top=0):
        reqs = _requests([sys_prompt + [int(t) for t in
                                        rng.integers(0, vocab, TAIL6)]
                          for _ in range(4)], n_top)
        return reqs[:1], reqs[1:]

    def whole(e, what):
        alloc, lru = e.allocators[0].available, len(e._bh_lru[0])
        if alloc + lru != e.num_blocks - 1:
            raise AssertionError(f"6c {what}: {alloc} free + {lru} cached "
                                 f"blocks, expected {e.num_blocks - 1}")
        return f"{alloc} free + {lru} cached = {e.num_blocks - 1}"

    paged = dict(slot, paged=True, block_size=BS)
    eng = Engine(params, config, prefix_cache=True, **paged)
    first, rest = shared(system)
    drive(eng, first, "g128", "6c cached", later=rest,
          must_run=g128_kernels + PAGED_KERNELS)
    blocks = SYSTEM6 // BS
    got = (eng.stats["prefix_hits"], eng.stats["prefix_tokens_reused"])
    if got != (3, 3 * blocks * BS):
        raise AssertionError(f"6c: (hits, reused) {got}, expected "
                             f"(3, {3 * blocks * BS}): {blocks} blocks each")
    log(f"  3 hits, {blocks} blocks adopted each; pool {whole(eng, 'run')}")
    del eng
    ref = Engine(params, config, **paged)
    ref_first = _requests([r.prompt_tokens for r in first], NEAR_TIE_TOP)
    ref_rest = _requests([r.prompt_tokens for r in rest], NEAR_TIE_TOP)
    drive(ref, ref_first, "g128", "6c reference (no prefix cache)",
          later=ref_rest)
    near_tie("6c", first + rest, ref_first + ref_rest)
    del ref
    # 13 usable: wave 1 holds at most 4 shared + 4 x 2 own blocks, then
    # caches 8 of them (the shared 4 and each request's fifth), so the 5
    # left free cannot hold wave 2, a new system prompt, without evicting
    tight = 14
    eng = Engine(params, config, prefix_cache=True, num_blocks=tight,
                 **paged)
    evicted = [0]
    evict = eng._evict_cached_blocks

    def counting(d, need):
        n = len(eng._bh_lru[d])
        evict(d, need)
        evicted[0] += n - len(eng._bh_lru[d])

    eng._evict_cached_blocks = counting
    for wave in (1, 2):
        first, rest = shared(system if wave == 1 else
                             [int(t) for t in rng.integers(0, vocab,
                                                           SYSTEM6)])
        drive(eng, first, "g128", f"6c over {tight} blocks, wave {wave}",
              later=rest)
        log(f"    pool {whole(eng, f'wave {wave}')}; {evicted[0]} cached "
            "blocks evicted so far")
    if not evicted[0]:
        raise AssertionError("6c: the tight pool evicted no cached block")
    del eng

    log(f"phase 6d: prompt-lookup speculation (spec_ngram {SPEC_NGRAM}, "
        f"spec_k {SPEC_K}): a prompt of {RICH6} distinct tokens, 3a's "
        "requests, a 64-token block repeated 4 times and a seeded sampled "
        "request (temperature 0.8)")
    block = [int(t) for t in rng.integers(0, vocab, 64)]
    traffic = ([[int(t) for t in rng.permutation(vocab)[:RICH6]]] + prompts
               + [block * 4, [int(t) for t in rng.integers(0, vocab, 200)]])

    def spec_reqs(n_top=0):
        return _requests(traffic[:-1], n_top) + _requests(
            traffic[-1:], n_top, temperature=0.8, seed=1234)

    greedy = len(traffic) - 1
    for mode, kw in (("slot", dict(slot, prefill_buckets=BUCKETS)),
                     ("paged", paged)):
        must = g128_kernels + pool_kernels + (
            PAGED_KERNELS if mode == "paged" else slot_kernels(2048))
        spec = dict(spec_ngram=SPEC_NGRAM, spec_k=SPEC_K)
        eng = Engine(params, config, **kw, **spec)
        feat = spec_reqs()
        _, _, on = drive(eng, feat, "g128", f"6d {mode}, captured verify",
                         must_run=must)
        st = eng.stats
        spec_keys = [k for k in eng._graphs if k[0] == "spec"]
        if not (st["spec_drafted"] > 0
                and sum(eng._graphs[k].replays for k in spec_keys) > 0):
            raise AssertionError(f"6d {mode}: no draft verified by a replay "
                                 f"({st['spec_drafted']} drafted, graphs "
                                 f"{sorted(map(str, eng._graphs))})")
        # one replay of a verify graph against the plain tick's of the same
        # sampling branch and extras
        pairs = [(k, (1,) + k[2:]) for k in spec_keys
                 if (1,) + k[2:] in eng._graphs]
        if not pairs:
            raise AssertionError(f"6d {mode}: no plain tick beside a verify "
                                 "of the same sampling key: "
                                 f"{sorted(map(str, eng._graphs))}")
        timed = {}
        for name, key in zip(("verify", "plain"), pairs[0]):
            graph = eng._graphs[key]
            graph.replay()
            torch.cuda.synchronize()
            times = []
            for _ in range(20):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                graph.replay()
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            timed[name] = statistics.median(times)
        log(f"  6d {mode}: one replay, CUDA-event median of 20 "
            f"({pairs[0][0][2]}, {pairs[0][0][4]}): verify (B {MAX_BATCH}, "
            f"T {1 + SPEC_K}) {timed['verify']:.4f} ms, plain tick "
            f"{timed['plain']:.4f} ms "
            f"({timed['verify'] / timed['plain']:.3f}x)")
        del eng
        eng = Engine(params, config, **kw, **spec)
        eager = spec_reqs()
        drive(eng, eager, "g128", f"6d {mode}, eager ticks", eager=True)
        if [r.output_tokens for r in eager] != \
                [r.output_tokens for r in feat]:
            raise AssertionError(f"6d {mode}: the captured verify's tokens "
                                 "differ from the eager verify's")
        log(f"  6d {mode}: tokens equal to the eager run's")
        del eng
        ref = Engine(params, config, **kw)
        _, _, off = drive(ref, spec_reqs(), "g128",
                          f"6d {mode}, no speculation")
        log(f"  6d {mode}: decode {on:.1f} tok/s with speculation, {off:.1f} "
            f"without ({on / off:.3f}x)")
        ref_reqs = spec_reqs(NEAR_TIE_TOP)
        drive(ref, ref_reqs, "g128", f"6d {mode} reference (no speculation, "
              f"top {NEAR_TIE_TOP} logprobs)")
        near_tie(f"6d {mode}", feat[:greedy], ref_reqs[:greedy])
        same = sum(a == b for a, b in zip(feat[-1].output_tokens,
                                          ref_reqs[-1].output_tokens))
        log(f"  6d {mode}: the seeded row's tokens equal at {same}/64 "
            "positions with speculation off (not asserted: the verify's "
            "flash and the decode kernel give other logits)")
        del ref
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: QQQ calibration on the card

#: calibration samples of 7a and 7b, each CALIB_SEQLEN tokens (the reference
#: calibrates on 128: the cut is for time)
CALIB_NSAMPLES, CALIB_SEQLEN = 16, 2048
#: the depth of 7a's HF checkpoint (full width)
CLI_LAYERS = 2
#: where phase 7 writes its HF directory and checkpoints (inside the
#: checkout, git-ignored); removed at the end of the run
CALIB_DIR = HERE / "build" / "chip_smoke_calib"
#: GPTQ on the card against the CPU, tests/test_torch_calib.py's rule: under
#: GPTQ_SHARE of the dequantized entries differ at (rtol, atol)
GPTQ_SHARE, GPTQ_RTOL, GPTQ_ATOL = 0.02, 1e-4, 1e-5
#: rotation keeps the function: max |rotated − plain| ≤ ROTATION_TOL ·
#: max |plain| of the f32 logits (JAX's own bound, tests/test_rotation.py)
ROTATION_TOL = 2e-3
#: held-out prompt of 7b's logit comparisons (the loader's test split)
HELD_OUT = 256


def dense_llama2(dev, n_layers, seed):
    """Seeded random dense bf16 Llama-2-7B params, ``n_layers`` deep, with
    norms drawn in [0.5, 1.5) so that the rotation's folds carry them."""
    from qqq_tpu_torch.models import ModelConfig, init_params

    config = ModelConfig(vocab_size=V, hidden_size=H, intermediate_size=I,
                         num_hidden_layers=n_layers, num_attention_heads=NH,
                         num_key_value_heads=NKV)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(config, gen, dtype=torch.bfloat16, device=dev)

    def norm():
        return (0.5 + torch.rand(H, generator=gen, device=dev)).to(
            torch.bfloat16)

    for layer in params["layers"]:
        layer["input_layernorm"] = norm()
        layer["post_attention_layernorm"] = norm()
    params["norm"] = norm()
    return params, config


def quantize_cli(hf_dir, out, *flags):
    """``python -m qqq_tpu_torch.cli.quantize`` on the card, in a process
    of its own; returns its wall time."""
    cmd = [sys.executable, "-m", "qqq_tpu_torch.cli.quantize",
           "--model_path", str(hf_dir), "--save_path", str(out),
           "--calib_dataset", "synthetic", "--nsamples", str(CALIB_NSAMPLES),
           "--max_length", str(CALIB_SEQLEN), *flags]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       timeout=900)
    wall = time.perf_counter() - t0
    if r.returncode:
        log(r.stdout[-4000:] + r.stderr[-8000:])
        raise AssertionError(f"quantize {' '.join(flags)} exited with "
                             f"{r.returncode}")
    notes = [m.group(0) for m in re.finditer(
        r"layer \d+ quantized in [\d.]+s|total [\d.]+s|re-packed .* in "
        r"[\d.]+s|loaded \S+ in [\d.]+s", r.stderr)]
    log(f"  cli/quantize {' '.join(flags)}: {wall:.1f} s wall "
        f"({'; '.join(notes)})")
    return wall


def _same_file(a, b, name="model.safetensors"):
    import filecmp

    return filecmp.cmp(a / name, b / name, shallow=False)


def greedy_tokens(dev, params, config, prompts, new=8):
    """A few greedy tokens of each prompt through the default Engine."""
    from qqq_tpu_torch.serve.engine import Engine, Request
    from qqq_tpu_torch.serve.sampling import SamplingParams

    eng = Engine(params, config, max_batch=len(prompts), max_len=2048,
                 prefill_buckets=BUCKETS, device=dev)
    reqs = [Request(prompt_tokens=p,
                    sampling=SamplingParams(max_new_tokens=new))
            for p in prompts]
    eng.run(reqs)
    toks = [r.output_tokens for r in reqs]
    if not all(len(t) == new and all(0 <= x < config.vocab_size for x in t)
               for t in toks):
        raise AssertionError(f"greedy decode returned {toks}")
    return toks


def phase7a(dev, prompts):
    """The CLI at full width, CLI_LAYERS deep: the reference's canonical
    recipes, each pack-only rerun bit-identical, the Marlin format, and the
    GPTQ-only recipe with --offload bit-identical to the resident run; every
    checkpoint loaded with load_any and decoded through the Engine."""
    from qqq_tpu_torch.cli.eval import load_any
    from qqq_tpu_torch.models.loader import save_hf_model

    from qqq_tpu_torch.models import forward
    from qqq_tpu_torch.utils.data import get_loaders

    shutil.rmtree(CALIB_DIR, ignore_errors=True)
    hf = CALIB_DIR / "llama2_7b_hf"
    params, config = dense_llama2(dev, CLI_LAYERS, seed=1)
    held = torch.from_numpy(get_loaders(
        "synthetic", nsamples=1, seed=0, seqlen=CALIB_SEQLEN,
        vocab_size=V)[1][:HELD_OUT]).to(dev, torch.int64)[None]
    dense_logits, _ = forward(params, config, held)
    t0 = time.perf_counter()
    save_hf_model(str(hf), params, config)
    del params
    torch.cuda.empty_cache()
    log(f"  a seeded random bf16 HF directory (Llama-2-7B width, "
        f"{CLI_LAYERS} layers: depth cut for time) written in "
        f"{time.perf_counter() - t0:.1f} s")
    walls = {}
    rot, smooth, plain = (CALIB_DIR / n for n in ("rotate", "smooth",
                                                  "gptq"))
    rotate = ("--rotate", "hadamard", "--w_group_size", "128", "--gptq_mse",
              "true")
    smoothing = ("--smooth_method", "os+", "--w_group_size", "-1")
    walls["rotate"] = quantize_cli(hf, rot, *rotate)
    walls["rotate pack_only"] = quantize_cli(
        hf, CALIB_DIR / "rotate_repack", *rotate, "--pack_only",
        "--quantizers_path", f"{rot}_quantizers.npz")
    if not _same_file(rot, CALIB_DIR / "rotate_repack"):
        raise AssertionError("7a: --pack_only differs from the rotation "
                             "recipe's checkpoint")
    walls["marlin"] = quantize_cli(
        hf, CALIB_DIR / "rotate_marlin", *rotate, "--pack_only",
        "--save_format", "marlin", "--quantizers_path",
        f"{rot}_quantizers.npz")
    walls["smooth"] = quantize_cli(hf, smooth, *smoothing)
    shutil.copy(f"{smooth}_scale_list.npz",
                f"{CALIB_DIR / 'smooth_repack'}_scale_list.npz")
    walls["smooth pack_only"] = quantize_cli(
        hf, CALIB_DIR / "smooth_repack", *smoothing, "--pack_only",
        "--quantizers_path", f"{smooth}_quantizers.npz")
    if not _same_file(smooth, CALIB_DIR / "smooth_repack"):
        raise AssertionError("7a: --pack_only differs from the smoothing "
                             "recipe's checkpoint")
    walls["gptq"] = quantize_cli(hf, plain, "--w_group_size", "128")
    walls["gptq offload"] = quantize_cli(
        hf, CALIB_DIR / "gptq_offload", "--w_group_size", "128",
        "--offload", "true")
    if not _same_file(plain, CALIB_DIR / "gptq_offload"):
        raise AssertionError("7a: --offload differs from the resident run")
    log("  --pack_only reruns bit-identical (rotation, smoothing), "
        "--offload bit-identical to the resident run")
    for name in ("rotate", "rotate_marlin", "smooth", "gptq"):
        loaded, cfg = load_any(str(CALIB_DIR / name), torch.bfloat16,
                               device=dev)
        toks = greedy_tokens(dev, loaded, cfg, prompts)
        logits, _ = forward(loaded, cfg, held)
        log(f"  {name}: loaded with load_any; final logits on a held-out "
            f"synthetic prompt of {HELD_OUT} tokens at relative RMS "
            f"{_rel_rms(logits, dense_logits):.4f} of the dense model's; "
            f"greedy tokens {json.dumps([t[:4] for t in toks])}...")
        del loaded
        torch.cuda.empty_cache()
    log(f"  cli/quantize wall times (s): {json.dumps({k: round(v, 1) for k, v in walls.items()})}")
    shutil.rmtree(CALIB_DIR)


def weighted_errors(layer, names, H, results, spec, percdamp=0.01):
    """½ tr((W − Q)ᵀ H_d (W − Q)), H_d = H damped as GPTQ damps it (the
    quantity GPTQ's loss accumulates for its own Q), of the linears
    ``names`` concatenated: (round-to-nearest Q on GPTQ's own scales and
    zeros (the MSE grid, bf16 scales), GPTQ's Q)."""
    from qqq_tpu_torch.core.quant import (
        dequantize_weight_int, quantize_weight_int,
    )

    def cat(key):
        return torch.cat([getattr(results[n], key) for n in names], dim=1)

    W = torch.cat([layer[n]["w"].to(torch.float32) for n in names], dim=1)
    dead = torch.diagonal(H) == 0
    Hd = H + torch.diag(dead.to(H.dtype))
    W[dead] = 0.0
    Hd = Hd + torch.eye(H.shape[0], device=H.device) * (
        percdamp * torch.mean(torch.diagonal(Hd)))
    s, z = cat("scale"), cat("zero")
    rtn = dequantize_weight_int(quantize_weight_int(W, s, z, spec), s, spec)

    def err(Q):
        D = W - Q
        return 0.5 * float((D * (Hd @ D)).sum())

    return err(rtn), err(cat("w_deq"))


class _EagerBlocks:
    """Stands in for ``calib/gptq.py:_BlockRunner`` to run every block's
    row loop eagerly on the card (a comparison only)."""

    def __init__(self, blocksize, N, maxq, sym_pc, device):
        self.args = (maxq, sym_pc)
        self.Err = torch.empty((blocksize, N), dtype=torch.float32,
                               device=device)

    def __call__(self, Wb, Hb, sb, zb):
        from qqq_tpu_torch.calib import gptq

        gptq._block_step(Wb, Hb, sb, zb, self.Err, *self.args)
        return self.Err


def gptq_card_vs_cpu(label, W, H):
    """gptq_quantize_matrix on the card and on the CPU from the same W and
    card-captured H, g128 without the MSE grid (scale and zero must then be
    bit-equal), act-order, bf16 scales.  On the card also with every
    block's row loop eager instead of replayed: bit-equal, and timed."""
    from qqq_tpu_torch.calib import gptq
    from qqq_tpu_torch.core.quant import QuantSpec

    spec = QuantSpec(bits=4, group_size=128)
    kw = dict(actorder=True, scale_store_dtype=torch.bfloat16)

    def on_card():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = gptq.gptq_quantize_matrix(W, H, spec, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    card, card_s = on_card()
    runner, gptq._BlockRunner = gptq._BlockRunner, _EagerBlocks
    try:
        eager, eager_s = on_card()
    finally:
        gptq._BlockRunner = runner
    if not (torch.equal(eager.q4, card.q4)
            and torch.equal(eager.w_deq, card.w_deq)):
        raise AssertionError(f"GPTQ {label}: the replayed row loops differ "
                             "from the eager ones")
    log(f"  GPTQ {label}: {card_s:.3f} s on the card with each block's row "
        f"loop a graph replay, {eager_s:.3f} s eager (bit-equal)")
    t0 = time.perf_counter()
    cpu = gptq.gptq_quantize_matrix(W.cpu(), H.cpu(), spec, **kw)
    cpu_s = time.perf_counter() - t0
    differ = float((~torch.isclose(card.w_deq.cpu(), cpu.w_deq,
                                   rtol=GPTQ_RTOL, atol=GPTQ_ATOL))
                   .float().mean())
    flips = float((card.q4.cpu() != cpu.q4).float().mean())
    rel = abs(float(card.loss) / float(cpu.loss) - 1)
    log(f"  GPTQ {label} {tuple(W.shape)}: card {card_s:.2f} s, CPU "
        f"{cpu_s:.2f} s; {differ:.4%} of the dequantized entries differ "
        f"(bound {GPTQ_SHARE:.0%}), {flips:.4%} of the codes, loss "
        f"{float(card.loss):.6g} vs {float(cpu.loss):.6g} ({rel:.2e} "
        f"relative)")
    if differ >= GPTQ_SHARE:
        raise AssertionError(f"GPTQ {label}: {differ:.4%} of the entries "
                             "differ between the card and the CPU")
    if not (torch.equal(card.scale.cpu(), cpu.scale)
            and torch.equal(card.zero.cpu(), cpu.zero)):
        raise AssertionError(f"GPTQ {label}: scale or zero differ")
    if rel >= (5e-3 if flips else 1e-3):
        raise AssertionError(f"GPTQ {label}: the losses differ by {rel:.2e}")


def rotation_invariance(dev, params, config, prompt):
    """A 2-layer cut of the dense model in f32, rotated: its logits must
    equal the unrotated cut's within ROTATION_TOL · max |logits|."""
    from qqq_tpu_torch.calib.rotation import fuse_layer_norms, rotate_model
    from qqq_tpu_torch.models import forward

    cfg2 = dataclasses.replace(config, num_hidden_layers=2)
    cut = _tree_map(lambda t: t.to(torch.float32),
                    {**params, "layers": params["layers"][:2]})
    base, _ = forward(cut, cfg2, prompt)
    rotated, _ = rotate_model(fuse_layer_norms(cut, cfg2), cfg2,
                              mode="hadamard", seed=0)
    rot, _ = forward(rotated, cfg2, prompt)
    err = float((rot - base).abs().max())
    scale = float(base.abs().max())
    log(f"  rotation keeps the function (2-layer f32 cut, {prompt.shape[1]} "
        f"tokens): max |rotated − plain| = {err:.3e} = {err / scale:.2e} of "
        f"max |logits| (bound {ROTATION_TOL:.0e}), relative RMS "
        f"{_rel_rms(rot, base):.3e}")
    if err > ROTATION_TOL * scale:
        raise AssertionError("rotation changed the 2-layer cut's logits")


def phase7b(dev):
    """The library at full width and depth: fuse_layer_norms →
    rotate_model("hadamard") → apply_gptq (g128, MSE grid, act-order) on
    CALIB_NSAMPLES synthetic samples, then the packed result served."""
    from qqq_tpu_torch.calib.pipeline import GPTQ_GROUPS, apply_gptq
    from qqq_tpu_torch.calib.rotation import fuse_layer_norms, rotate_model
    from qqq_tpu_torch.core.quant import QuantSpec
    from qqq_tpu_torch.models import forward, quantize_params_rtn
    from qqq_tpu_torch.utils.data import get_loaders

    params, config = dense_llama2(dev, L, seed=2)
    calib, test = get_loaders("synthetic", nsamples=CALIB_NSAMPLES, seed=0,
                              seqlen=CALIB_SEQLEN, vocab_size=V)
    held = torch.from_numpy(test[:HELD_OUT]).to(dev, torch.int64)[None]
    rotation_invariance(dev, params, config, held[:, :128])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t_run = time.perf_counter()
    params, _ = rotate_model(fuse_layer_norms(params, config), config,
                             mode="hadamard", seed=0)
    torch.cuda.synchronize()
    rot_s = time.perf_counter() - t_run
    dense_logits, _ = forward(params, config, held)
    spec = QuantSpec(bits=4, group_size=128, mse=True)
    rtn_err, gptq_err, hess0 = [], [], {}

    def hook(li, layer, Hs, results):
        errs = [weighted_errors(layer, names, Hs[key], results, spec)
                for names, key in GPTQ_GROUPS]
        rtn_err.append(sum(e[0] for e in errs))
        gptq_err.append(sum(e[1] for e in errs))
        if li == 0:
            hess0.update(gup=Hs["gup"].clone(), down=Hs["down"].clone())

    timings = {}
    t0 = time.perf_counter()
    packed, stats = apply_gptq(params, config, calib, spec, device=dev,
                               timings=timings, layer_hook=hook)
    torch.cuda.synchronize()
    gptq_s = time.perf_counter() - t0
    total_s = time.perf_counter() - t_run
    peak = torch.cuda.max_memory_allocated()
    log(f"  calibrated {L} layers on {CALIB_NSAMPLES} synthetic samples of "
        f"{CALIB_SEQLEN} tokens (the reference's default is 128 samples: "
        f"cut for time): rotation {rot_s:.2f} s, apply_gptq {gptq_s:.1f} s, "
        f"the whole run {total_s:.1f} s; per layer (s) Hessians "
        f"{json.dumps([round(t, 3) for t in timings['hessian']])}, GPTQ "
        f"{json.dumps([round(t, 3) for t in timings['gptq']])}, replay "
        f"{json.dumps([round(t, 3) for t in timings['replay']])}; sums "
        f"{sum(timings['hessian']):.1f} / {sum(timings['gptq']):.1f} / "
        f"{sum(timings['replay']):.1f} s; torch.cuda.max_memory_allocated "
        f"{peak / 2**30:.2f} GiB ({held_before / 2**30:.2f} GiB allocated "
        f"when the run began: the dense model and what earlier phases "
        f"hold)")
    gptq_loss = [sum(d.values()) for d in stats["layer_losses"]]
    ratios = [g / r for g, r in zip(gptq_loss, rtn_err)]
    own = max(abs(e / g - 1) for e, g in zip(gptq_err, gptq_loss))
    log(f"  GPTQ loss / RTN's Hessian-weighted error (RTN on GPTQ's own "
        f"scales) per layer: {json.dumps([round(x, 4) for x in ratios])}; "
        f"GPTQ's loss against its own Hessian-weighted error: at most "
        f"{own:.2e} apart")
    if len(ratios) != L or not all(x < 1 for x in ratios):
        raise AssertionError("GPTQ did not beat RTN in every layer")
    rtn = quantize_params_rtn(params, config, 128)
    g_logits, _ = forward(packed, config, held)
    r_logits, _ = forward(rtn, config, held)
    del rtn
    log(f"  final logits on a held-out synthetic prompt of {HELD_OUT} "
        f"tokens, relative RMS against the dense (rotated) model: GPTQ "
        f"{_rel_rms(g_logits, dense_logits):.4f}, RTN "
        f"{_rel_rms(r_logits, dense_logits):.4f}")
    gptq_card_vs_cpu("gate_proj of layer 0", params["layers"][0]["gate_proj"]
                     ["w"], hess0["gup"])
    gptq_card_vs_cpu("down_proj of layer 0", params["layers"][0]["down_proj"]
                     ["w"], hess0["down"])
    del params, hess0
    torch.cuda.empty_cache()
    log("  the calibrated checkpoint served: 3a's requests through the "
        "Engine's defaults")
    serve(dev, packed, config, "g128")


def check_seeded_noise(dev):
    """A seeded request's noise is JAX's stream (serve/sampling.py:
    threefry2x32, fold_in, the partitionable bits) in int64 torch ops: on
    the card its bits and uniforms equal the CPU's bit for bit and its
    Gumbel noise lies within 2 ulps of max(|g|, 1) of the CPU's (each of its
    two logs may round the other way), at Llama-2's and Llama-3's
    vocabularies; one (4, 32000) draw is timed (CUDA-event median of 20)."""
    from qqq_tpu_torch.serve import sampling as S

    seeds = torch.tensor([0, 1, 1234, 0x7FFFFFFF], dtype=torch.int32)
    ngen = torch.tensor([0, 5, 63, 100000], dtype=torch.int32)
    on = (seeds.to(dev), ngen.to(dev))
    worst = 0.0
    for vocab in (V, LLAMA31_8B["vocab_size"]):
        if not torch.equal(S.seeded_bits(*on, vocab).cpu(),
                           S.seeded_bits(seeds, ngen, vocab)):
            raise AssertionError(f"seeded bits at V={vocab}: the card's "
                                 "differ from the CPU's")
        if not torch.equal(
                S.seeded_uniform(*on, vocab).cpu().view(torch.int32),
                S.seeded_uniform(seeds, ngen, vocab).view(torch.int32)):
            raise AssertionError(f"seeded uniforms at V={vocab}: the card's "
                                 "differ from the CPU's")
        g = S.seeded_gumbel(*on, vocab).cpu()
        ref = S.seeded_gumbel(seeds, ngen, vocab)
        scale = torch.clamp_min(ref.abs(), 1.0)
        ulp = torch.nextafter(scale, torch.full_like(scale, 2.0 ** 60)) - scale
        worst = max(worst, float(((g - ref).abs() / ulp).max()))
    if worst > 2:
        raise AssertionError(f"seeded Gumbel noise: card vs CPU {worst} ulps")
    times = []
    S.seeded_gumbel(*on, V)
    for _ in range(20):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        S.seeded_gumbel(*on, V)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    log(f"  seeded noise (JAX's threefry stream): bits and uniforms equal "
        f"to the CPU's at V = {V} and {LLAMA31_8B['vocab_size']}, Gumbel "
        f"noise within {worst:.3g} ulps of max(|g|, 1); one (4, {V}) draw "
        f"{statistics.median(times):.4f} ms (eager, wrapper included)")


# ---------------------------------------------------------------------------
# phase 8: evaluation (cli/eval, utils/eval) on the card

#: cli/eval's windows: seqlen and count (the reference's WikiText2 window)
PPL_SEQLEN, PPL_WINDOWS = 2048, 4
#: the 2-layer cut's window, card against CPU (M = 512: the requant route)
CUT_SEQLEN = 512
#: loglikelihood_batch against per-pair loglikelihood on the card: the
#: same kernels at the same (8, bucket) shapes, each pair's row at another
#: position of the batch
LL_BATCH_TOL = 1e-3


def phase8(dev, params, config):
    """Evaluation on the card, on phase 5's saved checkpoint of 3a's
    weights (``params``, still resident):

    (a) ``python -m qqq_tpu_torch.cli.eval`` (its ``main``, in this process
        so that the kernel counts can be read: set to 0 just before, read
        just after) with ``--eval_ppl --allow_synthetic --max_windows 4``
        at seqlen 2048, on the synthetic corpus (named outright, so no
        loader tries a download): ppl, mean NLL per token, seconds per
        window, tokens/s; every W4A8 linear of a window (q, k, v, o, gate,
        up, down: the checkpoint's layers unfused, as JAX's eval runs them)
        is one launch of the requant GEMM (#3) at M = 2048, and no other
        kernel runs (the cache-free forward attends in PyTorch ops, as
        JAX's does);
    (b) the same windows through ``utils/eval.perplexity`` on the resident
        params (equal to the CLI's), then through the dense bf16 weights of
        the same seed (``torch.matmul``): the quantization gap;
    (c) a 2-layer cut's logits over one 512-token window, the cache-free
        forward that the eval runs, on the card (kernels) and on the CPU
        (plain versions): relative RMS within ``CARD_VS_CPU_TOL``, phase
        4's bound and reasoning (a fault in a kernel moves the logits by
        O(100 %)); the mean NLLs beside it, logged;
    (d) ``loglikelihood_batch`` (buckets of 64, 128 and 256, 8 rows each: M
        = 512 to 2048) against ``loglikelihood`` pair by pair, full depth,
        within ``LL_BATCH_TOL``, greedy flags equal."""
    from qqq_tpu_torch.cli import eval as ecli
    import torch.nn.functional as F

    from qqq_tpu_torch.models import forward, init_params
    from qqq_tpu_torch.utils.data import get_loaders
    from qqq_tpu_torch.utils.eval import (
        loglikelihood, loglikelihood_batch, perplexity,
    )

    argv = ["--model_path", str(CKPT_G128), "--eval_ppl", "--allow_synthetic",
            "--ppl_dataset", "synthetic", "--max_windows", str(PPL_WINDOWS),
            "--max_length", str(PPL_SEQLEN)]
    log(f"phase 8a: python -m qqq_tpu_torch.cli.eval {' '.join(argv)}")
    fns = kernel_fns()
    for fn, _, _ in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = ecli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, (fn, _, _) in fns.items()}
    n = res["synthetic_windows"]
    expect = dict.fromkeys(launches, 0)
    expect["w4a8_gemm_requant"] = 7 * config.num_hidden_layers * n
    if n != PPL_WINDOWS or launches != expect:
        raise AssertionError(f"cli/eval: {n} windows, launches {launches}, "
                             f"expected {expect}")
    ppl = res["synthetic_ppl"]
    if not (math.isfinite(ppl) and ppl > 1):
        raise AssertionError(f"cli/eval: perplexity {ppl}")
    log(f"  ppl {ppl}, mean NLL {res['synthetic_nll_per_token']:.5f} a "
        f"token, {res['synthetic_seconds_per_window']:.4f} s a window, "
        f"{res['synthetic_tokens_per_s']:.1f} tokens/s ({n} windows of "
        f"{PPL_SEQLEN}; the whole command {wall:.1f} s with the checkpoint "
        f"load); launches: w4a8_gemm_requant {launches['w4a8_gemm_requant']}"
        f" = 7 linears x {config.num_hidden_layers} layers x {n} windows at "
        f"M = {PPL_SEQLEN}, every other kernel 0")

    _, tokens = get_loaders("synthetic", seqlen=PPL_SEQLEN, vocab_size=V)
    t0 = time.perf_counter()
    q_ppl = perplexity(params, config, tokens, seqlen=PPL_SEQLEN,
                       max_windows=PPL_WINDOWS)
    q_s = time.perf_counter() - t0
    # the CLI rounds to 4 decimals; the weights it loaded are these, bit
    # for bit (phase 5)
    if not abs(q_ppl - ppl) <= 1e-4 + 1e-6 * ppl:
        raise AssertionError(f"utils/eval on the resident weights: ppl "
                             f"{q_ppl}, the CLI's {ppl}")
    dense = init_params(config, torch.Generator(device=dev).manual_seed(0),
                        dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    d_ppl = perplexity(dense, config, tokens, seqlen=PPL_SEQLEN,
                       max_windows=PPL_WINDOWS)
    d_s = time.perf_counter() - t0
    del dense
    torch.cuda.empty_cache()
    log(f"phase 8b: the same {PPL_WINDOWS} windows, W4A8 g128 (utils/eval, "
        f"the resident weights: equal to the CLI's) ppl {q_ppl:.4f} (NLL "
        f"{math.log(q_ppl):.5f}, {q_s / PPL_WINDOWS:.4f} s a window) against "
        f"dense bf16 of the same seed ppl {d_ppl:.4f} (NLL "
        f"{math.log(d_ppl):.5f}, {d_s / PPL_WINDOWS:.4f} s a window): "
        f"quantization gap {math.log(q_ppl) - math.log(d_ppl):+.5f} nats a "
        f"token")

    cfg2 = dataclasses.replace(config, num_hidden_layers=2)
    cut = {**params, "layers": params["layers"][:2]}
    cpu = _tree_map(lambda t: t.cpu(), cut)
    window = torch.from_numpy(tokens[None, :CUT_SEQLEN].astype(np.int32))
    sides = {}
    for side, p in (("card", cut), ("CPU", cpu)):
        t0 = time.perf_counter()
        lg = forward(p, cfg2, window.to(p["embed"].device))[0][0].float()
        nll = float(F.cross_entropy(
            lg[:-1], window[0, 1:].to(lg.device, torch.int64)))
        sides[side] = (lg.cpu(), nll, time.perf_counter() - t0)
        del lg
    rel = _rel_rms(sides["card"][0], sides["CPU"][0])
    log(f"phase 8c: 2-layer cut, one {CUT_SEQLEN}-token window: logits card "
        f"vs CPU {rel:.3%} RMS (bound {CARD_VS_CPU_TOL:.0%}); mean NLL card "
        f"{sides['card'][1]:.5f} ({sides['card'][2]:.3f} s) vs CPU "
        f"{sides['CPU'][1]:.5f} ({sides['CPU'][2]:.3f} s), "
        f"{abs(sides['card'][1] - sides['CPU'][1]) / sides['CPU'][1]:.3%} "
        "apart")
    if not rel <= CARD_VS_CPU_TOL:
        raise AssertionError(f"8c: card vs CPU logits {rel:.3%} RMS apart")
    del cpu

    rng = np.random.default_rng(8)
    pairs = [([int(t) for t in rng.integers(0, V, c)],
              [int(t) for t in rng.integers(0, V, k)])
             for c, k in ((20, 3), (50, 1), (60, 4), (100, 5), (180, 2),
                          (240, 8))]
    t0 = time.perf_counter()
    batched = loglikelihood_batch(params, config, pairs)
    t_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = [loglikelihood(params, config, c, t) for c, t in pairs]
    t_s = time.perf_counter() - t0
    worst = max(abs(a[0] - b[0]) / max(abs(b[0]), 1.0)
                for a, b in zip(batched, single))
    if worst > LL_BATCH_TOL or [a[1] for a in batched] != \
            [b[1] for b in single]:
        raise AssertionError(f"8d: batched vs per-pair log-likelihoods "
                             f"{worst:.3g} apart, greedy flags "
                             f"{[a[1] for a in batched]} vs "
                             f"{[b[1] for b in single]}")
    log(f"phase 8d: loglikelihood_batch of {len(pairs)} pairs (buckets 64, "
        f"128 and 256, 8 rows each) in {t_b:.3f} s against one batch a pair "
        f"in "
        f"{t_s:.3f} s: log-likelihoods {[round(a[0], 3) for a in batched]}, "
        f"{worst:.3g} apart at most (relative), greedy flags equal")


# ---------------------------------------------------------------------------
# phase 2, at the shard shapes of TP = 2, and phase 9: parallelism


def check_tp2_shapes(dev, gen, timer):
    """The kernels that phase 9b's TP = 2 ranks launch at their shard
    shapes, each checked against its plain version to its full-width rule
    and timed: #1, #2 and #3 at Llama-2-7B's shard GEMMs (TP2_SHAPES; down
    K = 5504, not a multiple of 256), #9 over 16 kv heads, #12 and #16 at
    16 heads over 16 kv heads, #14 at B = 2, T = S = 512 with 16 heads;
    then, logged, #2 and #3 at Llama-3.1-8B's (down K = 7168) and #14 at 16
    heads over its 4 kv heads.  Returns the report row of each."""
    log("  at the TP = 2 shard shapes of Llama-2-7B:")
    rows = check_gemm_family(dev, gen, timer, TP2_GEMM_CHECKS)
    rows["slot_decode_write_int8"] = check_kv_write(dev, gen, timer,
                                                    nkv=NKV // 2)
    rows["decode_attention_int8"] = check_decode(
        dev, gen, timer, heads=(NH // 2, NKV // 2), extra=())
    rows.update(check_flash(dev, gen, timer, cases=((2, 512),),
                            nkv=NKV // 2, nh=NH // 2))
    rows["paged_decode_attention_int8"] = check_paged_decode(
        dev, gen, timer, nh=NH // 2,
        cases=((NKV // 2, (1990, 2001, 1937, 2040)),))
    log("  at the TP = 2 shard shapes of Llama-3.1-8B:")
    check_gemm_family(dev, gen, timer, L31_TP2_GEMM_CHECKS)
    check_flash(dev, gen, timer, cases=((1, 512),), nkv=NKV3 // 2,
                nh=NH // 2, report_at=None)
    return rows


#: seconds a phase-9 world of processes may take from its start
P9_TIMEOUT = 480
#: where the phase-9 ranks write their logs and results (git-ignored)
P9_DIR = HERE / "build" / "chip_smoke_phase9"
#: the worlds of ranks that share the card, gloo: (data, model) each
P9_WORLDS = {"b": (1, 2), "c": (2, 1), "d": (2, 2)}
#: the worlds that run at once
P9_WAVES = (("b", "c"), ("d",))


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def tp_cut_checks(mesh, params, config, prompt):
    """On a 2-layer, full-width cut under ``mesh`` (TP = 2): (1) teacher-
    force one slot prefill (one row of bucket 128) and 4 decode steps on
    the card and, the same mesh over the CPU (plain versions, gloo on host
    tensors), compare the gathered logits step by step within phase 4's
    relative RMS; (2) the sequence-parallel prefill, with and without the
    ring, and the micro-batch-overlapped decode against the TP forward on
    the card (two rows, two chains).  Returns the numbers it logged."""
    from qqq_tpu_torch.models import forward
    from qqq_tpu_torch.parallel import (
        param_pspecs, shard_params, tp_decode_overlapped_fn, tp_forward_fn,
    )
    from qqq_tpu_torch.parallel.shard import local_config
    from qqq_tpu_torch.serve import kv_cache

    cfg2 = dataclasses.replace(config, num_hidden_layers=2)
    cut = {**params, "layers": params["layers"][:2]}
    tp = mesh.axis("model")
    lcfg = local_config(cfg2, tp.size)
    host = mesh.with_device("cpu")
    sides = {"card": (mesh.device, shard_params(cut, mesh)),
             "cpu": (host.device, shard_params(
                 _tree_map(lambda t: t.cpu(), cut), host))}
    n, bucket, steps = len(prompt), 128, 4
    toks = torch.zeros((1, bucket), dtype=torch.int64)
    toks[0, :n] = torch.tensor(prompt)
    outs, caches = {}, {}
    for name, (d, p) in sides.items():
        caches[name] = kv_cache.init(lcfg, 1, 256, quantized=True, device=d)
        lg, _ = forward(p, cfg2, toks.to(d), caches=caches[name],
                        cache_len=torch.zeros((1,), dtype=torch.int32,
                                              device=d),
                        logits_at=torch.tensor([n - 1], device=d), tp=tp)
        outs[name] = [lg[0, -1].float().cpu()]
    for step in range(steps):
        tok = int(outs["card"][-1].argmax())
        for name, (d, p) in sides.items():
            lg, _ = forward(p, cfg2, torch.tensor([[tok]], device=d),
                            caches=caches[name],
                            cache_len=torch.tensor([n + step],
                                                   dtype=torch.int32,
                                                   device=d), tp=tp)
            outs[name].append(lg[0, -1].float().cpu())
    rels = []
    for i, (a, b) in enumerate(zip(outs["card"], outs["cpu"])):
        if not (torch.isfinite(a).all() and a.shape == (config.vocab_size,)):
            raise AssertionError(f"TP cut step {i}: card logits not finite "
                                 "or of the wrong shape")
        rels.append(_rel_rms(a, b))
        log(f"  TP = 2 cut, step {i} ({'prefill' if i == 0 else 'decode'}): "
            f"card vs CPU {rels[-1]:.3%} RMS, argmax "
            f"{'agrees' if a.argmax() == b.argmax() else 'differs'}")
        if rels[-1] > CARD_VS_CPU_TOL:
            raise AssertionError(f"TP cut step {i}: card vs CPU logits "
                                 f"differ by {rels[-1]:.3%} RMS > "
                                 f"{CARD_VS_CPU_TOL:.0%}")
    del sides["cpu"], caches
    # sequence parallelism and the overlapped decode, on the card
    p = shard_params(cut, mesh)
    spec = param_pspecs(cut)
    rng = np.random.default_rng(2)
    t2 = torch.from_numpy(rng.integers(0, config.vocab_size, (2, bucket)))
    zero = torch.zeros((2,), dtype=torch.int32)
    got = {}
    for key, kw in (("tp", {}), ("sp", dict(sp=True)),
                    ("ring", dict(overlap=True))):
        c = kv_cache.init(lcfg, 2, 256, quantized=True, device=mesh.device)
        f = tp_forward_fn(cfg2, mesh, spec, with_cache=True, **kw)
        got[key] = f(p, t2, c, zero)[0].float().cpu()
    f = tp_forward_fn(cfg2, mesh, spec, with_cache=True)
    chains, plain = [], []
    for m in range(2):
        c = kv_cache.init(lcfg, 1, 256, quantized=True, device=mesh.device)
        f(p, t2[m:m + 1], c, zero[:1])
        chains.append(c)
        c2 = kv_cache.init(lcfg, 1, 256, quantized=True, device=mesh.device)
        f(p, t2[m:m + 1], c2, zero[:1])
        lg, _ = f(p, t2[m:m + 1, :1], c2, torch.full((1,), bucket,
                                                      dtype=torch.int32))
        plain.append(lg[:, -1].float().cpu())
    ov = tp_decode_overlapped_fn(cfg2, mesh, spec, None, micro=2)
    outs_ov, _ = ov(p, tuple(t2[m:m + 1, :1] for m in range(2)),
                    tuple(chains), tuple(torch.full((1,), bucket,
                                                    dtype=torch.int32)
                                         for _ in range(2)))
    got["overlapped"] = torch.cat([o.float().cpu() for o in outs_ov])
    got["plain decode"] = torch.cat(plain)
    diffs = {"sp": _rel_rms(got["sp"], got["tp"]),
             "ring": _rel_rms(got["ring"], got["tp"]),
             "overlapped": _rel_rms(got["overlapped"], got["plain decode"])}
    for k, v in diffs.items():
        log(f"  TP = 2 cut on the card: {k} against the "
            f"{'plain TP decode' if k == 'overlapped' else 'TP forward'}: {v:.3g} "
            f"relative RMS (max |diff| "
            f"{float((got[k] - got['tp' if k != 'overlapped' else 'plain decode']).abs().max()):.4g})")
        if not v <= P9_SP_TOL:
            raise AssertionError(f"{k}: {v:.3g} relative RMS from the TP "
                                 f"forward > {P9_SP_TOL}")
    return dict(card_vs_cpu=rels, **diffs)


#: sequence parallelism and the overlapped decode against the TP forward
#: on the card: the same partial sums of two ranks (a + b either way), so
#: equal up to the order of bf16 sums inside a collective
P9_SP_TOL = 1e-3


def phase9_child(kind: str, rank: str, world: str, port: str) -> int:
    """One rank of a phase-9 world (``python3 chip_smoke.py --phase9-child
    KIND RANK WORLD PORT``): gloo over ranks that share the card; loads
    phase 5's checkpoint of 3a's weights; writes its results as JSON."""
    import torch.distributed as dist

    import_port()
    from qqq_tpu_torch.cli.eval import load_any
    from qqq_tpu_torch.kernels import build
    from qqq_tpu_torch.parallel import initialize_distributed, make_mesh

    rank, world = int(rank), int(world)
    initialize_distributed(backend="gloo",
                           init_method=f"tcp://127.0.0.1:{port}",
                           rank=rank, world_size=world)
    mesh = make_mesh(*P9_WORLDS[kind])
    dev = mesh.device
    build.build_all()  # built already by the parent: a no-op under the lock
    log(f"phase 9{kind}, rank {rank} of {world}: {mesh}, collectives on "
        f"card tensors {json.dumps(mesh.transport())}")
    # the whole checkpoint in host memory; each Engine takes its shards
    # onto the card (ranks that share it hold their shards alone)
    params, config = load_any(str(CKPT_G128), torch.bfloat16, device="cpu")
    res = {}
    if kind in ("b", "c"):
        keep = []
        launches, prompt0, toks, eng = serve(
            dev, params, config, "g128", engine_kw=dict(mesh=mesh),
            keep=keep)
        res.update(slot=toks, launches=launches,
                   logprobs=[r.token_logprobs for r in keep],
                   ms_per_tick=1e3 * eng.stats["decode_s"]
                   / eng.stats["decode_ticks"],
                   replays=eng.stats["graph_replays"])
        del eng
        launches, _, toks, eng = serve(dev, params, config, "g128",
                                       paged=True, engine_kw=dict(mesh=mesh))
        res.update(paged=toks, launches_paged=launches, pools_whole=[
            a.available == eng.num_blocks - 1 for a in eng.allocators],
            dp=eng.dp, allocators=len(eng.allocators))
        del eng
        if kind == "b":
            res["cut"] = tp_cut_checks(mesh, params, config, prompt0)
    else:  # d: a 2-layer cut over data 2 x model 2, paged, prefix cache
        from qqq_tpu_torch.serve.engine import Engine, Request
        from qqq_tpu_torch.serve.sampling import SamplingParams

        cfg2 = dataclasses.replace(config, num_hidden_layers=2)
        cut = {**params, "layers": params["layers"][:2]}
        del params
        eng = Engine(cut, cfg2, mesh=mesh, max_batch=MAX_BATCH,
                     max_len=2048, paged=True, prefix_cache=True)
        prompt = [int(t) for t in np.random.default_rng(3).integers(
            0, config.vocab_size, 600)]
        streams = []
        for _ in range(2):  # the second round adopts each shard's blocks
            reqs = [Request(prompt_tokens=prompt,
                            sampling=SamplingParams(max_new_tokens=16))
                    for _ in range(MAX_BATCH)]
            eng.run(reqs)
            streams += [r.output_tokens for r in reqs]
        res.update(streams=streams, hits=eng.stats["prefix_hits"],
                   dp=eng.dp, allocators=len(eng.allocators),
                   pools_whole=[a.available + len(lru) == eng.num_blocks - 1
                                for a, lru in zip(eng.allocators,
                                                  eng._bh_lru)])
        log(f"  4 identical 600-token prompts twice on data 2 x model 2: "
            f"{len(set(map(tuple, streams)))} distinct stream(s), "
            f"{res['hits']} prefix hits, pools whole {res['pools_whole']}")
    P9_DIR.mkdir(parents=True, exist_ok=True)
    (P9_DIR / f"{kind}_rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _p9_world(kind: str):
    """Start a phase-9 world: its ranks, each logging to P9_DIR."""
    data, model = P9_WORLDS[kind]
    port = str(_free_port())
    procs = []
    for r in range(data * model):
        out = open(P9_DIR / f"{kind}_rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), "--phase9-child",
             kind, str(r), str(data * model), port],
            stdout=out, stderr=subprocess.STDOUT, cwd=str(HERE)), out))
    return procs


def phase9(dev, params, config):
    """Parallelism on the card.  (a) An NCCL mesh of one rank in this
    process: an all-reduce captured in a CUDA graph and replayed, then
    3a's requests through ``Engine(mesh=)`` on full Llama-2-7B g128,
    tokens and log-probabilities bit-equal to ``Engine(fuse=False)``
    without a mesh, decode graphs replayed.  Then three gloo worlds of
    ranks that share the card, started together, each rank a process
    loading phase 5's checkpoint: (b) ``make_mesh(1, 2)`` at full width and
    depth, 3a's requests (slot) and 3c's traffic (paged), both ranks'
    tokens equal, every kernel's launches as the dispatches imply, then
    :func:`tp_cut_checks`; (c) ``make_mesh(2, 1)``: 3a's requests give
    (a)'s unfused tokens, and each shard's pool is whole after 3c's
    traffic; (d) ``make_mesh(2, 2)`` on a 2-layer cut, paged, prefix cache:
    identical prompts give one stream on every shard.  A rank's non-zero
    exit or a world past P9_TIMEOUT fails the phase.  Returns the launches
    of each kernel at the shard shapes: 9b rank 0's slot run's, or its
    paged run's for the paged kernels."""
    import torch.distributed as dist

    from qqq_tpu_torch.parallel import initialize_distributed, make_mesh
    from qqq_tpu_torch.parallel.collectives import Axis, host_ops

    gloo = Axis("-", 2, 0, (), None, host_ops("gloo", dev)).transport()
    log(f"  collectives on card tensors: gloo {json.dumps(gloo)}")
    initialize_distributed(backend="nccl",
                           init_method=f"tcp://127.0.0.1:{_free_port()}",
                           rank=0, world_size=1)
    mesh = make_mesh(1, 1)
    log(f"phase 9a: {mesh}, collectives on card tensors "
        f"{json.dumps(mesh.transport())}")
    t = torch.arange(8, dtype=torch.float32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dist.all_reduce(t)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        t.add_(1)
        dist.all_reduce(t)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(t, torch.arange(8, dtype=torch.float32,
                                       device=dev) + 3):
        raise AssertionError("the captured NCCL all-reduce replayed wrong")
    del graph
    log("  an NCCL all-reduce in a world of one, captured in a CUDA graph "
        "and replayed 3 times: right; the Engine's collectives are the "
        "identity on axes of size 1, so its tick graphs hold the kernels "
        "alone")
    ref, got = [], []
    _, _, toks_ref, eng = serve(dev, params, config, "g128",
                                engine_kw=dict(fuse=False), keep=ref)
    ref_ms = 1e3 * eng.stats["decode_s"] / eng.stats["decode_ticks"]
    del eng
    _, _, toks, eng = serve(dev, params, config, "g128",
                            engine_kw=dict(mesh=mesh), keep=got)
    ms = 1e3 * eng.stats["decode_s"] / eng.stats["decode_ticks"]
    if not eng.stats["graph_replays"]:
        raise AssertionError("9a: the NCCL mesh replayed no decode graph")
    del eng
    if toks != toks_ref or [r.token_logprobs for r in got] != [
            r.token_logprobs for r in ref]:
        raise AssertionError("9a: the mesh's tokens or log-probabilities "
                             "differ from the unfused single-device run's")
    log(f"  tokens and log-probabilities bit-equal to Engine(fuse=False) "
        f"without a mesh; {ms:.3f} ms per tick (captured) against the "
        f"unfused run's {ref_ms:.3f}")
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    gc.collect()  # engines of earlier phases sit in reference cycles
    torch.cuda.empty_cache()
    log(f"  this process holds {torch.cuda.memory_reserved() / 2**30:.2f} "
        "GiB of the card while the worlds run")
    P9_DIR.mkdir(parents=True, exist_ok=True)
    worlds, failed = {}, []
    deadline = time.monotonic() + P9_TIMEOUT
    for wave in P9_WAVES:  # the full-depth worlds first, then the cut's
        for kind in wave:
            worlds[kind] = _p9_world(kind)
        for kind in wave:
            for r, (p, out) in enumerate(worlds[kind]):
                try:
                    rc = p.wait(timeout=max(1.0,
                                            deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    rc = None
                if rc != 0:
                    failed.append(f"9{kind} rank {r}: exit {rc}")
        for kind in wave:
            for p, out in worlds[kind]:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                out.close()
        if failed:
            break
    for kind in worlds:
        text = (P9_DIR / f"{kind}_rank0.log").read_text()
        log(f"phase 9{kind} (rank 0's log):")
        for line in text.splitlines():
            if not line.startswith("  tokens: "):
                log("  " + line)
    if failed:
        for kind, procs in worlds.items():
            for r in range(1, len(procs)):
                log(f"phase 9{kind} rank {r}'s log, its end:\n"
                    + (P9_DIR / f"{kind}_rank{r}.log").read_text()[-3000:])
        raise AssertionError("phase 9: " + "; ".join(failed))
    res = {k: [json.loads((P9_DIR / f"{k}_rank{r}.json").read_text())
               for r in range(len(procs))] for k, procs in worlds.items()}
    b, c, d = res["b"], res["c"], res["d"]
    for kind in ("b", "c"):
        for key in ("slot", "paged"):
            if any(r[key] != res[kind][0][key] for r in res[kind]):
                raise AssertionError(f"9{kind} {key}: the ranks' tokens "
                                     "differ")
        if any(r["replays"] for r in res[kind]):
            raise AssertionError(f"9{kind}: a gloo tick replayed a graph")
    if c[0]["slot"] != toks_ref:
        i, j = next((i, j) for i, (x, y) in enumerate(zip(c[0]["slot"],
                                                          toks_ref))
                    for j, (u, v) in enumerate(zip(x, y)) if u != v)
        raise AssertionError(f"9c: data 2's tokens differ from 9a's unfused "
                             f"single-device run's, first at request {i} "
                             f"token {j}: {c[0]['slot'][i][j]} against "
                             f"{toks_ref[i][j]}")
    if not (c[0]["dp"] == 2 and c[0]["allocators"] == 2
            and all(c[0]["pools_whole"])):
        raise AssertionError(f"9c: the pools after the paged run: {c[0]}")
    streams = {tuple(s) for r in d for s in r["streams"]}
    if len(streams) != 1 or not all(all(r["pools_whole"]) for r in d) \
            or d[0]["hits"] < MAX_BATCH:
        raise AssertionError(f"9d: {len(streams)} streams, pools whole "
                             f"{[r['pools_whole'] for r in d]}, "
                             f"{d[0]['hits']} prefix hits")
    same = sum(x == y for s, t in zip(b[0]["slot"], toks_ref)
               for x, y in zip(s, t))
    log(f"phase 9 worlds ({sum(map(len, worlds.values()))} processes on "
        f"the one card, in waves {P9_WAVES}) took "
        f"{time.perf_counter() - t0:.1f} s: "
        f"9b's ranks agree, TP = 2 tokens equal to the single-device run's "
        f"at {same}/{sum(map(len, toks_ref))} positions (not asserted: a "
        f"row-parallel linear quantizes its K-slice per token), host-staged "
        f"ms per tick {b[0]['ms_per_tick']:.3f} (9b) and "
        f"{c[0]['ms_per_tick']:.3f} (9c), not speeds; 9b's cut card vs CPU "
        f"worst {max(b[0]['cut']['card_vs_cpu']):.3%} RMS; 9c's tokens "
        f"equal 9a's unfused run's, its pools whole; 9d one stream over "
        f"{len(d)} ranks, {d[0]['hits']} prefix hits")
    return {k: n or b[0]["launches_paged"][k]
            for k, n in b[0]["launches"].items()}


# phase 10: the device timer (utils/benchmark.py: measure_op) on the card

#: measure_op against Timer.device_ms where the latter is over P10_MIN_MS:
#: the ratio must lie in P10_RATIO (sanity bounds, not a speed target)
P10_MIN_MS, P10_RATIO = 0.1, (0.5, 2.0)


def phase10(dev, smi):
    """``measure_op`` (JAX's timer, ported: iterations captured in CUDA
    graphs, each feeding its output's max into the next one's input, the
    slope between two counts; warm L2) beside ``Timer.device_ms`` (20
    calls in one graph, warm L2) and ``Timer.ms`` (L2 flushed before each
    launch) at #2, the exact g128 GEMM at decode (4, 11008, 4096), #3, the
    requant GEMM at (512, 11008, 4096), #14, slot flash at B = 2, T = S =
    2048, and an identity op on #2's output: what measure_op adds to every
    op (perturb, max, carry), with no kernel of the op's own (the two
    Timer readings of it time no work).  Each reading finite, measure_op's
    positive, the kernels' Timer readings too; where ``device_ms`` is over
    P10_MIN_MS, measure_op within P10_RATIO of it.  Then an op that reads
    a value back to the host must make measure_op raise, and the card must
    still compute afterwards.  The captures call the wrappers, so
    launch counts are not read after this phase."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k
    from qqq_tpu_torch.kernels.attention import flash_attention_int8
    from qqq_tpu_torch.utils import measure_op

    gen = torch.Generator(device=dev).manual_seed(10)
    timer = Timer(dev)

    def gemm_args(M, K, N):
        a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                          dtype=torch.int8)
        s_tok = torch.rand((M, 1), generator=gen, device=dev) * 0.05 + 1e-3
        w = torch.randint(-2**31, 2**31 - 1, (K // 8, N), generator=gen,
                          device=dev, dtype=torch.int32)
        s = (torch.rand((K // 128, N), generator=gen, device=dev) * 0.01
             + 1e-4).to(torch.bfloat16)
        return a, s_tok, w, s

    B, T = 2, 2048
    q = torch.randn((B, NH, T, HD), generator=gen, device=dev).to(
        torch.bfloat16)
    flash_args = (q, *_rand_slot_cache(dev, gen, B, T),
                  torch.zeros(B, dtype=torch.int32, device=dev))
    g2 = gemm_args(4, I, H)
    out2 = k.w4a8_gemm_group(*g2)
    cases = (
        ("#2 w4a8_gemm_group M=4 K=11008 N=4096", k.w4a8_gemm_group, g2),
        ("#3 w4a8_gemm_requant M=512 K=11008 N=4096", k.w4a8_gemm_requant,
         gemm_args(512, I, H)),
        ("#14 flash_attention_int8 B=2 T=S=2048", flash_attention_int8,
         flash_args),
        ("identity on #2's output (4, 4096) bf16", lambda x: x, (out2,)),
    )
    log(f"  {smi}; ms per call: measure_op (warm L2), Timer.device_ms "
        "(warm L2), Timer.ms (L2 flushed)")
    bad = []
    for what, op, args in cases:
        t0 = time.perf_counter()
        mo = measure_op(op, args) * 1e3
        secs = time.perf_counter() - t0
        dm = Timer.device_ms(lambda: op(*args))
        ms = timer.ms(lambda: op(*args))
        ratio = mo / dm if dm > 0 else math.inf
        log(f"  {what}: measure_op {mo:.4f}, device_ms {dm:.4f}, ms "
            f"{ms:.4f} (measure_op / device_ms {ratio:.3f}; measure_op took "
            f"{secs:.1f} s)")
        kernel = not what.startswith("identity")
        if not (all(math.isfinite(x) for x in (mo, dm, ms)) and mo > 0
                and (not kernel or (dm > 0 and ms > 0))):
            bad.append(f"{what}: a reading is not finite and positive")
        if dm > P10_MIN_MS and not P10_RATIO[0] <= ratio <= P10_RATIO[1]:
            bad.append(f"{what}: measure_op / device_ms = {ratio:.3f}, "
                       f"outside {P10_RATIO}")
    try:
        measure_op(lambda x: x * float(x.max()), (out2,))
    except RuntimeError as e:
        if "cannot be captured" not in str(e):
            raise
        log(f"  an op that reads a value back: measure_op raised "
            f"({str(e).splitlines()[0][:160]})")
    else:
        bad.append("measure_op timed an op that reads a value back")
    if not (torch.ones(8, device=dev).sum().item() == 8
            and torch.isfinite(torch.randn(8, device=dev)).all()):
        bad.append("the card computes wrongly after the refused op")
    if bad:
        raise AssertionError("phase 10: " + "; ".join(bad))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    import_port()
    from qqq_tpu_torch.kernels import build
    from qqq_tpu_torch.models import ModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} on {name}")

    log("phase 1: build")
    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"  built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in secs.items()})})")
    for k in build.KERNELS:
        for line in build.build_log(k).splitlines():
            if "registers" in line or "spill" in line or (
                    k in NAMED_SOURCES and "entry function" in line):
                log(f"  {k}: {line.strip()}")

    log("phase 2: kernels against their plain versions on the card")
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(dev)
    rows = {
        **check_gemm_family(dev, gen, timer),
        "slot_decode_write_int8": check_kv_write(dev, gen, timer),
        "decode_attention_int8": check_decode(dev, gen, timer),
        **check_flash(dev, gen, timer, qk_int8=True),
        **check_paged_writes(dev, gen, timer),
        **check_paged_flash(dev, gen, timer),
        "paged_decode_attention_int8": check_paged_decode(dev, gen, timer),
        **check_fused(dev, gen, timer),
        "flash_decode_attention_int8": check_flash_decode(dev, gen, timer),
    }
    log("  the per-channel kernels in each regime across the switch:")
    for kname, cross in check_channel_crossover(dev, gen, timer).items():
        rows[kname]["crossover"] = cross
    check_flash(dev, gen, timer, cases=FLASH_OFFSET_CASES, nkv=NKV3,
                report_at=None)
    check_flash_decode_qwen2(dev, gen, timer)
    log("  the existing kernels at run 3e's Llama-3.1-8B shapes:")
    check_kv_write(dev, gen, timer, B=4, S=L31_MAX_LEN, nkv=NKV3)
    check_flash(dev, gen, timer, cases=L31_FLASH_CASES, nkv=NKV3,
                report_at=None, qk_int8=True)
    check_gemm_family(dev, gen, timer, L31_GEMM_CHECKS)
    tp2_rows = check_tp2_shapes(dev, gen, timer)
    del timer
    log("  the int8-QKᵀ route's control (q with an outlier channel):")
    check_qk_int8_control(dev, gen)
    qk_launches = drive_qk_int8_route(dev, gen)
    torch.cuda.empty_cache()

    config = ModelConfig(vocab_size=V, hidden_size=H, intermediate_size=I,
                         num_hidden_layers=L, num_attention_heads=NH,
                         num_key_value_heads=NKV)
    runs = {}
    log("phase 3a: serve Llama-2-7B (g128 W4A8, gate/up GLU-fused, INT8 "
        "slot KV cache)")
    params = random_packed_params(dev, config, 128)
    runs["g128"], prompt0, toks_a, _ = serve(dev, params, config, "g128")
    log("phase 3a, eager: the same run with every decode tick eager")
    _, _, toks, _ = serve(dev, params, config, "g128", eager=True)
    if toks != toks_a:
        raise AssertionError("3a: the eager tick's tokens differ from the "
                             "captured tick's")
    log("  tokens equal to the captured run's")
    log(f"phase 3a, steps_per_tick {MULTI_STEPS}: 3a's traffic with "
        f"{MULTI_STEPS} decode steps fused in each captured tick")
    _, _, toks, _ = serve(dev, params, config, "g128",
                          steps_per_tick=MULTI_STEPS)
    if toks != toks_a:
        raise AssertionError(f"3a: steps_per_tick {MULTI_STEPS} gives other "
                             "tokens than steps_per_tick 1")
    log("  tokens equal to steps_per_tick 1's")
    log("phase 3f: 3a with FUSE_ACT_QUANT (decode linears on the "
        "activation-quant-fused g128 kernel)")
    runs["g128 fused"], _, toks, _ = serve(dev, params, config, "g128",
                                           fused=True)
    if toks != toks_a:
        raise AssertionError("3f: tokens differ from 3a's")
    log("  tokens equal to 3a's")
    log("phase 3c: serve Llama-2-7B (g128 W4A8, gate/up GLU-fused, paged "
        "INT8 KV pool, chunked prefill, Engine defaults)")
    runs["paged"], _, roomy, _ = serve(dev, params, config, "g128",
                                       paged=True)
    log(f"phase 3c, steps_per_tick {MULTI_STEPS}: 3c's traffic with "
        f"{MULTI_STEPS} decode steps fused in each captured tick")
    _, _, toks, _ = serve(dev, params, config, "g128", paged=True,
                          steps_per_tick=MULTI_STEPS)
    if toks != roomy:
        raise AssertionError(f"3c: steps_per_tick {MULTI_STEPS} gives other "
                             "tokens than steps_per_tick 1")
    log("  tokens equal to steps_per_tick 1's")
    tight = 13
    log(f"phase 3d: the same traffic over a pool of {tight} blocks "
        f"({tight - 1} usable; the requests end up holding 2 + 3 + 6 + 8): "
        "recompute preemption")
    _, _, toks, eng = serve(dev, params, config, "g128", paged=True,
                            num_blocks=tight)
    if not eng.stats["preemptions"] > 0:
        raise AssertionError("the tight pool preempted nothing")
    if eng.allocators[0].available != tight - 1:
        raise AssertionError(f"{eng.allocators[0].available} blocks free "
                             f"after the run, expected {tight - 1}")
    same = sum(a == b for x, y in zip(toks, roomy) for a, b in zip(x, y))
    log(f"  {eng.stats['preemptions']} preemptions, pool fully returned; "
        f"tokens equal to phase 3c's at {same}/{sum(map(len, roomy))} "
        "positions (not asserted: a re-prefill of generated tokens takes "
        "the requant GEMMs where decode took the exact ones)")
    del eng
    log("phase 4: card against CPU, 2-layer cut of the g128 weights")
    card_vs_cpu(dev, params, config, prompt0)
    card_vs_cpu_paged(dev, params, config, prompt0)
    log("phase 5: 3a's weights saved as a checkpoint, loaded back onto the "
        "card and served over HTTP")
    loaded, cfg = save_and_load(dev, params, config)
    _, _, toks, _ = serve(dev, loaded, cfg, "g128")
    if toks != toks_a:
        raise AssertionError("5: the loaded checkpoint's tokens differ from "
                             "3a's")
    log("  the direct run of 3a's requests on the loaded checkpoint: tokens "
        "equal to 3a's")
    rng = np.random.default_rng(0)
    serve_http(dev, loaded, cfg, [[int(t) for t in rng.integers(0, V, n)]
                                  for n in PROMPT_LENS])
    del loaded
    check_seeded_noise(dev)
    check_marlin(dev, params, config, 128)
    t6 = time.perf_counter()
    rng = np.random.default_rng(0)  # 3a's prompts (serve)
    phase6(dev, params, config, [[int(t) for t in rng.integers(0, V, n)]
                                 for n in PROMPT_LENS])
    log(f"phase 6 took {time.perf_counter() - t6:.1f} s")
    t8 = time.perf_counter()
    phase8(dev, params, config)
    log(f"phase 8 took {time.perf_counter() - t8:.1f} s")
    t9 = time.perf_counter()
    log("phase 9: tensor, sequence and data parallelism (qqq_tpu_torch."
        "parallel, Engine(mesh=)) on the card")
    tp2_launches = phase9(dev, params, config)
    log(f"phase 9 took {time.perf_counter() - t9:.1f} s")
    del params
    torch.cuda.empty_cache()
    log("phase 3b: serve Llama-2-7B (per-channel W4A8, gate/up GLU-fused, "
        "INT8 slot KV cache)")
    params = random_packed_params(dev, config, -1)
    runs["per-channel"], _, toks_b, _ = serve(dev, params, config,
                                              "per-channel")
    log("phase 3g: 3b with FUSE_ACT_QUANT (decode linears on the "
        "activation-quant-fused per-channel kernel)")
    runs["per-channel fused"], _, toks, _ = serve(
        dev, params, config, "per-channel", fused=True)
    if toks != toks_b:
        raise AssertionError("3g: tokens differ from 3b's")
    log("  tokens equal to 3b's")
    log("phase 5: the per-channel weights in the reference's Marlin layout")
    check_marlin(dev, params, config, -1)
    shutil.rmtree(CKPT_DIR)
    del params
    torch.cuda.empty_cache()

    config31 = ModelConfig.from_hf(LLAMA31_8B)
    log(f"phase 3e: serve Llama-3.1-8B ({config31.num_attention_heads} "
        f"heads, {config31.num_key_value_heads} kv heads, llama3 RoPE "
        f"scaling; g128 W4A8, gate/up GLU-fused, INT8 slot KV cache of "
        f"{L31_MAX_LEN})")
    params = random_packed_params(dev, config31, 128)
    runs["llama31"], prompt31, toks31, eng = serve(
        dev, params, config31, "g128", traffic=L31_TRAFFIC)
    # a request of P prompt tokens and n output tokens had n - 1 decode
    # steps; the last fed token n - 1 at position P + n - 2 and attended
    # P + n - 1 keys, on the S-tiled kernel (serve held its launches to 32
    # per tick and the whole-cache kernel's to 0)
    longest = int(np.argmax(L31_PROMPT_LENS))
    keys = L31_PROMPT_LENS[longest] + len(toks31[longest]) - 1
    if not keys > 8192:
        raise AssertionError(f"3e's longest row attended at most {keys} "
                             "keys, not past the 8192 switch")
    log(f"  the {L31_PROMPT_LENS[longest]}-token row returned "
        f"{len(toks31[longest])} tokens: its last decode step attended "
        f"{keys} keys on the S-tiled kernel "
        f"({runs['llama31']['flash_decode_attention_int8']} launches = "
        f"{config31.num_hidden_layers} layers x {eng.stats['decode_ticks']} "
        "ticks)")
    del eng
    log("phase 4: card against CPU, 2-layer cut of the Llama-3.1-8B g128 "
        "weights over a 16384-token slot cache")
    card_vs_cpu(dev, params, config31, prompt31, max_len=16384,
                batched=False)
    del params
    gc.collect()  # engines of earlier phases sit in reference cycles
    torch.cuda.empty_cache()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t7 = time.perf_counter()
    log(f"phase 7a: cli/quantize on the card ({smi})")
    rng = np.random.default_rng(0)  # 3a's prompts (serve)
    phase7a(dev, [[int(t) for t in rng.integers(0, V, n)]
                  for n in PROMPT_LENS])
    log("phase 7b: QQQ calibration of Llama-2-7B at full depth on the card "
        f"({smi})")
    phase7b(dev)
    log(f"phase 7 took {time.perf_counter() - t7:.1f} s")
    t10 = time.perf_counter()
    log("phase 10: the device timer (qqq_tpu_torch.utils.measure_op) on the "
        "card")
    phase10(dev, smi)
    log(f"phase 10 took {time.perf_counter() - t10:.1f} s")

    # each kernel's launches from the first run whose path it is on
    launches = {k: next((r[k] for r in runs.values() if r[k]), 0)
                for k in runs["g128"]}
    report = []
    for kname, (fn, source, replaces) in kernel_fns().items():
        r = rows[kname]
        report.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            **{key: r[key] for key in ("prefill", "crossover", "device_ms")
               if key in r},
        })
        if kname in tp2_rows:  # at the TP = 2 shard shape, phase 9b's path
            report[-1]["tp2"] = {**tp2_rows[kname],
                                 "launches": tp2_launches[kname]}
    for kname, (source, replaces) in QK_INT8_KERNELS.items():
        r = rows[kname]
        report.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": qk_launches[kname],
            **{key: r[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape")},
        })
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--phase9-child":
        sys.exit(phase9_child(*sys.argv[2:]))
    sys.exit(main())
