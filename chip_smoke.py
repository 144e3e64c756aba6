#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qqq_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. build the CUDA kernels from the sources in this checkout, printing
   ``-Xptxas -v`` (registers, shared memory, spills) of each entry of the
   tensor-core kernels (slot flash, g128 requant, the per-channel GEMM's
   weight stream and wgmma tiles, the exact g128 GEMMs' weight stream:
   plain, GLU and activation-quant-fused) and of the split decode;
2. check each of the sixteen kernels against its plain PyTorch version on
   the card at the Llama-2-7B and Llama-3.1-8B shapes of the served paths
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
   seed (its tokens equal in two batches), ``/v1/completions`` streamed as
   SSE equal to the plain reply, echo scoring, one cancel; graphs keyed by
   the sampling extras must replay, every kernel count must be as expected,
   and each graph's replay is timed.  2-layer full-width cuts of the g128
   and per-channel weights go through the reference QQQ's Marlin layout
   and back (codes and scales as stored).

The last lines are a ``{"kernels": [...]}`` report, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the qqq_tpu_torch package beside this file, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
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


def check_decode(dev, gen, timer):
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

    cases = [(B, NH, NKV, HD, S, None) for B, S in (
        (1, 1024), (4, 1024), (1, 2048), (4, 2048), (1, 4096), (4, 4096))]
    cases += [(4, nh, nkv, hd, S, clen)
              for nh, nkv, hd, S, clen in DECODE_EXTRA]
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
        if (B, nh, S) == (4, NH, 2048):
            report = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                          bound_by=by, shape="B=4 S=2048, cache_len "
                          "164/364/664/964")
        del kc, vc, kd, vd
    report["max_abs_err"] = err
    return report


def check_flash(dev, gen, timer, cases=((2, 128), (2, 512), (2, 2048)),
                nkv=NKV, report_at=(2, 512)):
    """Slot flash at each case of ``cases``: (B, T) with T = S (a fresh
    bucket-sized prefill cache, cache_len 0), or (B, T, S, cache lengths),
    each row of the output within two bf16 ulps of its own largest value
    (:func:`ulp_rows`: a causal prefill's first row sees one key and would
    set a whole-output bound far above the long rows).  Yardstick: SDPA on
    the dequantized bf16 K/V, kv heads repeated for GQA, causal (with the
    cache offset as a mask where cache_len > 0)."""
    import torch.nn.functional as F

    from qqq_tpu_torch.kernels.attention import (
        flash_attention_int8, flash_attention_int8_plain,
    )

    report, err = None, 0.0
    for case in cases:
        B, T = case[:2]
        S, clens = case[2:] if len(case) > 2 else (T, (0,) * B)
        clen = torch.tensor(clens, dtype=torch.int32, device=dev)
        q = torch.randn((B, NH, T, HD), generator=gen, device=dev).to(
            torch.bfloat16)
        kc = torch.randint(-128, 128, (B, nkv, S, HD), generator=gen,
                           device=dev, dtype=torch.int8)
        vc = torch.randint(-128, 128, (B, nkv, S, HD), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((B, nkv, S), generator=gen, device=dev) * 0.02 + 1e-3
        vs = torch.rand((B, nkv, S), generator=gen, device=dev) * 0.02 + 1e-3
        args = (q, kc, ks, vc, vs, clen)
        out = flash_attention_int8(*args)
        ref = flash_attention_int8_plain(*args)
        torch.cuda.synchronize()
        e, worst = ulp_rows(out, ref)
        if not worst <= 1:
            raise AssertionError(f"flash_attention_int8 B={B} T={T} S={S} "
                                 f"nkv={nkv} cache_len {clens}: a row differs"
                                 f" by {worst:.3g} times its bound of "
                                 f"{ATTN_ULPS} bf16 ulps")
        err = max(err, e)
        del out, ref
        kd = _dequant(kc, ks).repeat_interleave(NH // nkv, dim=1)
        vd = _dequant(vc, vs).repeat_interleave(NH // nkv, dim=1)
        ms = timer.ms(lambda: flash_attention_int8(*args))
        plain = timer.ms(lambda: flash_attention_int8_plain(*args))
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
        pairs = NH * sum(T * c + T * (T + 1) // 2 for c in clens)
        keys = sum(c + T for c in clens)
        nbytes = 2 * B * NH * T * HD * 2 + keys * nkv * (HD + 4) * 2 + B * 4
        b, by = bound_ms(nbytes, 4.0 * HD * pairs)
        log(f"  flash_attention_int8 B={B} T={T} S={S} nkv={nkv} cache_len "
            f"{clens}: max |diff| {e:.3g} (worst row {worst:.3g} of its "
            f"bound); {ms:.4f} ms (bound {b:.4f} by {by}, plain "
            f"{plain:.4f}, sdpa {lib:.4f})")
        if (B, T) == report_at and len(case) == 2:
            report = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                          bound_by=by, shape=f"B={B} T=S={T} causal, clen 0")
        del kc, vc, kd, vd
        torch.cuda.empty_cache()
    if report is not None:
        report["max_abs_err"] = err
    return report


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
    earlier blocks), and one row of a fresh prompt: each output row within
    two bf16 ulps of its own largest value (:func:`ulp_rows`), and bit-equal
    to slot flash on the pool gathered through the tables (the two differ
    only in where a key row is read; that kernel's time is logged beside
    it).  Yardstick: SDPA with the causal offset mask on the gathered
    K/V."""
    import torch.nn.functional as F

    from qqq_tpu_torch.kernels.attention import (
        flash_attention_int8, paged_flash_attention_int8,
        paged_flash_attention_int8_plain,
    )
    from qqq_tpu_torch.serve.paged_kv import gather

    report, err = None, 0.0
    T = 512
    for clen in ((300, 1400), (0,)):
        R = len(clen)
        pool = _rand_pool(dev, gen)
        tables = _scrambled_tables(dev, R, seed=10 + R)
        cl = torch.tensor(clen, dtype=torch.int32, device=dev)
        q = torch.randn((R, NH, T, HD), generator=gen, device=dev).to(
            torch.bfloat16)
        args = (q, *pool, tables, cl)
        out = paged_flash_attention_int8(*args)
        ref = paged_flash_attention_int8_plain(*args)
        slot_args = (q, *(gather(t, tables) for t in pool), cl)
        slot = flash_attention_int8(*slot_args)
        torch.cuda.synchronize()
        e, worst = ulp_rows(out, ref)
        if not worst <= 1:
            raise AssertionError(f"paged_flash_attention_int8 cache_len "
                                 f"{clen}: a row differs by {worst:.3g} "
                                 f"times its bound of {ATTN_ULPS} bf16 ulps")
        if not torch.equal(out, slot):
            raise AssertionError(f"paged_flash_attention_int8 cache_len "
                                 f"{clen}: not bit-equal to "
                                 "flash_attention_int8 on the gathered pool")
        err = max(err, e)
        del out, ref, slot
        kd, vd = _gathered_bf16(pool, tables)
        key = torch.arange(NBMAX * BS, device=dev)
        qpos = cl[:, None] + torch.arange(T, device=dev)[None, :]  # (R, T)
        mask = (key[None, None, :] <= qpos[:, :, None])[:, None]
        ms = timer.ms(lambda: paged_flash_attention_int8(*args))
        slot_ms = timer.ms(lambda: flash_attention_int8(*slot_args))
        plain = timer.ms(lambda: paged_flash_attention_int8_plain(*args))
        lib = timer.ms(lambda: F.scaled_dot_product_attention(
            q, kd, vd, attn_mask=mask))
        pairs = NH * sum(T * c + T * (T + 1) // 2 for c in clen)
        keys = sum(c + T for c in clen)
        nbytes = (2 * R * NH * T * HD * 2 + keys * NKV * (HD + 4) * 2
                  + R * 4 + sum(-(-(c + T) // BS) for c in clen) * 4)
        b, by = bound_ms(nbytes, 4.0 * HD * pairs)
        log(f"  paged_flash_attention_int8 R={R} T={T} cache_len {clen}: "
            f"max |diff| {e:.3g} (worst row {worst:.3g} of its bound), "
            f"bit-equal to slot flash on the gathered pool; {ms:.4f} ms "
            f"(bound {b:.4f} by {by}, slot flash on the gathered pool "
            f"{slot_ms:.4f}, plain {plain:.4f}, sdpa {lib:.4f})")
        if report is None:
            report = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                          bound_by=by, shape=f"R={R} T={T} causal, cache_len "
                          f"{list(clen)}, scrambled tables")
        del pool, kd, vd, slot_args
    report["max_abs_err"] = err
    return report


def check_paged_decode(dev, gen, timer):
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
    for nkv, clen in ((NKV, served), (NKV, (1, 2040, 1, 1)), (2, served)):
        pool = _rand_pool(dev, gen, nkv)
        cl = torch.tensor(clen, dtype=torch.int32, device=dev)
        q = torch.randn((B, NH, HD), generator=gen, device=dev).to(
            torch.bfloat16)
        args = (q, *pool, tables, cl)
        out = paged_decode_attention_int8(*args)
        ref = paged_decode_attention_int8_plain(*args)
        torch.cuda.synchronize()
        e, worst = ulp_rows(out, ref)
        what = f"paged_decode_attention_int8 B={B} nkv={nkv} cache_len {clen}"
        if not worst <= 1:
            raise AssertionError(f"{what}: a (row, head) differs by "
                                 f"{worst:.3g} times its bound of "
                                 f"{ATTN_ULPS} bf16 ulps")
        err = max(err, e)
        kd, vd = (x.repeat_interleave(NH // nkv, dim=1)
                  for x in _gathered_bf16(pool, tables))
        mask = (torch.arange(NBMAX * BS, device=dev)[None, :]
                < cl[:, None])[:, None, None, :]
        ms = timer.ms(lambda: paged_decode_attention_int8(*args))
        plain = timer.ms(lambda: paged_decode_attention_int8_plain(*args))
        lib = timer.ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kd, vd, attn_mask=mask))
        n_pos = sum(clen)
        nbytes = (n_pos * nkv * (HD + 4) * 2 + 2 * B * NH * HD * 2 + B * 4
                  + sum(-(-c // BS) for c in clen) * 4)
        b, by = bound_ms(nbytes, 4.0 * NH * HD * n_pos)
        log(f"  {what}: max |diff| {e:.3g} (worst (row, head) {worst:.3g} "
            f"of its bound); {ms:.4f} ms (bound {b:.4f} by {by}, plain "
            f"{plain:.4f}, sdpa {lib:.4f})")
        if report is None:
            report = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b,
                          bound_by=by, shape=f"B={B} cache_len "
                          f"{list(clen)}, scrambled tables")
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


def expected_launches(scheme, n_layers, dispatches, ticks, paged=False,
                      max_len=2048, fused=False, scores=()):
    """Launches per kernel that a served run implies (``ticks``: its decode
    steps, a replayed graph's counted as launched; ``scores``: the (M, T)
    of cache-free scoring forwards, which run the linears only).  Per
    layer and forward pass: four linears (q/k/v/o) and down_proj on the
    plain GEMM, gate/up on the GLU GEMM, one KV write and one attention
    (slot or paged; decode or prefill).  g128: the requant route for
    prefill dispatches of M ≥ 512 rows (T ≥ 64 always holds for the
    buckets and chunks here), the exact route for the rest and for decode.
    With ``fused`` (FUSE_ACT_QUANT), the five plain linears of each decode
    tick (M = 4) take the scheme's fused kernel; the GLU and every prefill
    dispatch (M ≥ 128) do not."""
    dispatches_kv, dispatches = dispatches, list(dispatches) + list(scores)
    n_big = sum(1 for m, t in dispatches if m >= 512 and t >= 64)
    small = len(dispatches) - n_big + ticks
    plain_ticks = 0 if fused else ticks  # ticks on the two-step route
    exp = dict.fromkeys(kernel_fns(), 0)
    if scheme == "g128":
        exp.update(w4a8_gemm_group=5 * n_layers
                   * (small - ticks + plain_ticks),
                   w4a8_glu_group=n_layers * small,
                   w4a8_gemm_requant=5 * n_layers * n_big,
                   w4a8_glu_requant=n_layers * n_big)
    else:
        passes = len(dispatches) + ticks
        exp.update(w4a8_gemm_channel=5 * n_layers
                   * (passes - ticks + plain_ticks),
                   w4a8_glu_channel=n_layers * passes)
    if fused:
        exp[FUSED_KERNEL[scheme]] = 5 * n_layers * ticks
    if paged:
        exp.update(paged_decode_write_int8=n_layers * ticks,
                   paged_decode_attention_int8=n_layers * ticks,
                   paged_chunk_write_int8=n_layers * len(dispatches_kv),
                   paged_flash_attention_int8=n_layers * len(dispatches_kv))
    else:
        write, decode, flash = slot_kernels(max_len)
        exp.update({write: n_layers * ticks, decode: n_layers * ticks,
                    flash: n_layers * len(dispatches_kv)})
    return exp


def serve(dev, params, config, scheme, paged=False, num_blocks=None,
          traffic=LLAMA2_TRAFFIC, fused=False, steps_per_tick=1,
          eager=False):
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
    Returns the counts, the first prompt, the output tokens and the
    engine."""
    from qqq_tpu_torch.kernels import w4a8_gemm
    from qqq_tpu_torch.serve.engine import Engine, Request
    from qqq_tpu_torch.serve.sampling import SamplingParams

    prompt_lens, buckets, max_len = traffic
    vocab = config.vocab_size
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, vocab, size=n)]
               for n in prompt_lens]
    if paged:
        eng = Engine(params, config, max_batch=MAX_BATCH, max_len=max_len,
                     paged=True, num_blocks=num_blocks, device=dev,
                     steps_per_tick=steps_per_tick)
    else:
        eng = Engine(params, config, max_batch=MAX_BATCH, max_len=max_len,
                     prefill_buckets=buckets, device=dev,
                     steps_per_tick=steps_per_tick)
    eng._eager_tick = eager
    if not all("gate_up_glu" in layer for layer in eng.params["layers"]):
        raise AssertionError("Engine() did not fuse gate/up")
    reqs = [Request(prompt_tokens=p,
                    sampling=SamplingParams(max_new_tokens=64))
            for p in prompts]
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
        if len(r.output_tokens) != 64 or not all(
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
    # (M, T) of each prefill dispatch, as the engine's scheduler chose them
    dispatches = [(rows * t, t) for rows, t in st["prefill_shapes"]]
    expect = expected_launches(scheme, config.num_hidden_layers, dispatches,
                               st["decode_steps"], paged=paged,
                               max_len=max_len, fused=fused)
    must_run = (SCHEME_KERNELS[scheme]
                + (PAGED_KERNELS if paged else slot_kernels(max_len))
                + ((FUSED_KERNEL[scheme],) if fused else ()))
    tick = "eager" if eager else "captured"
    label = (f"{scheme}{' paged' if paged else ''}"
             f"{' FUSE_ACT_QUANT' if fused else ''}, {tick} tick, "
             f"steps_per_tick {steps_per_tick}")
    for name, n in launches.items():
        if n != expect[name]:
            raise AssertionError(f"{label}: {name}: {n} launches on the "
                                 f"served path, expected {expect[name]}")
        if n == 0 and name in must_run:
            raise AssertionError(f"{label}: {name} never launched on the "
                                 f"served path (M, T) = {dispatches}")
    decode_tokens = st["generated_tokens"] - len(reqs)
    log(f"  served {len(reqs)} requests (prompts {prompt_lens}, 64 new "
        f"tokens, depth {config.num_hidden_layers}, {label}, fuse=True, "
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
    log(f"  decode ({tick} tick, steps_per_tick {steps_per_tick}): "
        f"{1e3 * st['decode_s'] / ticks:.3f} ms per tick, "
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


def save_and_load(dev, params, config):
    """``save_quantized`` the served params and ``load_any`` them back onto
    the card: every tensor's dtype, shape and bits must be equal."""
    from qqq_tpu_torch.cli.eval import load_any
    from qqq_tpu_torch.models.loader import _flatten, save_quantized

    path = CKPT_DIR / "llama2_7b_g128"
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
    shutil.rmtree(path)
    return loaded, cfg


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
    dispatches = [(rows * t, t) for rows, t in st["prefill_shapes"]]
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
        "flash_attention_int8": check_flash(dev, gen, timer),
        **check_paged_writes(dev, gen, timer),
        "paged_flash_attention_int8": check_paged_flash(dev, gen, timer),
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
                report_at=None)
    check_gemm_family(dev, gen, timer, L31_GEMM_CHECKS)
    del timer
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
    check_marlin(dev, params, config, 128)
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
    torch.cuda.empty_cache()

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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
