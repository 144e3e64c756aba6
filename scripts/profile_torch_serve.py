#!/usr/bin/env python3
"""Where the time goes in the port's serving path on one NVIDIA GPU.

    python3 scripts/profile_torch_serve.py [--layers 32] [--ticks 8]
                                           [--group-size 128] [--paged]
                                           [--llama31] [--fuse-act-quant]
                                           [--steps-per-tick 1]
                                           [--spec-k 0]

Builds the Llama-2-7B-geometry port model (random weights from a seeded
generator, RTN-packed in groups of 128, or per channel with
``--group-size -1``; the Engine's default gate/up GLU fusion), admits 4
prompts of 500 tokens and decodes.  Over the INT8 slot cache the prompts
prefill in one dispatch (bucket 512, M = 2048 rows per GEMM); with
``--paged``, over the paged INT8 pool with the Engine's paged defaults
(blocks of 128, chunks of 512, two rows per dispatch), in two chunk
dispatches (M = 1024 each).  It profiles the prefill and ``--ticks``
steady decode ticks with ``torch.profiler`` (CPU + CUDA activities) and
prints, for each: the host wall time (ending in a synchronize), the summed
device time of all CUDA kernels, the device idle share, and the kernels
ranked by device time, per dispatch and per tick.  The decode ticks run
twice: eagerly (the engine's private eager-tick switch), then as the
engine serves, each tick one replay of its captured CUDA graph (two
warm-up ticks first: the first captures the graph); each tick decodes
``--steps-per-tick`` steps.  Before the profiled ticks, as many unprofiled
ones are timed on the host clock (ending in a synchronize).  The card's
name and power limit come first.  With
``--fuse-act-quant`` the run sets ``FUSE_ACT_QUANT`` (the decode ticks'
plain linears on the activation-quant-fused kernel, as chip_smoke.py's
runs 3f and 3g).  The W4A8 GEMMs whose kernels share a name stem are
labelled with their row of PERF.md's kernel table (#1 .. #7).

With ``--llama31`` the model is Llama-3.1-8B (``ModelConfig.from_hf`` of
chip_smoke.py's config: 8 kv heads, llama3 RoPE scaling) over a
32768-token slot cache, and the 4 prompts are 100, 400, 1500 and 12000
tokens long (buckets 128, 512, 2048 and 16384, one dispatch each, profiled
together, once, with no warm-up: the kernels are built before it): every
decode tick runs the S-tiled decode kernel.

With ``--spec-k k`` each tick is instead the speculative verify of
``Engine(spec_ngram=1, spec_k=k)`` (one (4, 1 + k) forward, every row
given k drafted tokens, eager and then replayed from its captured graph),
which rewrites the same k + 1 positions of each row every tick.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


#: name stems of the W4A8 GEMM kernels → their row of PERF.md's table (the
#: first stem a kernel's name holds)
KERNEL_LABELS = (
    ("QuantizedX", "#4 w4a8_gemm_fused_channel"),
    ("stream::glu_kernel", "#7 w4a8_glu_group"),
    ("stream::fused_kernel", "#5 w4a8_gemm_fused_group"),
    ("stream::kernel<", "#2 w4a8_gemm_group"),
    ("stream::channel_kernel<false", "#1 w4a8_gemm_channel"),
    ("stream::channel_kernel<true", "#6 w4a8_glu_channel"),
)


def kernel_label(name: str) -> str:
    return next((f"[{lab}] " for stem, lab in KERNEL_LABELS if stem in name),
                "") + name


def kernel_table(prof, top: int = 20):
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rows.append((e.self_device_time_total / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows[:top]


def device_spans(prof, gap_ms: float = 0.3):
    """The device's activity (kernels and copies) cut where it idled over
    ``gap_ms``: one group a decode tick when the ticks' kernels run back to
    back, as a replayed graph's do.  Returns [(span ms, busy ms)]."""
    ev = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    groups = []
    for start, end in ev:
        if groups and start - groups[-1][1] <= gap_ms * 1e3:
            g = groups[-1]
            g[1] = max(g[1], end)
            g[2] += end - start
        else:
            groups.append([start, end, end - start])
    return [((e - s) / 1e3, busy / 1e3) for s, e, busy in groups]


def report(label: str, wall_ms: float, prof, per: int = 1,
           unit: str = "dispatch") -> None:
    busy, rows = kernel_table(prof)
    print(f"{label}: wall {wall_ms / per:.3f} ms, device kernels "
          f"{busy / per:.3f} ms, idle share {1 - busy / wall_ms:.3f}"
          f" (per {unit})")
    for ms, n, name in rows:
        print(f"    {ms / per:9.4f} ms  {n // per:6d}x  {kernel_label(name)[:110]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--group-size", type=int, default=128, choices=(128, -1))
    ap.add_argument("--paged", action="store_true",
                    help="serve over the paged INT8 pool (Engine defaults)")
    ap.add_argument("--llama31", action="store_true",
                    help="Llama-3.1-8B over a 32768-token slot cache, "
                         "prompts of 100/400/1500/12000 tokens")
    ap.add_argument("--fuse-act-quant", action="store_true",
                    help="set FUSE_ACT_QUANT for the run")
    ap.add_argument("--steps-per-tick", type=int, default=1,
                    help="decode steps fused in each tick")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="profile the speculative verify of k drafts a row "
                         "in place of the decode tick")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    from qqq_tpu_torch.kernels import build, w4a8_gemm
    from qqq_tpu_torch.models import (
        ModelConfig, init_params, quantize_params_rtn,
    )
    from qqq_tpu_torch.serve.engine import Engine, Request
    from qqq_tpu_torch.serve.sampling import SamplingParams

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    if args.fuse_act_quant:
        w4a8_gemm.FUSE_ACT_QUANT = True
    print(f"group_size {args.group_size}, {args.layers} layers, gate/up "
          f"GLU-fused, {'paged' if args.paged else 'slot'} KV cache"
          f"{', FUSE_ACT_QUANT' if w4a8_gemm.FUSE_ACT_QUANT else ''}")
    build.build_all()
    dev = torch.device("cuda")
    if args.llama31:
        from chip_smoke import L31_BUCKETS, L31_TRAFFIC, LLAMA31_8B

        cfg = dataclasses.replace(ModelConfig.from_hf(LLAMA31_8B),
                                  num_hidden_layers=args.layers)
        lens, _, max_len = L31_TRAFFIC
        kw = dict(prefill_buckets=L31_BUCKETS)
    else:
        cfg = ModelConfig(num_hidden_layers=args.layers)  # Llama-2-7B
        lens, max_len, kw = (500,) * 4, 2048, {}
    params = quantize_params_rtn(
        init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev), cfg, args.group_size)
    rng = np.random.default_rng(0)

    def requests():
        return [Request([int(t) for t in rng.integers(0, cfg.vocab_size, n)],
                        SamplingParams(max_new_tokens=1000))
                for n in lens]

    if args.spec_k:
        kw.update(spec_ngram=1, spec_k=args.spec_k)
    eng = Engine(params, cfg, max_batch=4, max_len=max_len, paged=args.paged,
                 device=dev, steps_per_tick=args.steps_per_tick, **kw)
    active = np.ones(4, bool)

    def prefill():
        """Admit 4 prompts into slots 0-3 the way Engine.run does."""
        if args.paged:
            eng._pending = requests()
            eng._admit_chunked()
            eng._progress_chunk_prefills()
        elif args.llama31:
            eng._pending = requests()
            eng._admit_whole()
        else:
            eng._admit_batch(requests(), [0, 1, 2, 3], 512)

    def tick():
        if args.paged:
            eng._grow_for_decode()
        if not args.spec_k:
            eng._decode_tick(active, args.steps_per_tick)
            return
        branch, ex = eng._pack_tick(active, list(eng.slot_req),
                                    [[1] * args.spec_k] * 4)
        eng._sync_tables()
        eng._run_verify(branch, ex).cpu()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if args.llama31:
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        report(f"prefill, prompts {lens} in dispatches "
               f"{eng.stats['prefill_shapes']} (rows, bucket)", wall, prof,
               unit="prefill of all 4")
    else:
        prefill()  # warm-up
        for _ in range(3):
            tick()
        for s in range(4):
            eng._free_slot(s)
        torch.cuda.synchronize()
        n0 = eng.stats["prefill_dispatches"]
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        n = eng.stats["prefill_dispatches"] - n0
        report(f"prefill, 4 x 500 tokens in {n} dispatch(es) of "
               f"{eng.stats['prefill_shapes'][-1]} (rows, tokens)", wall,
               prof, per=n)

    for mode in ("eager", "captured"):
        eng._eager_tick = mode == "eager"
        for _ in range(2):
            tick()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            tick()
        torch.cuda.synchronize()
        print(f"decode, {mode} tick, unprofiled: wall "
              f"{(time.perf_counter() - t0) * 1e3 / args.ticks:.3f} ms (per "
              "tick)")
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.ticks):
                tick()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        what = (f"verify of {args.spec_k} drafts a row" if args.spec_k
                else f"tick of {args.steps_per_tick} step(s)")
        report(f"decode, {mode} {what}, batch "
               f"4, cache lengths {eng.slot_len.tolist()}", wall, prof,
               per=args.ticks, unit="tick")
        spans = device_spans(prof)
        span = sum(s for s, _ in spans)
        busy = sum(b for _, b in spans)
        print(f"    device activity in {len(spans)} runs without a gap over "
              f"0.3 ms: {span / args.ticks:.3f} ms a tick, busy "
              f"{busy / span:.3f} of it; outside them "
              f"{1 - span / wall:.3f} of the wall time")
    print(f"graphs captured {eng.stats['graph_captures']}, replays "
          f"{eng.stats['graph_replays']}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
