#!/usr/bin/env python3
"""Slot and paged flash (csrc/flash_attention.cu, the default bf16 QKᵀ
route) of several checkouts of qqq_tpu_torch, timed in one run on one
NVIDIA GPU.

    python3 scripts/compare_flash_trees.py ROOT_A ROOT_B [ROOT_C ...]
    python3 scripts/compare_flash_trees.py --one ROOT

Each ROOT is a directory holding a ``qqq_tpu_torch`` package (a checkout,
or one unpacked with ``git archive``); its kernels build from its own
sources into ``ROOT/build/``.  The trees run one process each, in the order
given and then again in reverse (A, B, C, C, B, A), so that a drift of the
card's clock during the run falls on every tree alike.  Each process times
``flash_attention_int8`` and ``paged_flash_attention_int8`` with their
default arguments at chip_smoke.py's report shapes (Llama-2-7B slot flash,
B = 2, T = S = 512; Llama-3.1-8B slot flash, T = S = 16384, 8 kv heads;
paged flash, R = 2, T = 512 after 300 and 1400 cached keys over scrambled
tables), on inputs drawn from one seed: ``ms``, the median of 20 single
launches timed by CUDA events with the L2 flushed before each, wrapper
included (chip_smoke's ``Timer.ms``), and ``device_ms``, 20 launches in
one CUDA graph, replayed 5 times, the median over 20 (``Timer.device_ms``).
It prints one JSON line a process, ptxas's register counts of the bf16
flash entries at hd = 128 included, then the card's name and power limit
and a table of each tree's medians.  ``--one ROOT`` is the child process.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys

NH, HD, BS, NBMAX, NB_POOL = 32, 128, 128, 16, 65
#: name → (B, T, S or None for the pool, kv heads, cache lengths)
SHAPES = {
    "slot B=2 T=S=512": (2, 512, 512, 32, (0, 0)),
    "slot B=1 T=S=16384 nkv=8": (1, 16384, 16384, 8, (0,)),
    "paged R=2 T=512 cache_len 300/1400": (2, 512, None, 32, (300, 1400)),
}


def _time_tree(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from qqq_tpu_torch.kernels import build
    from qqq_tpu_torch.kernels.attention import (
        flash_attention_int8, paged_flash_attention_int8,
    )

    build.build_all(("flash_attention",))
    regs = [line.strip() for line in
            build.build_log("flash_attention").splitlines()
            if "registers" in line]
    entries = re.findall(r"entry function '(\S+)'",
                         build.build_log("flash_attention"))
    # bf16 flash at hd = 128 (the served one): its entries' register counts
    regs128 = {e: r for e, r in zip(entries, regs)
               if "flash_tc_kernelILi128E13__nv_bfloat16" in e}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def ms(fn):
        fn()
        out = []
        for _ in range(20):
            flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1))
        return statistics.median(out)

    def device_ms(fn, n=20, reps=5):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        out = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            graph.replay()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1) / n)
        return statistics.median(out)

    res = {"root": root, "registers_hd128_bf16": regs128}
    for name, (B, T, S, nkv, clen) in SHAPES.items():
        rows = NB_POOL if S is None else B
        keys = BS if S is None else S
        kc = torch.randint(-128, 128, (rows, nkv, keys, HD), generator=gen,
                           device=dev, dtype=torch.int8)
        vc = torch.randint(-128, 128, (rows, nkv, keys, HD), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((rows, nkv, keys), generator=gen, device=dev) * 0.02 \
            + 1e-3
        vs = torch.rand((rows, nkv, keys), generator=gen, device=dev) * 0.02 \
            + 1e-3
        q = torch.randn((B, NH, T, HD), generator=gen, device=dev).to(
            torch.bfloat16)
        cl = torch.tensor(clen, dtype=torch.int32, device=dev)
        if S is None:
            perm = torch.randperm(NB_POOL - 1,
                                  generator=torch.Generator().manual_seed(12))
            tables = (perm[:B * NBMAX] + 1).reshape(B, NBMAX).to(
                torch.int32).to(dev)

            def fn():
                paged_flash_attention_int8(q, kc, ks, vc, vs, tables, cl)
        else:
            def fn():
                flash_attention_int8(q, kc, ks, vc, vs, cl)
        res[name] = {"ms": ms(fn), "device_ms": device_ms(fn)}
        del kc, vc, ks, vs, q
        torch.cuda.empty_cache()
    return res


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(_time_tree(argv[1])), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for root in [*argv, *reversed(argv)]:
        out = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True, check=True,
                             timeout=900).stdout.strip().splitlines()[-1]
        print(out, flush=True)
        runs.append(json.loads(out))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    for name in SHAPES:
        for key in ("ms", "device_ms"):
            line = [f"{name} {key}:"]
            for root in argv:
                vals = [r[name][key] for r in runs if r["root"] == root]
                line.append(f"{root} {statistics.median(vals):.4f} "
                            f"({' / '.join(f'{v:.4f}' for v in vals)})")
            print("  ".join(line))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
