#!/usr/bin/env python3
"""The readings that a cell's correctness limit is set from, in one process:

    python3 h100_bench/readings.py --workload <cell> --seeds a,b,c \\
        --seconds <s> [--control-bits 4]

For each seed, a whole run of the cell (its own weights, engine, warm-up
and a window of ``--seconds``) and its reference check, as
``h100_bench/run.py`` makes them, printing the program's gaps; with
``--control-bits`` also the control's (the reference one precision step
below the configuration's, harness/correct.py) and whether the control
passes the cell's limits (``control_correct``, which has to be false).
One JSON line a seed.  The benchmark's own runs never read the control.
"""

from __future__ import annotations

import gc
import json
import sys

import torch

import run
from harness import spec


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-bits", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        run.log("no CUDA card: no readings")
        return 3
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    dev = torch.device("cuda", 0)
    for s in args.seeds.split(","):
        out = run.run_cell(cell, bench, int(s), args.seconds, False, dev,
                           control_bits=args.control_bits)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        print(json.dumps({
            "seed": int(s), "max_gap_nats": out["checks"]["max_gap_nats"][
                "value"],
            "control_max_gap_nats": out.get("control_max_gap_nats"),
            "mean_gap_nats": out["checks"]["mean_gap_nats"]["value"],
            "control_mean_gap_nats": out.get("control_mean_gap_nats"),
            "control_correct": out.get("control_correct"),
            "served_tokens_checked": out["checks"]["served_tokens_checked"][
                "value"],
            "correct": out["correct"], "metrics": {
                k: v["value"] for k, v in out["metrics"].items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
