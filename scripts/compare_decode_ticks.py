#!/usr/bin/env python3
"""The captured decode tick of chip_smoke.py's runs 3a, 3f and 3c, for one
or more checkouts of the repo, each in a process of its own.  On the card.

    python3 scripts/compare_decode_ticks.py ROOT [ROOT ...] [--reps N]
                                            [--log FILE]

Each ROOT is a checkout (its own ``qqq_tpu_torch``, ``chip_smoke.py`` and
``build/``); they run one after another in the order given, so to compare
two give them as A B B A.  Each child builds its kernels, draws
chip_smoke.py's random g128 Llama-2-7B (full width and depth, seed 0) and
serves chip_smoke.py's four requests with that checkout's ``serve``: 3a
(slot KV cache, gate/up GLU-fused), 3f (3a with ``FUSE_ACT_QUANT``) and 3c
(paged, chunked prefill), ``--reps`` times each.  It reports the ms per tick
of the captured replays alone on the host's clock (every decode tick but
each graph's first, which runs eagerly and captures it), and after each
run the device time of the run's one-step tick graph: the median of 30
replays, each timed by CUDA events (the state of the run's last tick;
no host work between them).  The children's own logs go to ``--log``.  The
last lines give the card's name and power limit and one JSON object:
[{"root", "tick_ms": {run: [...]}, "device_ms": {run: [...]}}, ...].
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

RUNS = {"3a": {}, "3f": {"fused": True}, "3c": {"paged": True}}


def child(root: str, reps: int) -> int:
    import torch

    sys.path.insert(0, root)
    import chip_smoke as cs

    cs.import_port()
    from qqq_tpu_torch.kernels import build
    from qqq_tpu_torch.models import ModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.build_all()
    config = ModelConfig(vocab_size=cs.V, hidden_size=cs.H,
                         intermediate_size=cs.I, num_hidden_layers=cs.L,
                         num_attention_heads=cs.NH,
                         num_key_value_heads=cs.NKV)
    params = cs.random_packed_params(dev, config, 128)
    out = {"tick_ms": {run: [] for run in RUNS},
           "device_ms": {run: [] for run in RUNS}}
    for _ in range(reps):
        for run, kw in RUNS.items():
            cs.log(f"run {run} of {root}")
            eng = cs.serve(dev, params, config, "g128", **kw)[3]
            st = eng.stats
            replay_s = st["decode_s"] - st["graph_capture_s"]
            out["tick_ms"][run].append(1e3 * replay_s / st["graph_replays"])
            graph = next(g.graph for k, g in eng._graphs.items() if k[0] == 1)
            times = []
            for _ in range(30):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                graph.replay()
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            out["device_ms"][run].append(statistics.median(times))
            del eng, graph
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--log")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.reps)
    import torch

    if not torch.cuda.is_available():
        print("compare_decode_ticks: no CUDA device", file=sys.stderr)
        return 2
    log = open(args.log, "w") if args.log else None
    results = []
    for root in args.roots:
        root = str(pathlib.Path(root).resolve())
        p = subprocess.run(
            [sys.executable, __file__, root, "--child", root,
             "--reps", str(args.reps)],
            capture_output=True, text=True, timeout=900)
        if log:
            log.write(f"=== {root} (rc {p.returncode})\n{p.stdout}"
                      f"{p.stderr}")
            log.flush()
        if p.returncode:
            print(p.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{root}: the child exited {p.returncode}")
        res = json.loads(p.stdout.strip().splitlines()[-1])
        for what, per_run in res.items():
            print(f"{root}, {what}: " + ", ".join(
                f"{run} {' / '.join(f'{t:.3f}' for t in ms)}"
                for run, ms in per_run.items()), flush=True)
        results.append({"root": root, **res})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
