#!/usr/bin/env python3
"""One run of one cell of the H100 serving benchmark of ``qqq_tpu_torch``.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It draws the cell's model from the seed on
the card, builds the port's ``Engine`` with the cell's settings, warms up
the cell's own shapes, serves the cell's traffic for ``--seconds`` through
``add_request`` / ``run``, checks a sample of what it served against the
plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` (with
``--trace 1`` its ``busy_s`` and ``window_s`` too), with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
which also end standard error.

It needs the card: without CUDA, or with fewer cards than the cell asks
for, it exits 3 and prints no result; if JAX or the JAX package
(``qqq_tpu``) is loaded once the window has closed it exits 4.  Every
build and kernel cache lives under ``build/`` inside the checkout.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The host's monotonic clock at this process's start (its start time
    in ``/proc``), or now where that cannot be read."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - age if 0 <= age < 600 else now
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for _p in (REPO, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)
_CACHE = os.path.join(REPO, "build", "h100_bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "cuda")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

import torch  # noqa: E402

from harness import correct as C  # noqa: E402
from harness import device, driver, program, spec  # noqa: E402
from harness.context import Context  # noqa: E402
from harness.trace import Profiler, summarize  # noqa: E402
from harness.traffic import Traffic  # noqa: E402


def log(msg: str) -> None:
    print(f"[h100_bench] {msg}", file=sys.stderr, flush=True)


def run_cell(cell: Dict[str, Any], bench: Dict[str, Any], seed: int,
             seconds: float, trace: bool, dev, dtype=torch.bfloat16,
             t_process: Optional[float] = None,
             control_bits: Optional[int] = None) -> Dict[str, Any]:
    """One run of ``cell`` on ``dev`` (the card; tests pass the CPU):
    returns the result line as a dict.  ``control_bits`` also reads the
    control (see harness/correct.py); the benchmark's runs never do."""
    t_process = time.monotonic() if t_process is None else t_process
    cfg, settings, mix = cell["config"], cell["settings"], cell["traffic"]
    V = cfg["vocab_size"]
    t = time.monotonic()
    params = program.build_params(cfg, seed, dev, dtype)
    eng = program.make_engine(params, cfg, settings, dev, dtype)
    del params
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log(f"weights drawn, packed and engine built in "
        f"{time.monotonic() - t:.3f} s")
    t = time.monotonic()
    n = program.warm_up(eng, mix, seed, V)
    log(f"warm-up: {n} prefill dispatches, "
        f"{eng.stats['graph_captures']} graph captures "
        f"({eng.stats['graph_capture_s']:.3f} s) in "
        f"{time.monotonic() - t:.3f} s")
    traffic = Traffic(mix, seed, V, settings.get("rate_rps", 0.0))
    prof = spans = None
    if trace:
        Profiler.warm(dev)
        prof = Profiler(seconds - settings.get("profile_s", 1.0), seconds)
        spans = program.Spans(eng, prof.before, prof.after)
        prof.spans = spans
    setup_s = time.monotonic() - t_process
    log(f"setup {setup_s:.3f} s; window of {seconds} s opens")
    if mix["loop"] == "closed":
        win = driver.closed_loop(eng, traffic, mix["clients"], seconds,
                                 on_open=prof.arm if prof else None)
    else:
        win = driver.open_loop(eng, traffic, seconds,
                               on_open=prof.arm if prof else None)
    if prof is not None:
        prof.stop()
    mem_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
    summary = None
    if prof is not None and prof.prof is not None:
        t = time.monotonic()
        summary = summarize(prof.prof, prof.t_stop - prof.t_start)
        log(f"trace read in {time.monotonic() - t:.3f} s: "
            f"{summary['kernels']} device ops, families "
            f"{ {k: round(v, 6) for k, v in summary['family_s'].items()} }"
            f", by dispatch kind {summary['kind_busy_s']}")
        for name in summary["unmapped"]:
            log(f"kernel of no family: {name}")
        for name, files in summary["ambiguous"].items():
            log(f"kernel of two families ({files}): {name}")
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    ctx = Context(cell, win, setup_s, spans.records if spans else None,
                  summary, spec.peaks(kind),
                  (prof.t_start, prof.t_stop) if summary else None)
    metrics: Dict[str, Any] = {}
    for m in spec.metrics_of(bench, cell["name"], trace):
        v = spec.reader(m["name"])(ctx)
        if v is None or not math.isfinite(v):
            log(f"metric {m['name']}: {v}, left out of the line")
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    _log_window(win, eng, ctx)

    # the check, once the window has closed and the program's state is freed
    answered = ctx.answered()
    failed = sum(1 for r in answered if r.finish_reason == "error")
    if mix["loop"] == "open":
        failed += win.unfinished
    sample = [{"prompt": list(r.prompt_tokens),
               "output": list(r.output_tokens)}
              for r in C.pick([r for r in answered
                               if r.done and not r.cancelled
                               and r.finish_reason == "length"],
                              seed, settings["check"]["requests"])]
    attempted = len(win.requests)
    program.release(eng)
    del eng, win, ctx, spans, prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.monotonic()
    got = C.served_gaps(cfg, seed, sample, dev, control_bits)
    log(f"reference over {got['requests']} requests, {got['tokens']} served "
        f"tokens, in {time.monotonic() - t:.3f} s")
    lim = settings["limits"]
    checks = {
        "max_gap_nats": {"value": got["max_gap"],
                         "limit": lim["max_gap_nats"]},
        "mean_gap_nats": {"value": got["mean_gap"],
                          "limit": lim["mean_gap_nats"]},
        "failed_requests": {"value": failed, "limit": 0},
        "served_tokens_checked": {"value": got["tokens"],
                                  "limit": settings["check"]["min_tokens"]},
    }
    ok = _within(got["max_gap"], got["mean_gap"], lim) and failed == 0 \
        and got["tokens"] >= settings["check"]["min_tokens"]
    dev_out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": kind, "count": 1, "memory_peak_bytes": mem_peak}
    out: Dict[str, Any] = {"correct": ok, "attempted": attempted,
                           "failed": failed, "metrics": metrics,
                           "device": dev_out}
    if summary is not None:
        dev_out["busy_s"] = summary["busy_s"]
        dev_out["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    if control_bits is not None:
        out["control_max_gap_nats"] = got["control_max_gap"]
        out["control_mean_gap_nats"] = got["control_mean_gap"]
        out["control_correct"] = _within(got["control_max_gap"],
                                         got["control_mean_gap"], lim)
    out["checks"] = checks
    return out


def _within(max_gap: float, mean_gap: float, lim: Dict[str, float]) -> bool:
    """The gaps' part of ``correct``: each gap at or under its limit."""
    return max_gap <= lim["max_gap_nats"] and mean_gap <= lim["mean_gap_nats"]


def _log_window(win, eng, ctx) -> None:
    s0, s1 = win.stats0, win.stats1 or program.stats_snapshot(eng)
    d = {k: s1[k] - s0[k] for k in ("decode_ticks", "decode_s", "prefill_s",
                                    "prefill_tokens", "prefill_dispatches",
                                    "generated_tokens", "preemptions",
                                    "graph_captures")}
    log(f"window: {len(win.requests)} requests, {len(ctx.answered())} "
        f"answered, {win.tokens_in_window} tokens inside; engine stats over "
        f"it {d}")
    if d["decode_ticks"]:
        log(f"  engine decode_s / decode_ticks = "
            f"{1e3 * d['decode_s'] / d['decode_ticks']:.4f} ms")
    if win.lateness:
        late = sorted(win.lateness)
        log(f"  feeder lateness: median {1e3 * late[len(late) // 2]:.3f} ms, "
            f"max {1e3 * late[-1]:.3f} ms; unfinished {win.unfinished}")
    if win.queue:
        log(f"  queue: last {win.queue[-1][1]} outstanding, max "
            f"{max(q for _, q in win.queue)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    need = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"needs {need} CUDA card(s); torch.cuda.is_available() = "
            f"{torch.cuda.is_available()}, device_count() = "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f": no result")
        return 3
    dev = torch.device("cuda", 0)
    card = device.smi()
    log(f"card: {torch.cuda.get_device_name(dev)} (nvidia-smi: "
        f"{card['name']}, power limit {card['power_limit']}); torch "
        f"{torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    out = run_cell(cell, bench, args.seed, args.seconds, bool(args.trace),
                   dev, t_process=T_PROCESS)
    bad = device.forbidden()
    if bad:
        log(f"forbidden modules loaded: {bad}: no result")
        return 4
    out["device"]["power_limit"] = card["power_limit"]
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
