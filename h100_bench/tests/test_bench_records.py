"""The metrics that read the program's own dispatch records and admission
stamps (harness/records.py), over a traced toy run of the closed cell on
the CPU: each record's shape is the benchmark's span's, the queue wait is
the requests' own, and the metrics that need the card's events are left
out; against a program that keeps no records, every one is left out."""

import math

import pytest
import torch

import run
from harness import records, spec
from toy import toy_bench, toy_cell

SEED = 2**31 + 7
NEW = ("queue_wait_ms.closed", "tick_device_ms.closed",
       "tick_launch_ms.closed", "idle_between.closed")


@pytest.fixture(scope="module")
def traced():
    """One traced toy run: (its result line, the readers' context)."""
    seen = []
    orig = spec.reader

    def reader(name):
        f = orig(name)

        def read(ctx):
            seen.append(ctx)
            return f(ctx)
        return read

    spec.reader = reader
    try:
        out = run.run_cell(toy_cell("closed", limit=0.05), toy_bench(), SEED,
                           2.0, True, torch.device("cpu"), torch.float32)
    finally:
        spec.reader = orig
    return out, seen[0]


def test_each_record_has_the_benchmark_spans_shape(traced):
    """The spans wrap the engine's three dispatch methods from the warm-up's
    end on, so they pair with the log's last records, one to one and in
    order, each record inside its span."""
    _, ctx = traced
    log = list(ctx.window.eng.dispatch_log)
    spans = ctx.spans
    assert spans and len(log) > len(spans)
    for s, r in zip(spans, log[-len(spans):]):
        assert {k: r[k] for k in s["desc"]} == s["desc"]
        assert s["t0"] <= r["t_start"] <= r["t_end"] <= s["t1"]


def test_queue_wait_is_the_admitted_requests_own(traced):
    out, ctx = traced
    w = ctx.window
    a, b = ctx.profiled
    end = w.closed_at
    waits = [r.t_admit - r.t_enqueue for r in w.requests
             if r.t_admit is not None
             and (w.t0 <= r.t_admit < min(a, end)
                  or max(b, w.t0) <= r.t_admit < end)]
    assert waits
    got = out["metrics"]["queue_wait_ms.closed"]
    assert got["unit"] == "ms"
    assert math.isclose(got["value"], 1e3 * sum(waits) / len(waits))
    # clients are admitted no earlier than they are sent
    assert min(waits) >= 0


def test_device_metrics_are_left_out_off_the_card(traced):
    out, ctx = traced
    for name in NEW[1:]:
        assert name not in out["metrics"]
        assert spec.reader(name)(ctx) is None
    assert records.dispatches(ctx, "decode")
    assert records.gaps(ctx) is None


def test_a_program_without_records_reads_none(traced):
    """A program before the records (no ``dispatch_log``), or a ring that
    no longer reaches back to the window's opening: every new reader gives
    None."""
    _, ctx = traced

    class Bare:
        pass

    eng = ctx.window.eng
    try:
        ctx.window.eng = Bare()
        assert all(spec.reader(n)(ctx) is None for n in NEW)
        full = type(eng.dispatch_log)(list(eng.dispatch_log)[-3:], maxlen=3)
        ctx.window.eng = Bare()
        ctx.window.eng.dispatch_log = full
        assert full[0]["t_start"] >= ctx.window.t0
        assert all(spec.reader(n)(ctx) is None for n in NEW)
    finally:
        ctx.window.eng = eng
