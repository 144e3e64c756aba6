"""Percentiles and window arithmetic on hand-made stamps."""

import math
import types

from harness import stats
from harness.context import Context


def test_percentile_interpolates_between_ranks():
    assert stats.percentile([], 95) is None
    assert stats.percentile([3.0], 95) == 3.0
    v = list(range(1, 101))  # 1 .. 100
    assert math.isclose(stats.percentile(v, 95), 95.05)
    assert stats.percentile(v, 50) == 50.5
    assert stats.percentile([5, 1, 3], 100) == 5
    assert stats.percentile([1, 2, math.inf], 95) == math.inf
    assert stats.percentile([1, 2, 3, math.inf], 50) == 2.5


def _req(t_first, t_done, n, cancelled=False):
    return types.SimpleNamespace(t_first_token=t_first, t_done=t_done,
                                 output_tokens=[0] * n, done=True,
                                 cancelled=cancelled, finish_reason="length")


def _ctx(loop, requests, due, t0=100.0, seconds=10.0):
    win = types.SimpleNamespace(requests=requests, due=due, t0=t0,
                                t_end=t0 + seconds, seconds=seconds,
                                closed_at=t0 + seconds, tokens_in_window=0)
    cell = {"config": {}, "traffic": {"loop": loop}}
    return Context(cell, win, setup_s=1.0)


def test_ttft_counts_from_the_due_time_through_a_stall():
    """Open loop: five requests due each second; the engine stalls 3 s
    after the second, so the three behind it wait from their due times;
    the fifth never answers."""
    due = [100.0, 101.0, 102.0, 103.0, 104.0]
    reqs = [_req(100.2, 101.0, 5), _req(101.2, 102.0, 5),
            _req(105.2, 106.0, 5), _req(105.3, 106.1, 5),
            _req(None, None, 0)]
    reqs[4].done = False
    ctx = _ctx("open", reqs, due)
    tt = ctx.ttfts()
    assert [round(x, 6) for x in tt[:4]] == [0.2, 0.2, 3.2, 2.3]
    assert tt[4] == math.inf
    # p95 over 5: rank 3.8 between 3.2 and inf → inf (one never answered)
    assert stats.percentile(tt, 95) == math.inf
    assert math.isclose(stats.percentile(tt[:4], 50), 1.25)


def test_tpot_and_the_closed_windows_finished_requests():
    reqs = [_req(100.5, 101.5, 11),       # 0.1 s a token
            _req(102.0, 112.0, 101),      # finishes after the window
            _req(103.0, 105.0, 5, True),  # cancelled at the close
            _req(104.0, 104.0, 1)]        # one token: no TPOT
    ctx = _ctx("closed", reqs, [100.0] * 4)
    assert ctx.answered() == [reqs[0], reqs[3]]
    assert [round(x, 9) for x in ctx.tpots()] == [0.1]
    assert math.isclose(stats.tpot(100.5, 101.5, 11), 0.1)



def _span(kind, t0, t1, profiled, units):
    desc = ({"kind": "decode", "steps": units, "rows": [1]}
            if kind == "decode" else
            {"kind": "prefill", "rows": [(0, 1)], "heads": 1,
             "padded": units})
    return {"t0": t0, "t1": t1, "desc": desc, "profiled": profiled}


def test_idle_scales_the_traces_busy_seconds_by_each_kinds_work():
    """A 10 s window, its last 2 s profiled: there one decode step kept the
    device busy 10 ms and 512 prefilled positions 40 ms; the 8 s unprofiled
    held 200 steps and 4 prefills of 512, so the device was busy 2.16 s of
    them, whatever the peaks."""
    spans = ([_span("decode", 100.0 + 0.03 * i, 100.0 + 0.03 * i + 0.02,
                    False, 1) for i in range(200)]
             + [_span("prefill", 106.0 + 0.3 * i, 106.1 + 0.3 * i, False, 512)
                for i in range(4)]
             + [_span("decode", 108.0 + 0.1 * i, 108.05 + 0.1 * i, True, 1)
                for i in range(10)]
             + [_span("prefill", 109.5, 109.7, True, 1024)])
    ctx = _ctx("closed", [], [])
    ctx.spans = spans
    ctx.profiled = (108.0, 110.0)
    ctx.trace = {"kind_busy_s": {"decode": 0.1, "prefill": 0.08}}
    assert math.isclose(ctx.idle(), 100.0 * (1 - (200 * 0.01 + 4 * 0.04) / 8))
    ctx.trace = None
    assert ctx.idle() is None


def test_device_time_goes_to_the_dispatch_that_launched_it():
    from harness.trace import SPAN, _busy_by_kind
    host = [(0.0, 10.0, SPAN + "decode"), (12.0, 30.0, SPAN + "prefill"),
            (1.0, 2.0, "cudaGraphLaunch"), (31.0, 40.0, SPAN + "decode")]
    dev = [(-5.0, -1.0, "before any span"), (2.0, 9.0, "tick"),
           (3.0, 4.0, "overlapping"), (11.0, 12.5, "late tick kernel"),
           (13.0, 20.0, "gemm"), (19.0, 25.0, "gemm"), (33.0, 35.0, "tick")]
    got = _busy_by_kind(dev, host)
    assert math.isclose(got["decode"], 1e-6 * (7 + 1.5 + 2))
    assert math.isclose(got["prefill"], 1e-6 * 12)
