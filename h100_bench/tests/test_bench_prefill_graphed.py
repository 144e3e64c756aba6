"""``prefill_graphed``'s reader (metrics/prefill_graphed.py) over toy
dispatch logs: the share of the whole-bucket prefill records in the
window's unprofiled part that replayed a graph; None where the records
lack the field (a program before it), where the engine prefills in chunks
and where no prefill started."""

import collections
import types

import pytest

from harness import spec

READ = spec.reader("prefill_graphed.closed")


def _ctx(recs, prefill_chunk=0, profiled=(20.0, 23.0)):
    """A reader's context over ``recs`` (a window open from 10 s to 60 s,
    profiled over ``profiled``)."""
    eng = types.SimpleNamespace(
        dispatch_log=collections.deque(recs, maxlen=1024),
        prefill_chunk=prefill_chunk)
    window = types.SimpleNamespace(eng=eng, t0=10.0, t_end=60.0,
                                   closed_at=60.5)
    return types.SimpleNamespace(window=window, profiled=profiled)


def _rec(t, kind="prefill", graph="replay", with_field=True):
    r = {"kind": kind, "t_start": t, "t_end": t + 0.01}
    if with_field and kind == "prefill":
        r["graph"] = graph
    return r


def test_share_of_replays_in_the_unprofiled_part():
    """Set-up's captures (before the window) and the profiled sub-window's
    records are left out; a capture or an eager prefill in the window
    counts against the share; ticks do not count."""
    recs = [_rec(1.0, graph="capture"), _rec(2.0, graph="capture"),
            _rec(11.0), _rec(12.0, kind="decode"), _rec(13.0, graph=None),
            _rec(14.0), _rec(21.0, graph="capture"), _rec(30.0),
            _rec(31.0, graph="capture"), _rec(40.0)]
    assert READ(_ctx(recs)) == pytest.approx(100.0 * 4 / 6)
    assert READ(_ctx(recs, profiled=None)) == pytest.approx(100.0 * 4 / 7)
    replays = [_rec(11.0 + i) for i in range(5)]
    assert READ(_ctx(replays)) == 100.0


def test_none_without_the_field_or_without_whole_prefills():
    old = [_rec(11.0, with_field=False), _rec(12.0, kind="decode"),
           _rec(13.0, with_field=False)]
    assert READ(_ctx(old)) is None
    assert READ(_ctx([_rec(11.0), _rec(12.0)], prefill_chunk=512)) is None
    assert READ(_ctx([_rec(12.0, kind="decode")])) is None
    assert READ(_ctx([_rec(1.0)])) is None  # before the window only
