"""The engine's dispatch records (``Engine.dispatch_log``) and admission
stamps (``Request.t_admit``) on the CPU, and the arithmetic of the device
spans (``utils/profiling.py:DeviceSpans``) over stand-in events: one record
per prefill dispatch, decode tick and verify, with the scheduler's shapes;
host phases in order; a request's first admission kept through a
preemption; the ring bounded.  The card's events against a profiler trace
are checked in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from qqq_tpu_torch.models import ModelConfig, init_params
from qqq_tpu_torch.serve import engine as engine_mod
from qqq_tpu_torch.serve.engine import Engine, Request
from qqq_tpu_torch.serve.sampling import SamplingParams
from qqq_tpu_torch.utils.profiling import DeviceSpans

CFG = ModelConfig(vocab_size=128, hidden_size=64, intermediate_size=96,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128)
SLOT = dict(max_batch=4, max_len=64, prefill_buckets=(16, 32))

PREFILL_PHASES = ("t_start", "t_forward", "t_synced", "t_end")
TICK_PHASES = ("t_start", "t_packed", "t_launched", "t_synced",
               "t_delivered", "t_end")


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, torch.Generator().manual_seed(0),
                       dtype=torch.float32, device="cpu")


def _serve(params, prompts, n_new=5, **kw):
    eng = Engine(params, CFG, dtype=torch.float32, device="cpu",
                 **{**SLOT, **kw})
    reqs = [Request(p, SamplingParams(max_new_tokens=n_new)) for p in prompts]
    eng.run(reqs)
    return eng, reqs


def _prefills(eng):
    return [(r["rows"], r["heads"], r["padded"]) for r in eng.dispatch_log
            if r["kind"] == "prefill"]


def test_one_record_per_whole_prompt_dispatch_and_tick(params):
    """Slot mode, buckets (16, 32), 4 slots: the bucket-16 group (3, 7, 9)
    goes as 2 + 1 rows, the 20-token prompt alone in the 32 bucket, the
    30-token one when a slot frees; each tick's rows are the active rows'
    contexts before it."""
    eng, _ = _serve(params, [list(range(1, n + 1)) for n in (3, 20, 7, 9,
                                                              30)])
    log = list(eng.dispatch_log)
    st = eng.stats
    assert [r["seq"] for r in log] == list(range(len(log)))
    assert [r["kind"] for r in log].count("prefill") \
        == st["prefill_dispatches"] == 4
    assert [r["kind"] for r in log].count("decode") == st["decode_ticks"]
    assert _prefills(eng) == [([(0, 3), (0, 7)], 2, 32), ([(0, 9)], 1, 16),
                              ([(0, 20)], 1, 32), ([(0, 30)], 1, 32)]
    ticks = [r for r in log if r["kind"] == "decode"]
    assert ticks[0]["rows"] == [3, 7, 9, 20]
    assert ticks[1]["rows"] == [4, 8, 10, 21]
    assert all(t["steps"] == 1 for t in ticks)
    assert sum(len(t["rows"]) for t in ticks) \
        == st["generated_tokens"] - st["prefills"]


def test_chunk_records_and_verify_records(params):
    """Chunked prefill in slot mode (chunks of 8 over 2 slots): each
    record's rows are (start, tokens) of the rows it runs, ``heads`` the
    rows whose prompt it completes; with speculation a verify is logged
    only when a row drafted, as kind "verify"."""
    eng, _ = _serve(params, [list(range(1, 14)), list(range(1, 22))],
                    max_batch=2, prefill_chunk=8)
    assert _prefills(eng) == [([(0, 8), (0, 8)], 0, 16),
                              ([(8, 5), (8, 8)], 1, 16),
                              ([(16, 5)], 1, 8)]
    eng, _ = _serve(params, [[1, 2, 3] * 6], n_new=12, spec_ngram=2,
                    spec_k=4)
    kinds = [r["kind"] for r in eng.dispatch_log]
    assert kinds.count("verify") == eng.stats["spec_ticks"] > 0
    assert kinds.count("verify") + kinds.count("decode") \
        == eng.stats["decode_ticks"]
    assert all(r["steps"] == 1 and r["rows"] for r in eng.dispatch_log
               if r["kind"] == "verify")


def test_host_phases_in_order_and_no_device_fields_on_the_cpu(params):
    eng, reqs = _serve(params, [list(range(1, n + 1)) for n in (5, 17, 9)],
                       n_new=4)
    log = list(eng.dispatch_log)
    for r in log:
        phases = PREFILL_PHASES if r["kind"] == "prefill" else TICK_PHASES
        ts = [r[k] for k in phases]
        assert ts == sorted(ts), r
        assert r["device_start"] is r["device_end"] is r["gap_before_s"] \
            is None
    for a, b in zip(log, log[1:]):
        assert a["t_end"] <= b["t_start"]
    for q in reqs:
        assert q.t_enqueue <= q.t_admit <= q.t_first_token <= q.t_done
        first = next(r for r in log if r["kind"] == "prefill"
                     and r["t_start"] == q.t_admit)
        assert first["t_synced"] <= q.t_first_token <= first["t_end"]


def test_t_admit_is_kept_through_a_preemption(params, monkeypatch):
    """Paged, a pool of 6 usable blocks of 8 for three requests that grow
    to 7: the latest admitted is preempted and admitted again, and keeps
    the stamp of its first admission."""
    seen = {}
    orig = Engine._preempt

    def preempt(self, protect):
        victims = [r for i, r in enumerate(self.slot_req)
                   if r is not None and i != protect]
        ok = orig(self, protect)
        for r in victims:
            if r in self._pending:
                seen.setdefault(id(r), (r, r.t_admit))
        return ok

    monkeypatch.setattr(Engine, "_preempt", preempt)
    rng = np.random.default_rng(1234)
    prompts = [[int(t) for t in rng.integers(0, 128, size=n)]
               for n in (6, 11, 3)]
    eng, reqs = _serve(params, prompts, n_new=8, paged=True, block_size=8,
                       num_blocks=7)
    assert eng.stats["preemptions"] > 0 and seen
    for r, t_admit in seen.values():
        assert t_admit is not None and r.t_admit == t_admit
        # its re-admission ran chunks after the stamp it keeps
        assert sum(1 for d in eng.dispatch_log if d["kind"] == "prefill"
                   and d["t_start"] > t_admit) >= 1
    assert all(q.t_enqueue <= q.t_admit <= q.t_first_token for q in reqs)


def test_the_ring_keeps_the_newest(params, monkeypatch):
    monkeypatch.setattr(engine_mod, "DISPATCH_LOG_SIZE", 3)
    eng, _ = _serve(params, [list(range(1, n + 1)) for n in (4, 6)])
    n = eng.stats["prefill_dispatches"] + eng.stats["decode_ticks"]
    assert n > 3
    assert [r["seq"] for r in eng.dispatch_log] == [n - 3, n - 2, n - 1]
    assert "prefill_shapes" not in eng.stats


def test_prefill_records_carry_their_graph_field(params):
    """Every prefill record says how it ran: on the CPU a whole-bucket
    prefill and a chunk are both eager (``graph`` None), and the host
    stamps of a whole-bucket prefill keep their order."""
    eng, _ = _serve(params, [list(range(1, n + 1)) for n in (5, 17, 9)],
                    n_new=4)
    whole = [r for r in eng.dispatch_log if r["kind"] == "prefill"]
    assert len(whole) == eng.stats["prefill_dispatches"] == 2
    for r in whole:
        assert "graph" in r and r["graph"] is None
        assert r["t_start"] <= r["t_forward"] <= r["t_synced"] <= r["t_end"]
    eng, _ = _serve(params, [list(range(1, 14)), list(range(1, 22))],
                    max_batch=2, prefill_chunk=8)
    chunks = [r for r in eng.dispatch_log if r["kind"] == "prefill"]
    assert chunks and all("graph" in r and r["graph"] is None
                          for r in chunks)


def _greedy(params, prompt, n):
    """``n`` greedy tokens by full forwards, no cache."""
    from qqq_tpu_torch.models.llama import forward

    toks = list(prompt)
    for _ in range(n):
        logits, _ = forward(params, CFG, torch.tensor([toks]))
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def test_the_cpu_never_captures_a_prefill(params):
    """Whole-bucket prefills of 4 and 1 rows in bucket 16 and of 2 and 1 in
    bucket 32 run eagerly on the CPU: no prefill graph is captured or
    replayed, none is kept, and the greedy tokens are those of full
    forwards without a cache."""
    rng = np.random.default_rng(7)
    lens = (3, 5, 9, 12, 20, 30, 2, 18)
    prompts = [[int(t) for t in rng.integers(0, 128, n)] for n in lens]
    eng, reqs = _serve(params, prompts, n_new=4, kv_quantized=False)
    st = eng.stats
    assert st["prefill_graph_replays"] == st["prefill_graph_captures"] == 0
    assert st["prefill_graph_capture_s"] == 0.0
    assert not eng._prefill_graphs and not eng._prefill_in
    shapes = {(len(r["rows"]), r["padded"] // len(r["rows"]))
              for r in eng.dispatch_log if r["kind"] == "prefill"}
    assert shapes == {(4, 16), (1, 16), (2, 32), (1, 32)}
    assert [q.output_tokens for q in reqs] == [_greedy(params, p, 4)
                                               for p in prompts]


class _Event:
    """A stand-in for a timing CUDA event that ran at device time ``t``."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)

    def query(self):
        return True


def test_device_spans_place_events_on_the_host_clock(monkeypatch):
    """A device clock 100 s behind the host's; a prefill, then two ticks,
    each handed over before its sync and ending at it; the clock anchored
    at the first sync and again 1.3 s later.  Each start event lands at the
    anchor's host stamp plus the device time between them, whichever came
    first; each gap is the device idle since the previous sync; a record
    waits for its sync; the events go back to the pool once read."""
    from qqq_tpu_torch.utils import profiling

    ds = DeviceSpans(torch.device("cpu"))
    assert ds.mark() is None
    ds.on = True
    anchors = [_Event(-98.3), _Event(-97.0)]
    dev = list(anchors)
    stamps = [1.7, 3.0]
    monkeypatch.setattr(ds, "mark", lambda: dev.pop(0))
    monkeypatch.setattr(profiling.time, "monotonic", lambda: stamps.pop(0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    starts = [_Event(-99.0), _Event(-98.0), _Event(-97.4)]
    recs = [{}, {}, {}]

    def dispatch(i, t_start, t_synced, fill=True):
        if fill:
            ds.fill()  # while the device works: the last record is read
        ds.close(recs[i], starts[i], t_start)
        recs[i]["t_synced"] = t_synced
        ds.synced(t_synced)

    ds.close(recs[0], starts[0], 1.0)
    ds.fill()  # its sync has not returned: it waits
    assert "device_start" not in recs[0]
    recs[0]["t_synced"] = 1.7
    ds.synced(1.7)
    dispatch(1, 2.0, 2.4)
    assert recs[0]["device_start"] == pytest.approx(1.0)
    dispatch(2, 2.6, 3.0, fill=False)  # read later, against the new anchor
    assert "device_start" not in recs[1]
    ds.flush()
    want = [(1.0, 1.7, None), (2.0, 2.4, 0.3), (2.6, 3.0, 0.2)]
    for rec, (a, b, gap) in zip(recs, want):
        assert rec["device_start"] == pytest.approx(a)
        assert rec["device_end"] == pytest.approx(b)
        assert rec.get("gap_before_s") == (None if gap is None
                                           else pytest.approx(gap))
    assert [id(e) for e in ds._pool] == [id(e) for e in (
        starts[0], anchors[0], starts[1], starts[2])]
    assert not dev and not stamps
