"""The comparison that decides ``correct``, driven through a whole toy run
on the CPU (the harness's look for a card skipped): sound, it passes; with
the timed path broken underneath, it fails, once for each fault a served
cell can have on one chip."""

import pytest
import torch

import run
from toy import toy_bench, toy_cell

SEED = 2**31 + 99


def _run(loop="closed", seconds=2.0):
    return run.run_cell(toy_cell(loop, limit=0.05), toy_bench(), SEED,
                        seconds, False, torch.device("cpu"), torch.float32)


def _kv_unchanged(monkeypatch):
    """A step that returns its state unchanged: no K/V is ever written."""
    from qqq_tpu_torch.serve import kv_cache, paged_kv
    monkeypatch.setattr(kv_cache, "write", lambda cache, *a, **k: cache)
    monkeypatch.setattr(paged_kv, "write", lambda cache, *a, **k: cache)


def _half_batch(monkeypatch):
    """Half of the batch left out: a batched forward (a decode step or a
    prefill dispatch) computes the first half of its rows and hands the
    second half the first half's results."""
    from qqq_tpu_torch.models import llama as M
    orig = M.forward

    def forward(params, config, tokens, **kw):
        out, caches = orig(params, config, tokens, **kw)
        B = tokens.shape[0]
        if B > 1:
            h = B // 2
            out = torch.cat([out[:B - h], out[:h]])
        return out, caches
    monkeypatch.setattr(M, "forward", forward)


def _token_altered(monkeypatch):
    """A token altered where it is produced: the sampler's choice + 1."""
    from qqq_tpu_torch.serve import engine
    orig = engine.sample_batched

    def sample(logits, *a, **k):
        return (orig(logits, *a, **k) + 1) % logits.shape[-1]
    monkeypatch.setattr(engine, "sample_batched", sample)


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_sound_run_is_correct(loop):
    out = _run(loop)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [_kv_unchanged, _half_batch,
                                   _token_altered])
@pytest.mark.parametrize("loop", ["closed", "open"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault, loop):
    fault(monkeypatch)
    out = _run(loop)
    assert not out["correct"], out["checks"]
    assert out["checks"]["max_gap_nats"]["value"] > 0.05
