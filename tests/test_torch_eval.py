"""Port (qqq_tpu_torch) against the JAX package: evaluation
(utils/eval.py: perplexity, log-likelihood scoring), cli/eval, the
zero-shot harness (cli/zeroshot.py), utils/profiling and the host INT4
packer (native/).

A toy model from a JAX seed, RTN-quantized by JAX (``__graft_entry__.
_quantize_params``) and converted bit for bit (``params_from_numpy``), so
both packages score the same weights: dense f32, per channel and g128.
The JAX forward runs its Pallas kernels in interpret mode, the port its
plain versions on the CPU.  Tolerances:

* dense f32: both forwards are f32 with sums in other orders; perplexity
  and log-likelihoods within 1e-5 relative (measured: 1.5e-6 and 9e-8);
* W4A8 (per channel, g128): the forwards' logits agree to 2e-3 absolute
  (tests/test_torch_model.py), since one activation code flipped at a
  rounding boundary moves an output by a quantization step; summed over a
  window, 2e-3 relative on perplexity and on each log-likelihood (1e-3
  absolute for the near-zero ones; measured: perplexity equal, a
  log-likelihood up to 7.5e-5 relative);
* greedy flags, formatting, packing, the CLI's perplexity against the
  library's on the same tokens, StageTimer's text: equal.

Scoring batches take JAX's fixed shape: B·T = 8·64 = 512 rows in a bucket
of 64 and 8 windows of 64 tokens, which sends every W4A8 linear of the g128
model to the requant route (M ≥ 512), as in JAX.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _quantize_params as jax_rtn
from qqq_tpu.cli import zeroshot as jzs
from qqq_tpu.models import ModelConfig as JConfig
from qqq_tpu.models import init_params as jax_init_params
from qqq_tpu.models import loader as jloader
from qqq_tpu.native import build as jnative
from qqq_tpu.utils import eval as jev
from qqq_tpu.utils import profiling as jprof

from qqq_tpu_torch.cli import eval as tcli
from qqq_tpu_torch.cli import zeroshot as tzs
from qqq_tpu_torch.core.packing import pack_int4
from qqq_tpu_torch.models import ModelConfig, params_from_numpy
from qqq_tpu_torch.models import loader as tloader
from qqq_tpu_torch.native import build as tnative
from qqq_tpu_torch.utils import StageTimer, device_trace
from qqq_tpu_torch.utils import eval as tev

from test_zeroshot_format import (
    ARC_DOC, HELLASWAG_DOC, PIQA_DOC, WINOGRANDE_DOC,
)

_CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256)
JCFG, TCFG = JConfig(**_CFG), ModelConfig(**_CFG)
SCHEMES = {"dense": None, "channel": -1, "g128": 128}
#: (rtol, atol) of log-likelihoods and perplexity, by scheme (see above)
TOL = {"dense": (1e-5, 1e-5), "channel": (2e-3, 1e-3), "g128": (2e-3, 1e-3)}


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    dense = jax_init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    out = {}
    for name, gs in SCHEMES.items():
        jp = dense if gs is None else jax_rtn(dense, JCFG, group_size=gs)
        out[name] = (jp, params_from_numpy(_tree_np(jp), TCFG, device="cpu"))
    return out


def _pairs(rng, n, max_ctx=40, max_cont=6):
    return [([int(t) for t in rng.integers(0, 256, rng.integers(2, max_ctx))],
             [int(t) for t in rng.integers(0, 256, rng.integers(1, max_cont))])
            for _ in range(n)]


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_perplexity_matches_jax(models, scheme):
    """8 windows of 64 tokens in one batch (M = 512: the requant route for
    g128), then 3 windows of 16 one at a time (M = 16: the exact route)."""
    jp, tp = models[scheme]
    rtol, _ = TOL[scheme]
    tokens = np.random.default_rng(1).integers(0, 256, 64 * 9).astype(np.int32)
    for kw in (dict(seqlen=64, batch=8, max_windows=8),
               dict(seqlen=16, max_windows=3)):
        want = jev.perplexity(jp, JCFG, tokens, **kw)
        got = tev.perplexity(tp, TCFG, tokens, **kw)
        assert got == pytest.approx(want, rel=rtol)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_loglikelihood_matches_jax(models, scheme):
    """One pair alone (a batch of 8 rows, 7 of them padding) and a batch of
    pairs in buckets of 16 and 64 (8 × 64 = 512 rows: requant for g128),
    one pair past the last bucket (left-truncated): log-likelihoods and
    greedy flags."""
    jp, tp = models[scheme]
    rtol, atol = TOL[scheme]
    rng = np.random.default_rng(2)
    ctx, cont = _pairs(rng, 1)[0]
    want = jev.loglikelihood(jp, JCFG, ctx, cont)
    got = tev.loglikelihood(tp, TCFG, ctx, cont)
    assert got[0] == pytest.approx(want[0], rel=rtol, abs=atol)
    assert got[1] == want[1]
    pairs = _pairs(rng, 11) + [(list(range(70)), [5, 6, 7])]
    kw = dict(batch_size=8, buckets=(16, 64))
    want = jev.loglikelihood_batch(jp, JCFG, pairs, **kw)
    got = tev.loglikelihood_batch(tp, TCFG, pairs, **kw)
    for (g_ll, g_gr), (w_ll, w_gr) in zip(got, want):
        assert g_ll == pytest.approx(w_ll, rel=rtol, abs=atol)
        assert g_gr == w_gr


def test_uniform_model_ppl_is_vocab():
    """All weights zero: constant logits, a uniform distribution, ppl =
    V."""
    from qqq_tpu_torch.models import init_params

    params = init_params(TCFG, torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")

    def zero(t):
        if isinstance(t, dict):
            return {k: zero(v) for k, v in t.items()}
        if isinstance(t, list):
            return [zero(v) for v in t]
        return None if t is None else torch.zeros_like(t)

    tokens = np.random.default_rng(0).integers(0, 256, 16 * 8).astype(np.int32)
    ppl = tev.perplexity(zero(params), TCFG, tokens, seqlen=16)
    assert ppl == pytest.approx(256.0, rel=1e-5)


def test_loglikelihood_additivity_and_batch_equals_single(models):
    """ll(ctx, a + b) = ll(ctx, a) + ll(ctx + a, b); the bucketed, padded
    batch equals scoring each pair alone (dense f32)."""
    _, tp = models["dense"]
    rng = np.random.default_rng(4)
    ctx, a, b = ([int(t) for t in rng.integers(0, 256, n)] for n in (5, 3, 2))
    ll_ab, _ = tev.loglikelihood(tp, TCFG, ctx, a + b)
    ll_a, _ = tev.loglikelihood(tp, TCFG, ctx, a)
    ll_b, _ = tev.loglikelihood(tp, TCFG, ctx + a, b)
    assert ll_ab == pytest.approx(ll_a + ll_b, rel=1e-5, abs=1e-5)
    pairs = _pairs(rng, 5, max_ctx=20)
    batched = tev.loglikelihood_batch(tp, TCFG, pairs, batch_size=2,
                                      buckets=(16, 32))
    for (c, t), (ll, greedy) in zip(pairs, batched):
        ll_s, greedy_s = tev.loglikelihood(tp, TCFG, c, t)
        assert ll == pytest.approx(ll_s, rel=1e-5, abs=1e-5)
        assert greedy == greedy_s


# ---------------------------------------------------------------------------
# zero-shot formatting and the task runner


@pytest.mark.parametrize("task,doc", [
    ("piqa", PIQA_DOC), ("arc_easy", ARC_DOC), ("arc_challenge", ARC_DOC),
    ("hellaswag", HELLASWAG_DOC), ("winogrande", WINOGRANDE_DOC),
])
def test_zeroshot_formatting_matches_jax(task, doc):
    """The docs of tests/test_zeroshot_format.py: requests, the few-shot
    rendering and the lm_eval 0.4.2 constants equal JAX's."""
    assert tzs.doc_requests(task, doc) == jzs.doc_requests(task, doc)
    assert tzs.example_text(task, doc) == jzs.example_text(task, doc)
    assert (tzs.TASKS, tzs.TARGET_DELIMITER, tzs.FEWSHOT_DELIMITER,
            tzs.FEWSHOT_SEED) == (jzs.TASKS, jzs.TARGET_DELIMITER,
                                  jzs.FEWSHOT_DELIMITER, jzs.FEWSHOT_SEED)
    text = doc.get("ctx", doc.get("goal", doc.get("sentence", "")))
    for s in (text, " [title] A [b] c  d ", "x [header] y [title]"):
        assert tzs.hellaswag_preprocess(s) == jzs.hellaswag_preprocess(s)
    bad = dict(ARC_DOC, answerKey="Z")
    assert tzs.doc_requests("arc_easy", bad) is None
    with pytest.raises(ValueError):
        tzs.doc_requests("boolq", doc)


def test_fewshot_sampler_matches_jax():
    train = [dict(PIQA_DOC, goal=f"goal {i}", label=i % 2) for i in range(9)]
    mine, theirs = tzs.FewshotSampler(train), jzs.FewshotSampler(train)
    for k, doc in ((2, train[0]), (3, None), (0, None), (4, train[5])):
        assert mine.context("piqa", k, doc) == theirs.context("piqa", k, doc)


def _fake_raw(name, limit, split="validation"):
    n = 6 if split == "train" else 3
    return [{"goal": f"[{split} q{i}]", "sol1": f"a{i}", "sol2": f"b{i}",
             "label": i % 2} for i in range(n)]


class _FakeTok:
    """Byte-level stand-in tokenizer (no tokenizer files in the repo)."""

    def __call__(self, text, add_special_tokens=True):
        class R:
            input_ids = [b % 120 for b in text.encode()] or [1]
        return R()


def _fake_scorer(seen):
    def score(params, config, pairs, **kw):
        seen.extend(len(c) for c, _ in pairs)
        return [(-0.01 * len(c) - 0.1 * sum(t) % 7, len(t) == 1)
                for c, t in pairs]
    return score


def test_run_tasks_matches_jax(models, monkeypatch):
    """run_tasks with a fake loader, tokenizer and scorer (after
    tests/test_data_eval.py:158): the few-shot prefix lengthens every
    context, and the results (acc, acc_norm) equal JAX's run_tasks on the
    same fakes."""
    import transformers

    from qqq_tpu.utils import eval as jev_mod
    from qqq_tpu_torch.utils import eval as tev_mod

    monkeypatch.setattr(tzs, "_load_raw", _fake_raw)
    monkeypatch.setattr(jzs, "_load_raw", _fake_raw)
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        classmethod(lambda cls, *a, **k: _FakeTok()))
    seen, jseen = [], []
    monkeypatch.setattr(tev_mod, "loglikelihood_batch", _fake_scorer(seen))
    monkeypatch.setattr(jev_mod, "loglikelihood_batch", _fake_scorer(jseen))
    jp, tp = models["dense"]
    for k in (0, 2):
        got = tzs.run_tasks(tp, TCFG, "unused", ["piqa", " piqa"],
                            num_fewshot=k)
        want = jzs.run_tasks(jp, JCFG, "unused", ["piqa", " piqa"],
                             num_fewshot=k)
        assert got == want and set(got) == {"piqa_acc", "piqa_acc_norm"}
        assert seen == jseen
        if k == 0:
            zero_len = max(seen)
        seen.clear()
        jseen.clear()
    got = tzs.run_tasks(tp, TCFG, "unused", ["piqa"], num_fewshot=2)
    assert min(seen) > zero_len  # every context carries the prefix


# ---------------------------------------------------------------------------
# cli/eval


def test_eval_cli_on_a_saved_checkpoint(models, tmp_path, capsys):
    """``main([... --device cpu --eval_ppl --allow_synthetic --max_windows
    2])`` on the g128 checkpoint the port saved: its perplexity equals the
    library's on the loader's tokens and JAX's on the checkpoint JAX reads
    back; the synthetic corpus is named outright, so that no loader tries a
    download."""
    _, tp = models["g128"]
    path = str(tmp_path / "tiny_g128")
    tloader.save_quantized(path, tp, TCFG, {"quant_method": "qqq",
                                            "wbits": 4, "group_size": 128})
    res = tcli.main(["--model_path", path, "--eval_ppl", "--allow_synthetic",
                     "--ppl_dataset", "synthetic", "--max_windows", "2",
                     "--max_length", "64", "--dtype", "float32",
                     "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == res
    assert res["synthetic_windows"] == 2
    assert res["synthetic_nll_per_token"] == pytest.approx(
        np.log(res["synthetic_ppl"]), rel=1e-4)
    assert res["synthetic_seconds_per_window"] > 0
    from qqq_tpu.utils.data import get_loaders

    _, tokens = get_loaders("synthetic", seqlen=64, vocab_size=256)
    params, config = tcli.load_any(path, torch.float32, device="cpu")
    direct = tev.perplexity(params, config, tokens, seqlen=64, max_windows=2)
    assert res["synthetic_ppl"] == round(direct, 4)
    jp, jc, _ = jloader.load_quantized(path, dtype=jnp.float32)
    want = jev.perplexity(jp, jc, tokens, seqlen=64, max_windows=2)
    assert direct == pytest.approx(want, rel=TOL["g128"][0])


def test_eval_cli_flags_match_jax(monkeypatch):
    """Every flag of JAX's parser, with its default, plus ``--device``
    (default: the card)."""
    import sys

    from qqq_tpu.cli import eval as jcli

    monkeypatch.setattr(sys, "argv", ["eval", "--model_path", "m"])
    want = vars(jcli.parse_args())
    got = vars(tcli.parse_args(["--model_path", "m"]))
    assert got.pop("device") == "cuda"
    assert got == want


# ---------------------------------------------------------------------------
# utils/profiling


def test_stage_timer_report_matches_jax():
    """The same totals and counts give JAX's report text; a stage fenced on
    a CPU tensor is timed without a card."""
    mine, theirs = StageTimer(), jprof.StageTimer()
    for t in (mine, theirs):
        t.totals.update({"gptq": 12.5, "hessian": 3.25, "rotate": 0.5})
        t.counts.update({"gptq": 32, "hessian": 32, "rotate": 1})
    assert mine.report() == theirs.report()
    assert mine.report().splitlines()[1].split()[0] == "gptq"
    with mine.stage("replay", fence={"x": [torch.ones(3)]}):
        pass
    assert mine.counts["replay"] == 1 and mine.totals["replay"] >= 0


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(d, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


# ---------------------------------------------------------------------------
# native/: the host INT4 packer


def test_pack_int4_host_matches_jax_and_core():
    """Bit-equal to JAX's host packer and to the port's core/packing
    pack_int4, native and through the NumPy twin; unpacking inverts it."""
    q = np.random.default_rng(0).integers(-8, 8, (512, 384)).astype(np.int8)
    packed = tnative.pack_int4_host(q)
    assert tnative.load_native() is not None  # a C compiler is here
    np.testing.assert_array_equal(packed, jnative.pack_int4_host(q))
    np.testing.assert_array_equal(packed, pack_int4(torch.from_numpy(q)).numpy())
    np.testing.assert_array_equal(tnative._pack_int4_numpy(q), packed)
    np.testing.assert_array_equal(tnative.unpack_int4_host(packed), q)
    np.testing.assert_array_equal(tnative._unpack_int4_numpy(packed), q)
    np.testing.assert_array_equal(jnative.unpack_int4_host(packed), q)
    with pytest.raises(ValueError):
        tnative.pack_int4_host(np.full((128, 4), 8, np.int8))


def test_native_build_fallback_and_failure(monkeypatch, tmp_path):
    """No C compiler: the NumPy twin.  A compiler that fails: an error,
    not a silent fallback."""
    q = np.random.default_rng(1).integers(-8, 8, (256, 16)).astype(np.int8)
    want = tnative._pack_int4_numpy(q)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "_compiler", lambda: None)
    np.testing.assert_array_equal(tnative.pack_int4_host(q), want)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "_compiler", lambda: "false")
    with pytest.raises(RuntimeError, match="INT4 packer"):
        tnative.load_native()
