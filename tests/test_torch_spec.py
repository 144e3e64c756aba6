"""Port (qqq_tpu_torch) against the JAX package: prompt-lookup speculative
decoding (``Engine(spec_ngram=n, spec_k=k)``), slot and paged.

The JAX engine tests' toy model (tests/test_engine.py, dense f32 weights
from ``PRNGKey(0)``) goes to both packages with the same bits; prompts come
from a numpy seed.  The port runs its plain versions on the CPU (the
verify's forward over the slot cache read as a pool of max_len-token
blocks), the JAX engine its Pallas kernels in interpret mode.  Tolerances:
greedy tokens, finish reasons and the schedulers' counts (drafted and
accepted tokens among them) equal; top-N ids equal and their logprobs
within 1e-4; a seeded sampled row's tokens byte-identical with speculation
on and off (the port's own seeded noise, not JAX's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qqq_tpu.models import ModelConfig as JConfig
from qqq_tpu.models import init_params as jax_init_params
from qqq_tpu.serve.engine import Engine as JEngine
from qqq_tpu.serve.engine import Request as JRequest
from qqq_tpu.serve.sampling import SamplingParams as JSampling

from qqq_tpu_torch.models import ModelConfig, params_from_numpy
from qqq_tpu_torch.serve.engine import Engine, Request
from qqq_tpu_torch.serve.sampling import SamplingParams

_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
JCFG, TCFG = JConfig(**_CFG), ModelConfig(**_CFG)
STATS = ("prefills", "prefill_chunks", "prefill_tokens", "decode_ticks",
         "prefix_hits", "prefix_tokens_reused", "spec_drafted",
         "spec_accepted", "preemptions")
SPEC = dict(spec_ngram=2, spec_k=4)


@pytest.fixture(scope="module")
def params():
    jparams = jax_init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      TCFG, device="cpu")


def _toks(rng, n):
    return [int(t) for t in rng.integers(0, 128, size=n)]


def _both(params, prompts, sps, stats=True, **kw):
    """Serve ``prompts`` (request i with SamplingParams(**sps[i])) through
    the JAX engine and the port's, both built with ``kw``; greedy rows'
    tokens, every finish reason and, with ``stats``, the schedulers' counts
    equal.  Returns both engines and both request lists."""
    jeng = JEngine(params[0], JCFG, dtype=jnp.float32, **kw)
    eng = Engine(params[1], TCFG, dtype=torch.float32, device="cpu", **kw)
    jreqs = [JRequest(prompt_tokens=p, sampling=JSampling(**sp))
             for p, sp in zip(prompts, sps)]
    reqs = [Request(p, SamplingParams(**sp)) for p, sp in zip(prompts, sps)]
    jeng.run(jreqs)
    eng.run(reqs)
    for r, jr, sp in zip(reqs, jreqs, sps):
        if sp.get("temperature", 0.0) == 0.0:
            assert r.output_tokens == jr.output_tokens
            assert r.finish_reason == jr.finish_reason
    if stats:
        chunked = ("prefill_dispatches",) if kw.get("prefill_chunk") \
            or kw.get("paged") else ()
        for k in STATS + chunked:
            assert eng.stats[k] == jeng.stats[k], k
    return jeng, eng, jreqs, reqs


def test_spec_greedy_matches_jax(params, monkeypatch):
    """JAX :490: greedy rows, 32 new tokens, drafts accepted, fewer ticks
    than one token a tick; one row also reports its top 2 logprobs per
    token (each verify position's own), one carries a repetition penalty
    (it never drafts: its position 0 takes the penalty).  The CPU engine
    builds no CUDA graph."""
    def no_graph(*a, **k):
        raise AssertionError("a CPU engine built a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    rng = np.random.default_rng(11)
    prompts = [_toks(rng, n) for n in (6, 11, 9)]
    sps = [dict(max_new_tokens=32), dict(max_new_tokens=32, top_logprobs=2),
           dict(max_new_tokens=32, repetition_penalty=1.3)]
    jeng, eng, jreqs, reqs = _both(
        params, prompts, sps, max_batch=4, max_len=128, kv_quantized=False,
        prefill_buckets=(16,), **SPEC)
    assert eng.stats["spec_accepted"] > 0
    assert eng.stats["decode_ticks"] < 2 * 32
    assert eng.stats["graph_captures"] == eng.stats["graph_replays"] == 0
    r, jr = reqs[1], jreqs[1]
    assert len(r.top_logprobs) == len(r.output_tokens) == 32
    assert [[t for t, _ in row] for row in r.top_logprobs] == \
        [[t for t, _ in row] for row in jr.top_logprobs]
    np.testing.assert_allclose(
        [[v for _, v in row] for row in r.top_logprobs],
        [[v for _, v in row] for row in jr.top_logprobs], atol=1e-4)
    np.testing.assert_allclose(r.token_logprobs, jr.token_logprobs,
                               atol=1e-4)


def test_spec_sampled_beside_greedy_with_eos(params):
    """JAX :514: a sampled row (temperature 0.9, top-k 20) drafts and
    verifies beside a greedy row whose EOS falls inside an accepted run;
    the greedy row stops exactly where JAX's does.  The sampled row draws
    the port's noise, so the counts are not JAX's."""
    rng = np.random.default_rng(12)
    p1, p2 = _toks(rng, 5), _toks(rng, 8)
    ref = Engine(params[1], TCFG, dtype=torch.float32, device="cpu",
                 max_batch=1, max_len=128, kv_quantized=False,
                 prefill_buckets=(16,))
    probe = Request(p1, SamplingParams(max_new_tokens=24))
    ref.run([probe])
    sps = [dict(max_new_tokens=24, eos_token_id=probe.output_tokens[15]),
           dict(max_new_tokens=10, temperature=0.9, top_k=20)]
    _, eng, _, reqs = _both(params, [p1, p2], sps, stats=False, max_batch=2,
                            max_len=128, kv_quantized=False,
                            prefill_buckets=(16,), **SPEC)
    assert reqs[0].output_tokens == probe.output_tokens[:15]
    assert reqs[0].finish_reason == "stop"
    assert len(reqs[1].output_tokens) == 10
    assert eng.stats["spec_drafted"] > 0


def test_spec_with_chunked_prefill_near_max_len(params):
    """JAX :594: a 31-token prompt chunk-prefills into a 32-token cache
    beside a decoding row; ticks whose verify would write past the cache
    take the plain path."""
    rng = np.random.default_rng(13)
    _both(params, [_toks(rng, 4), _toks(rng, 31)],
          [dict(max_new_tokens=12), dict(max_new_tokens=1)], max_batch=2,
          max_len=32, kv_quantized=False, prefill_chunk=8, spec_ngram=2,
          spec_k=8)


@pytest.mark.parametrize("ngram, steps, most_ticks", [(2, 4, 31), (24, 3, 5)])
def test_spec_falls_back_to_the_multistep_tick(params, ngram, steps,
                                               most_ticks):
    """JAX :1203 and :1221: with ``steps_per_tick`` > 1 a tick where no
    row drafts runs the fused multi-step tick; an n-gram longer than any
    repeat never drafts at all (every tick takes the plain path)."""
    rng = np.random.default_rng(14)
    n_new = 32 if ngram == 2 else 12
    _, eng, _, _ = _both(params, [_toks(rng, 7 if ngram == 2 else 9)],
                         [dict(max_new_tokens=n_new)], max_batch=1,
                         max_len=128, kv_quantized=False,
                         prefill_buckets=(16,), spec_ngram=ngram, spec_k=4,
                         steps_per_tick=steps)
    assert eng.stats["decode_ticks"] <= most_ticks
    if ngram == 24:
        assert eng.stats["spec_drafted"] == eng.stats["spec_ticks"] == 0


def test_paged_spec_under_preemption(params):
    """Paged speculation over a pool too small for the traffic (12 usable
    blocks of 8 against prompts of 6/19/38/56 tokens), INT8 KV, prefix
    cache on: every tick reserves 1 + k positions, drafts are verified
    through the block tables, requests are preempted and resumed, and the
    pool is whole after the run."""
    rng = np.random.default_rng(15)
    prompts = [_toks(rng, n) for n in (6, 19, 38, 56)]
    prompts[0] = prompts[0] + prompts[0][:4] + prompts[0]  # repeats: drafts
    jeng, eng, _, _ = _both(
        params, prompts, [dict(max_new_tokens=12)] * 4, max_batch=4,
        max_len=128, kv_quantized=True, paged=True, block_size=8,
        prefill_chunk=32, prefill_batch=2, num_blocks=13,
        prefix_cache=True, **SPEC)
    assert eng.stats["preemptions"] > 0
    assert eng.stats["spec_drafted"] > 0
    assert (eng.allocators[0].available + len(eng._bh_lru[0])
            == eng.num_blocks - 1)


@pytest.mark.parametrize("mode", ["slot", "paged"])
def test_seeded_rows_identical_with_and_without_spec(params, mode):
    """A seeded sampled row's j-th verified position draws the noise of
    generation index ngen + j, so its tokens are byte-identical with
    speculation on and off, beside greedy and unseeded rows."""
    rng = np.random.default_rng(16)
    base = _toks(rng, 6)
    prompts = [base * 3, _toks(rng, 10), base + base[:3]]
    sps = [SamplingParams(max_new_tokens=20, temperature=0.8, seed=7),
           SamplingParams(max_new_tokens=20),
           SamplingParams(max_new_tokens=20, temperature=1.2, top_p=0.9,
                          seed=3)]
    kw = dict(max_batch=4, max_len=128, kv_quantized=False)
    if mode == "paged":
        kw.update(paged=True, block_size=8)

    def run(**extra):
        eng = Engine(params[1], TCFG, dtype=torch.float32, device="cpu",
                     **kw, **extra)
        reqs = [Request(p, sp) for p, sp in zip(prompts, sps)]
        eng.run(reqs)
        return eng, [r.output_tokens for r in reqs]

    _, plain = run()
    eng, spec = run(**SPEC)
    assert eng.stats["spec_accepted"] > 0
    assert spec == plain
