"""Port (qqq_tpu_torch) against the JAX package: the slice end to end on a
small per-channel W4A8 Llama over the INT8 slot cache.

Both packages compute from identical bits: the JAX params are RTN-packed by
the JAX package and carried across with ``params_from_numpy``.  The port
runs on the CPU (plain versions), the JAX Pallas kernels in interpret mode.
``max_len`` is a multiple of 128 so that the JAX decode write takes its
Pallas slot kernel.

Tolerances: both sides quantize activations per token, so an f32 difference
in the last bit (other summation orders in rms_norm, RoPE, attention) can
flip one INT8 code and move an output by one quantization step.  A layer's
output (size ~1) is held to 2e-3 absolute; logits (size ~0.05) to 2e-3
absolute.  Greedy tokens must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _quantize_params as jax_rtn
from qqq_tpu.models import ModelConfig as JConfig
from qqq_tpu.models import init_params as jax_init_params
from qqq_tpu.models import llama as JM
from qqq_tpu.serve import kv_cache as jkv
from qqq_tpu.serve.engine import Engine as JEngine
from qqq_tpu.serve.engine import Request as JRequest
from qqq_tpu.serve.engine import generate as jax_generate
from qqq_tpu.serve.sampling import SamplingParams as JSampling
from qqq_tpu.serve.sampling import _topk_topp_filter as jax_filter

from qqq_tpu_torch.models import (
    ModelConfig, params_from_numpy, quantize_params_rtn,
)
from qqq_tpu_torch.models import llama as TM
from qqq_tpu_torch.serve import kv_cache as tkv
from qqq_tpu_torch.serve.engine import Engine, Request, generate
from qqq_tpu_torch.serve.sampling import (
    FILTERED, SamplingParams, _topk_topp_filter, sample_batched,
)

_CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256)
JCFG, TCFG = JConfig(**_CFG), ModelConfig(**_CFG)
MAX_LEN = 128
PROMPT_LENS = (7, 23, 3)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    dense = jax_init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    jparams = jax_rtn(dense, JCFG, group_size=-1)
    tparams = params_from_numpy(_tree_np(jparams), TCFG, device="cpu")
    tdense = params_from_numpy(_tree_np(dense), TCFG, device="cpu")
    return jparams, tparams, tdense


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, 256, size=n)]
            for n in PROMPT_LENS]


def _engine_kw():
    return dict(max_batch=2, max_len=MAX_LEN, prefill_buckets=(16, 64))


def _eos_traffic(prompts, greedy):
    """(prompt, eos) per request: every prompt with request 1's third
    greedy token as EOS (request 1 stops on it, the others run to their
    length unless they meet it), and prompt 0 again with its own first
    greedy token as EOS (an instant EOS: no token survives)."""
    eos = greedy[1][2]
    return [(p, eos) for p in prompts] + [(prompts[0], greedy[0][0])]


@pytest.fixture(scope="module")
def jax_greedy(models, prompts):
    """JAX's greedy tokens, then JAX's Engine on the EOS traffic: its
    requests and its stats."""
    jparams = models[0]
    out = jax_generate(jparams, JCFG, prompts, JSampling(max_new_tokens=5),
                       kv_quantized=True, dtype=jnp.float32, **_engine_kw())
    jeng = JEngine(jparams, JCFG, kv_quantized=True, dtype=jnp.float32,
                   **_engine_kw())
    jreqs = [JRequest(prompt_tokens=p,
                      sampling=JSampling(max_new_tokens=5, eos_token_id=e))
             for p, e in _eos_traffic(prompts, out)]
    jeng.run(jreqs)
    return out, jreqs, jeng.stats


def test_quantize_params_rtn_matches_jax(models):
    jparams, tparams, tdense = models
    mine = quantize_params_rtn(tdense, TCFG)
    for a, b in zip(mine["layers"], tparams["layers"]):
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                     "up_proj", "down_proj"):
            for leaf in ("w_packed", "s_channel"):
                assert torch.equal(a[name][leaf], b[name][leaf]), (name, leaf)


_LLAMA3_SCALING = {"rope_type": "llama3", "factor": 8.0,
                   "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                   "original_max_position_embeddings": 64}


@pytest.mark.parametrize("scaling", [None, _LLAMA3_SCALING,
                                     {"type": "linear", "factor": 4.0}])
def test_rope_matches_jax(scaling):
    """rope_inv_freq (plain, llama3 and linear scaling) and apply_rope at
    positions up to 512.  f32 pow, cos and sin are other implementations on
    the two sides: 1e-6 relative on the frequencies and 1e-6 absolute on
    unit-normal q/k (measured: 0 and 2.4e-7)."""
    cfg = dict(_CFG, rope_scaling=scaling)
    jf = np.asarray(JM.rope_inv_freq(JConfig(**cfg)))
    tf = TM.rope_inv_freq(ModelConfig(**cfg))
    np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-6, atol=0)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, 64)).astype(np.float32)
    pos = rng.integers(0, 512, (2, 5)).astype(np.int32)
    jq, jk = JM.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                           jnp.asarray(jf))
    tq, tk = TM.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(pos), torch.from_numpy(jf.copy()))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-6)


def test_decoder_layer_matches_jax(models):
    jparams, tparams, _ = models
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 256)).astype(np.float32)
    pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    jout, _ = JM.decoder_layer(jparams["layers"][0], jnp.asarray(x),
                               jnp.asarray(pos), JM.rope_inv_freq(JCFG), JCFG)
    tout, _ = TM.decoder_layer(tparams["layers"][0], torch.from_numpy(x),
                               torch.from_numpy(pos), TM.rope_inv_freq(TCFG),
                               TCFG)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=2e-3)


@pytest.mark.parametrize("quantized", [True, False])
def test_forward_prefill_and_decode_logits_match_jax(models, quantized):
    """Prefill 16 tokens into the cache (``forward``), then three
    ``decode_step``s, both sides fed the JAX argmax tokens.  INT8 cache:
    flash path + indexed write, then slot write + decode attention; f32
    cache: the plain attention over the read-back cache."""
    jparams, tparams, _ = models
    B, T = 2, 16
    toks = np.random.default_rng(2).integers(0, 256, (B, T)).astype(np.int32)
    jc = jkv.init(JCFG, B, MAX_LEN, quantized=quantized, dtype=jnp.float32)
    tc = tkv.init(TCFG, B, MAX_LEN, quantized=quantized, dtype=torch.float32,
                  device="cpu")
    clen = np.zeros((B,), np.int32)
    for step in range(4):
        jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
        jcl, tcl = jnp.asarray(clen), torch.from_numpy(clen)
        if step == 0:
            jl, jc = JM.forward(jparams, JCFG, jt, caches=jc, cache_len=jcl)
            tl, tc = TM.forward(tparams, TCFG, tt, caches=tc, cache_len=tcl)
        else:
            jl, jc = JM.decode_step(jparams, JCFG, jt, jc, jcl)
            tl, tc = TM.decode_step(tparams, TCFG, tt, tc, tcl)
        jl = np.asarray(jl)
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=2e-3,
                                   err_msg=f"step {step}")
        clen = clen + toks.shape[1]
        toks = jl.reshape(B, -1, jl.shape[-1])[:, -1].argmax(-1)
        toks = toks.astype(np.int32)[:, None]


def test_generate_greedy_matches_jax(models, prompts, jax_greedy):
    """3 requests over 2 slots (continuous admission), two buckets; both
    engines with their default arguments, so gate/up run GLU-fused."""
    out = generate(models[1], TCFG, prompts, SamplingParams(max_new_tokens=5),
                   dtype=torch.float32, device="cpu", **_engine_kw())
    assert out == jax_greedy[0]


def test_generate_eos_stops_where_jax_stops(models, prompts, jax_greedy):
    """Stop, instant-EOS and length finishes against JAX's Engine on the
    same requests: the tokens, the finish reasons, the count of generated
    tokens (a popped EOS never counts) and which requests have a TTFT (an
    instant EOS has none)."""
    out, jreqs, jstats = jax_greedy
    eng = Engine(models[1], TCFG, dtype=torch.float32, device="cpu",
                 **_engine_kw())
    reqs = [Request(prompt_tokens=p,
                    sampling=SamplingParams(max_new_tokens=5,
                                            eos_token_id=e))
            for p, e in _eos_traffic(prompts, out)]
    eng.run(reqs)
    assert [r.output_tokens for r in reqs] == [r.output_tokens for r in jreqs]
    assert [r.finish_reason for r in reqs] == [r.finish_reason
                                               for r in jreqs]
    assert reqs[1].finish_reason == "stop" and len(reqs[1].output_tokens) == 2
    assert reqs[3].finish_reason == "stop" and reqs[3].output_tokens == []
    assert "length" in [r.finish_reason for r in reqs]
    assert eng.stats["generated_tokens"] == jstats["generated_tokens"] \
        == sum(len(r.output_tokens) for r in reqs)
    assert [r.ttft is None for r in reqs] == [r.ttft is None for r in jreqs]
    assert reqs[3].ttft is None and reqs[0].ttft is not None
    assert eng.stats["prefill_dispatches"] >= 2


@pytest.mark.parametrize("scratch_mb,expect", [(None, 8), ("1", 1),
                                               ("3", 5)])
def test_prefill_batch_follows_scratch_budget_like_jax(
        models, monkeypatch, scratch_mb, expect):
    """QQQ_TPU_PREFILL_SCRATCH_MB (default 1536) caps the admission
    group, read at construction as JAX's Engine reads it: a row of the
    1024-token bucket needs 2 layers x 2 kv heads x 1024 x 2 x (64 + 4)
    bytes = 0.53 MiB of INT8 scratch, so 1 MiB admits one row, 3 MiB five,
    the default the cap of eight."""
    if scratch_mb is None:
        monkeypatch.delenv("QQQ_TPU_PREFILL_SCRATCH_MB", raising=False)
    else:
        monkeypatch.setenv("QQQ_TPU_PREFILL_SCRATCH_MB", scratch_mb)
    kw = dict(max_batch=2, max_len=1024, prefill_buckets=(16, 1024))
    jeng = JEngine(models[0], JCFG, kv_quantized=True, dtype=jnp.float32,
                   **kw)
    eng = Engine(models[1], TCFG, dtype=torch.float32, device="cpu", **kw)
    assert eng.prefill_batch == jeng.prefill_batch == expect


def test_engine_later_slice_features_raise(models):
    """The paged pool and the per-request sampling extras are ported; the
    prefix cache, chunked prefill in slot mode and speculative decoding
    are not."""
    with pytest.raises(NotImplementedError, match="prefix_cache"):
        Engine(models[1], TCFG, paged=True, prefix_cache=True, device="cpu")
    with pytest.raises(NotImplementedError, match="slot mode"):
        Engine(models[1], TCFG, prefill_chunk=64, device="cpu")
    with pytest.raises(NotImplementedError, match="spec_ngram"):
        Engine(models[1], TCFG, spec_ngram=2, device="cpu")
    eng = Engine(models[1], TCFG, device="cpu", **_engine_kw())
    req = Request([1, 2], SamplingParams(repetition_penalty=1.2,
                                         max_new_tokens=2))
    eng.run([req])  # served, no longer refused
    assert req.done and len(req.output_tokens) == 2


def test_sampling_filter_matches_jax():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((4, 64)) * 2).astype(np.float32)
    top_k = np.array([0, 5, 0, 3], np.int32)
    top_p = np.array([1.0, 1.0, 0.7, 0.9], np.float32)
    min_p = np.array([0.0, 0.0, 0.0, 0.1], np.float32)
    ref = np.asarray(jax_filter(*(jnp.asarray(a) for a in
                                  (logits, top_k, top_p, min_p))))
    out = _topk_topp_filter(*(torch.from_numpy(a) for a in
                              (logits, top_k, top_p, min_p)))
    assert np.array_equal(np.isinf(out.numpy()), np.isinf(ref))
    fin = np.isfinite(ref)
    assert np.array_equal(out.numpy()[fin], ref[fin])

    gen = torch.Generator().manual_seed(0)
    tl = torch.from_numpy(logits)
    tok = sample_batched(tl, gen, torch.tensor([0.0, 0.8, 0.8, 1.0]),
                         torch.tensor([0, 1, 0, 0]), torch.ones(4),
                         branch=FILTERED)
    assert tok[0] == tl[0].argmax() and tok[1] == tl[1].argmax()
    assert 0 <= int(tok[2]) < 64 and 0 <= int(tok[3]) < 64
