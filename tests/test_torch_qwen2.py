"""Port (qqq_tpu_torch) against the JAX package on a Qwen2-shaped model:
``model_type="qwen2"``, q/k/v biases (``attention_bias``), the lm_head tied
to the embedding (``tie_word_embeddings``), hd 64 and GQA (4 heads over 2
kv heads), two layers at toy width, per channel, g128 and dense.

The dense params, their q/k/v biases included (JAX's ``init_params``
zeroes those), are drawn with numpy; the port RTN-packs them (bit for bit
as the JAX package does: ``test_torch_model.py``, ``test_torch_g128.py``),
and each scheme's numpy tree goes to JAX as it is and to the port through
the converter (``params_from_numpy``).  The port runs on the CPU (plain
versions), the JAX Pallas kernels in interpret mode.

Tolerances: forward and decode logits within a share of the largest
|logit| (LOGIT_TOL), stated per scheme: per channel 1e-5 (integer GEMMs,
the same f32 multiplies in one order on both sides: measured 7e-7); g128
5e-3 (the exact route's f32 group sum is not bit-equal between the
packages: XLA may fuse a multiply and an add where PyTorch rounds each, as
``test_torch_g128.py`` notes; from the first decode step on, one flipped
INT8 activation code moves a batch row's logits by one quantization step:
measured 3.0e-3, at the prefill step 7e-7); dense 2e-4 (f32 GEMMs summed in other orders on each side, so a
few INT8 KV codes flip: measured 9.5e-5).  Greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qqq_tpu.models import ModelConfig as JConfig
from qqq_tpu.models import llama as JM
from qqq_tpu.serve import kv_cache as jkv
from qqq_tpu.serve.engine import generate as jax_generate
from qqq_tpu.serve.sampling import SamplingParams as JSampling

from qqq_tpu_torch.models import (
    ModelConfig, params_from_numpy, quantize_params_rtn,
)
from qqq_tpu_torch.models import llama as TM
from qqq_tpu_torch.serve import kv_cache as tkv
from qqq_tpu_torch.serve.engine import generate
from qqq_tpu_torch.serve.sampling import SamplingParams

_CFG = dict(model_type="qwen2", vocab_size=256, hidden_size=256,
            intermediate_size=512, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64,
            attention_bias=True, tie_word_embeddings=True,
            rms_norm_eps=1e-6, rope_theta=1e6, max_position_embeddings=512)
JCFG, TCFG = JConfig(**_CFG), ModelConfig(**_CFG)
MAX_LEN = 128
LOGIT_TOL = {"per-channel": 1e-5, "g128": 5e-3, "dense": 2e-4}  # × max|l|
SCHEMES = tuple(LOGIT_TOL)
_ENGINE = dict(max_batch=2, max_len=MAX_LEN, prefill_buckets=(16,))


def _dense_np(rng):
    """The dense f32 params tree (the JAX package's layout) from ``rng``:
    weights N(0, 0.02²), norms near 1, q/k/v biases N(0, 0.2²), no
    lm_head (tied)."""
    H, I, V = TCFG.hidden_size, TCFG.intermediate_size, TCFG.vocab_size
    qd, kvd = TCFG.q_dim, TCFG.kv_dim

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def lin(k, n, bias=False):
        return {"w": normal((k, n), 0.02),
                **({"b": normal((n,), 0.2)} if bias else {})}

    layers = [{"input_layernorm": 1 + normal((H,), 0.1),
               "q_proj": lin(H, qd, True), "k_proj": lin(H, kvd, True),
               "v_proj": lin(H, kvd, True), "o_proj": lin(qd, H),
               "post_attention_layernorm": 1 + normal((H,), 0.1),
               "gate_proj": lin(H, I), "up_proj": lin(H, I),
               "down_proj": lin(I, H)}
              for _ in range(TCFG.num_hidden_layers)]
    return {"embed": normal((V, H), 0.02), "layers": layers,
            "norm": 1 + normal((H,), 0.1), "lm_head": None}


def _np_tree(tree):
    """Port params → numpy with the same bits (bf16 as ml_dtypes')."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    if tree is None:
        return None
    if tree.dtype == torch.bfloat16:
        return tree.view(torch.int16).numpy().view(jnp.bfloat16)
    return tree.numpy()


@pytest.fixture(scope="module")
def models():
    """Scheme → (JAX params, port params) of one numpy-drawn model."""
    dense = _dense_np(np.random.default_rng(7))
    tdense = params_from_numpy(dense, TCFG, device="cpu")
    trees = {"dense": dense}
    for scheme, gs in (("per-channel", -1), ("g128", 128)):
        trees[scheme] = _np_tree(quantize_params_rtn(tdense, TCFG,
                                                     group_size=gs))
    return {k: (jax.tree.map(jnp.asarray, t),
                params_from_numpy(t, TCFG, device="cpu"))
            for k, t in trees.items()}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, 256, size=n)] for n in (7, 12, 3)]


@pytest.fixture(scope="module")
def jax_greedy(models, prompts):
    """JAX's default engine (gate/up GLU-fused) on the g128 model."""
    return jax_generate(models["g128"][0], JCFG, prompts,
                        JSampling(max_new_tokens=5), kv_quantized=True,
                        dtype=jnp.float32, **_ENGINE)


def test_params_carry_the_biases_and_tie_the_head(models):
    """Every q/k/v linear of every scheme keeps its nonzero bias, bit for
    bit on both sides; no lm_head is stored."""
    for jparams, tparams in models.values():
        assert tparams["lm_head"] is None
        for lj, lt in zip(jparams["layers"], tparams["layers"]):
            for name in ("q_proj", "k_proj", "v_proj"):
                b = lt[name]["b"]
                assert b.abs().min() > 0
                assert np.array_equal(b.numpy(), np.asarray(lj[name]["b"]))
            assert "b" not in lt["o_proj"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_forward_and_decode_logits_match_jax(models, scheme):
    """Prefill 16 tokens into the INT8 slot cache (``forward``), then three
    ``decode_step``s, both sides fed the JAX argmax tokens."""
    jparams, tparams = models[scheme]
    jforward = jax.jit(JM.forward, static_argnums=1)
    jdecode = jax.jit(JM.decode_step, static_argnums=1)
    B, T = 2, 16
    toks = np.random.default_rng(2).integers(0, 256, (B, T)).astype(np.int32)
    jc = jkv.init(JCFG, B, MAX_LEN, quantized=True, dtype=jnp.float32)
    tc = tkv.init(TCFG, B, MAX_LEN, quantized=True, dtype=torch.float32,
                  device="cpu")
    clen = np.zeros((B,), np.int32)
    for step in range(4):
        jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
        jcl, tcl = jnp.asarray(clen), torch.from_numpy(clen)
        if step == 0:
            jl, jc = jforward(jparams, JCFG, jt, caches=jc, cache_len=jcl)
            tl, tc = TM.forward(tparams, TCFG, tt, caches=tc, cache_len=tcl)
        else:
            jl, jc = jdecode(jparams, JCFG, jt, jc, jcl)
            tl, tc = TM.decode_step(tparams, TCFG, tt, tc, tcl)
        jl = np.asarray(jl)
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                                   atol=LOGIT_TOL[scheme] * np.abs(jl).max(),
                                   err_msg=f"{scheme} step {step}")
        clen = clen + toks.shape[1]
        toks = jl.reshape(B, -1, jl.shape[-1])[:, -1].argmax(-1)
        toks = toks.astype(np.int32)[:, None]


@pytest.mark.parametrize("qkv", [False, True])
def test_default_engine_greedy_matches_jax(models, prompts, jax_greedy, qkv):
    """3 requests over 2 slots through the port's default engine (gate/up
    GLU-fused) against JAX's, on the g128 model; with ``qkv``, q/k/v are
    first fused into one ``qkv_proj`` whose bias is the three biases
    concatenated (the same columns, so the same tokens as JAX's unfused
    q/k/v)."""
    tparams = models["g128"][1]
    if qkv:
        raw = tparams
        tparams = TM.fuse_inference_params(raw, TCFG, qkv=True, glu=False)
        for layer, lr in zip(tparams["layers"], raw["layers"]):
            assert "q_proj" not in layer
            assert torch.equal(layer["qkv_proj"]["b"], torch.cat(
                [lr[n]["b"] for n in ("q_proj", "k_proj", "v_proj")]))
    out = generate(tparams, TCFG, prompts, SamplingParams(max_new_tokens=5),
                   dtype=torch.float32, device="cpu", **_ENGINE)
    assert out == jax_greedy
