"""Port (qqq_tpu_torch) against the JAX package: the g128 W4A8 GEMM routes,
the GLU-fused gate/up and the default (fused) engine on a g128 model.

Inputs come from a numpy seed and go to both packages; the port runs its
plain versions on the CPU, the JAX Pallas kernels run in interpret mode.

Tolerances:
* integer-exact pieces (s_extra, the INT8 regrid, RTN codes, packing, the
  fused layouts) and the requant route (one exact int32 dot, two f32
  multiplies in one order): bit-exact;
* the exact g128 route sums the groups' f32 terms in group order on both
  sides, but XLA may fuse a multiply and an add where PyTorch rounds each:
  the JAX kernel's own tolerance against its oracle, rtol 5e-6 and atol
  5e-5·max|ref| (tests/test_kernels.py:60-72);
* the GLU epilogue g·σ(g)·u: σ is another exp on each side; JAX's own
  tolerance for the fused GLU kernel, rtol 2e-5 and atol 2e-5·max|ref|
  (tests/test_kernels.py:289-292);
* model logits: 2e-3 absolute and greedy tokens equal, as in
  tests/test_torch_model.py (one flipped activation code moves an output
  by one quantization step).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _quantize_params as jax_rtn
from qqq_tpu.core import packing as jpack
from qqq_tpu.core import quant as jquant
from qqq_tpu.models import ModelConfig as JConfig
from qqq_tpu.models import init_params as jax_init_params
from qqq_tpu.models import llama as JM
from qqq_tpu.serve.engine import generate as jax_generate
from qqq_tpu.serve.sampling import SamplingParams as JSampling

from qqq_tpu_torch.core import quant as tquant
from qqq_tpu_torch.models import ModelConfig, params_from_numpy
from qqq_tpu_torch.models import llama as TM
from qqq_tpu_torch.models.quantize import quantize_params_rtn
from qqq_tpu_torch.serve.engine import Engine, Request
from qqq_tpu_torch.serve.sampling import SamplingParams

_CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=512)
JCFG, TCFG = JConfig(**_CFG), ModelConfig(**_CFG)
# the modules (both packages' kernels/__init__ rebind the name to a function)
jk = importlib.import_module("qqq_tpu.kernels.w4a8_gemm")
tk = importlib.import_module("qqq_tpu_torch.kernels.w4a8_gemm")


def _t(x):
    """numpy / JAX array → torch tensor with the same bits (bf16 too)."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(t):
    return t.to(torch.float32).numpy()


def _group_scales(rng, G, N):
    s = (rng.random((G, N)) * 0.02 + 1e-3).astype(np.float32)
    s[:, 3] = 0.0  # an all-zero channel takes s_extra = 1
    return s


def _operands(rng, M, K, N):
    x = (rng.standard_normal((M, K)) * 2).astype(np.float32)
    a_q, s_tok = jquant.quantize_activations_per_token(jnp.asarray(x))
    q4 = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
    return a_q, s_tok, q4, jpack.pack_int4(jnp.asarray(q4))


def _close(got, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rel,
                               atol=rel * (np.abs(ref).max() + 1e-6))


# (a) ------------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N", [(3, 384, 40), (9, 256, 64)])
def test_requant_numerics_and_group_reference_bit_exact(M, K, N):
    rng = np.random.default_rng(M * K + N)
    sg = _group_scales(rng, K // 128, N)
    se_j = jquant.s_extra_from_group_scales(jnp.asarray(sg))
    s_frac_t, se_t = tquant.requant_scales(_t(sg))
    assert np.array_equal(se_t.numpy(), np.asarray(se_j))
    s_frac_j = jnp.asarray(sg) / se_j[None, :]
    assert np.array_equal(s_frac_t.numpy(), np.asarray(s_frac_j))
    a_q, s_tok, q4, _ = _operands(rng, M, K, N)
    w8_j = jquant.requantize_group_weights_int8(jnp.asarray(q4), s_frac_j, 128)
    w8_t = tquant.requantize_group_weights_int8(_t(q4), s_frac_t, 128)
    assert np.array_equal(w8_t.numpy(), np.asarray(w8_j))
    for sg_dtype in (jnp.float32, jnp.bfloat16):
        sgd = jnp.asarray(sg, sg_dtype)
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            ref = jquant.w4a8_matmul_reference(
                a_q, s_tok, jnp.asarray(q4), None, sgd, group_size=128,
                out_dtype=jdt)
            got = tquant.w4a8_matmul_reference(
                _t(a_q), _t(s_tok), _t(q4), None, _t(sgd), group_size=128,
                out_dtype=tdt)
            assert np.array_equal(_np(got), np.asarray(ref, np.float32))


# (c) ------------------------------------------------------------------------


@pytest.mark.parametrize("sg_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("M,K,N", [(1, 256, 64), (5, 384, 96), (40, 512, 256)])
def test_g128_gemm_routes_match_jax(M, K, N, sg_dtype):
    """Exact route at the JAX kernel's tolerance, requant route bit-exact,
    K = 384 has three groups (not a power of two)."""
    rng = np.random.default_rng(M + K + N)
    a_q, s_tok, _, wp = _operands(rng, M, K, N)
    sg = jnp.asarray(_group_scales(rng, K // 128, N), sg_dtype)
    args_t = (_t(a_q), _t(s_tok), _t(wp), None, _t(sg))
    for requant in (False, True):
        ref = jk.w4a8_gemm(a_q, s_tok, wp, None, sg, group_size=128,
                           out_dtype=jnp.float32, requant=requant)
        got = tk.w4a8_gemm(*args_t, group_size=128, out_dtype=torch.float32,
                           requant=requant)
        if requant:
            assert np.array_equal(got.numpy(), np.asarray(ref))
        else:
            _close(got.numpy(), ref, 5e-6)


def test_g128_auto_route_follows_m():
    """requant=None: M ≥ 512 takes the requant route, smaller M the exact
    one; the two differ by the INT8 regrid."""
    rng = np.random.default_rng(7)
    a_q, s_tok, _, wp = _operands(rng, 512, 256, 64)
    sg = _t(jnp.asarray(_group_scales(rng, 2, 64), jnp.bfloat16))
    a, st, w = _t(a_q), _t(s_tok), _t(wp)
    kw = dict(group_size=128, out_dtype=torch.float32)
    auto = tk.w4a8_gemm(a, st, w, None, sg, **kw)
    assert torch.equal(auto, tk.w4a8_gemm(a, st, w, None, sg, requant=True,
                                          **kw))
    assert not torch.equal(auto, tk.w4a8_gemm(a, st, w, None, sg,
                                              requant=False, **kw))
    small = tk.w4a8_gemm(a[:8], st[:8], w, None, sg, **kw)
    assert torch.equal(small, tk.w4a8_gemm(a[:8], st[:8], w, None, sg,
                                           requant=False, **kw))


# (d) ------------------------------------------------------------------------


# M = 130 on the channel route: past the per-channel GLU's regime switch
# on the card, a ragged tensor-core tile; on the exact g128 route: nine
# 16-row blocks of the weight stream, the last ragged, with f32 s_group (as
# Marlin imports store it)
@pytest.mark.parametrize("route,M,sg_dtype", [
    pytest.param("channel", 24, None, id="channel"),
    pytest.param("group", 24, jnp.bfloat16, id="group"),
    pytest.param("requant", 24, jnp.bfloat16, id="requant"),
    pytest.param("channel", 130, None, id="channel-M130"),
    pytest.param("group", 130, jnp.float32, id="group-M130")])
def test_glu_layout_and_gemm_match_jax(route, M, sg_dtype):
    rng = np.random.default_rng(11)
    K, I = 384, 512
    a_q, s_tok, _, wg = _operands(rng, M, K, I)
    wu = jpack.pack_int4(jnp.asarray(
        rng.integers(-8, 8, size=(K, I)).astype(np.int8)))
    gate, up = {"w_packed": wg}, {"w_packed": wu}
    if route == "channel":
        gate["s_channel"] = jnp.asarray(rng.random(I) * 0.01 + 1e-3,
                                        jnp.float32)
        up["s_channel"] = jnp.asarray(rng.random(I) * 0.01 + 1e-3, jnp.float32)
    else:
        gate["s_group"] = jnp.asarray(_group_scales(rng, K // 128, I),
                                      sg_dtype)
        up["s_group"] = jnp.asarray(_group_scales(rng, K // 128, I),
                                    sg_dtype)
    fused_j = jk.fuse_glu_layout(gate, up)
    to_t = lambda d: {k: _t(v) for k, v in d.items()}  # noqa: E731
    fused_t = tk.fuse_glu_layout(to_t(gate), to_t(up))
    assert fused_t.keys() == fused_j.keys()
    for k, v in fused_j.items():
        assert torch.equal(fused_t[k], _t(v)), k
    gs = -1 if route == "channel" else 128
    requant = None if route == "channel" else route == "requant"
    ref = jk.w4a8_glu_gemm(a_q, s_tok, fused_j["w_packed"],
                           fused_j.get("s_channel"), fused_j.get("s_group"),
                           group_size=gs, out_dtype=jnp.float32,
                           requant=requant)
    got = tk.w4a8_glu_gemm(_t(a_q), _t(s_tok), fused_t["w_packed"],
                           fused_t.get("s_channel"), fused_t.get("s_group"),
                           group_size=gs, out_dtype=torch.float32,
                           requant=requant)
    assert got.shape == (M, I)
    _close(got.numpy(), ref, 2e-5)


# (b), (e), (f): a small g128 model ------------------------------------------


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    dense = jax_init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    jparams = jax_rtn(dense, JCFG, group_size=128)
    tparams = params_from_numpy(_tree_np(jparams), TCFG, device="cpu")
    tdense = params_from_numpy(_tree_np(dense), TCFG, device="cpu")
    return jparams, tparams, tdense


def test_rtn_g128_packing_bit_exact(models):
    """Scales rounded to bf16 before the codes are chosen, on both sides."""
    _, tparams, tdense = models
    mine = quantize_params_rtn(tdense, TCFG, group_size=128)
    for a, b in zip(mine["layers"], tparams["layers"]):
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                     "up_proj", "down_proj"):
            assert a[name]["s_group"].dtype == torch.bfloat16
            for leaf in ("w_packed", "s_group"):
                assert torch.equal(a[name][leaf], b[name][leaf]), (name, leaf)


def test_fuse_inference_params_qkv_forward_matches_jax(models):
    """The fused layouts bit for bit; each fused layer against JAX's from
    the same input (JAX's hidden state, so that one side's activation-code
    flip does not feed the next layer); the fused forward against the
    unfused one (the concatenated GEMM computes the same columns)."""
    jparams, tparams, _ = models
    fused_j = JM.fuse_inference_params(jparams, JCFG, qkv=True)
    fused_t = TM.fuse_inference_params(tparams, TCFG, qkv=True)
    want = params_from_numpy(_tree_np(fused_j), TCFG, device="cpu")
    for a, b in zip(fused_t["layers"], want["layers"]):
        assert a.keys() == b.keys() and "qkv_proj" in a
        for name in ("qkv_proj", "gate_up_glu"):
            for leaf, v in b[name].items():
                assert torch.equal(a[name][leaf], v), (name, leaf)
    toks = np.random.default_rng(3).integers(0, 256, (2, 16)).astype(np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    x = jnp.asarray(jparams["embed"])[toks]
    for lj, lt in zip(fused_j["layers"], fused_t["layers"]):
        want_x, _ = JM.decoder_layer(lj, x, jnp.asarray(pos),
                                     JM.rope_inv_freq(JCFG), JCFG)
        got_x, _ = TM.decoder_layer(lt, _t(x), torch.from_numpy(pos),
                                    TM.rope_inv_freq(TCFG), TCFG)
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0,
                                   atol=2e-3)
        x = want_x
    tt = torch.from_numpy(toks).long()
    got, _ = TM.forward(fused_t, TCFG, tt)
    unfused, _ = TM.forward(tparams, TCFG, tt)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), rtol=0,
                               atol=1e-5)


def test_default_engine_g128_greedy_matches_jax(models, monkeypatch):
    """Both engines with default arguments (gate/up GLU-fused).  Prompts of
    150 and 200 tokens prefill together in bucket 256 (M = 512 rows, T ≥ 64:
    the requant routes), the 5-token one in bucket 16 and every decode step
    on the exact routes."""
    jparams, tparams, _ = models
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, 256, size=n)]
               for n in (150, 200, 5)]
    kw = dict(max_batch=2, max_len=384, prefill_buckets=(16, 256))
    ref = jax_generate(jparams, JCFG, prompts, JSampling(max_new_tokens=4),
                       kv_quantized=True, dtype=jnp.float32, **kw)
    calls = {"requant": 0, "group": 0}

    def spy(route, plain):
        def f(*a, **k):
            calls[route] += 1
            return plain(*a, **k)
        return f

    monkeypatch.setattr(tk, "w4a8_glu_requant_plain",
                        spy("requant", tk.w4a8_glu_requant_plain))
    monkeypatch.setattr(tk, "w4a8_glu_group_plain",
                        spy("group", tk.w4a8_glu_group_plain))
    eng = Engine(tparams, TCFG, dtype=torch.float32, device="cpu", **kw)
    assert all("gate_up_glu" in layer and "gate_proj" not in layer
               for layer in eng.params["layers"])
    reqs = [Request(p, SamplingParams(max_new_tokens=4)) for p in prompts]
    eng.run(reqs)
    assert [r.output_tokens for r in reqs] == ref
    assert eng.stats["prefill_shapes"] == [(2, 256), (1, 16)]
    assert calls["requant"] == TCFG.num_hidden_layers  # the bucket-256 pair
    assert calls["group"] > 0
