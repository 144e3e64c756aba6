"""Port (qqq_tpu_torch) against the JAX package: long-context GQA serving
(the S-tiled decode past the whole-cache switch, Llama-3.1's config and
llama3 RoPE scaling) and the activation-quant-fused W4A8 GEMMs.

Inputs come from a numpy seed and go to both packages; the port runs its
plain versions on the CPU, the JAX Pallas kernels run in interpret mode.

Tolerances:
* S-tiled decode: 1e-5 absolute, as paged decode (tests/test_torch_paged.py).
  Both sides walk JAX's key tile and round ``q/√hd`` and ``e·v_scale`` to
  bf16 at the same points; only f32 sums in another order differ (the
  port's sums go by the split kernel's 128-key chunks, its tile maxima are
  JAX's exactly).
* fused GEMMs and the fused route of ``w4a8_linear``: bit-exact.  XLA's
  compile on the CPU turns JAX's ``absmax / 127`` (a division by a
  constant) into a multiply by the reciprocal, which is an ulp off the
  IEEE division of the JAX kernel's source, of the CUDA kernel and of the
  plain version in some rows; a row whose absmax is a power of two gets the
  same scale either way, so these inputs pin each row's absmax to 4.
* the engines: greedy tokens equal.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qqq_tpu.core import packing as jpack
from qqq_tpu.kernels import attention as jattn
from qqq_tpu.models import ModelConfig as JConfig
from qqq_tpu.models import init_params as jax_init_params
from qqq_tpu.models import llama as JM
from qqq_tpu.serve.engine import generate as jax_generate
from qqq_tpu.serve.sampling import SamplingParams as JSampling

from qqq_tpu_torch.kernels import attention as tattn
from qqq_tpu_torch.models import (
    ModelConfig, params_from_numpy, quantize_params_rtn,
)
from qqq_tpu_torch.models import llama as TM
from qqq_tpu_torch.serve.engine import Engine, Request
from qqq_tpu_torch.serve.sampling import SamplingParams

# the modules (both packages' kernels/__init__ rebind the name to a function)
jk = importlib.import_module("qqq_tpu.kernels.w4a8_gemm")
tk = importlib.import_module("qqq_tpu_torch.kernels.w4a8_gemm")

#: meta-llama/Llama-3.1-8B config.json (the fields ModelConfig reads)
LLAMA31_8B = {
    "model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
    "intermediate_size": 14336, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
    "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
    "max_position_embeddings": 131072, "tie_word_embeddings": False,
    "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                     "high_freq_factor": 4.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
}


def _t(x):
    """numpy / JAX array → torch tensor with the same bits (bf16 too)."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_jax(tree):
    """Port params → JAX params with the same bits (bf16 included)."""
    if isinstance(tree, dict):
        return {k: _tree_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_jax(v) for v in tree]
    if tree is None:
        return None
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(tree.numpy())


def _cache(rng, B, nkv, S, hd):
    kc = rng.integers(-128, 128, size=(B, nkv, S, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, size=(B, nkv, S, hd)).astype(np.int8)
    ks = (rng.random((B, nkv, S)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((B, nkv, S)) * 0.02 + 1e-3).astype(np.float32)
    return kc, ks, vc, vs


# (a), (b) the S-tiled decode -------------------------------------------------


@pytest.mark.parametrize("B,nh,nkv,S,hd,sblk,clen", [
    # MHA: one key, a tile boundary, mid-tile, the whole cache
    (4, 4, 4, 768, 128, 256, (1, 256, 500, 768)),
    # GQA g = 4: the same four kinds of cache length
    (4, 8, 2, 1024, 64, 256, (1, 512, 777, 1024)),
    # rows ending on a 128-key chunk and on a tile, and one key past each
    (4, 8, 2, 1024, 64, 256, (128, 129, 256, 257)),
    # one long row beside rows of one key (the split's imbalance)
    (4, 8, 2, 2048, 64, 512, (1, 2047, 1, 1)),
    # g = 16, which JAX serves and the port used to refuse
    (2, 32, 2, 1024, 64, 256, (300, 1024)),
    # JAX's walk-down gives the whole cache, 1999 keys: a short last chunk
    (2, 4, 2, 1999, 64, None, (1999, 1030)),
    # hd = 96: six of a key row's eight 16-byte columns are live
    (4, 8, 2, 1024, 96, 256, (1, 129, 513, 1024)),
    # hd = 256: sixteen columns a key row
    (2, 4, 2, 1024, 256, 256, (300, 1024)),
])
def test_flash_decode_plain_matches_jax(B, nh, nkv, S, hd, sblk, clen):
    rng = np.random.default_rng(S + nh)
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    arrs = (q, *_cache(rng, B, nkv, S, hd), np.array(clen, np.int32))
    ref = np.asarray(jattn.flash_decode_attention_int8(
        *map(jnp.asarray, arrs), sblk=sblk))
    out = tattn.flash_decode_attention_int8(*map(_t, arrs), sblk=sblk)
    assert out.shape == (B, nh, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_decode_attention_auto_past_switch_matches_jax():
    """S = 16384 at hd = 64 lies past the switch: both packages take the
    S-tiled kernel there, whose tile is the whole cache at this width."""
    B, nh, nkv, S, hd = 2, 4, 2, 16384, 64
    assert S * (hd + 8) > 8192 * (128 + 8)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    arrs = (q, *_cache(rng, B, nkv, S, hd),
            np.array([S // 2 + 3, 9000], np.int32))
    ref = np.asarray(jattn.decode_attention_auto(*map(jnp.asarray, arrs)))
    out = tattn.decode_attention_auto(*map(_t, arrs))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    assert tattn.flash_decode_tile(nkv, S, hd, nh // nkv) == S


# (c), (d) the activation-quant-fused GEMMs -----------------------------------


def _fused_operands(rng, M, K, N, x_dtype):
    x = (rng.standard_normal((M, K)) * 0.8).astype(np.float32)
    x = np.clip(x, -3.9, 3.9)
    x[:, 7] = 4.0  # absmax a power of two in every row (module docstring)
    x[0] = 0.0     # an all-zero row
    xj = jnp.asarray(x, x_dtype)
    q4 = rng.integers(-8, 8, size=(K, N)).astype(np.int8)
    wp = jpack.pack_int4(jnp.asarray(q4))
    s_ch = jnp.asarray(rng.random(N) * 0.01 + 1e-3, jnp.float32)
    s_g = jnp.asarray(rng.random((K // 128, N)) * 0.02 + 1e-3, jnp.bfloat16)
    return xj, wp, s_ch, s_g


@pytest.mark.parametrize("x_dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("M,K,N", [(1, 256, 256), (33, 512, 384),
                                   (4, 128, 64)])
def test_fused_gemm_plains_match_jax(M, K, N, x_dtype):
    """JAX's own test shapes (tests/test_kernels.py); both schemes."""
    rng = np.random.default_rng(M * K + N)
    xj, wp, s_ch, s_g = _fused_operands(rng, M, K, N, x_dtype)
    for gs, sc, sg in ((-1, s_ch, None), (128, None, s_g)):
        ref = jk.w4a8_gemm_fused(xj, wp, sc, sg, group_size=gs,
                                 out_dtype=jnp.float32)
        got = tk.w4a8_gemm_fused(
            _t(xj), _t(wp), None if sc is None else _t(sc),
            None if sg is None else _t(sg), group_size=gs,
            out_dtype=torch.float32)
        assert np.array_equal(got.numpy(), np.asarray(ref)), gs
        assert not got[0].any()


@pytest.mark.parametrize("group_size", [-1, 128])
def test_w4a8_linear_fused_route_matches_jax(monkeypatch, group_size):
    """``FUSE_ACT_QUANT`` set in both packages: (3, 4, K) activations (M =
    12) take the fused route on both sides, bit-exact; (65, K) stays on
    the two-step route (M > 64), as does a K with no fused tile."""
    rng = np.random.default_rng(group_size + 2)
    K, N = 384, 200  # N pads to 256 for _fused_bn, as JAX pads it
    xj, wp, s_ch, s_g = _fused_operands(rng, 65, K, N, jnp.bfloat16)
    sc, sg = (s_ch, None) if group_size == -1 else (None, s_g)
    monkeypatch.setattr(jk, "FUSE_ACT_QUANT", True)
    monkeypatch.setattr(tk, "FUSE_ACT_QUANT", True)
    route = "group" if group_size == 128 else "channel"
    plain, calls = getattr(tk, f"w4a8_gemm_fused_{route}_plain"), []

    def spy(*a, **k):
        calls.append(a[0].shape[0])
        return plain(*a, **k)

    monkeypatch.setattr(tk, f"w4a8_gemm_fused_{route}_plain", spy)
    for x in (xj[:12].reshape(3, 4, K), xj):
        ref = jk.w4a8_linear(x, wp, sc, sg, group_size=group_size,
                             out_dtype=jnp.float32)
        got = tk.w4a8_linear(_t(x), _t(wp), None if sc is None else _t(sc),
                             None if sg is None else _t(sg),
                             group_size=group_size, out_dtype=torch.float32)
        assert got.shape == ref.shape
        assert np.array_equal(got.numpy(), np.asarray(ref))
    assert calls == [12]
    assert tk._fused_bn(K, 256) and not tk._fused_bn(24576 + 128, 128)


# (e) the config --------------------------------------------------------------


def test_from_hf_llama31_matches_jax():
    """Equal fields in both packages, the list round-trip of rope_scaling
    (as json gives it back), and llama3 RoPE frequencies bit for bit."""
    jc, tc = JConfig.from_hf(LLAMA31_8B), ModelConfig.from_hf(LLAMA31_8B)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.num_kv_groups, tc.head_dim) == (4, 128)
    back = ModelConfig(**{**dataclasses.asdict(tc),
                          "rope_scaling": [list(p) for p in tc.rope_scaling]})
    assert back == tc and hash(back) == hash(tc)
    assert torch.equal(TM.rope_inv_freq(tc), _t(JM.rope_inv_freq(jc)))
    with pytest.raises(ValueError, match="model_type"):
        ModelConfig.from_hf({**LLAMA31_8B, "model_type": "gpt2"})


# (f), (g) a Llama-3.1-shaped model served ------------------------------------

#: Llama-3.1's shape at toy width: GQA g = 4, hd 64, llama3 rope_scaling
_TOY = {**LLAMA31_8B, "vocab_size": 256, "hidden_size": 256,
        "intermediate_size": 512, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 1, "head_dim": 64}
_SERVE = dict(max_batch=2, prefill_buckets=(16, 64))


@pytest.fixture(scope="module")
def toy():
    tcfg, jcfg = ModelConfig.from_hf(_TOY), JConfig.from_hf(_TOY)
    dense = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = quantize_params_rtn(
        params_from_numpy(_tree_np(dense), tcfg, device="cpu"), tcfg,
        group_size=128)
    rng = np.random.default_rng(31)
    prompts = [[int(t) for t in rng.integers(0, 256, size=n)]
               for n in (5, 40)]
    return tcfg, jcfg, tparams, _tree_jax(tparams), prompts


def _serve(params, cfg, prompts, **kw):
    eng = Engine(params, cfg, dtype=torch.float32, device="cpu",
                 **{**_SERVE, **kw})
    reqs = [Request(p, SamplingParams(max_new_tokens=4)) for p in prompts]
    eng.run(reqs)
    return eng, [r.output_tokens for r in reqs]


def test_llama31_shaped_engine_greedy_matches_jax(toy, monkeypatch):
    """Both engines with default arguments over a 16384-slot INT8 cache:
    every decode step lies past the switch, so the S-tiled kernel (JAX) and
    its plain version (port) run it; greedy tokens equal."""
    tcfg, jcfg, tparams, jparams, prompts = toy
    jcalls, tcalls = [], []
    jfn, tfn = (jattn.flash_decode_attention_int8,
                tattn.flash_decode_attention_int8_plain)

    def jspy(*a, **k):
        jcalls.append(1)  # traced once per compiled decode step
        return jfn(*a, **k)

    def tspy(*a, **k):
        tcalls.append(1)
        return tfn(*a, **k)

    monkeypatch.setattr(jattn, "flash_decode_attention_int8", jspy)
    monkeypatch.setattr(tattn, "flash_decode_attention_int8_plain", tspy)
    want = jax_generate(jparams, jcfg, prompts, JSampling(max_new_tokens=4),
                        kv_quantized=True, dtype=jnp.float32, max_len=16384,
                        **_SERVE)
    eng, got = _serve(tparams, tcfg, prompts, max_len=16384)
    assert got == want
    assert jcalls and len(tcalls) == (tcfg.num_hidden_layers
                                      * eng.stats["decode_ticks"]) > 0


def test_engine_fused_act_quant_tokens_equal(toy, monkeypatch):
    """The port's engine with ``FUSE_ACT_QUANT`` on and off: the fused
    route computes the same function, so greedy tokens are equal; with the
    flag on, the decode linears (M = 2) take it."""
    tcfg, _, tparams, _, prompts = toy
    _, off = _serve(tparams, tcfg, prompts, max_len=128)
    plain, rows = tk.w4a8_gemm_fused_group_plain, []

    def spy(*a, **k):
        rows.append(a[0].shape[0])
        return plain(*a, **k)

    monkeypatch.setattr(tk, "w4a8_gemm_fused_group_plain", spy)
    monkeypatch.setattr(tk, "FUSE_ACT_QUANT", True)
    eng, on = _serve(tparams, tcfg, prompts, max_len=128)
    assert on == off
    # q/k/v/o/down of every layer at every tick; prefill (M ≥ 16) in part
    ticks = eng.stats["decode_ticks"]
    assert rows.count(2) == 5 * tcfg.num_hidden_layers * ticks > 0
