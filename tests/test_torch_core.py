"""Port (qqq_tpu_torch) against the JAX package: integer-exact pieces.

Packing, activation codes, RTN weight codes, the W4A8 GEMM's int32 core and
output, and the INT8 KV cache write must be bit-identical.  Inputs are made
from a numpy seed and handed to both packages; the port runs on the CPU
(its plain versions), the JAX Pallas kernels in interpret mode.
"""

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qqq_tpu.core import packing as jpack
from qqq_tpu.core import quant as jquant
from qqq_tpu.kernels.w4a8_gemm import w4a8_gemm as jax_w4a8_gemm
from qqq_tpu.models import ModelConfig as JConfig
from qqq_tpu.serve import kv_cache as jkv

from qqq_tpu_torch.core import packing as tpack
from qqq_tpu_torch.core import quant as tquant
from qqq_tpu_torch.kernels.w4a8_gemm import w4a8_gemm, w4a8_linear
from qqq_tpu_torch.models import ModelConfig, params_from_numpy
from qqq_tpu_torch.models.quantize import quantize_linear_rtn
from qqq_tpu_torch.serve import kv_cache as tkv

REPO = pathlib.Path(__file__).resolve().parent.parent


def _t(x):
    return torch.from_numpy(np.array(x))


def _codes(rng, K, N):
    return rng.integers(-8, 8, size=(K, N)).astype(np.int8)


@pytest.mark.parametrize("K,N", [(128, 8), (384, 40)])
def test_pack_unpack_bit_exact(K, N):
    q = _codes(np.random.default_rng(K), K, N)
    jw = np.asarray(jpack.pack_int4(jnp.asarray(q)))
    tw = tpack.pack_int4(_t(q)).numpy()
    assert tw.dtype == np.int32 and np.array_equal(tw, jw)
    assert np.array_equal(tpack.unpack_int4(_t(jw)).numpy(),
                          np.asarray(jpack.unpack_int4(jnp.asarray(jw))))
    assert np.array_equal(tpack.unpack_int4(_t(tw)).numpy(), q)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_activation_quant_bit_exact(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((7, 256)) * 3).astype(np.float32)
    x[3] = 0.0  # all-zero row takes the tiny-scale guard
    jx = jnp.asarray(x) if dtype == np.float32 else jnp.asarray(x, jnp.bfloat16)
    jq, js = jquant.quantize_activations_per_token(jx)
    tx = (_t(x) if dtype == np.float32 else
          _t(np.asarray(jx).view(np.uint16)).view(torch.bfloat16))
    tq, ts = tquant.quantize_activations_per_token(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))


def test_rtn_layer_codes_and_packing_bit_exact():
    """find_params_weight + quantize_weight_int + packing of one linear."""
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((256, 96)) * 0.02).astype(np.float32)
    w[:, 5] = 0.0  # degenerate channel
    spec = jquant.QuantSpec(bits=4, group_size=-1)
    js, jz = jquant.find_params_weight(jnp.asarray(w), spec)
    jq = jquant.quantize_weight_int(jnp.asarray(w), js, jz, spec)
    tspec = tquant.QuantSpec(bits=4, group_size=-1)
    ts, tz = tquant.find_params_weight(_t(w), tspec)
    tq = tquant.quantize_weight_int(_t(w), ts, tz, tspec)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    lin = quantize_linear_rtn({"w": _t(w)}, tspec)
    assert np.array_equal(lin["w_packed"].numpy(),
                          np.asarray(jpack.pack_int4(jq)))
    assert np.array_equal(lin["s_channel"].numpy(), np.asarray(js[0]))


# M = 130: past both per-channel kernels' regime switches on the card (the
# tensor-core tiles' rows), a ragged 256-row tile
@pytest.mark.parametrize("M,K,N", [(1, 256, 64), (5, 384, 96), (33, 128, 32),
                                   (130, 256, 96)])
def test_w4a8_gemm_int32_core_and_output_bit_exact(M, K, N):
    rng = np.random.default_rng(M * K + N)
    a = rng.integers(-128, 128, size=(M, K)).astype(np.int8)
    s_tok = (rng.random((M, 1)) * 0.05 + 1e-3).astype(np.float32)
    q4 = _codes(rng, K, N)
    s_ch = (rng.random(N) * 0.01 + 1e-4).astype(np.float32)
    wp = np.asarray(jpack.pack_int4(jnp.asarray(q4)))

    j_acc = np.asarray(jax.lax.dot_general(
        jnp.asarray(a), jnp.asarray(q4), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    # unit scales and an f32 output give the int32 core itself (|acc| < 2^24)
    t_acc = tquant.w4a8_matmul_reference(
        _t(a), torch.ones((M, 1)), tpack.unpack_int4(_t(wp)), torch.ones(N),
        out_dtype=torch.float32)
    assert np.array_equal(t_acc.to(torch.int32).numpy(), j_acc)

    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        j_out = jax_w4a8_gemm(jnp.asarray(a), jnp.asarray(s_tok),
                              jnp.asarray(wp), jnp.asarray(s_ch),
                              group_size=-1, out_dtype=jdt)
        t_out = w4a8_gemm(_t(a), _t(s_tok), _t(wp), _t(s_ch), out_dtype=tdt)
        assert t_out.dtype == tdt
        assert np.array_equal(t_out.to(torch.float32).numpy(),
                              np.asarray(j_out.astype(jnp.float32)))
        j_ref = jquant.w4a8_matmul_reference(
            jnp.asarray(a), jnp.asarray(s_tok), jnp.asarray(q4),
            jnp.asarray(s_ch), out_dtype=jdt)
        t_ref = tquant.w4a8_matmul_reference(_t(a), _t(s_tok), _t(q4),
                                             _t(s_ch), out_dtype=tdt)
        assert np.array_equal(t_ref.to(torch.float32).numpy(),
                              np.asarray(j_ref.astype(jnp.float32)))


def test_w4a8_gemm_g128_waits_for_next_slice():
    """g128 ``w4a8_linear`` on a (B, T, K) input with a bias against JAX's
    (exact route, bf16 s_group, f32 out; the JAX kernel's tolerance, see
    tests/test_torch_g128.py).  What still raises: a g128 call without
    s_group, and group sizes other than -1 and 128."""
    from qqq_tpu.kernels.w4a8_gemm import w4a8_linear as jax_linear

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 256)).astype(np.float32)
    wp = np.asarray(jpack.pack_int4(jnp.asarray(_codes(rng, 256, 64))))
    sg = jnp.asarray(rng.random((2, 64)) * 0.01 + 1e-3, jnp.bfloat16)
    bias = rng.standard_normal(64).astype(np.float32)
    ref = np.asarray(jax_linear(jnp.asarray(x), jnp.asarray(wp), None, sg,
                                bias=jnp.asarray(bias), group_size=128,
                                out_dtype=jnp.float32))
    t_sg = _t(np.asarray(sg).view(np.uint16)).view(torch.bfloat16)
    out = w4a8_linear(_t(x), _t(wp), None, t_sg, bias=_t(bias),
                      group_size=128, out_dtype=torch.float32)
    assert out.shape == (2, 3, 64)
    np.testing.assert_allclose(out.numpy(), ref, rtol=5e-6,
                               atol=5e-5 * np.abs(ref).max())
    with pytest.raises(ValueError, match="needs s_group"):
        w4a8_linear(_t(x), _t(wp), torch.ones(64), group_size=128)
    with pytest.raises(ValueError, match="group_size 64"):
        w4a8_linear(_t(x), _t(wp), None, t_sg, group_size=64)


def test_channel_regime_switch():
    """The per-channel kernels' regime on the card: the weight stream at
    decode rows, the int8 wgmma tiles from each kernel's threshold on, so
    that the served prefill buckets of 512 and 2048 rows a request take
    the tiles.  On the CPU every M runs the plain version and no kernel
    launch is counted."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    for glu, t in ((False, k.CHANNEL_TILES_MIN_M),
                   (True, k.GLU_CHANNEL_TILES_MIN_M)):
        assert 8 < t <= 512
        assert [k.channel_regime(M, glu) for M in (1, 4, t - 1, t, 512,
                                                   4096)] == (
            ["stream"] * 3 + ["tiles"] * 3)
    rng = np.random.default_rng(3)
    wp = _t(jpack.pack_int4(jnp.asarray(_codes(rng, 128, 512))))
    s_ch = torch.rand(512) * 0.01 + 1e-4
    before = {n: f.launches for n, f in k.KERNEL_WRAPPERS.items()}
    for M in (4, 127, 128, 256):
        a = torch.randint(-128, 128, (M, 128), dtype=torch.int8)
        s_tok = torch.rand(M, 1) * 0.05 + 1e-3
        assert torch.equal(k.w4a8_gemm_channel(a, s_tok, wp, s_ch),
                           k.w4a8_gemm_channel_plain(a, s_tok, wp, s_ch))
        assert torch.equal(k.w4a8_glu_channel(a, s_tok, wp, s_ch),
                           k.w4a8_glu_channel_plain(a, s_tok, wp, s_ch))
    assert {n: f.launches for n, f in k.KERNEL_WRAPPERS.items()} == before


_KV_CFG = dict(vocab_size=16, hidden_size=256, intermediate_size=256,
               num_hidden_layers=1, num_attention_heads=4,
               num_key_value_heads=2)


@pytest.mark.parametrize("T", [1, 5])
def test_kv_write_codes_and_scales_bit_exact(T):
    """T = 1 takes the slot-write kernel on both sides (S % 128 == 0 on
    the JAX side); T > 1 the indexed prefill write.  The last row sits at
    capacity, where both clamp the position."""
    jcfg, tcfg = JConfig(**_KV_CFG), ModelConfig(**_KV_CFG)
    B, S = 3, 128
    rng = np.random.default_rng(T)
    jc = jkv.init(jcfg, B, S, quantized=True)[0]
    tc = tkv.init(tcfg, B, S, quantized=True, device="cpu")[0]
    offsets = np.array([0, 37, S], np.int32)
    for step in range(2):
        k = rng.standard_normal((B, T, 2, 64)).astype(np.float32)
        v = rng.standard_normal((B, T, 2, 64)).astype(np.float32)
        k[0, 0, 1] = 0.0  # all-zero head row
        jc = jkv.write(jc, jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(offsets + step))
        tkv.write(tc, _t(k), _t(v), _t(offsets + step))
    for name in ("k", "v", "k_scale", "v_scale"):
        assert np.array_equal(tc[name].numpy(), np.asarray(jc[name])), name


def test_params_from_numpy_keeps_bf16_bits():
    cfg = ModelConfig(vocab_size=4, hidden_size=8, num_hidden_layers=1)
    emb = jnp.asarray(np.random.default_rng(3).standard_normal((4, 8)),
                      jnp.bfloat16)
    tree = jax.tree.map(np.asarray, {"embed": emb, "layers": [{"x": None}],
                                     "norm": jnp.ones((8,), jnp.float32)})
    p = params_from_numpy(tree, cfg, device="cpu")
    assert p["embed"].dtype == torch.bfloat16 and p["layers"][0]["x"] is None
    assert np.array_equal(p["embed"].view(torch.uint16).numpy(),
                          np.asarray(emb).view(np.uint16))
    with pytest.raises(ValueError):
        params_from_numpy(tree, ModelConfig(vocab_size=4, hidden_size=8,
                                            num_hidden_layers=2), "cpu")


def test_entry_points_refuse_silent_cpu_fallback(monkeypatch):
    from qqq_tpu_torch.models import init_params
    from qqq_tpu_torch.serve.engine import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(vocab_size=16, hidden_size=128, intermediate_size=128,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=2)
    params = init_params(cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(params, cfg, max_batch=1, max_len=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(params, cfg, max_batch=1, max_len=128, paged=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)


_PORT_FILES = sorted((REPO / "qqq_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]
# "qqq_tpu_torch" itself starts with "qqq_tpu": the patterns stop at "_"
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+jax\b|^\s*(?:import|from)\s+qqq_tpu\b(?!_)"
    r"|\bqqq_tpu\.", re.M)


def test_port_imports_no_jax():
    code = ("import sys, qqq_tpu_torch, qqq_tpu_torch.core, "
            "qqq_tpu_torch.models, qqq_tpu_torch.kernels.attention, "
            "qqq_tpu_torch.kernels.kv_write, qqq_tpu_torch.kernels.w4a8_gemm, "
            "qqq_tpu_torch.serve.engine, qqq_tpu_torch.serve.sampling; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'qqq_tpu' or m.startswith('qqq_tpu.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)
    offenders = [
        f"{p.relative_to(REPO)}: {m.group(0).strip()}"
        for p in _PORT_FILES for m in _FORBIDDEN.finditer(p.read_text())
    ]
    assert not offenders, offenders
