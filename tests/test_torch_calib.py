"""Port (qqq_tpu_torch) against the JAX package: the calibration stack.

The same inputs, made from a numpy seed, go through the JAX function and
the port's on the CPU (f32 products at full precision on both sides).

Tolerances, and why:
* min/max quantization parameters, codes, packing, the Hadamard matrices
  (float64 numpy on both sides), the observers' integer parts and the
  packing of a JAX ``quantizers.npz``: bit-exact;
* the MSE grid: the port computes each candidate as XLA compiles JAX's
  scan (``core/quant.py``), but ``|w − q|^2.4`` is a ``pow`` in each
  library and the group sums run in another order, so a near tie between
  two shrink steps could flip: at most 1 % of the (group, channel) scales
  may differ (none does here);
* observers whose range is a sum (mean, std, the MSE grid's losses): rtol
  1e-5; the scipy-driven MSEFast searches minimize a loss that is
  piecewise constant in the range, whose values differ in the last bits
  between the libraries, so Brent's search can stop elsewhere in a flat
  stretch: rtol 2e-3;
* the Hessian: rtol 1e-5, atol 1e-6 (a product in another order);
* GPTQ: the rule of tests/test_gptq.py:90-91, under 2 % of the
  dequantized entries differ at rtol 1e-4, atol 1e-5 (the Cholesky chain
  and the trailing products round differently, and a code on a rounding
  edge can flip, and its column's later rows follow); scale and zero
  (fixed before the loop) bit-equal without MSE; the loss within 1e-3
  relative where every code is equal, and within 5e-3 where a flipped
  code changed its column's later errors;
* rotation: the rotated weights within 1e-5 · max|w| of JAX's (f32
  products in another order); the rotated model's logits within
  2e-3 · max|logits| of the unrotated model's, JAX's own bound
  (tests/test_rotation.py);
* smoothing: ``sq`` (no search) within rtol 1e-5; ``os+`` and ``awq``
  pick the same candidate as JAX (every chosen scale within rtol 1e-5).
  The search is an argmin over a loss full of roundings: in a later layer,
  whose input already differs from JAX's in the last bits, one flipped
  activation code moves a loss by ~0.4 % at 16 tokens and can move the
  argmin; the case runs 32 tokens (a real search runs 2048);
* ``apply_gptq``: per linear, the 2 % rule on the dequantized weights.
  The two packages compute each layer's Hessian in their own order, and
  act-order sorts diag(H): two diagonal entries equal to the last bits can
  swap, and the whole schedule then differs (another valid GPTQ result).
  A Hessian of rank below K (fewer tokens than inputs, 1 % damping) makes
  that likely; the case calibrates on 2048 tokens, 8 per input channel of
  down_proj (a real calibration has thousands).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qqq_tpu.calib import clipping as jclip
from qqq_tpu.calib import gptq as jgptq
from qqq_tpu.calib import observers as jobs
from qqq_tpu.calib import pipeline as jpipe
from qqq_tpu.calib import rotation as jrot
from qqq_tpu.calib import smooth as jsmooth
from qqq_tpu.core import hadamard as jhad
from qqq_tpu.core import quant as jquant
from qqq_tpu.models import ModelConfig as JConfig
from qqq_tpu.models import init_params as jax_init_params
from qqq_tpu.models import llama as JM

from qqq_tpu_torch.calib import clipping as tclip
from qqq_tpu_torch.calib import gptq as tgptq
from qqq_tpu_torch.calib import observers as tobs
from qqq_tpu_torch.calib import pipeline as tpipe
from qqq_tpu_torch.calib import rotation as trot
from qqq_tpu_torch.calib import smooth as tsmooth
from qqq_tpu_torch.core import hadamard as thad
from qqq_tpu_torch.core import quant as tquant
from qqq_tpu_torch.models import ModelConfig, forward, params_from_numpy
from qqq_tpu_torch.models import llama as TM

_CFG = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
GPTQ_TOL = dict(rtol=1e-4, atol=1e-5)
GPTQ_SHARE = 0.02


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _to_torch(tree, config):
    return params_from_numpy(jax.tree.map(np.asarray, tree), config,
                             device="cpu")


def _jspec(spec):
    return jquant.QuantSpec(**dataclasses.asdict(spec))


def _mismatch(a, b, **tol) -> float:
    return float(np.mean(~np.isclose(_np(a), _np(b), **tol)))


# ---------------------------------------------------------------------------
# core


@pytest.mark.parametrize("group_size", [-1, 128])
@pytest.mark.parametrize("mse", [False, True])
def test_find_params_weight(group_size, mse):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((256, 96)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel
    spec = tquant.QuantSpec(bits=4, group_size=group_size, mse=mse)
    s, z = tquant.find_params_weight(torch.from_numpy(w), spec)
    js, jz = jquant.find_params_weight(jnp.asarray(w), _jspec(spec))
    np.testing.assert_array_equal(_np(z), _np(jz))
    if not mse:
        np.testing.assert_array_equal(_np(s), _np(js))
    else:
        assert np.mean(_np(s) != _np(js)) <= 0.01
    # the helpers, on these parameters
    q = tquant.quantize_weight_int(torch.from_numpy(w), s, z, spec)
    jq = jquant.quantize_weight_int(jnp.asarray(w), jnp.asarray(_np(s)),
                                    jnp.asarray(_np(z)), _jspec(spec))
    np.testing.assert_array_equal(_np(q), _np(jq))
    deq = tquant.dequantize_weight_int(q, s, spec)
    np.testing.assert_array_equal(
        _np(deq), _np(jquant.dequantize_weight_int(jq, jnp.asarray(_np(s)),
                                                   _jspec(spec))))
    np.testing.assert_array_equal(
        _np(tquant.fake_quantize_weight(torch.from_numpy(w), spec, s, z)),
        _np(deq))
    if not mse:
        np.testing.assert_array_equal(
            _np(tquant.fake_quantize_weight(torch.from_numpy(w), spec)),
            _np(jquant.fake_quantize_weight(jnp.asarray(w), _jspec(spec))))
    se = tquant.int8_channel_scale(deq)
    np.testing.assert_array_equal(
        _np(se), _np(jquant.int8_channel_scale(jnp.asarray(_np(deq)))))
    np.testing.assert_array_equal(
        _np(tquant.double_scale(s, se)),
        _np(jquant.double_scale(jnp.asarray(_np(s)), jnp.asarray(_np(se)))))


@pytest.mark.parametrize("K", [1, 2, 4, 8, 12, 20, 28, 36, 40, 44, 52, 60,
                               108, 140, 156, 172])
def test_hadamard_base(K):
    np.testing.assert_array_equal(thad.hadamard_base(K),
                                  jhad.hadamard_base(K))


@pytest.mark.parametrize("n", [64, 688, 1248, 1280, 1408, 2432])
def test_hadamard_matrices(n):
    np.testing.assert_array_equal(thad.hadamard_matrix(n),
                                  jhad.hadamard_matrix(n))
    np.testing.assert_array_equal(thad.random_hadamard_matrix(n, seed=3),
                                  jhad.random_hadamard_matrix(n, seed=3))


# ---------------------------------------------------------------------------
# observers and token-wise clipping

#: (keyword arguments, rtol of the range) per observer
_OBS_CASES = {
    "minmax": ({"ch_axis": 0}, 0.0),
    "quantile": ({"ch_axis": 0, "percentile": 0.9}, 0.0),
    "lsq_plus": ({"ch_axis": 0}, 1e-5),
    "avg_minmax": ({}, 0.0),
    "ema_minmax": ({}, 0.0),
    "avg_token_quantile": ({"percentile": 0.9}, 0.0),
    "ema_quantile": ({}, 0.0),
    "avg_quantile": ({}, 0.0),
    "mse": ({"ch_axis": 0}, 1e-5),
    "avg_mse": ({"num": 30}, 1e-5),
    "mse_fast": ({}, 2e-3),
    "avg_mse_fast": ({"symmetric": False}, 2e-3),
    "ema_mse_fast": ({}, 2e-3),
}


@pytest.mark.parametrize("name", sorted(tobs.OBSERVERS))
def test_observer_qparams(name):
    assert set(tobs.OBSERVERS) == set(jobs.OBSERVERS)
    assert tobs.REFERENCE_NAMES == jobs.REFERENCE_NAMES
    kw, rtol = _OBS_CASES[name]
    rng = np.random.default_rng(7)
    t_obs = tobs.make_observer(name, **kw)
    j_obs = jobs.make_observer(name, **kw)
    for b in range(2):
        x = rng.standard_normal((2, 24, 32)).astype(np.float32)
        x[0, 5, 3] = 9.0 + b  # an outlier token
        mask = None
        if name == "avg_token_quantile":
            mask = np.ones((2, 24), bool)
            mask[1, 20:] = False
        t_obs.update(torch.from_numpy(x), mask)
        j_obs.update(jnp.asarray(x), mask)
    for got, want in zip(t_obs.qparams(), j_obs.qparams()):
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=0)


def test_token_wise_clipping_search():
    cfg = dict(_CFG, num_hidden_layers=1)
    jp = jax_init_params(JConfig(**cfg), jax.random.PRNGKey(2),
                         dtype=jnp.float32)
    tp = _to_torch(jp, ModelConfig(**cfg))
    tokens = np.random.default_rng(3).integers(0, 128, (2, 16)).astype(
        np.int32)
    ratio, loss = tclip.token_wise_clipping_search(
        tp, ModelConfig(**cfg), torch.from_numpy(tokens).long(), iters=4,
        step=0.05)
    jratio, jloss = jclip.token_wise_clipping_search(
        jp, JConfig(**cfg), jnp.asarray(tokens), iters=4, step=0.05)
    assert ratio == jratio
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    x = np.random.default_rng(4).standard_normal((6, 64)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tclip.fake_quant_act_percentile(torch.from_numpy(x), 0.9)),
        _np(jclip.fake_quant_act_percentile(jnp.asarray(x),
                                            jnp.float32(0.9))),
        rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# GPTQ


def _problem(seed, K, N, n=96):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((K, N)).astype(np.float32) * 0.05
    base = rng.standard_normal((n, K)).astype(np.float32)
    mix = rng.standard_normal((K, K)).astype(np.float32) * 0.2 + np.eye(K)
    X = base @ mix
    X[:, 5] = 0.0  # a dead input
    return W, X.astype(np.float32)


def test_hessian_update():
    _, X = _problem(0, 128, 8)
    H, n = tgptq.hessian_init(128)
    jH, jn = jgptq.hessian_init(128)
    for xb in (X[:40], X[40:]):
        H, n = tgptq.hessian_update(H, n, torch.from_numpy(xb))
        jH, jn = jgptq.hessian_update(jH, jn, jnp.asarray(xb))
    assert n == float(jn)
    np.testing.assert_allclose(_np(H), _np(jH), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("group_size", [-1, 128])
@pytest.mark.parametrize("actorder", [False, True])
@pytest.mark.parametrize("mse", [False, True])
def test_gptq_quantize_matrix(group_size, actorder, mse):
    W, X = _problem(1, 256, 48)
    H = 2.0 / X.shape[0] * (X.T.astype(np.float64) @ X).astype(np.float32)
    spec = tquant.QuantSpec(bits=4, group_size=group_size, mse=mse)
    kw = dict(actorder=actorder, scale_store_dtype=torch.bfloat16)
    res = tgptq.gptq_quantize_matrix(torch.from_numpy(W), torch.from_numpy(H),
                                     spec, **kw)
    jres = jgptq.gptq_quantize_matrix(
        jnp.asarray(W), jnp.asarray(H), _jspec(spec), actorder=actorder,
        scale_store_dtype=jnp.bfloat16)
    assert _mismatch(res.w_deq, jres.w_deq, **GPTQ_TOL) < GPTQ_SHARE
    assert np.mean(_np(res.q4) != _np(jres.q4)) < GPTQ_SHARE
    if not mse:
        np.testing.assert_array_equal(_np(res.scale), _np(jres.scale))
    np.testing.assert_array_equal(_np(res.zero), _np(jres.zero))
    flips = np.any(_np(res.q4) != _np(jres.q4))
    np.testing.assert_allclose(float(res.loss), float(jres.loss),
                               rtol=5e-3 if flips else 1e-3)
    np.testing.assert_allclose(float(res.column_loss.sum()), float(res.loss),
                               rtol=1e-6)
    # codes × scales reproduce the dequantized weights, in range
    g = 256 if group_size == -1 else group_size
    recon = _np(res.q4).astype(np.float32) * np.repeat(_np(res.scale), g, 0)
    np.testing.assert_array_equal(recon, _np(res.w_deq))
    assert _np(res.q4).min() >= -8 and _np(res.q4).max() <= 7


def test_gptq_raises_where_not_positive_definite():
    H = -torch.eye(128)
    with pytest.raises(torch.linalg.LinAlgError):
        tgptq.gptq_quantize_matrix(torch.ones(128, 8), H,
                                   tquant.QuantSpec(group_size=-1))


# ---------------------------------------------------------------------------
# rotation


def _ln_params(seed, tie):
    cfg = dict(_CFG, tie_word_embeddings=tie, attention_bias=True)
    jp = jax_init_params(JConfig(**cfg), jax.random.PRNGKey(seed),
                         dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    for layer in jp["layers"]:
        for name in ("input_layernorm", "post_attention_layernorm"):
            layer[name] = jnp.asarray(rng.uniform(0.5, 1.5, 128), jnp.float32)
        for name in ("q_proj", "k_proj", "v_proj"):
            layer[name]["b"] = jnp.asarray(
                rng.standard_normal(layer[name]["w"].shape[1]) * 0.1,
                jnp.float32)
    jp["norm"] = jnp.asarray(rng.uniform(0.5, 1.5, 128), jnp.float32)
    return jp, JConfig(**cfg), ModelConfig(**cfg)


def _assert_close_tree(port, ref, rel):
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _assert_close_tree(port[k], ref[k], rel)
    elif isinstance(ref, (list, tuple)):
        for a, b in zip(port, ref):
            _assert_close_tree(a, b, rel)
    elif ref is None:
        assert port is None
    else:
        want = np.asarray(ref)
        np.testing.assert_allclose(_np(port), want, rtol=0,
                                   atol=rel * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("mode", ["hadamard", "random"])
@pytest.mark.parametrize("tie", [False, True])
def test_rotation(mode, tie):
    jp, jcfg, tcfg = _ln_params(5, tie)
    tp = _to_torch(jp, tcfg)
    jr, jQ = jrot.rotate_model(jrot.fuse_layer_norms(jp, jcfg), jcfg,
                               mode=mode, seed=1)
    tr, tQ = trot.rotate_model(trot.fuse_layer_norms(tp, tcfg), tcfg,
                               mode=mode, seed=1)
    np.testing.assert_array_equal(tQ, jQ)
    _assert_close_tree(tr, jr, 1e-5)
    tokens = torch.from_numpy(
        np.random.default_rng(6).integers(0, 128, (2, 12))).long()
    base, _ = forward(tp, tcfg, tokens)
    rot, _ = forward(tr, tcfg, tokens)
    np.testing.assert_allclose(_np(rot), _np(base),
                               atol=2e-3 * float(base.abs().max()))


# ---------------------------------------------------------------------------
# smoothing


def _sub_block_case(module_type, seed):
    jcfg, tcfg = JConfig(**_CFG), ModelConfig(**_CFG)
    rng = np.random.default_rng(seed)
    B, T = 1, 16
    C = 256 if module_type == "down_proj" else 128
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    x[..., 7] *= 12.0  # an outlier channel
    N = {"qkv": 128 + 2 * 64, "o_proj": 128, "up_and_gate": 512,
         "down_proj": 128}[module_type]
    w = (rng.standard_normal((C, N)) * 0.05).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T))
    jextra = {"config": jcfg, "positions": jnp.asarray(pos),
              "inv_freq": JM.rope_inv_freq(jcfg)}
    textra = {"config": tcfg, "positions": torch.from_numpy(pos.copy()),
              "inv_freq": TM.rope_inv_freq(tcfg)}
    return x, w, jextra, textra


@pytest.mark.parametrize("module_type,method", [
    ("qkv", "os+"), ("o_proj", "os+"), ("up_and_gate", "awq"),
    ("down_proj", "sq"), ("down_proj", "os+")])
def test_migrate(module_type, method):
    x, w, jextra, textra = _sub_block_case(module_type, 8)
    kw = dict(method=method, n_grid=12 if method == "os+" else None)
    s = tsmooth.migrate(module_type, torch.from_numpy(x), torch.from_numpy(w),
                        textra, **kw)
    js = jsmooth.migrate(module_type, jnp.asarray(x), jnp.asarray(w), jextra,
                         **kw)
    np.testing.assert_allclose(_np(s), _np(js), rtol=1e-5, atol=0)


@pytest.mark.parametrize("nkv", [4, 2])
def test_smooth_model_and_export(nkv):
    cfg = dict(_CFG, num_key_value_heads=nkv)
    jcfg, tcfg = JConfig(**cfg), ModelConfig(**cfg)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(9), dtype=jnp.float32)
    tp = _to_torch(jp, tcfg)
    tokens = np.random.default_rng(9).integers(0, 128, (1, 32)).astype(
        np.int32)
    sl = tsmooth.smooth_model(tp, tcfg, torch.from_numpy(tokens).long(),
                              n_grid=10)
    jsl = jsmooth.smooth_model(jp, jcfg, jnp.asarray(tokens), n_grid=10)
    assert len(sl) == len(jsl) == 4 * cfg["num_hidden_layers"]
    for a, b in zip(sl, jsl):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=0)
    out = tsmooth.export_smoothed_model(tp, tcfg, sl)
    jout = jsmooth.export_smoothed_model(
        jp, jcfg, [jnp.asarray(_np(s)) for s in sl])
    _assert_close_tree(out, jout, 1e-6)
    # GQA leaves o_proj (and v_proj's output side) as they were
    same = torch.equal(out["layers"][0]["o_proj"]["w"],
                       tp["layers"][0]["o_proj"]["w"])
    assert same == (nkv != 4)
    t = torch.from_numpy(tokens).long()
    np.testing.assert_allclose(_np(forward(out, tcfg, t)[0]),
                               _np(forward(tp, tcfg, t)[0]), rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the pipeline


def _pipeline_case(shape=(32, 64)):
    jcfg, tcfg = JConfig(**_CFG), ModelConfig(**_CFG)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    calib = np.random.default_rng(0).integers(0, 128, shape).astype(np.int32)
    return jp, jcfg, tcfg, calib


@pytest.mark.parametrize("group_size", [-1, 128])
def test_apply_gptq(group_size, tmp_path):
    jp, jcfg, tcfg, calib = _pipeline_case()
    spec = tquant.QuantSpec(bits=4, group_size=group_size, mse=True)
    kw = dict(sample_batch=4, dtype=torch.float32, pack=False)
    tp = _to_torch(jp, tcfg)
    qpath, jqpath = str(tmp_path / "q.npz"), str(tmp_path / "jq.npz")
    out, stats = tpipe.apply_gptq(tp, tcfg, calib, spec, **kw,
                                  quantizers_path=qpath)
    jout, jstats = jpipe.apply_gptq(
        jp, jcfg, jnp.asarray(calib), _jspec(spec), sample_batch=4,
        dtype=jnp.float32, pack=False, quantizers_path=jqpath)
    codes, jcodes = np.load(qpath), np.load(jqpath)
    for li in range(2):
        for name in tpipe.LINEARS:
            got = out["layers"][li][name]["w"]
            want = jout["layers"][li][name]["w"]
            assert _mismatch(got, want, **GPTQ_TOL) < GPTQ_SHARE, (li, name)
            key = f"layers.{li}.{name}.q4"
            assert np.mean(codes[key] != jcodes[key]) < GPTQ_SHARE, key
            np.testing.assert_allclose(stats["layer_losses"][li][name],
                                       jstats["layer_losses"][li][name],
                                       rtol=1e-3)
    # the packed result, through quantizers.npz, and from host memory
    packed, _ = tpipe.apply_gptq(tp, tcfg, calib, spec, **dict(
        kw, pack=True), quantizers_path=qpath)
    streamed, _ = tpipe.apply_gptq(tp, tcfg, calib, spec, **dict(
        kw, pack=True), stream_from_host=True, device="cpu")
    repacked = tpipe.pack_from_quantizers(tp, tcfg, spec, qpath)
    for li in range(2):
        for name in tpipe.LINEARS:
            for k, t in packed["layers"][li][name].items():
                assert torch.equal(streamed["layers"][li][name][k], t)
                assert torch.equal(repacked["layers"][li][name][k], t)


def test_quantize_lm_head():
    jp, jcfg, tcfg, calib = _pipeline_case()
    spec = tquant.QuantSpec(bits=4, group_size=128)
    out, stats = tpipe.apply_gptq(_to_torch(jp, tcfg), tcfg, calib, spec,
                                  dtype=torch.float32, pack=False,
                                  quantize_lm_head=True)
    jout, jstats = jpipe.apply_gptq(jp, jcfg, jnp.asarray(calib),
                                    _jspec(spec), dtype=jnp.float32,
                                    pack=False, quantize_lm_head=True)
    assert _mismatch(out["lm_head"]["w"], jout["lm_head"]["w"],
                     **GPTQ_TOL) < GPTQ_SHARE
    np.testing.assert_allclose(stats["lm_head_loss"], jstats["lm_head_loss"],
                               rtol=1e-3)


@pytest.mark.parametrize("group_size", [-1, 128])
def test_pack_jax_quantizers(group_size, tmp_path):
    """A quantizers.npz written by JAX's apply_gptq, packed by the port:
    JAX's packed params bit for bit."""
    jp, jcfg, tcfg, calib = _pipeline_case((4, 32))
    jspec = jquant.QuantSpec(bits=4, group_size=group_size)
    qpath = str(tmp_path / "jax_quantizers.npz")
    jout, _ = jpipe.apply_gptq(jp, jcfg, jnp.asarray(calib), jspec,
                               dtype=jnp.float32, quantize_lm_head=True,
                               quantizers_path=qpath)
    out = tpipe.pack_from_quantizers(
        _to_torch(jp, tcfg), tcfg,
        tquant.QuantSpec(bits=4, group_size=group_size), qpath)
    for li in range(2):
        for name in tpipe.LINEARS:
            want = jout["layers"][li][name]
            got = out["layers"][li][name]
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(_np(got[k]), _np(want[k]))
    for k in jout["lm_head"]:
        np.testing.assert_array_equal(_np(out["lm_head"][k]),
                                      _np(jout["lm_head"][k]))
