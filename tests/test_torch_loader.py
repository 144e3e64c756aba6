"""Port (qqq_tpu_torch) against the JAX package: checkpoints.

* The port's own safetensors reader and writer against the ``safetensors``
  package, both ways, at every dtype the checkpoints use: bit-exact.
* Our quantized layout (``save_quantized`` / ``load_quantized``), per
  channel and g128, written by either package and read by the other:
  every tensor bit-exact; the forward logits of the loaded params within
  2e-3 of JAX's, as tests/test_torch_g128.py holds the model.
* A toy HF directory (``model.safetensors`` and ``pytorch_model.bin``) read
  by ``load_hf_model``: bit-exact to JAX's import.
* The reference QQQ's Marlin layout: a checkpoint that JAX's
  ``save_marlin_checkpoint`` writes, read by the port's
  ``load_qqq_hf_checkpoint``, bit-exact to JAX's reading of it; the port's
  writer read back by JAX's reader too.
* ``load_any``'s three-way dispatch.

Weights are drawn from seeds (JAX's init, the port's RTN packing); the
directories are written by the test.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

from qqq_tpu.cli.eval import load_any as jax_load_any
from qqq_tpu.models import ModelConfig as JConfig
from qqq_tpu.models import forward as jax_forward
from qqq_tpu.models import init_params as jax_init_params
from qqq_tpu.models import loader as jloader
from qqq_tpu.models import marlin_compat as jmarlin

from qqq_tpu_torch.cli.eval import load_any
from qqq_tpu_torch.models import (
    ModelConfig, forward, params_from_numpy, quantize_params_rtn,
)
from qqq_tpu_torch.models import loader, marlin_compat

_CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
JCFG, TCFG = JConfig(**_CFG), ModelConfig(**_CFG)
LOGIT_TOL = 2e-3


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy (bf16 as uint16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jnp_bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    if tree is None:
        return None
    a = _np(tree)
    return jnp.asarray(a.view(jnp.bfloat16) if tree.dtype == torch.bfloat16
                       else a)


def _assert_same_tree(port, ref):
    """Same structure, dtypes and bits (``ref`` a JAX tree)."""
    if isinstance(ref, dict):
        assert set(port) == set(ref)
        for k in ref:
            _assert_same_tree(port[k], ref[k])
    elif isinstance(ref, list):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _assert_same_tree(a, b)
    elif ref is None:
        assert port is None
    else:
        want = _jnp_bits(ref)
        got = _np(port)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def dense():
    jparams = jax_init_params(JCFG, jax.random.PRNGKey(3), dtype=jnp.float32)
    return params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG,
                             device="cpu")


@pytest.fixture(scope="module", params=[-1, 128], ids=["channel", "g128"])
def packed(request, dense):
    """(group size, port params, the same bits as a JAX tree); the g128
    scales bf16, as the calibration pipeline stores them."""
    tparams = quantize_params_rtn(dense, TCFG, group_size=request.param)
    return request.param, tparams, _to_jax(tparams)


_ST_DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.int8,
              torch.uint8, torch.int32, torch.int64]


@pytest.mark.parametrize("dtype", _ST_DTYPES, ids=str)
def test_safetensors_io_matches_the_package(tmp_path, dtype):
    """The port's writer read by ``safe_open`` and the package's writer read
    by the port: dtype, shape and bytes equal, an empty tensor and a
    3-d one included, with metadata in the header."""
    g = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        base = torch.randn((3, 5, 7), generator=g).to(dtype)
    else:
        info = torch.iinfo(dtype)
        base = torch.randint(info.min, info.max, (3, 5, 7), generator=g,
                             dtype=torch.int64).to(dtype)
    tensors = {"w": base, "row": base[1, 2].clone(),
               "empty": base[:0].clone(),
               "odd": base.reshape(-1)[:3].clone(),
               "f32": torch.arange(4, dtype=torch.float32)}
    path = str(tmp_path / "port.safetensors")
    loader._st_write(path, tensors, metadata={"format": "pt"})
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        assert set(f.keys()) == set(tensors)
        for k, t in tensors.items():
            got = f.get_tensor(k)
            assert got.dtype == t.dtype and got.shape == t.shape
            assert got.view(torch.uint8).tolist() == t.view(
                torch.uint8).tolist()
    path = str(tmp_path / "package.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    assert set(loader._st_keys(path)) == set(tensors)
    back = loader._st_read(path)
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and back[k].shape == t.shape
        assert back[k].view(torch.uint8).tolist() == t.view(
            torch.uint8).tolist()


def test_quantized_checkpoints_cross_load(tmp_path, packed):
    """JAX ``save_quantized`` → port ``load_quantized`` and the reverse:
    every tensor's bits and dtype, the config and quantization config; the
    loaded params' logits within 2e-3 of JAX's on the same prompt."""
    gs, tparams, jparams = packed
    qc = {"quant_method": "qqq", "wbits": 4, "group_size": gs}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jloader.save_quantized(jdir, jparams, JCFG, qc)
    loader.save_quantized(tdir, tparams, TCFG, qc)
    got, cfg, got_qc = loader.load_quantized(jdir, dtype=torch.float32,
                                             device="cpu")
    assert cfg == TCFG and got_qc == qc
    want, jcfg, _ = jloader.load_quantized(jdir, dtype=jnp.float32)
    _assert_same_tree(got, want)
    back, jcfg2, back_qc = jloader.load_quantized(tdir, dtype=jnp.float32)
    assert jcfg2 == JCFG and back_qc == qc
    _assert_same_tree(got, back)
    # bf16 loads keep fp32 scales and norms, cast the rest
    bf, _, _ = loader.load_quantized(tdir, dtype=torch.bfloat16,
                                     device="cpu")
    _assert_same_tree(bf, jloader.load_quantized(tdir)[0])
    prompt = np.random.default_rng(1).integers(0, 256, size=(1, 12))
    logits, _ = forward(got, cfg, torch.from_numpy(prompt))
    jlogits, _ = jax_forward(want, jcfg, jnp.asarray(prompt, jnp.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=LOGIT_TOL)


def _write_hf(path, dense, fmt):
    """A toy HF Llama directory from dense params: (out, in) weights."""
    os.makedirs(path, exist_ok=True)
    sd = {"model.embed_tokens.weight": dense["embed"],
          "model.norm.weight": dense["norm"],
          "lm_head.weight": dense["lm_head"]["w"].T.contiguous()}
    for i, layer in enumerate(dense["layers"]):
        pre = f"model.layers.{i}"
        sd[f"{pre}.input_layernorm.weight"] = layer["input_layernorm"]
        sd[f"{pre}.post_attention_layernorm.weight"] = \
            layer["post_attention_layernorm"]
        for ours, theirs in loader._LAYER_LINEARS:
            sd[f"{pre}.{theirs}.weight"] = layer[ours]["w"].T.contiguous()
    sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    if fmt == "safetensors":
        save_file(sd, os.path.join(path, "model.safetensors"))
    else:
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**_CFG, "model_type": "llama"}, f)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_load_hf_model_matches_jax(tmp_path, dense, fmt):
    path = str(tmp_path / fmt)
    _write_hf(path, dense, fmt)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got, cfg = loader.load_hf_model(path, dtype=tdt, device="cpu")
        want, jcfg = jloader.load_hf_model(path, dtype=jdt)
        assert cfg == TCFG
        _assert_same_tree(got, want)


def test_marlin_checkpoints_match_jax(tmp_path, packed):
    """JAX's Marlin export read by the port and by JAX: the same params,
    bit for bit (codes repacked into the nibble planes, fp32 scales, bf16
    FP tensors); the port's export read by JAX gives the same params."""
    gs, tparams, jparams = packed
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jmarlin.save_marlin_checkpoint(jdir, jparams, JCFG, group_size=gs)
    marlin_compat.save_marlin_checkpoint(tdir, tparams, TCFG, group_size=gs)
    want, _ = jmarlin.load_qqq_hf_checkpoint(jdir)
    got, cfg = marlin_compat.load_qqq_hf_checkpoint(jdir, device="cpu")
    assert cfg == TCFG
    _assert_same_tree(got, want)
    _assert_same_tree(got, jmarlin.load_qqq_hf_checkpoint(tdir)[0])
    # the files themselves: the same tensors, bit for bit
    a, b = loader._st_read(os.path.join(jdir, "model.safetensors")), \
        loader._st_read(os.path.join(tdir, "model.safetensors"))
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(
            a[k].view(torch.uint8), b[k].view(torch.uint8)), k
    # codes and per-channel scales survive the round trip exactly
    for lin in ("q_proj", "down_proj"):
        orig, back = tparams["layers"][1][lin], got["layers"][1][lin]
        assert torch.equal(orig["w_packed"], back["w_packed"])
        if gs == -1:
            assert torch.equal(orig["s_channel"], back["s_channel"])


def test_load_any_dispatch(tmp_path, dense, packed):
    """Our layout, the Marlin layout and a plain HF directory each load
    through ``load_any`` as their own loader loads them, and as JAX's
    ``load_any`` does."""
    gs, tparams, jparams = packed
    ours, marlin, hf = (str(tmp_path / n) for n in ("ours", "marlin", "hf"))
    loader.save_quantized(ours, tparams, TCFG)
    marlin_compat.save_marlin_checkpoint(marlin, tparams, TCFG,
                                         group_size=gs)
    _write_hf(hf, dense, "safetensors")
    for path in (ours, marlin, hf):
        got, cfg = load_any(path, torch.float32, device="cpu")
        want, _ = jax_load_any(path, jnp.float32)
        _assert_same_tree(got, want)
    assert "w_packed" in load_any(ours, device="cpu")[0]["layers"][0][
        "q_proj"]
    assert "w" in load_any(hf, device="cpu")[0]["layers"][0]["q_proj"]
