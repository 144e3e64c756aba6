"""Port (qqq_tpu_torch) against the JAX package: ``cli/quantize`` and the
calibration data loader.

A tiny HF directory is written with the port's own safetensors writer
(``models/loader.py:save_hf_model``, as the card machine has no
``transformers``) and quantized by ``python -m qqq_tpu_torch.cli.quantize
--device cpu`` with the reference's two recipes: rotation + GPTQ (g128,
MSE grid) and os+ smoothing + GPTQ (per channel).

* the checkpoint loads in JAX's ``load_quantized`` and in the port's with
  every tensor bit-equal, JAX's forward on it within 2e-3 of the port's
  (tests/test_torch_loader.py's bound), and it serves through the port's
  ``Engine``;
* ``--pack_only`` (from the saved codes and scale list) writes the same
  bytes; ``--offload`` (layers streamed from host memory) writes the same
  bytes as the resident run; ``--save_format marlin`` loads through
  ``load_any``;
* ``get_loaders("synthetic")`` and ``_crops`` equal JAX's; a known
  dataset that cannot be loaded raises unless ``--allow_synthetic``.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qqq_tpu.models import forward as jax_forward
from qqq_tpu.models import loader as jloader
from qqq_tpu.utils import data as jdata

from qqq_tpu_torch.cli import quantize as tquantize
from qqq_tpu_torch.cli.eval import load_any
from qqq_tpu_torch.models import ModelConfig, forward, init_params
from qqq_tpu_torch.models import loader
from qqq_tpu_torch.serve.engine import Engine, Request
from qqq_tpu_torch.serve.sampling import SamplingParams
from qqq_tpu_torch.utils import data as tdata

CFG = ModelConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=4, max_position_embeddings=256)
LOGIT_TOL = 2e-3
ROTATE = ["--rotate", "hadamard", "--w_group_size", "128", "--gptq_mse",
          "true"]
SMOOTH = ["--smooth_method", "os+", "--w_group_size", "-1"]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    params = init_params(CFG, torch.Generator().manual_seed(0),
                         dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for layer in params["layers"]:  # norms that the folds must carry
        for name in ("input_layernorm", "post_attention_layernorm"):
            layer[name] = 0.5 + torch.rand(128, generator=gen)
    path = str(tmp_path_factory.mktemp("hf") / "tiny")
    loader.save_hf_model(path, params, CFG)
    return path


def _quantize(hf_dir, out, *flags):
    tquantize.main(["--model_path", hf_dir, "--save_path", out,
                    "--calib_dataset", "synthetic", "--nsamples", "8",
                    "--max_length", "32", "--dtype", "float32",
                    "--device", "cpu", *flags])


def _bytes(path):
    with open(os.path.join(path, "model.safetensors"), "rb") as f:
        return f.read()


def test_save_hf_model_round_trip(hf_dir):
    params, config = loader.load_hf_model(hf_dir, torch.float32, "cpu")
    assert config == CFG
    jparams, jconfig = jloader.load_hf_model(hf_dir, dtype=jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(jparams["layers"][1]["down_proj"]["w"]),
        params["layers"][1]["down_proj"]["w"].numpy())


@pytest.mark.parametrize("recipe", ["rotate", "smooth"])
def test_quantize_cli(hf_dir, tmp_path, recipe):
    flags = ROTATE if recipe == "rotate" else SMOOTH
    out = str(tmp_path / "q")
    _quantize(hf_dir, out, *flags)
    assert os.path.exists(out + "_quantizers.npz")
    assert (recipe == "smooth") == os.path.exists(out + "_scale_list.npz")

    # JAX's reader and the port's: the same tensors, bit for bit
    params, config, qc = loader.load_quantized(out, torch.float32, "cpu")
    jparams, jconfig, jqc = jloader.load_quantized(out, dtype=jnp.float32)
    assert qc == jqc and qc["group_size"] == int(flags[flags.index(
        "--w_group_size") + 1])
    flat, jflat = loader._flatten(params), jloader._flatten(jparams)
    assert set(flat) == set(jflat)
    for k, t in flat.items():
        a = np.asarray(jflat[k])
        np.testing.assert_array_equal(
            t.numpy() if t.dtype != torch.bfloat16
            else t.view(torch.int16).numpy().view(np.uint16),
            a.view(np.uint16) if a.dtype.name == "bfloat16" else a, k)
    tokens = np.random.default_rng(2).integers(0, 256, (2, 16))
    got, _ = forward(params, config, torch.from_numpy(tokens))
    want, _ = jax_forward(jparams, jconfig, jnp.asarray(tokens, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)

    # served through the port's Engine
    eng = Engine(params, config, max_batch=2, max_len=64, device="cpu",
                 dtype=torch.float32, prefill_buckets=(16, 32))
    reqs = [Request(prompt_tokens=[int(t) for t in tokens[i]],
                    sampling=SamplingParams(max_new_tokens=6))
            for i in range(2)]
    eng.run(reqs)
    assert all(len(r.output_tokens) == 6 for r in reqs)

    # pack-only resume: the same bytes
    # (the smoothing scales are read from beside --save_path)
    repacked = str(tmp_path / "r")
    if recipe == "smooth":
        shutil.copy(out + "_scale_list.npz", repacked + "_scale_list.npz")
    _quantize(hf_dir, repacked, *flags, "--pack_only", "--quantizers_path",
              out + "_quantizers.npz")
    assert _bytes(repacked) == _bytes(out)


def test_quantize_cli_offload_and_marlin(hf_dir, tmp_path):
    """--offload (GPTQ only, layers from host memory) writes the resident
    run's bytes; --save_format marlin loads through load_any."""
    base = ["--w_group_size", "128"]
    resident, offload = str(tmp_path / "a"), str(tmp_path / "b")
    _quantize(hf_dir, resident, *base)
    _quantize(hf_dir, offload, *base, "--offload", "true")
    assert _bytes(offload) == _bytes(resident)
    marlin = str(tmp_path / "m")
    _quantize(hf_dir, marlin, *base, "--pack_only", "--save_format",
              "marlin", "--quantizers_path", resident + "_quantizers.npz")
    with open(os.path.join(marlin, "config.json")) as f:
        assert json.load(f)["quantization_config"]["quant_method"] == "qqq"
    mparams, _ = load_any(marlin, torch.float32, device="cpu")
    nparams, _ = load_any(resident, torch.float32, device="cpu")
    for name in ("q_proj", "down_proj"):
        assert torch.equal(mparams["layers"][1][name]["w_packed"],
                           nparams["layers"][1][name]["w_packed"])


def test_quantize_cli_rejects_offload_with_rotation(hf_dir, tmp_path):
    with pytest.raises(SystemExit):
        _quantize(hf_dir, str(tmp_path / "x"), *ROTATE, "--offload", "true")


def test_quantize_cli_needs_a_card_by_default(hf_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tquantize.main(["--model_path", hf_dir, "--save_path",
                        str(tmp_path / "x"), "--calib_dataset", "synthetic"])


def test_get_loaders_synthetic_and_crops():
    calib, test = tdata.get_loaders("synthetic", nsamples=5, seed=3,
                                    seqlen=64, vocab_size=1000)
    jcalib, jtest = jdata.get_loaders("synthetic", nsamples=5, seed=3,
                                      seqlen=64, vocab_size=1000)
    np.testing.assert_array_equal(calib, jcalib)
    np.testing.assert_array_equal(test, jtest)
    ids = np.random.default_rng(0).integers(0, 1000, 5000).astype(np.int32)
    np.testing.assert_array_equal(tdata._crops(ids, 7, 11, 128),
                                  jdata._crops(ids, 7, 11, 128))
    assert tdata.KNOWN_DATASETS == jdata.KNOWN_DATASETS


def test_known_dataset_without_allow_synthetic_raises(monkeypatch):
    def unavailable(*args, **kwargs):
        raise OSError("no network")

    monkeypatch.setattr(tdata, "_load_corpus", unavailable)
    with pytest.raises(RuntimeError, match="allow_synthetic"):
        tdata.get_loaders("wikitext2", "unused", nsamples=2, seqlen=16)
    calib, _ = tdata.get_loaders("wikitext2", "unused", nsamples=2, seqlen=16,
                                 vocab_size=50, allow_synthetic=True)
    np.testing.assert_array_equal(
        calib, tdata.get_loaders("synthetic", nsamples=2, seqlen=16,
                                 vocab_size=50)[0])
    with pytest.raises(ValueError, match="unknown calibration dataset"):
        tdata.get_loaders("no-such-corpus")
