"""QuaRot-style network rotation (port of qqq_tpu/calib/rotation.py).

RMSNorm weights are folded into the linears after them, then every
hidden-state interface is conjugated with an orthogonal Q (outliers spread
across channels) and v/o get a per-head exact Hadamard; the network
computes the same function.  On the (in, out) weight layout the reference's
``W·Q`` / ``Qᵀ·W`` on (out, in) weights are ``Qᵀ·w`` / ``w·Q``.  Q is built
on the host in float64 (``core/hadamard.py``, the JAX package's Q bit for
bit); the folds run in float32 on the weights' device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from qqq_tpu_torch.core.hadamard import hadamard_matrix, random_hadamard_matrix
from qqq_tpu_torch.models.config import ModelConfig


def _fold_ln(ln_w: torch.Tensor, linears: list):
    """``w ← diag(ln) · w`` on the input side of each linear; ln ← 1."""
    out = []
    for lin in linears:
        w = lin["w"].to(torch.float32) * ln_w.to(torch.float32)[:, None]
        out.append({**lin, "w": w.to(lin["w"].dtype)})
    return torch.ones_like(ln_w), out


def fuse_layer_norms(params: Dict[str, Any],
                     config: ModelConfig) -> Dict[str, Any]:
    """input_layernorm → q/k/v, post_attention_layernorm → gate/up, the
    final norm → lm_head.  Tied embeddings are untied first (a fold into a
    tied embedding would change the input side too)."""
    del config
    params = dict(params)
    if params.get("lm_head") is None:
        params["lm_head"] = {"w": params["embed"].T.contiguous()}
    new_layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        layer["input_layernorm"], (
            layer["q_proj"], layer["k_proj"], layer["v_proj"]) = _fold_ln(
            layer["input_layernorm"],
            [layer["q_proj"], layer["k_proj"], layer["v_proj"]])
        layer["post_attention_layernorm"], (
            layer["gate_proj"], layer["up_proj"]) = _fold_ln(
            layer["post_attention_layernorm"],
            [layer["gate_proj"], layer["up_proj"]])
        new_layers.append(layer)
    params["layers"] = new_layers
    params["norm"], (params["lm_head"],) = _fold_ln(params["norm"],
                                                    [params["lm_head"]])
    return params


def get_orthogonal_matrix(size: int, mode: str = "hadamard",
                          seed: int = 0) -> np.ndarray:
    """'hadamard' (randomized) or 'random' (QR), float64."""
    if mode == "hadamard":
        return random_hadamard_matrix(size, seed=seed)
    if mode == "random":
        rng = np.random.default_rng(seed)
        q, r = np.linalg.qr(rng.standard_normal((size, size)))
        return q * np.sign(np.diag(r))[None, :]
    raise ValueError(f"unknown rotation mode {mode!r}")


def _rot_in(lin: Dict[str, Any], Q: torch.Tensor) -> Dict[str, Any]:
    """Input side: ``Qᵀ · w``."""
    return {**lin, "w": (Q.T @ lin["w"].to(torch.float32)).to(lin["w"].dtype)}


def _rot_out(lin: Dict[str, Any], Q: torch.Tensor) -> Dict[str, Any]:
    """Output side: ``w · Q``; the bias rotates too."""
    nl = {**lin, "w": (lin["w"].to(torch.float32) @ Q).to(lin["w"].dtype)}
    if "b" in lin:
        nl["b"] = (lin["b"].to(torch.float32) @ Q).to(lin["b"].dtype)
    return nl


def _head_hadamard(head_dim: int, device) -> torch.Tensor:
    return torch.from_numpy(hadamard_matrix(head_dim)).to(
        device=device, dtype=torch.float32)


def _had_heads_out(lin: Dict[str, Any], head_dim: int) -> Dict[str, Any]:
    """Per-head exact Hadamard on the output side (v_proj): each head_dim
    chunk of the output is multiplied by H_hd."""
    w = lin["w"].to(torch.float32)
    Hd = _head_hadamard(head_dim, w.device)
    K, N = w.shape
    nl = {**lin, "w": (w.reshape(K, N // head_dim, head_dim) @ Hd)
          .reshape(K, N).to(lin["w"].dtype)}
    if "b" in lin:
        b = lin["b"].to(torch.float32)
        nl["b"] = ((b.reshape(N // head_dim, head_dim) @ Hd).reshape(N)
                   .to(lin["b"].dtype))
    return nl


def _had_heads_in(lin: Dict[str, Any], head_dim: int) -> Dict[str, Any]:
    """Per-head exact Hadamard on the input side (o_proj): ``H · w`` per
    head block (H is symmetric and orthogonal)."""
    w = lin["w"].to(torch.float32)
    Hd = _head_hadamard(head_dim, w.device)
    K, N = w.shape
    wr = w.reshape(K // head_dim, head_dim, N)
    w = torch.einsum("de,gen->gdn", Hd, wr).reshape(K, N)
    return {**lin, "w": w.to(lin["w"].dtype)}


def rotate_model(
    params: Dict[str, Any],
    config: ModelConfig,
    *,
    mode: str = "hadamard",
    seed: int = 0,
    Q: Optional[np.ndarray] = None,
) -> Tuple[Dict[str, Any], np.ndarray]:
    """Rotate a model whose norms :func:`fuse_layer_norms` folded.  A given
    ``Q`` is applied again (the same rotation after smoothing).  Returns
    (params, Q float64)."""
    if Q is None:
        Q = get_orthogonal_matrix(config.hidden_size, mode, seed)
    dev = params["embed"].device
    Qt = torch.from_numpy(np.asarray(Q)).to(device=dev, dtype=torch.float32)
    hd = config.head_dim

    params = dict(params)
    params["embed"] = (params["embed"].to(torch.float32) @ Qt).to(
        params["embed"].dtype)
    if params.get("lm_head") is not None:
        params["lm_head"] = _rot_in(params["lm_head"], Qt)
    new_layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        for name in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
            layer[name] = _rot_in(layer[name], Qt)
        layer["o_proj"] = _rot_out(layer["o_proj"], Qt)
        layer["down_proj"] = _rot_out(layer["down_proj"], Qt)
        layer["v_proj"] = _had_heads_out(layer["v_proj"], hd)
        layer["o_proj"] = _had_heads_in(layer["o_proj"], hd)
        new_layers.append(layer)
    params["layers"] = new_layers
    return params, Q
