"""Round-to-nearest W4 packing of dense params (port of
qqq_tpu/calib/pipeline.py:quantize_result_to_linear and of the RTN stand-in
that the JAX package's entry points use in place of GPTQ).

Per-channel only in this slice: each decoder linear becomes
``{"w_packed": (K//8, N) int32, "s_channel": (N,) f32[, "b"]}``.  Embeddings,
norms and the lm_head stay dense, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from qqq_tpu_torch.core.packing import pack_int4
from qqq_tpu_torch.core.quant import (
    QuantSpec, find_params_weight, quantize_weight_int,
)

LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj",
           "gate_proj", "up_proj", "down_proj")


def quantize_result_to_linear(
    q4: torch.Tensor, scale: torch.Tensor, spec: QuantSpec,
    bias: Optional[torch.Tensor],
) -> Dict[str, Any]:
    """Signed codes (K, N) and scales (1, N) → packed inference linear."""
    if not spec.per_channel:
        raise NotImplementedError("g128 packing arrives in the next slice")
    p: Dict[str, Any] = {
        "w_packed": pack_int4(q4),
        "s_channel": scale[0].to(torch.float32),
    }
    if bias is not None:
        p["b"] = bias
    return p


def quantize_linear_rtn(lin: Dict[str, torch.Tensor],
                        spec: QuantSpec) -> Dict[str, Any]:
    w = lin["w"].to(torch.float32)
    scale, zero = find_params_weight(w, spec)
    q4 = quantize_weight_int(w, scale, zero, spec)
    return quantize_result_to_linear(q4, scale, spec, lin.get("b"))


def quantize_params_rtn(
    params: Dict[str, Any], config, group_size: int = -1,
) -> Dict[str, Any]:
    """Pack every decoder linear with round-to-nearest W4.  The dense
    weights of a layer are dropped from the result as it is packed."""
    if group_size != -1:
        raise NotImplementedError(
            "g128 RTN packing arrives with the g128 GEMM in the next slice"
        )
    if len(params["layers"]) != config.num_hidden_layers:
        raise ValueError("params and config disagree on the layer count")
    spec = QuantSpec(bits=4, group_size=group_size)
    layers = []
    for layer in params["layers"]:
        nl = dict(layer)
        for name in LINEARS:
            nl[name] = quantize_linear_rtn(layer[name], spec)
        layers.append(nl)
    return {**params, "layers": layers}
