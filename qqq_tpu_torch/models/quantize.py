"""Round-to-nearest W4 packing of dense params (port of
qqq_tpu/calib/pipeline.py:quantize_result_to_linear and of the RTN stand-in
that the JAX package's entry points use in place of GPTQ).

Each decoder linear becomes ``{"w_packed": (K//8, N) int32, "s_channel":
(N,) f32[, "b"]}`` (per channel) or ``{"w_packed", "s_group": (K//128, N)
bf16[, "b"]}`` (g128; the scales are stored in bf16 as the calibration
pipeline stores them, and rounded to bf16 before the codes are chosen, so
stored scales and codes agree).  Embeddings, norms and the lm_head stay
dense, as in the reference.
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
    """Signed codes (K, N) and scales (G, N) → packed inference linear."""
    p: Dict[str, Any] = {"w_packed": pack_int4(q4)}
    if spec.per_channel:
        p["s_channel"] = scale[0].to(torch.float32)
    else:
        p["s_group"] = scale.to(torch.bfloat16)
    if bias is not None:
        p["b"] = bias
    return p


def quantize_linear_rtn(lin: Dict[str, torch.Tensor],
                        spec: QuantSpec) -> Dict[str, Any]:
    w = lin["w"].to(torch.float32)
    scale, zero = find_params_weight(w, spec)
    if not spec.per_channel:  # s_group is stored bf16: round before coding
        scale = scale.to(torch.bfloat16).to(torch.float32)
    q4 = quantize_weight_int(w, scale, zero, spec)
    return quantize_result_to_linear(q4, scale, spec, lin.get("b"))


def quantize_params_rtn(
    params: Dict[str, Any], config, group_size: int = -1,
) -> Dict[str, Any]:
    """Pack every decoder linear with round-to-nearest W4, per channel
    (``group_size=-1``) or in groups of 128.  The dense weights of a layer
    are dropped from the result as it is packed."""
    if group_size not in (-1, 128):
        raise ValueError(f"group_size {group_size}: only -1 and 128")
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
