"""Token-wise activation clipping search (port of qqq_tpu/calib/clipping.py).

Sweeps activation-percentile ratios ``1.0 − i·step`` and keeps the one
that minimizes the calibration LM loss with quantization enabled: every
decoder linear runs fake-quantized per-channel INT4 weights and per-token
INT8 activations whose scale comes from the ``ratio``-quantile of the
token's |x| instead of its absmax.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from qqq_tpu_torch.calib.observers import quantile
from qqq_tpu_torch.core.quant import QuantSpec, fake_quantize_weight, true_div
from qqq_tpu_torch.models import llama as M
from qqq_tpu_torch.models.config import ModelConfig

logger = logging.getLogger("qqq_tpu_torch")


def fake_quant_act_percentile(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """Dynamic per-token INT8 fake quant with percentile clipping."""
    flat = x.to(torch.float32).reshape(-1, x.shape[-1])
    clip = quantile(flat.abs(), ratio, dim=-1, keepdim=True)
    s = true_div(torch.clamp_min(clip, 1e-30), 127.0)
    q = torch.clamp(torch.round(flat / s), -128, 127)
    return (q * s).reshape(x.shape).to(x.dtype)


def _quantized_lm_loss(params: Dict[str, Any], config: ModelConfig,
                       tokens: torch.Tensor, ratio: float) -> torch.Tensor:
    """Causal-LM cross entropy with every decoder linear on fake-quantized
    weights and ratio-clipped per-token INT8 activations."""
    w_spec = QuantSpec(bits=4, group_size=-1)
    B, T = tokens.shape
    dev = tokens.device
    inv_freq = M.rope_inv_freq(config, dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    x = params["embed"][tokens].to(torch.float32)

    def qlin(lin, h):
        wq = fake_quantize_weight(lin["w"].to(torch.float32), w_spec)
        out = fake_quant_act_percentile(h, ratio) @ wq
        if "b" in lin:
            out = out + lin["b"].to(out.dtype)
        return out

    nh, nkv, hd = (config.num_attention_heads, config.num_key_value_heads,
                   config.head_dim)
    mask = positions[:, None, :] <= positions[:, :, None]
    for layer in params["layers"]:
        h = M.rms_norm(x, layer["input_layernorm"], config.rms_norm_eps)
        q = qlin(layer["q_proj"], h).reshape(B, T, nh, hd)
        k = qlin(layer["k_proj"], h).reshape(B, T, nkv, hd)
        v = qlin(layer["v_proj"], h).reshape(B, T, nkv, hd)
        q, k = M.apply_rope(q, k, positions, inv_freq)
        kf = M.repeat_kv(k, config.num_kv_groups)
        vf = M.repeat_kv(v, config.num_kv_groups)
        attn = M._attention_scores(q, kf, vf, mask).reshape(B, T, nh * hd)
        x = x + qlin(layer["o_proj"], attn)
        h2 = M.rms_norm(x, layer["post_attention_layernorm"],
                        config.rms_norm_eps)
        swiglu = F.silu(qlin(layer["gate_proj"], h2)) * qlin(
            layer["up_proj"], h2)
        x = x + qlin(layer["down_proj"], swiglu)

    x = M.rms_norm(x, params["norm"], config.rms_norm_eps)
    head = (params["lm_head"]["w"] if params.get("lm_head") is not None
            else params["embed"].T)
    logits = x @ head.to(x.dtype)
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].to(torch.int64))
    return torch.mean(nll)


def token_wise_clipping_search(
    params: Dict[str, Any],
    config: ModelConfig,
    calib_tokens: torch.Tensor,  # (n, T)
    *,
    a_bit: int = 8,
    step: float = 0.005,
    iters: int = 10,
) -> Tuple[float, float]:
    """Returns (best_ratio, best_loss); the first of equal losses wins."""
    del a_bit  # the reference's candidate count per bit width is ``iters``
    best_ratio, best_loss = 1.0, None
    with torch.no_grad():
        for i in range(iters):
            ratio = 1.0 - step * i
            loss = float(_quantized_lm_loss(params, config, calib_tokens,
                                            ratio))
            logger.info("token clipping ratio %.4f: loss %.5f", ratio, loss)
            if best_loss is None or loss < best_loss:
                best_ratio, best_loss = ratio, loss
    return best_ratio, best_loss
