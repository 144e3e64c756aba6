"""Functional Llama / Qwen2 forward pass (port of qqq_tpu/models/llama.py,
single device: no tensor-parallel or ring branches).

Params keep the JAX package's layout (weights are (in, out)):

    {"embed": (V, H),
     "layers": [
        {"input_layernorm": (H,),
         "q_proj"/"k_proj"/"v_proj"/"o_proj": Linear,
         "post_attention_layernorm": (H,),
         "gate_proj"/"up_proj"/"down_proj": Linear},
        ...],
     "norm": (H,),
     "lm_head": Linear | None (tied embeddings)}

    Linear := {"w": (K, N) [, "b": (N,)]}                         (dense)
             | {"w_packed": (K//8, N) int32, "s_channel": (N,) [, "b"]}  (W4A8)
             | {"w_packed", "s_group": (K//128, N) bf16/f32 [, "b"]}  (W4A8 g128)

:func:`fuse_inference_params` may replace gate/up by one ``gate_up_glu``
linear (the GLU-fused kernel) and q/k/v by one ``qkv_proj``.

A packed linear runs through the W4A8 GEMM kernels; attention over an INT8
slot cache runs through the slot-write, decode and flash kernels, and over
an INT8 block pool (``block_tables`` given, serve/paged_kv.py) through the
paged write, paged decode and paged flash kernels.  Caches are updated in
place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from qqq_tpu_torch.kernels.attention import (
    decode_attention_auto, flash_attention_int8, paged_decode_attention_int8,
    paged_flash_attention_int8,
)
from qqq_tpu_torch.kernels.w4a8_gemm import (
    fuse_glu_layout, w4a8_glu_linear, w4a8_linear,
)
from qqq_tpu_torch.models.config import ModelConfig
from qqq_tpu_torch.serve import kv_cache as kvc
from qqq_tpu_torch.serve import paged_kv as pkv
from qqq_tpu_torch.utils.device import resolve_device

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# primitives


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dtype)


def _requant_policy(x: torch.Tensor) -> Optional[bool]:
    """g128 GEMM route for activations ``x``: a decode-like call (a sequence
    dim shorter than 64, however large the batch) stays on the exact route;
    otherwise the kernel's own rule (requant when M ≥ 512) decides."""
    return False if x.ndim >= 3 and x.shape[-2] < 64 else None


def linear_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Dense or W4A8 linear, dispatched on the param structure."""
    if "w_packed" in p:
        return w4a8_linear(
            x, p["w_packed"], p.get("s_channel"), p.get("s_group"),
            bias=p.get("b"), group_size=128 if "s_group" in p else -1,
            out_dtype=x.dtype, requant=_requant_policy(x),
        )
    out = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        out = out + p["b"].to(out.dtype)
    return out


def rope_inv_freq(config: ModelConfig, device=None) -> torch.Tensor:
    """RoPE inverse frequencies, with HF llama3 and linear scaling."""
    hd = config.head_dim
    inv_freq = 1.0 / (config.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))
    rs = config.rope_scaling_dict
    kind = rs.get("rope_type", rs.get("type")) if rs else None
    if kind == "llama3":
        factor = rs["factor"]
        low = rs["low_freq_factor"]
        high = rs["high_freq_factor"]
        old_len = rs["original_max_position_embeddings"]
        wavelen = 2 * math.pi / inv_freq
        low_wl = old_len / low
        high_wl = old_len / high
        scaled = inv_freq / factor
        smooth = (old_len / wavelen - low) / (high - low)
        smoothed = (1 - smooth) * scaled + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > low_wl,
            torch.where(wavelen < high_wl, smoothed, scaled),
            inv_freq,
        )
    elif kind == "linear":
        inv_freq = inv_freq / rs["factor"]
    return inv_freq


def apply_rope(
    q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
    inv_freq: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-convention rotary embedding (rotate_half).
    q: (B, T, nh, hd), k: (B, T, nkv, hd), positions: (B, T)."""
    angles = positions[..., None].to(torch.float32) * inv_freq  # (B, T, hd/2)
    cos = torch.cat([torch.cos(angles)] * 2, dim=-1)[:, :, None, :]
    sin = torch.cat([torch.sin(angles)] * 2, dim=-1)[:, :, None, :]

    def rot(x):
        xf = x.to(torch.float32)
        half = x.shape[-1] // 2
        rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
        return (xf * cos + rotated * sin).to(x.dtype)

    return rot(q), rot(k)


def repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, nkv, hd) → (B, S, nh, hd) by repeating each kv head."""
    if groups == 1:
        return x
    return torch.repeat_interleave(x, groups, dim=2)


# ---------------------------------------------------------------------------
# attention / mlp / layers


def _attention_scores(q, k, v, mask):
    """Plain softmax attention.  q (B, T, nh, hd), k/v (B, S, nh, hd), mask
    (B, T, S) bool (True = attend)."""
    hd = q.shape[-1]
    scores = torch.einsum(
        "btnh,bsnh->bnts", q.to(torch.float32), k.to(torch.float32)
    ) / math.sqrt(hd)
    scores = torch.where(mask[:, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bnts,bsnh->btnh", probs.to(v.dtype), v)


def attention(
    layer: Dict[str, Any],
    x: torch.Tensor,  # (B, T, H)
    positions: torch.Tensor,  # (B, T)
    inv_freq: torch.Tensor,
    config: ModelConfig,
    cache: Optional[Dict[str, Any]] = None,
    cache_len: Optional[torch.Tensor] = None,
    block_tables: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Self-attention; with a cache the new K/V are written in place first
    (``cache_len`` = tokens already in the cache, per row).  With
    ``block_tables`` (B, max_blocks) the cache is a paged block pool."""
    B, T = x.shape[:2]
    nh, nkv = config.num_attention_heads, config.num_key_value_heads
    hd = config.head_dim
    if "qkv_proj" in layer:  # one GEMM over the concatenated columns
        qkv = linear_apply(layer["qkv_proj"], x)
        qd, kvd = nh * hd, nkv * hd
        q = qkv[..., :qd].reshape(B, T, nh, hd)
        k = qkv[..., qd:qd + kvd].reshape(B, T, nkv, hd)
        v = qkv[..., qd + kvd:].reshape(B, T, nkv, hd)
    else:
        q = linear_apply(layer["q_proj"], x).reshape(B, T, nh, hd)
        k = linear_apply(layer["k_proj"], x).reshape(B, T, nkv, hd)
        v = linear_apply(layer["v_proj"], x).reshape(B, T, nkv, hd)
    q, k = apply_rope(q, k, positions, inv_freq)

    if cache is None:
        kf, vf = k, v
        mask = positions[:, None, :] <= positions[:, :, None]
    elif block_tables is not None:
        cache = pkv.write(cache, k, v, cache_len, block_tables)
        if "k_scale" in cache:
            pool = (cache["k"], cache["k_scale"], cache["v"],
                    cache["v_scale"], block_tables)
            if T == 1:
                out = paged_decode_attention_int8(
                    q[:, 0].contiguous(), *pool, cache_len + 1,
                ).reshape(B, 1, nh * hd)
            else:
                out = paged_flash_attention_int8(
                    q.transpose(1, 2).contiguous(), *pool, cache_len,
                    causal=True,
                ).transpose(1, 2).reshape(B, T, nh * hd)
            return linear_apply(layer["o_proj"], out), cache
        # fp pool: the dense gather, masked as the slot cache is
        S = block_tables.shape[1] * cache["k"].shape[2]
        kf, vf = pkv.read(cache, block_tables, S, x.dtype)
        key_idx = torch.arange(S, device=x.device)[None, :]
        valid = key_idx < (cache_len.to(torch.int64) + T)[:, None]
        mask = valid[:, None, :] & (key_idx[:, None, :] <= positions[:, :, None])
    else:
        cache = kvc.write(cache, k, v, cache_len)
        if "k_scale" in cache:
            if T == 1:
                out = decode_attention_auto(
                    q[:, 0].contiguous(),
                    cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
                    cache_len + 1,
                ).reshape(B, 1, nh * hd)
            else:
                out = flash_attention_int8(
                    q.transpose(1, 2).contiguous(),  # (B, nh, T, hd)
                    cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
                    cache_len, causal=True,
                ).transpose(1, 2).reshape(B, T, nh * hd)
            return linear_apply(layer["o_proj"], out), cache
        kf, vf = kvc.read(cache, x.dtype)
        S = kf.shape[1]
        # slot index doubles as key position
        key_idx = torch.arange(S, device=x.device)[None, :]
        valid = key_idx < (cache_len.to(torch.int64) + T)[:, None]
        mask = valid[:, None, :] & (key_idx[:, None, :] <= positions[:, :, None])

    kf = repeat_kv(kf, config.num_kv_groups)
    vf = repeat_kv(vf, config.num_kv_groups)
    out = _attention_scores(q, kf, vf, mask).reshape(B, T, nh * hd)
    return linear_apply(layer["o_proj"], out), cache


def mlp(layer: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    if "gate_up_glu" in layer:  # silu(gate)·up in the GEMM's f32 epilogue
        h = w4a8_glu_linear(x, layer["gate_up_glu"], out_dtype=x.dtype,
                            requant=_requant_policy(x))
    else:
        gate = linear_apply(layer["gate_proj"], x)
        up = linear_apply(layer["up_proj"], x)
        h = F.silu(gate) * up
    return linear_apply(layer["down_proj"], h)


def decoder_layer(
    layer: Dict[str, Any],
    x: torch.Tensor,
    positions: torch.Tensor,
    inv_freq: torch.Tensor,
    config: ModelConfig,
    cache: Optional[Dict[str, Any]] = None,
    cache_len: Optional[torch.Tensor] = None,
    block_tables: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    h = rms_norm(x, layer["input_layernorm"], config.rms_norm_eps)
    attn_out, cache = attention(layer, h, positions, inv_freq, config, cache,
                                cache_len, block_tables)
    x = x + attn_out
    h = rms_norm(x, layer["post_attention_layernorm"], config.rms_norm_eps)
    return x + mlp(layer, h), cache


def fuse_inference_params(
    params: Dict[str, Any], config: ModelConfig,
    *, qkv: bool = False, glu: bool = True,
) -> Dict[str, Any]:
    """Inference-time GEMM fusion over packed W4A8 params (single device):

    * ``glu``: gate/up → ``gate_up_glu`` (:func:`fuse_glu_layout`), the
      kernel whose epilogue writes silu(gate)·up, so that the (M, I) gate and
      up intermediates never reach device memory;
    * ``qkv``: q/k/v → one ``qkv_proj`` whose columns are q, k, v
      concatenated (off by default, as in JAX).

    Dense layers and shapes that do not fuse pass through unchanged.  The
    fused tensors are new; the unfused ones stay in ``params``."""
    del config  # the layouts carry every shape

    def fuse_qkv(q, k, v):
        parts = (q, k, v)
        if not all("w_packed" in p for p in parts):
            return None
        if len({"s_group" in p for p in parts}) != 1:
            return None
        if len({"b" in p for p in parts}) != 1:
            return None
        fused = {"w_packed": torch.cat([p["w_packed"] for p in parts], dim=1)}
        if "s_group" in q:
            fused["s_group"] = torch.cat([p["s_group"] for p in parts], dim=1)
        else:
            fused["s_channel"] = torch.cat([p["s_channel"] for p in parts])
        if "b" in q:
            fused["b"] = torch.cat([p["b"] for p in parts])
        return fused

    layers = []
    for layer in params["layers"]:
        nl = dict(layer)
        fq = (fuse_qkv(layer["q_proj"], layer["k_proj"], layer["v_proj"])
              if qkv else None)
        if fq is not None:
            nl["qkv_proj"] = fq
            del nl["q_proj"], nl["k_proj"], nl["v_proj"]
        fg = fuse_glu_layout(layer["gate_proj"], layer["up_proj"]) if glu \
            else None
        if fg is not None:
            nl["gate_up_glu"] = fg
            del nl["gate_proj"], nl["up_proj"]
        layers.append(nl)
    return {**params, "layers": layers}


# ---------------------------------------------------------------------------
# full model


def forward(
    params: Dict[str, Any],
    config: ModelConfig,
    tokens: torch.Tensor,  # (B, T) integer
    *,
    positions: Optional[torch.Tensor] = None,
    caches: Optional[List[Dict[str, Any]]] = None,
    cache_len: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
    logits_at: Optional[torch.Tensor] = None,
    block_tables: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[List[Dict[str, Any]]]]:
    """Returns (logits (B, T, V) f32, caches).  ``caches=None`` scores the
    full sequence; with caches this is prefill (T > 1) or decode (T = 1),
    and the caches are updated in place.  With ``block_tables`` (B,
    max_blocks) int32 the caches are paged block pools
    (serve/paged_kv.py) instead of fixed slots.  ``logits_at`` (B,)
    computes the lm_head at that one position per row → (B, 1, V)."""
    B, T = tokens.shape
    dev = tokens.device
    if cache_len is not None:
        cache_len = torch.as_tensor(cache_len, dtype=torch.int32, device=dev)
        cache_len = cache_len.expand(B).contiguous()
    if positions is None:
        ar = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
        positions = (cache_len[:, None] + ar if cache_len is not None
                     else ar.expand(B, T))

    inv_freq = rope_inv_freq(config, dev)
    x = params["embed"][tokens]
    for i, layer in enumerate(params["layers"]):
        x, _ = decoder_layer(
            layer, x, positions, inv_freq, config,
            caches[i] if caches is not None else None, cache_len,
            block_tables,
        )
    x = rms_norm(x, params["norm"], config.rms_norm_eps)
    if return_hidden:
        return x, caches
    if logits_at is not None:
        x = x[torch.arange(B, device=dev), logits_at.to(torch.int64)][:, None]
    if params.get("lm_head") is not None:
        logits = linear_apply(params["lm_head"], x)
    else:  # tied embeddings
        logits = torch.matmul(x, params["embed"].T.to(x.dtype))
    return logits.to(torch.float32), caches


def decode_step(params, config, tokens, caches, cache_len):
    """One decoding step; returns (logits (B, V), caches)."""
    logits, caches = forward(params, config, tokens, caches=caches,
                             cache_len=cache_len)
    return logits[:, -1, :], caches


# ---------------------------------------------------------------------------
# init (random, for tests and the chip smoke run)


def init_params(
    config: ModelConfig,
    generator: Optional[torch.Generator] = None,
    *,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> Dict[str, Any]:
    """Random dense params (N(0, 0.02) weights, unit norms) drawn on
    ``device`` from ``generator`` (a fresh one seeded 0 when None)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    H, I = config.hidden_size, config.intermediate_size
    qd, kvd = config.q_dim, config.kv_dim

    def normal(shape):
        w = torch.empty(shape, dtype=torch.float32, device=device)
        return (w.normal_(generator=generator) * 0.02).to(dtype)

    def dense(shape, bias=False):
        p = {"w": normal(shape)}
        if bias:
            p["b"] = torch.zeros((shape[1],), dtype=dtype, device=device)
        return p

    def ones():
        return torch.ones((H,), dtype=dtype, device=device)

    layers = []
    for _ in range(config.num_hidden_layers):
        layers.append({
            "input_layernorm": ones(),
            "q_proj": dense((H, qd), config.attention_bias),
            "k_proj": dense((H, kvd), config.attention_bias),
            "v_proj": dense((H, kvd), config.attention_bias),
            "o_proj": dense((qd, H)),
            "post_attention_layernorm": ones(),
            "gate_proj": dense((H, I)),
            "up_proj": dense((H, I)),
            "down_proj": dense((I, H)),
        })
    embed = normal((config.vocab_size, H))
    return {
        "embed": embed,
        "layers": layers,
        "norm": ones(),
        "lm_head": None if config.tie_word_embeddings
        else dense((H, config.vocab_size)),
    }
