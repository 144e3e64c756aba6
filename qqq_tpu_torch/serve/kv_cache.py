"""KV cache: fixed-slot layout with optional INT8 quantization (port of
qqq_tpu/serve/kv_cache.py).

Layout per layer is head-major: ``k``/``v`` of shape (B, n_kv, S, head_dim),
INT8 scales (B, n_kv, S); slot ``s`` holds the token at position ``s``.

Unlike the JAX package, whose arrays are immutable, :func:`write` updates the
cache buffers **in place** (and returns the same dict): the decode write goes
through the slot-write kernel, the prefill write (T > 1) through one indexed
copy per buffer.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from qqq_tpu_torch.core.quant import true_div

_F32_TINY = torch.finfo(torch.float32).tiny


def init(
    config, batch: int, max_len: int, *, quantized: bool = True,
    dtype: torch.dtype = torch.bfloat16, device=None,
) -> List[Dict[str, Any]]:
    nkv, hd = config.num_key_value_heads, config.head_dim
    store_dtype = torch.int8 if quantized else dtype
    caches = []
    for _ in range(config.num_hidden_layers):
        c = {
            "k": torch.zeros((batch, nkv, max_len, hd), dtype=store_dtype,
                             device=device),
            "v": torch.zeros((batch, nkv, max_len, hd), dtype=store_dtype,
                             device=device),
        }
        if quantized:
            c["k_scale"] = torch.zeros((batch, nkv, max_len),
                                       dtype=torch.float32, device=device)
            c["v_scale"] = torch.zeros((batch, nkv, max_len),
                                       dtype=torch.float32, device=device)
        caches.append(c)
    return caches


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric INT8 over the last dim: ``s = max(absmax / 127, tiny)``,
    ``q = clip(round(x / s), -128, 127)``; returns (q, s[..., 0])."""
    xf = x.to(torch.float32)
    s = true_div(xf.abs().amax(dim=-1, keepdim=True), 127.0)
    s = torch.clamp_min(s, _F32_TINY)
    q = torch.clamp(torch.round(xf / s), -128, 127).to(torch.int8)
    return q, s[..., 0]


def write(
    cache: Dict[str, Any],
    k_new: torch.Tensor,  # (B, T, n_kv, hd)
    v_new: torch.Tensor,
    offsets: torch.Tensor,  # (B,) int32: position of the first new token
) -> Dict[str, Any]:
    """Write T new tokens per row at ``offsets``, in place.  Like the
    ``dynamic_update_slice`` it ports, a start past ``S - T`` is clamped."""
    quantized = "k_scale" in cache
    if quantized and k_new.shape[1] == 1:
        from qqq_tpu_torch.kernels.kv_write import slot_decode_write_int8

        slot_decode_write_int8(
            cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
            k_new, v_new, offsets,
        )
        return cache

    B, T = k_new.shape[:2]
    S = cache["k"].shape[2]
    start = offsets.to(torch.int64).clamp(0, S - T)
    pos = start[:, None] + torch.arange(T, device=start.device)[None, :]
    rows = torch.arange(B, device=start.device)[:, None]
    # cache[rows, :, pos] is (B, T, n_kv, ...) — the layout of k_new
    if quantized:
        kq, ks = _quant(k_new)
        vq, vs = _quant(v_new)
        cache["k"][rows, :, pos] = kq
        cache["v"][rows, :, pos] = vq
        cache["k_scale"][rows, :, pos] = ks
        cache["v_scale"][rows, :, pos] = vs
    else:
        cache["k"][rows, :, pos] = k_new.to(cache["k"].dtype)
        cache["v"][rows, :, pos] = v_new.to(cache["v"].dtype)
    return cache


def read(cache: Dict[str, Any], dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dequantized full cache in the model's (B, S, n_kv, hd) layout."""
    if "k_scale" in cache:
        k = cache["k"].to(torch.float32) * cache["k_scale"][..., None]
        v = cache["v"].to(torch.float32) * cache["v_scale"][..., None]
        k, v = k.to(dtype), v.to(dtype)
    else:
        k, v = cache["k"].to(dtype), cache["v"].to(dtype)
    return k.transpose(1, 2), v.transpose(1, 2)
