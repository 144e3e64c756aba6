"""Decode-time INT8 KV write into the fixed-slot cache (port of
qqq_tpu/kernels/kv_write.py:slot_decode_write_int8).

Per (b, kv head), the new token's K and V rows are quantized by
serve/kv_cache._quant's numerics and written **in place** at position
``min(cache_len[b], S - 1)``.  On CUDA tensors this is one launch of
csrc/kv_write.cu (quantization and store fused); on CPU tensors the plain
PyTorch version runs.  Codes and scales are bit-identical between the two.
The paged writes (_write_kernel, _chunk_write_kernel) come with the paged
pool in a later slice.
"""

from __future__ import annotations

import torch

from qqq_tpu_torch.kernels import build
from qqq_tpu_torch.serve.kv_cache import _quant

_IN_DTYPES = (torch.bfloat16, torch.float32)


def slot_decode_write_int8_plain(k_cache, k_scale, v_cache, v_scale,
                                 k_new, v_new, cache_len):
    B, nkv, S, hd = k_cache.shape
    pos = cache_len.to(torch.int64).clamp(0, S - 1)
    rows = torch.arange(B, device=k_cache.device)
    for cache, scale, new in ((k_cache, k_scale, k_new),
                              (v_cache, v_scale, v_new)):
        q, s = _quant(new[:, 0])  # (B, nkv, hd), (B, nkv)
        cache[rows, :, pos] = q
        scale[rows, :, pos] = s
    return k_cache, k_scale, v_cache, v_scale


def slot_decode_write_int8(
    k_cache: torch.Tensor,   # (B, nkv, S, hd) int8, updated in place
    k_scale: torch.Tensor,   # (B, nkv, S) f32, updated in place
    v_cache: torch.Tensor,
    v_scale: torch.Tensor,
    k_new: torch.Tensor,     # (B, 1, nkv, hd) bf16 or f32
    v_new: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) int32: the position being written
):
    """Quantize and write one decode token per row, in place; returns the
    four (same) cache buffers."""
    B, nkv, S, hd = k_cache.shape
    if tuple(k_new.shape) != (B, 1, nkv, hd):
        raise ValueError(f"k_new {tuple(k_new.shape)}, expected "
                         f"{(B, 1, nkv, hd)}")
    if k_cache.device.type == "cpu":
        return slot_decode_write_int8_plain(k_cache, k_scale, v_cache,
                                            v_scale, k_new, v_new, cache_len)
    if k_cache.device.type != "cuda":
        raise ValueError(f"slot_decode_write_int8: device {k_cache.device}")
    if k_new.dtype not in _IN_DTYPES:
        raise TypeError(f"k_new dtype {k_new.dtype} not in {_IN_DTYPES}")
    for t, dt, shape, name in (
        (k_cache, torch.int8, (B, nkv, S, hd), "k_cache"),
        (v_cache, torch.int8, (B, nkv, S, hd), "v_cache"),
        (k_scale, torch.float32, (B, nkv, S), "k_scale"),
        (v_scale, torch.float32, (B, nkv, S), "v_scale"),
        (k_new, k_new.dtype, (B, 1, nkv, hd), "k_new"),
        (v_new, k_new.dtype, (B, 1, nkv, hd), "v_new"),
        (cache_len, torch.int32, (B,), "cache_len"),
    ):
        build.require(t, dt, shape, name, k_cache.device)
    fn = build.bind("kv_write", "slot_decode_write_int8", "pppppppiiiiip")
    build.check(fn(k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
                   k_scale.data_ptr(), v_cache.data_ptr(), v_scale.data_ptr(),
                   cache_len.data_ptr(), B, nkv, S, hd,
                   int(k_new.dtype == torch.bfloat16),
                   build.stream_of(k_cache)),
                "slot_decode_write_int8")
    slot_decode_write_int8.launches += 1
    return k_cache, k_scale, v_cache, v_scale


slot_decode_write_int8.launches = 0  # kernel launches; only CUDA counts
