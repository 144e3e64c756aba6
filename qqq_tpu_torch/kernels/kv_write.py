"""INT8 KV writes into the fixed-slot cache and into the paged block pool
(port of qqq_tpu/kernels/kv_write.py: slot_decode_write_int8,
paged_decode_write_int8 and paged_chunk_write_int8).

Per token row and kv head, the new K and V rows are quantized by
serve/kv_cache._quant's numerics and written **in place**:
* slot: at position ``min(cache_len[b], S - 1)`` of row b;
* paged: token t of row b at position ``p = cache_len[b] + t``, in pool
  block ``tables[b, p // bs]`` at ``p % bs``, or in the null block 0 when
  ``p // bs`` is past the table (serve/paged_kv.py).
On CUDA tensors each is one launch of csrc/kv_write.cu (quantization and
store fused); on CPU tensors the plain PyTorch versions run.  Codes and
scales are bit-identical between the two, outside the null block, whose
content the pool leaves unspecified (rows that land there may collide).
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


# ---------------------------------------------------------------------------
# paged pool


def paged_chunk_write_int8_plain(k_pool, k_scale, v_pool, v_scale, k_new,
                                 v_new, tables, cache_len):
    """Both paged writes' plain version: ``_quant`` per token row and head,
    then one indexed store per buffer (rows that route to the null block
    may collide there, in any order)."""
    from qqq_tpu_torch.serve.paged_kv import _phys_or_null

    bs = k_pool.shape[2]
    T = k_new.shape[1]
    pos = (cache_len.to(torch.int64)[:, None]
           + torch.arange(T, device=k_pool.device)[None, :])  # (B, T)
    phys = _phys_or_null(tables, pos // bs)
    off = pos % bs
    for pool, scale, new in ((k_pool, k_scale, k_new),
                             (v_pool, v_scale, v_new)):
        q, s = _quant(new)  # (B, T, nkv, hd), (B, T, nkv)
        pool[phys, :, off] = q
        scale[phys, :, off] = s
    return k_pool, k_scale, v_pool, v_scale


paged_decode_write_int8_plain = paged_chunk_write_int8_plain


def _paged_write(fn, plain, k_pool, k_scale, v_pool, v_scale, k_new, v_new,
                 tables, cache_len):
    """The two paged writes' wrapper body: CPU tensors → ``plain``; CUDA
    tensors → check every operand and launch the C entry named like
    ``fn``."""
    name = fn.__name__
    nb, nkv, bs, hd = k_pool.shape
    B, T = k_new.shape[:2]
    nbmax = tables.shape[1]
    if tuple(k_new.shape) != (B, T, nkv, hd) or (
            fn is paged_decode_write_int8 and T != 1):
        raise ValueError(f"{name}: k_new {tuple(k_new.shape)} against pool "
                         f"{tuple(k_pool.shape)}")
    if k_pool.device.type == "cpu":
        return plain(k_pool, k_scale, v_pool, v_scale, k_new, v_new, tables,
                     cache_len)
    if k_pool.device.type != "cuda":
        raise ValueError(f"{name}: device {k_pool.device}")
    if k_new.dtype not in _IN_DTYPES:
        raise TypeError(f"k_new dtype {k_new.dtype} not in {_IN_DTYPES}")
    for t, dt, shape, arg in (
        (k_pool, torch.int8, (nb, nkv, bs, hd), "k_pool"),
        (v_pool, torch.int8, (nb, nkv, bs, hd), "v_pool"),
        (k_scale, torch.float32, (nb, nkv, bs), "k_scale"),
        (v_scale, torch.float32, (nb, nkv, bs), "v_scale"),
        (k_new, k_new.dtype, (B, T, nkv, hd), "k_new"),
        (v_new, k_new.dtype, (B, T, nkv, hd), "v_new"),
        (tables, torch.int32, (B, nbmax), "tables"),
        (cache_len, torch.int32, (B,), "cache_len"),
    ):
        build.require(t, dt, shape, arg, k_pool.device)
    if B * T == 0:
        return k_pool, k_scale, v_pool, v_scale
    c = build.bind("kv_write", name, "ppppppppiiiiiiip")
    build.check(c(k_new.data_ptr(), v_new.data_ptr(), k_pool.data_ptr(),
                  k_scale.data_ptr(), v_pool.data_ptr(), v_scale.data_ptr(),
                  tables.data_ptr(), cache_len.data_ptr(), B, T, nkv, bs,
                  nbmax, hd, int(k_new.dtype == torch.bfloat16),
                  build.stream_of(k_pool)), name)
    fn.launches += 1
    return k_pool, k_scale, v_pool, v_scale


def paged_decode_write_int8(
    k_pool: torch.Tensor,    # (nb, nkv, bs, hd) int8, updated in place
    k_scale: torch.Tensor,   # (nb, nkv, bs) f32, updated in place
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    k_new: torch.Tensor,     # (B, 1, nkv, hd) bf16 or f32
    v_new: torch.Tensor,
    tables: torch.Tensor,    # (B, nbmax) int32
    cache_len: torch.Tensor,  # (B,) int32: the position being written
):
    """Quantize and write one decode token per row into the pool, in place;
    returns the four (same) pool buffers."""
    return _paged_write(paged_decode_write_int8,
                        paged_decode_write_int8_plain, k_pool, k_scale,
                        v_pool, v_scale, k_new, v_new, tables, cache_len)


def paged_chunk_write_int8(
    k_pool: torch.Tensor,    # (nb, nkv, bs, hd) int8, updated in place
    k_scale: torch.Tensor,   # (nb, nkv, bs) f32, updated in place
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    k_new: torch.Tensor,     # (B, T, nkv, hd) bf16 or f32: chunk tokens
    v_new: torch.Tensor,
    tables: torch.Tensor,    # (B, nbmax) int32
    cache_len: torch.Tensor,  # (B,) int32: position of the chunk's token 0
):
    """Quantize and write T chunk tokens per row into the pool, in place;
    returns the four (same) pool buffers."""
    return _paged_write(paged_chunk_write_int8,
                        paged_chunk_write_int8_plain, k_pool, k_scale,
                        v_pool, v_scale, k_new, v_new, tables, cache_len)


paged_decode_write_int8.launches = 0  # kernel launches; only CUDA counts
paged_chunk_write_int8.launches = 0
