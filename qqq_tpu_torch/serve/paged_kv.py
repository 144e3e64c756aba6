"""Paged KV cache: a block pool shared by all requests, with per-request
block tables (port of qqq_tpu/serve/paged_kv.py).

Layout per layer (block-major, so that one table entry is one pool index):

    k / v      : (num_blocks, n_kv, block_size, head_dim)  int8 | fp
    k_scale /
    v_scale    : (num_blocks, n_kv, block_size) f32        (INT8 only)

Block 0 is the **null block**: unused table entries point at it and the
writes of masked rows and of positions past a row's table land in it, so
every scattered or gathered address is in bounds and never touches live
data.  The allocator never hands it out, and its content is unspecified.
The token at sequence position ``p`` of a request lives at
``(table[p // block_size], :, p % block_size)``.

Like the port's slot cache (serve/kv_cache.py), :func:`write` updates the
pool **in place** and returns the same dict.  On an INT8 pool it goes
through the paged write kernels (kernels/kv_write.py: one token per row at
decode, a chunk per row at prefill), which quantize as
``serve/kv_cache._quant`` does; an fp pool takes one indexed copy.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch


def init(
    config, num_blocks: int, block_size: int, *, quantized: bool = True,
    dtype: torch.dtype = torch.bfloat16, device=None,
) -> List[Dict[str, Any]]:
    """Per-layer block pools.  ``num_blocks`` INCLUDES the null block 0:
    usable capacity is ``(num_blocks - 1) * block_size`` tokens."""
    nkv, hd = config.num_key_value_heads, config.head_dim
    store_dtype = torch.int8 if quantized else dtype
    caches = []
    for _ in range(config.num_hidden_layers):
        c = {
            "k": torch.zeros((num_blocks, nkv, block_size, hd),
                             dtype=store_dtype, device=device),
            "v": torch.zeros((num_blocks, nkv, block_size, hd),
                             dtype=store_dtype, device=device),
        }
        if quantized:
            c["k_scale"] = torch.zeros((num_blocks, nkv, block_size),
                                       dtype=torch.float32, device=device)
            c["v_scale"] = torch.zeros((num_blocks, nkv, block_size),
                                       dtype=torch.float32, device=device)
        caches.append(c)
    return caches


def _phys_or_null(tables: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """Pool block of virtual block ``vb`` (B, n) per row; virtual blocks
    past the table route to the null block, never into the clamped last
    live one."""
    nbmax = tables.shape[1]
    got = torch.gather(tables.to(torch.int64), 1, vb.clamp(0, nbmax - 1))
    return torch.where(vb >= nbmax, 0, got)


def write(
    cache: Dict[str, Any],
    k_new: torch.Tensor,    # (B, T, n_kv, hd)
    v_new: torch.Tensor,
    offsets: torch.Tensor,  # (B,) int32: sequence position of token 0
    tables: torch.Tensor,   # (B, max_blocks) int32: pool indices, 0 = null
) -> Dict[str, Any]:
    """Write T new tokens per row into their pool blocks, in place."""
    if "k_scale" in cache:
        from qqq_tpu_torch.kernels.kv_write import (
            paged_chunk_write_int8, paged_decode_write_int8,
        )

        fn = paged_decode_write_int8 if k_new.shape[1] == 1 \
            else paged_chunk_write_int8
        fn(cache["k"], cache["k_scale"], cache["v"], cache["v_scale"],
           k_new, v_new, tables, offsets)
        return cache
    T = k_new.shape[1]
    bs = cache["k"].shape[2]
    pos = (offsets.to(torch.int64)[:, None]
           + torch.arange(T, device=offsets.device)[None, :])  # (B, T)
    phys = _phys_or_null(tables, pos // bs)
    off = pos % bs
    # pool[phys, :, off] is (B, T, n_kv, hd), the layout of k_new
    cache["k"][phys, :, off] = k_new.to(cache["k"].dtype)
    cache["v"][phys, :, off] = v_new.to(cache["v"].dtype)
    return cache


def gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """The pool's blocks in each row's table order, head-major like the
    slot cache: (nb, n_kv, bs, ...) → (B, n_kv, max_blocks·bs, ...)."""
    g = pool[tables.to(torch.int64)]      # (B, nbmax, n_kv, bs, ...)
    g = g.transpose(1, 2)                  # (B, n_kv, nbmax, bs, ...)
    return g.reshape(g.shape[:2] + (-1,) + g.shape[4:])


def read(
    cache: Dict[str, Any], tables: torch.Tensor, seq_len: int, dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (B, seq_len, n_kv, hd) k/v gathered from the pool and
    dequantized: the fp pool's attention path and the tests' oracle."""
    bs = cache["k"].shape[2]
    tables = tables[:, :-(-seq_len // bs)]

    def dense(name):
        return gather(cache[name], tables)[:, :, :seq_len]

    if "k_scale" in cache:
        k = dense("k").to(torch.float32) * dense("k_scale")[..., None]
        v = dense("v").to(torch.float32) * dense("v_scale")[..., None]
    else:
        k, v = dense("k"), dense("v")
    return k.to(dtype).transpose(1, 2), v.to(dtype).transpose(1, 2)


class BlockAllocator:
    """Host-side free list over the pool.  Block 0 (the null block) is never
    allocated; the engine calls this between device steps."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the null block)")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: need {n} blocks, {len(self._free)} free"
            )
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks) -> None:
        for b in blocks:
            b = int(b)
            if b == 0:
                raise ValueError("null block cannot be freed")
            self._free.append(b)
