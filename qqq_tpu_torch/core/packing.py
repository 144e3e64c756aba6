"""INT4 nibble-plane packing: the interchange format that the JAX package
(qqq_tpu/core/packing.py) and this port share.

Layout (``PACK_BLOCK = 128`` k-rows per block):

* packed array: int32, shape ``(K // 8, N)``; block ``b`` owns word rows
  ``[16b, 16b+16)``.
* word row ``16b + r``, little-endian byte ``i``: low nibble = code
  ``k = 128b + 4r + i``, high nibble = code ``k = 128b + 64 + 4r + i``.

Codes are stored offset-unsigned (``u = q + 8``).  On the GPU this layout
needs no re-tiling: ``w & 0x0F0F0F0F`` and ``(w >> 4) & 0x0F0F0F0F`` are
each four unsigned codes of consecutive k, which the weight stream feeds
to int8 MMAs as they are (csrc/w4a8_stream.cuh).
"""

from __future__ import annotations

import torch

PACK_BLOCK = 128  # k-rows per packing block; equals the g=128 group size


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack signed int4 codes ``(K, N) int8`` → ``(K // 8, N) int32``.

    ``q`` must be in [-8, 7] (out-of-range codes are clamped); K must be a
    multiple of ``PACK_BLOCK``.
    """
    K, N = q.shape
    if K % PACK_BLOCK != 0:
        raise ValueError(f"K={K} must be a multiple of {PACK_BLOCK}")
    u = (q.clamp(-8, 7).to(torch.int64) + 8)  # offset-unsigned [0, 15]
    ub = u.reshape(K // PACK_BLOCK, 2, 16, 4, N)  # [block, half, r, i, n]
    byte = ub[:, 0] | (ub[:, 1] << 4)  # [block, r, i, n], values 0..255
    w = byte[:, :, 0] | (byte[:, :, 1] << 8) | (byte[:, :, 2] << 16) \
        | (byte[:, :, 3] << 24)
    w = torch.where(w >= 2**31, w - 2**32, w)  # two's complement int32
    return w.reshape(K // 8, N).to(torch.int32)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Unpack ``(K//8, N) int32`` → signed int4 codes ``(K, N) int8``."""
    K8, N = packed.shape
    K = K8 * 8
    w = packed.to(torch.int64) & 0xFFFFFFFF
    wb = w.reshape(K // PACK_BLOCK, 16, N)  # [block, r, n]
    bytes_ = torch.stack([(wb >> (8 * i)) & 0xFF for i in range(4)], dim=2)
    lo = (bytes_ & 0xF).reshape(K // PACK_BLOCK, 64, N)
    hi = (bytes_ >> 4).reshape(K // PACK_BLOCK, 64, N)
    u = torch.cat([lo, hi], dim=1)  # [block, 128, n] in k order
    return (u - 8).reshape(K, N).to(torch.int8)
