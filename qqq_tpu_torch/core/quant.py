"""W4A8 quantization numerics in plain PyTorch (port of qqq_tpu/core/quant.py).

* Activations: dynamic symmetric per-token INT8 — ``s = absmax / 127``,
  ``q = clip(round(x / s), -128, 127)``.
* Weights, per-channel: symmetric INT4 with range ±7 and no zero point.
* Weights, per-group (``group_size = 128``): affine INT4 on [0, 15] with a
  fixed zero point of 8, stored as the signed code ``q - 8``.

Weights are ``(K, N) = (in_features, out_features)``.  Rounding is
half-to-even everywhere (``torch.round``), as in the JAX package, so codes
are bit-identical between the two.  The MSE grid search of
``find_params_weight`` waits for the calibration port.

The g128 requant route of the GEMM regrids the INT4 codes to INT8 through
the double scale ``s_frac = s_group / s_extra`` (``s_extra`` derived from
the group scales alone) and takes one int32 dot over the whole K.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of a weight quantization scheme;
    ``group_size == -1`` means per-channel."""

    bits: int = 4
    group_size: int = -1
    sym: bool = True
    mse: bool = False
    norm: float = 2.4
    grid: int = 100
    maxshrink: float = 0.8

    @property
    def per_channel(self) -> bool:
        return self.group_size == -1

    @property
    def maxq(self) -> int:
        if self.per_channel and self.sym:
            return 2 ** (self.bits - 1) - 1
        return 2**self.bits - 1

    @property
    def zero_code(self) -> int:
        if self.per_channel and self.sym:
            return 0
        return (self.maxq + 1) // 2


_F32_TINY = torch.finfo(torch.float32).tiny


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as one IEEE division on every device.  PyTorch's CUDA
    kernels turn division by a Python scalar into multiplication by its
    reciprocal, which differs in the last bit; the JAX package and the CUDA
    kernels divide."""
    return x / torch.full_like(x, d)


def quantize_activations_per_token(
    x: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(q, s)``: ``q`` int8 of x.shape, ``s`` f32 of
    ``x.shape[:-1] + (1,)``.  The absmax is taken in x's own dtype (exact),
    the rest in f32."""
    s = true_div(x.abs().amax(dim=-1, keepdim=True).to(torch.float32), 127.0)
    s = torch.clamp_min(s, _F32_TINY)  # guard all-zero rows
    q = torch.clamp(torch.round(x.to(torch.float32) / s), -128, 127)
    return q.to(torch.int8), s


def _group(spec: QuantSpec, K: int) -> int:
    return K if spec.per_channel else spec.group_size


def find_params_weight(
    w: torch.Tensor, spec: QuantSpec
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min/max quantization parameters ``(scale, zero)`` of shape (G, N),
    G = K // group_size (1 for per-channel)."""
    if spec.mse:
        raise NotImplementedError(
            "the MSE grid search arrives with the calibration port"
        )
    w = w.to(torch.float32)
    K, N = w.shape
    g = _group(spec, K)
    wg = w.reshape(K // g, g, N)
    xmin = torch.clamp_max(wg.amin(dim=1), 0.0)
    xmax = torch.clamp_min(wg.amax(dim=1), 0.0)
    if spec.sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)
    maxq = spec.maxq
    if spec.per_channel and spec.sym:
        return true_div(xmax, maxq), torch.zeros_like(xmax)
    scale = true_div(xmax - xmin, maxq)
    if spec.sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)
    return scale, zero


def quantize_weight_int(
    w: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor, spec: QuantSpec
) -> torch.Tensor:
    """Signed int8 codes in [-8, 7] (per-group, code - 8) or [-7, 7]
    (per-channel) — the values that get nibble-packed."""
    K, N = w.shape
    g = _group(spec, K)
    wg = w.to(torch.float32).reshape(K // g, g, N)
    s, z = scale[:, None, :], zero[:, None, :]
    maxq = spec.maxq
    if spec.per_channel and spec.sym:
        q = torch.clamp(torch.round(wg / s), -maxq, maxq)
    else:
        q = torch.clamp(torch.round(wg / s) + z, 0, maxq) - z
    return q.reshape(K, N).to(torch.int8)


def s_extra_from_group_scales(s_group: torch.Tensor) -> torch.Tensor:
    """The per-channel INT8 scale ``7 · max_g s_group[g, n] / 127`` (N,) f32
    of (G, N) full group scales of any float dtype; an all-zero channel
    takes 1.  Equals the absmax / 127 of the dequantized weights for every
    min/max or MSE-shrunk symmetric INT4 quantization, whose largest group
    attains a ±7 code."""
    s = s_group.to(torch.float32).amax(dim=0)
    s = torch.where(s == 0, torch.ones_like(s), s)
    return s * (7.0 / 127.0)


def requant_scales(s_group: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s_frac (G, N), s_extra (N,))`` f32 for the requant route:
    ``s_frac = s_group / s_extra``, one IEEE division per entry."""
    s_g32 = s_group.to(torch.float32)
    s_extra = s_extra_from_group_scales(s_g32)
    return s_g32 / s_extra[None, :], s_extra


def requantize_group_weights_int8(
    q4: torch.Tensor, s_frac: torch.Tensor, group_size: int
) -> torch.Tensor:
    """INT4 codes (K, N) in [-8, 7] → INT8 (K, N): ``clip(round(q ·
    s_frac[g]), ±127)``, the f32 product rounded once, half to even."""
    K, N = q4.shape
    qg = q4.to(torch.float32).reshape(K // group_size, group_size, N)
    w8 = torch.round(qg * s_frac[:, None, :].to(torch.float32))
    return torch.clamp(w8, -127, 127).reshape(K, N).to(torch.int8)


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 operands, taken through float64
    (|a·b| < 2^53 for every K this package meets)."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def w4a8_matmul_reference(
    a_q: torch.Tensor,
    s_token: torch.Tensor,
    q4: torch.Tensor,
    s_channel: Optional[torch.Tensor] = None,
    s_group: Optional[torch.Tensor] = None,
    *,
    group_size: int = -1,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """W4A8 GEMM oracle on unpacked codes ``q4`` (K, N).

    Per-channel: ``(A·W4)_s32 · s_channel · s_token``.
    Per-group (``group_size = 128``, ``s_group`` (K/128, N) full scales of
    any float dtype): ``Σ_g (A_g·W4_g)_s32 · s_group[g]`` accumulated in f32
    group by group in order, a multiply and an add each rounded on its own,
    then ``· s_token``."""
    s_token = s_token.to(torch.float32)
    if group_size == -1:
        if s_channel is None:
            raise ValueError("the per-channel GEMM needs s_channel")
        acc = int_dot(a_q, q4)
        out = acc.to(torch.float32) * s_channel[None, :].to(torch.float32)
        return (out * s_token).to(out_dtype)
    if s_group is None:
        raise ValueError("the per-group GEMM needs s_group")
    M, K = a_q.shape
    sg = s_group.to(torch.float32)
    facc = torch.zeros((M, q4.shape[1]), dtype=torch.float32,
                       device=a_q.device)
    for g in range(K // group_size):  # the kernels' accumulation order
        sl = slice(g * group_size, (g + 1) * group_size)
        facc = facc + int_dot(a_q[:, sl], q4[sl]).to(torch.float32) * sg[g]
    return (facc * s_token).to(out_dtype)
