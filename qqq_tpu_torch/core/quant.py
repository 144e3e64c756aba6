"""W4A8 quantization numerics in plain PyTorch (port of qqq_tpu/core/quant.py).

* Activations: dynamic symmetric per-token INT8 — ``s = absmax / 127``,
  ``q = clip(round(x / s), -128, 127)``.
* Weights, per-channel: symmetric INT4 with range ±7 and no zero point.
* Weights, per-group (``group_size = 128``): affine INT4 on [0, 15] with a
  fixed zero point of 8, stored as the signed code ``q - 8``.

Weights are ``(K, N) = (in_features, out_features)``.  Rounding is
half-to-even everywhere (``torch.round``), as in the JAX package, so codes
are bit-identical between the two.  ``find_params_weight`` with
``spec.mse`` runs the reference's shrink grid (``p = 1 − i/grid``, error
``Σ|q(w) − w|^norm``, the first best kept).

The g128 requant route of the GEMM regrids the INT4 codes to INT8 through
the double scale ``s_frac = s_group / s_extra`` (``s_extra`` derived from
the group scales alone) and takes one int32 dot over the whole K.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
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


def _minmax_ranges(w: torch.Tensor, spec: QuantSpec, g: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(group, channel) ``(xmin, xmax)`` (G, N) of ``w`` (K, N) f32,
    symmetrized for ``spec.sym``; an all-zero group takes (-1, 1)."""
    K, N = w.shape
    wg = w.reshape(K // g, g, N)
    xmin = torch.clamp_max(wg.amin(dim=1), 0.0)
    xmax = torch.clamp_min(wg.amax(dim=1), 0.0)
    if spec.sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)
    return xmin, xmax


def _params_from_ranges(xmin: torch.Tensor, xmax: torch.Tensor,
                        spec: QuantSpec, reciprocal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    maxq = spec.maxq

    def over_maxq(r):
        if reciprocal:
            return r * torch.tensor(np.float32(1.0) / np.float32(maxq),
                                    device=r.device)
        return true_div(r, maxq)

    if spec.per_channel and spec.sym:
        return over_maxq(xmax), torch.zeros_like(xmax)
    scale = over_maxq(xmax - xmin)
    if spec.sym:
        zero = torch.full_like(scale, (maxq + 1) / 2)
    else:
        zero = torch.round(-xmin / scale)
    return scale, zero


def find_params_weight(
    w: torch.Tensor, spec: QuantSpec, *, reciprocal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantization parameters ``(scale, zero)`` of shape (G, N),
    G = K // group_size (1 for per-channel): min/max, or with ``spec.mse``
    the best of ``int(maxshrink · grid)`` ranges shrunk by ``p = 1 − i/grid``
    under the error ``Σ|q(w) − w|^norm`` per (group, channel), a later
    candidate taken only when strictly better.

    The min/max scale is ``range / maxq``, one IEEE division, as the JAX
    package computes it op by op; with ``reciprocal`` it is ``range ·
    f32(1/maxq)``, as XLA compiles it inside the JAX package's jitted GPTQ
    (the grid's scales always take that form)."""
    w = w.to(torch.float32)
    K, N = w.shape
    g = _group(spec, K)
    xmin0, xmax0 = _minmax_ranges(w, spec, g)
    scale0, zero0 = _params_from_ranges(xmin0, xmax0, spec, reciprocal)
    if not spec.mse:
        return scale0, zero0
    wg = w.reshape(K // g, g, N)
    sym_pc = spec.per_channel and spec.sym
    best_err = torch.full_like(scale0, float("inf"))
    best_scale, best_zero = scale0, zero0
    # the grid's arithmetic as XLA compiles the JAX package's scan: the
    # shrink factor 1 − i · f32(1/grid) rounded once (a fused multiply-add),
    # the range times the f32 reciprocal of maxq
    step = np.float64(np.float32(1.0) / np.float32(spec.grid))
    for i in range(int(spec.maxshrink * spec.grid)):
        p = torch.tensor(np.float32(1.0 - i * step), device=w.device)
        xmin1, xmax1 = p * xmin0, p * xmax0
        scale1, zero1 = _params_from_ranges(xmin1, xmax1, spec,
                                            reciprocal=True)
        if spec.sym:
            zero1 = zero0
        s, z = scale1[:, None, :], zero1[:, None, :]
        if sym_pc:
            deq = s * torch.clamp(torch.round(wg / s), -spec.maxq, spec.maxq)
        else:
            deq = s * (torch.clamp(torch.round(wg / s) + z, 0, spec.maxq) - z)
        err = torch.sum(torch.pow(torch.abs(deq - wg), spec.norm), dim=1)
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best_scale = torch.where(better, scale1, best_scale)
        best_zero = torch.where(better, zero1, best_zero)
    return best_scale, best_zero


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


def dequantize_weight_int(q: torch.Tensor, scale: torch.Tensor,
                          spec: QuantSpec) -> torch.Tensor:
    """Signed codes (K, N) back to f32: ``q · scale[g]``."""
    K, N = q.shape
    g = _group(spec, K)
    qg = q.to(torch.float32).reshape(K // g, g, N)
    return (qg * scale[:, None, :]).reshape(K, N)


def fake_quantize_weight(
    w: torch.Tensor, spec: QuantSpec, scale: Optional[torch.Tensor] = None,
    zero: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Quantize-dequantize round trip of ``w`` (K, N) → f32."""
    if scale is None:
        scale, zero = find_params_weight(w, spec)
    q = quantize_weight_int(w, scale, zero, spec)
    return dequantize_weight_int(q, scale, spec)


def int8_channel_scale(w_deq: torch.Tensor) -> torch.Tensor:
    """Per-output-channel symmetric INT8 scale ``absmax / 127`` (N,) f32 of
    dequantized INT4 weights (K, N); an all-zero channel takes 1 / 127."""
    absmax = w_deq.to(torch.float32).abs().amax(dim=0)
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    return true_div(absmax, 127.0)


def double_scale(scale: torch.Tensor, s_extra: torch.Tensor) -> torch.Tensor:
    """The per-group kernel scale ``scale / s_extra`` (G, N) f32."""
    return (scale / s_extra[None, :]).to(torch.float32)


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
