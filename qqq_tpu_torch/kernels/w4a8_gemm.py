"""Per-channel W4A8 GEMM (port of qqq_tpu/kernels/w4a8_gemm.py:w4a8_gemm and
w4a8_linear, ``group_size=-1``).

``D = ((A_i8 · U)_s32 − 8·rowsum(A)) · s_channel[n] · s_token[m]`` with U the
stored offset codes (q + 8).  On a CUDA tensor :func:`w4a8_gemm` launches
csrc/w4a8_gemm.cu; on a CPU tensor it runs :func:`w4a8_gemm_plain`, the
same arithmetic in plain PyTorch.  The int32 core is exact, so the two are
bit-identical.  The g128 variants (_w4a8_group_kernel,
_w4a8_requant_group_kernel) and the GLU epilogue (_w4a8_channel_glu_kernel)
arrive in the next slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from qqq_tpu_torch.core.packing import PACK_BLOCK, unpack_int4
from qqq_tpu_torch.core.quant import (
    quantize_activations_per_token, w4a8_matmul_reference,
)
from qqq_tpu_torch.kernels import build

_OUT_DTYPES = (torch.bfloat16, torch.float32)


def w4a8_gemm_plain(
    a_q: torch.Tensor, s_token: torch.Tensor, w_packed: torch.Tensor,
    s_channel: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the exact ``(A·W4)_s32`` (which
    equals the kernel's ``(A·U) − 8·rowsum(A)``), times ``s_channel`` then
    ``s_token`` in the JAX kernel's order."""
    return w4a8_matmul_reference(a_q, s_token.reshape(-1, 1),
                                 unpack_int4(w_packed), s_channel,
                                 out_dtype=out_dtype)


def w4a8_gemm(
    a_q: torch.Tensor,
    s_token: torch.Tensor,
    w_packed: torch.Tensor,
    s_channel: Optional[torch.Tensor] = None,
    s_group: Optional[torch.Tensor] = None,
    *,
    group_size: int = -1,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """W4A8 GEMM.  ``a_q`` (M, K) int8, ``s_token`` (M, 1) or (M,) f32,
    ``w_packed`` (K//8, N) int32, ``s_channel`` (N,) f32 → (M, N)
    ``out_dtype`` (bf16 or f32)."""
    if group_size != -1 or s_group is not None:
        raise NotImplementedError(
            "the g128 W4A8 GEMM (_w4a8_group_kernel, "
            "_w4a8_requant_group_kernel) arrives in the next slice"
        )
    if s_channel is None:
        raise ValueError("per-channel W4A8 GEMM needs s_channel")
    M, K = a_q.shape
    N = w_packed.shape[1]
    if K % PACK_BLOCK or tuple(w_packed.shape) != (K // 8, N):
        raise ValueError(f"a_q {tuple(a_q.shape)} / w_packed "
                         f"{tuple(w_packed.shape)}: K must be a multiple of "
                         f"{PACK_BLOCK} and w_packed (K//8, N)")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype {out_dtype} not in {_OUT_DTYPES}")
    if a_q.device.type == "cpu":
        return w4a8_gemm_plain(a_q, s_token, w_packed, s_channel, out_dtype)
    if a_q.device.type != "cuda":
        raise ValueError(f"w4a8_gemm: unsupported device {a_q.device}")
    s_tok = s_token.reshape(M)
    dev = a_q.device
    build.require(a_q, torch.int8, (M, K), "a_q", dev)
    build.require(s_tok, torch.float32, (M,), "s_token", dev)
    build.require(w_packed, torch.int32, (K // 8, N), "w_packed", dev)
    build.require(s_channel, torch.float32, (N,), "s_channel", dev)
    if a_q.data_ptr() % 16:
        raise ValueError("a_q must be 16-byte aligned (read as int4 vectors)")
    out = torch.empty((M, N), dtype=out_dtype, device=a_q.device)
    fn = build.bind("w4a8_gemm", "w4a8_gemm_channel", "pppppiiiip")
    build.check(fn(a_q.data_ptr(), s_tok.data_ptr(), w_packed.data_ptr(),
                   s_channel.data_ptr(), out.data_ptr(), M, K, N,
                   int(out_dtype == torch.bfloat16), build.stream_of(a_q)),
                "w4a8_gemm")
    w4a8_gemm.launches += 1
    return out


w4a8_gemm.launches = 0  # kernel launches; only the CUDA branch counts


def w4a8_linear(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    s_channel: Optional[torch.Tensor] = None,
    s_group: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    *,
    group_size: int = -1,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Quantized linear layer: per-token INT8 activation quantization (plain
    PyTorch, in front of the kernel as in JAX) + W4A8 GEMM + bias.
    ``x`` may have any leading shape ``(..., K)``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    a_q, s_tok = quantize_activations_per_token(x2)
    out = w4a8_gemm(a_q, s_tok, w_packed, s_channel, s_group,
                    group_size=group_size, out_dtype=out_dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.reshape(*lead, -1)
