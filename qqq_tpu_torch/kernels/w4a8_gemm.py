"""W4A8 GEMM, per channel and g128, plain, GLU-fused and with the
activation quantization fused in (port of qqq_tpu/kernels/w4a8_gemm.py:
w4a8_gemm, w4a8_gemm_fused, w4a8_linear, fuse_glu_layout, w4a8_glu_gemm,
w4a8_glu_linear, FUSE_ACT_QUANT).

Eight kernel routes, one wrapper each, each with a plain PyTorch twin and
its own launch count (loop: ``mma`` the int8 ``mma.sync`` tensor cores
fed by the TMA weight stream of w4a8_stream.cuh (the two fused kernels
quantize x into their A fragments themselves), ``wgmma`` the int8
warpgroup tensor-core tiles of w4a8_tc.cuh; ``mma|wgmma``: the stream below
``CHANNEL_TILES_MIN_M`` rows (GLU: ``GLU_CHANNEL_TILES_MIN_M``), the tiles
from there); sources under csrc/:

=======================  ==============================  ==============  ==========
wrapper                  TPU kernel                      CUDA source     loop
=======================  ==============================  ==============  ==========
w4a8_gemm_channel        _w4a8_channel_kernel            w4a8_gemm.cu    mma|wgmma
w4a8_glu_channel         _w4a8_channel_glu_kernel        w4a8_gemm.cu    mma|wgmma
w4a8_gemm_group          _w4a8_group_kernel              w4a8_group.cu   mma
w4a8_glu_group           _w4a8_group_glu_kernel          w4a8_group.cu   mma
w4a8_gemm_requant        _w4a8_requant_group_kernel      w4a8_requant.cu wgmma
w4a8_glu_requant         _w4a8_requant_group_glu_kernel  w4a8_requant.cu wgmma
w4a8_gemm_fused_channel  _w4a8_fused_channel_kernel      w4a8_fused.cu   mma
w4a8_gemm_fused_group    _w4a8_fused_group_kernel        w4a8_fused.cu   mma
=======================  ==============================  ==============  ==========

On a CUDA tensor a wrapper launches its kernel (or raises); on a CPU tensor
it runs its plain version.  :func:`w4a8_gemm` and :func:`w4a8_glu_gemm`
choose the route as the JAX package does: per channel, or g128 exact, or
g128 requant (``requant`` if given, else ``M >= 512``).  The two fused
routes take raw bf16/f32 activations and quantize them per token in the
kernel's prologue; :func:`w4a8_linear` takes them as JAX does, when
``FUSE_ACT_QUANT`` is set, M ≤ 64 and :func:`_fused_bn` admits (K, N).

Numerics.  Per channel and requant are exact in int32 up to two f32
multiplies in the JAX order: kernel and plain version are bit-identical
(per channel in both regimes).
The exact g128 route sums the groups' f32 terms in group order, each
product and sum rounded on its own, on both sides: bit-identical too.  The
fused routes add the JAX kernels' quantization, ``s = max(absmax, 1e-30) /
127`` and ``clip(rint(x / s))`` with IEEE divisions, to those two: also
bit-identical, and equal to the unfused route except on an all-zero row's
scale (its outputs are 0 either way).  The GLU epilogue ``g·σ(g)·u`` (f32,
one rounding to the output dtype) may differ where the kernel's ``expf``
and PyTorch's ``sigmoid`` do.
"""

from __future__ import annotations

import sys
import types
from typing import Any, Dict, Optional

import torch

from qqq_tpu_torch.core.packing import PACK_BLOCK, unpack_int4
from qqq_tpu_torch.core.quant import (
    int_dot, quantize_activations_per_token, requant_scales,
    requantize_group_weights_int8, true_div, w4a8_matmul_reference,
)
from qqq_tpu_torch.kernels import build

_OUT_DTYPES = (torch.bfloat16, torch.float32)
_SG_DTYPES = (torch.bfloat16, torch.float32)
_X_DTYPES = (torch.bfloat16, torch.float32)

GLU_INTERLEAVE = 256  # gate/up column-tile width baked into the fused layout

#: rows (M) from which the g128 GEMM takes the requant route by default
REQUANT_MIN_M = 512

#: rows (M) from which the per-channel GEMM takes the int8 wgmma tiles
#: instead of the weight stream, and the same for its GLU: where the two
#: regimes' measured times cross on the H100 (PERF.md, chip_smoke.py's
#: crossover rows; between M = 64 and 128 for the plain GEMM at
#: Llama-2-7B's (K, N), past 128 for the GLU, whose 172 column tiles of
#: 2I = 22016 fill the card without a split).  Both regimes are bit-exact,
#: so the switch never changes a result
CHANNEL_TILES_MIN_M = 128
GLU_CHANNEL_TILES_MIN_M = 256

#: the JAX module's switch (off there: slower on v5e): :func:`w4a8_linear`
#: reads it at call time and, when set, quantizes decode-size activations
#: inside the fused kernels
FUSE_ACT_QUANT = False


# ---------------------------------------------------------------------------
# plain versions


def glu_epilogue_plain(y: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``silu(gate)·up`` of scaled f32 values ``y`` (M, 2I) in the fused
    column layout → (M, I) ``out_dtype``."""
    M, n2 = y.shape
    t = y.reshape(M, n2 // (2 * GLU_INTERLEAVE), 2, GLU_INTERLEAVE)
    g, u = t[:, :, 0], t[:, :, 1]
    return (g * torch.sigmoid(g) * u).reshape(M, n2 // 2).to(out_dtype)


def w4a8_gemm_channel_plain(a_q, s_token, w_packed, s_channel,
                            out_dtype=torch.bfloat16):
    """The exact ``(A·W4)_s32`` (which equals the kernel's ``(A·U) −
    8·rowsum(A)``), times ``s_channel`` then ``s_token``."""
    return w4a8_matmul_reference(a_q, s_token.reshape(-1, 1),
                                 unpack_int4(w_packed), s_channel,
                                 out_dtype=out_dtype)


def w4a8_gemm_group_plain(a_q, s_token, w_packed, s_group,
                          out_dtype=torch.bfloat16):
    """Per-group f32 sum in group order, then ``· s_token``."""
    return w4a8_matmul_reference(a_q, s_token.reshape(-1, 1),
                                 unpack_int4(w_packed), None, s_group,
                                 group_size=PACK_BLOCK, out_dtype=out_dtype)


def w4a8_gemm_requant_plain(a_q, s_token, w_packed, s_group,
                            out_dtype=torch.bfloat16):
    """INT4 → INT8 through ``s_frac``, one exact int32 dot, then
    ``· s_extra · s_token``."""
    s_frac, s_extra = requant_scales(s_group)
    w8 = requantize_group_weights_int8(unpack_int4(w_packed), s_frac,
                                       PACK_BLOCK)
    out = int_dot(a_q, w8).to(torch.float32) * s_extra[None, :]
    return (out * s_token.reshape(-1, 1).to(torch.float32)).to(out_dtype)


def quantize_activations_fused_plain(x: torch.Tensor):
    """The fused kernels' prologue, per row of ``x`` (M, K): ``s =
    max(absmax, 1e-30) / 127`` and ``a = clip(rint(x / s), −128, 127)``,
    both IEEE divisions (the JAX kernels' order; core/quant.py's divides
    first and clamps after, which differs only on an all-zero row).
    Returns (a (M, K) int8, s (M, 1) f32)."""
    xf = x.to(torch.float32)
    s = true_div(torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-30),
                 127.0)
    a = torch.clamp(torch.round(xf / s), -128, 127)
    return a.to(torch.int8), s


def w4a8_gemm_fused_channel_plain(x, w_packed, s_channel,
                                  out_dtype=torch.bfloat16):
    """Per-token quantization of ``x`` as the fused kernel does it, then
    the per-channel GEMM."""
    a, s = quantize_activations_fused_plain(x)
    return w4a8_gemm_channel_plain(a, s, w_packed, s_channel, out_dtype)


def w4a8_gemm_fused_group_plain(x, w_packed, s_group,
                                out_dtype=torch.bfloat16):
    """Per-token quantization of ``x`` as the fused kernel does it, then
    the exact g128 GEMM (groups summed in f32 in order)."""
    a, s = quantize_activations_fused_plain(x)
    return w4a8_gemm_group_plain(a, s, w_packed, s_group, out_dtype)


def w4a8_glu_channel_plain(a_q, s_token, w_glu, s_channel,
                           out_dtype=torch.bfloat16):
    return glu_epilogue_plain(w4a8_gemm_channel_plain(
        a_q, s_token, w_glu, s_channel, torch.float32), out_dtype)


def w4a8_glu_group_plain(a_q, s_token, w_glu, s_group,
                         out_dtype=torch.bfloat16):
    return glu_epilogue_plain(w4a8_gemm_group_plain(
        a_q, s_token, w_glu, s_group, torch.float32), out_dtype)


def w4a8_glu_requant_plain(a_q, s_token, w_glu, s_group,
                           out_dtype=torch.bfloat16):
    return glu_epilogue_plain(w4a8_gemm_requant_plain(
        a_q, s_token, w_glu, s_group, torch.float32), out_dtype)


# ---------------------------------------------------------------------------
# kernel wrappers


def _shapes(a_q, w_packed, out_dtype, glu: bool):
    """(M, K, N, device kind) after the checks every route shares; N is the
    weight's width (2I with ``glu``)."""
    M, K = a_q.shape
    N = w_packed.shape[1]
    if K % PACK_BLOCK or tuple(w_packed.shape) != (K // 8, N):
        raise ValueError(f"a_q {tuple(a_q.shape)} / w_packed "
                         f"{tuple(w_packed.shape)}: K must be a multiple of "
                         f"{PACK_BLOCK} and w_packed (K//8, N)")
    if glu and N % (2 * GLU_INTERLEAVE):
        raise ValueError(f"GLU weight width {N} is not a multiple of "
                         f"{2 * GLU_INTERLEAVE}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype {out_dtype} not in {_OUT_DTYPES}")
    if a_q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"w4a8 GEMM: unsupported device {a_q.device}")
    return M, K, N, a_q.device.type


def _common_cuda(a_q, s_token, w_packed, M, K, N, out_dtype, glu):
    """Checks the operands every kernel reads and allocates the output."""
    s_tok = s_token.reshape(M)
    dev = a_q.device
    build.require(a_q, torch.int8, (M, K), "a_q", dev)
    build.require(s_tok, torch.float32, (M,), "s_token", dev)
    build.require(w_packed, torch.int32, (K // 8, N), "w_packed", dev)
    if a_q.data_ptr() % 16:
        raise ValueError("a_q must be 16-byte aligned (read as int4 vectors)")
    out = torch.empty((M, N // 2 if glu else N), dtype=out_dtype, device=dev)
    return s_tok, out


def _workspace(lib: str, sizer: str, M: int, K: int, N: int, dev,
               what: str) -> Optional[torch.Tensor]:
    """The int32 split-K workspace a tile kernel asks for through its sizing
    entry (``torch.empty``; None when it asks for none)."""
    size = build.bind(lib, sizer, "iii", ret="q")
    ws_bytes = int(size(M, K, N))
    if ws_bytes < 0:
        raise RuntimeError(f"{what}: CUDA error {-ws_bytes} sizing the "
                           "split-K workspace")
    return (torch.empty(ws_bytes // 4, dtype=torch.int32, device=dev)
            if ws_bytes else None)


def channel_regime(M: int, glu: bool = False) -> str:
    """The regime of the per-channel kernel (GLU with ``glu``) for M rows:
    ``"tiles"`` (the int8 wgmma tiles) from ``CHANNEL_TILES_MIN_M`` rows
    (GLU: ``GLU_CHANNEL_TILES_MIN_M``), else ``"stream"`` (the TMA weight
    stream on int8 ``mma.sync``)."""
    min_m = GLU_CHANNEL_TILES_MIN_M if glu else CHANNEL_TILES_MIN_M
    return "tiles" if M >= min_m else "stream"


def _channel(counter, a_q, s_token, w_packed, s_channel, out_dtype, glu,
             regime: Optional[str] = None):
    """The per-channel route; ``regime`` ("stream" or "tiles") overrides
    :func:`channel_regime` (the card tests and chip_smoke.py's crossover
    rows force each regime through it; the wrappers never pass it)."""
    M, K, N, kind = _shapes(a_q, w_packed, out_dtype, glu)
    if kind == "cpu":
        plain = w4a8_glu_channel_plain if glu else w4a8_gemm_channel_plain
        return plain(a_q, s_token, w_packed, s_channel, out_dtype)
    s_tok, out = _common_cuda(a_q, s_token, w_packed, M, K, N, out_dtype, glu)
    build.require(s_channel, torch.float32, (N,), "s_channel", a_q.device)
    regime = regime or channel_regime(M, glu)
    if regime not in ("stream", "tiles"):
        raise ValueError(f"regime {regime!r} not in ('stream', 'tiles')")
    what = f"{counter.__name__} at M={M}, K={K}, N={N} ({regime})"
    ws = (_workspace("w4a8_gemm", "w4a8_channel_workspace_bytes", M, K, N,
                     a_q.device, what) if regime == "tiles" else None)
    fn = build.bind("w4a8_gemm", "w4a8_gemm_channel", "ppppppiiiiiip")
    build.check(fn(a_q.data_ptr(), s_tok.data_ptr(), w_packed.data_ptr(),
                   s_channel.data_ptr(), out.data_ptr(),
                   None if ws is None else ws.data_ptr(), M, K, N, int(glu),
                   int(out_dtype == torch.bfloat16), int(regime == "tiles"),
                   build.stream_of(a_q)), what)
    counter.launches += 1
    return out


def _group(counter, a_q, s_token, w_packed, s_group, out_dtype, glu):
    M, K, N, kind = _shapes(a_q, w_packed, out_dtype, glu)
    if kind == "cpu":
        plain = w4a8_glu_group_plain if glu else w4a8_gemm_group_plain
        return plain(a_q, s_token, w_packed, s_group, out_dtype)
    s_tok, out = _common_cuda(a_q, s_token, w_packed, M, K, N, out_dtype, glu)
    if s_group.dtype not in _SG_DTYPES:
        raise TypeError(f"s_group dtype {s_group.dtype} not in {_SG_DTYPES}")
    build.require(s_group, s_group.dtype, (K // PACK_BLOCK, N), "s_group",
                  a_q.device)
    fn = build.bind("w4a8_group", "w4a8_gemm_group", "pppppiiiiiip")
    build.check(fn(a_q.data_ptr(), s_tok.data_ptr(), w_packed.data_ptr(),
                   s_group.data_ptr(), out.data_ptr(), M, K, N, int(glu),
                   int(s_group.dtype == torch.bfloat16),
                   int(out_dtype == torch.bfloat16), build.stream_of(a_q)),
                counter.__name__)
    counter.launches += 1
    return out


def _requant(counter, a_q, s_token, w_packed, s_group, out_dtype, glu):
    M, K, N, kind = _shapes(a_q, w_packed, out_dtype, glu)
    if kind == "cpu":
        plain = w4a8_glu_requant_plain if glu else w4a8_gemm_requant_plain
        return plain(a_q, s_token, w_packed, s_group, out_dtype)
    s_tok, out = _common_cuda(a_q, s_token, w_packed, M, K, N, out_dtype, glu)
    if tuple(s_group.shape) != (K // PACK_BLOCK, N):
        raise ValueError(f"s_group: shape {tuple(s_group.shape)}, expected "
                         f"{(K // PACK_BLOCK, N)}")
    s_frac, s_extra = requant_scales(s_group)
    build.require(s_frac, torch.float32, (K // PACK_BLOCK, N), "s_frac",
                  a_q.device)
    ws = _workspace("w4a8_requant", "w4a8_requant_workspace_bytes", M, K, N,
                    a_q.device, counter.__name__)
    fn = build.bind("w4a8_requant", "w4a8_gemm_requant", "pppppppiiiiip")
    build.check(fn(a_q.data_ptr(), s_tok.data_ptr(), w_packed.data_ptr(),
                   s_frac.data_ptr(), s_extra.data_ptr(), out.data_ptr(),
                   None if ws is None else ws.data_ptr(), M, K, N, int(glu),
                   int(out_dtype == torch.bfloat16), build.stream_of(a_q)),
                f"{counter.__name__} at M={M}, K={K}, N={N}")
    counter.launches += 1
    return out


def _fused(counter, x, w_packed, scales, out_dtype, group: bool):
    M, K = x.shape
    N = w_packed.shape[1]
    if K % PACK_BLOCK or tuple(w_packed.shape) != (K // 8, N):
        raise ValueError(f"x {tuple(x.shape)} / w_packed "
                         f"{tuple(w_packed.shape)}: K must be a multiple of "
                         f"{PACK_BLOCK} and w_packed (K//8, N)")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype {out_dtype} not in {_OUT_DTYPES}")
    if x.device.type == "cpu":
        plain = (w4a8_gemm_fused_group_plain if group
                 else w4a8_gemm_fused_channel_plain)
        return plain(x, w_packed, scales, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused W4A8 GEMM: unsupported device {x.device}")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {_X_DTYPES}")
    dev = x.device
    build.require(x, x.dtype, (M, K), "x", dev)
    build.require(w_packed, torch.int32, (K // 8, N), "w_packed", dev)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (read as int4 vectors)")
    if group:
        if scales.dtype not in _SG_DTYPES:
            raise TypeError(f"s_group dtype {scales.dtype} not in "
                            f"{_SG_DTYPES}")
        build.require(scales, scales.dtype, (K // PACK_BLOCK, N), "s_group",
                      dev)
    else:
        build.require(scales, torch.float32, (N,), "s_channel", dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    fn = build.bind("w4a8_fused", "w4a8_gemm_fused", "ppppiiiiiiip")
    build.check(fn(x.data_ptr(), w_packed.data_ptr(), scales.data_ptr(),
                   out.data_ptr(), M, K, N, int(group),
                   int(x.dtype == torch.bfloat16),
                   int(scales.dtype == torch.bfloat16),
                   int(out_dtype == torch.bfloat16), build.stream_of(x)),
                f"{counter.__name__} at M={M}, K={K}, N={N}")
    counter.launches += 1
    return out


def _counted(route, glu: bool, name: str, doc: str):
    """The public wrapper of one kernel.  ``route`` adds one to the
    wrapper's own ``launches`` right after it launches the kernel."""

    def wrapper(a_q, s_token, w_packed, scales, out_dtype=torch.bfloat16):
        return route(wrapper, a_q, s_token, w_packed, scales, out_dtype, glu)

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    wrapper.launches = 0  # kernel launches; only the CUDA branch counts
    return wrapper


w4a8_gemm_channel = _counted(
    _channel, False, "w4a8_gemm_channel",
    "Per-channel GEMM (_w4a8_channel_kernel): a_q (M, K) int8, s_token "
    "(M, 1) f32, w_packed (K//8, N) int32, s_channel (N,) f32 → (M, N).")
w4a8_glu_channel = _counted(
    _channel, True, "w4a8_glu_channel",
    "Per-channel GEMM with the GLU epilogue (_w4a8_channel_glu_kernel): "
    "w_glu (K//8, 2I) in the fused layout, s_channel (2I,) → (M, I).")
w4a8_gemm_group = _counted(
    _group, False, "w4a8_gemm_group",
    "Exact g128 GEMM (_w4a8_group_kernel): s_group (K//128, N) bf16 or f32 "
    "→ (M, N).")
w4a8_glu_group = _counted(
    _group, True, "w4a8_glu_group",
    "Exact g128 GEMM with the GLU epilogue (_w4a8_group_glu_kernel): "
    "s_group (K//128, 2I) → (M, I).")
w4a8_gemm_requant = _counted(
    _requant, False, "w4a8_gemm_requant",
    "g128 requant GEMM (_w4a8_requant_group_kernel): s_group (K//128, N) "
    "→ (M, N); s_frac and s_extra are derived from s_group.")
w4a8_glu_requant = _counted(
    _requant, True, "w4a8_glu_requant",
    "g128 requant GEMM with the GLU epilogue "
    "(_w4a8_requant_group_glu_kernel) → (M, I).")


def _counted_fused(group: bool, name: str, doc: str):
    """The public wrapper of one activation-quant-fused kernel; its own
    ``launches`` as :func:`_counted`."""

    def wrapper(x, w_packed, scales, out_dtype=torch.bfloat16):
        return _fused(wrapper, x, w_packed, scales, out_dtype, group)

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = doc
    wrapper.launches = 0  # kernel launches; only the CUDA branch counts
    return wrapper


w4a8_gemm_fused_channel = _counted_fused(
    False, "w4a8_gemm_fused_channel",
    "Per-channel GEMM with the per-token activation quantization in its "
    "prologue (_w4a8_fused_channel_kernel): x (M, K) bf16 or f32, w_packed "
    "(K//8, N) int32, s_channel (N,) f32 → (M, N).")
w4a8_gemm_fused_group = _counted_fused(
    True, "w4a8_gemm_fused_group",
    "Exact g128 GEMM with the per-token activation quantization in its "
    "prologue (_w4a8_fused_group_kernel): x (M, K) bf16 or f32, s_group "
    "(K//128, N) bf16 or f32 → (M, N).")

#: every kernel wrapper of this module, by name
KERNEL_WRAPPERS = {f.__name__: f for f in (
    w4a8_gemm_channel, w4a8_glu_channel, w4a8_gemm_group, w4a8_glu_group,
    w4a8_gemm_requant, w4a8_glu_requant, w4a8_gemm_fused_channel,
    w4a8_gemm_fused_group)}


# ---------------------------------------------------------------------------
# dispatch


def _route(M: int, s_channel, s_group, group_size: int,
           requant: Optional[bool]):
    """``(route name, scales)``: "channel", "group" or "requant"."""
    if group_size == -1:
        if s_channel is None:
            raise ValueError("per-channel W4A8 GEMM needs s_channel")
        return "channel", s_channel
    if group_size != PACK_BLOCK:
        raise ValueError(f"group_size {group_size}: only -1 and "
                         f"{PACK_BLOCK}")
    if s_group is None:
        raise ValueError("g128 W4A8 GEMM needs s_group")
    do_requant = requant if requant is not None else M >= REQUANT_MIN_M
    return ("requant" if do_requant else "group"), s_group


_GEMM = {"channel": w4a8_gemm_channel, "group": w4a8_gemm_group,
         "requant": w4a8_gemm_requant}
_GLU = {"channel": w4a8_glu_channel, "group": w4a8_glu_group,
        "requant": w4a8_glu_requant}


def w4a8_gemm(
    a_q: torch.Tensor,
    s_token: torch.Tensor,
    w_packed: torch.Tensor,
    s_channel: Optional[torch.Tensor] = None,
    s_group: Optional[torch.Tensor] = None,
    *,
    group_size: int = -1,
    out_dtype: torch.dtype = torch.bfloat16,
    requant: Optional[bool] = None,
) -> torch.Tensor:
    """W4A8 GEMM.  ``a_q`` (M, K) int8, ``s_token`` (M, 1) or (M,) f32,
    ``w_packed`` (K//8, N) int32, and ``s_channel`` (N,) f32
    (``group_size=-1``) or ``s_group`` (K//128, N) bf16/f32
    (``group_size=128``) → (M, N) ``out_dtype`` (bf16 or f32).  ``requant``
    (g128 only): None = requant when M ≥ 512, else exact; True/False force
    the route."""
    name, scales = _route(a_q.shape[0], s_channel, s_group, group_size,
                          requant)
    return _GEMM[name](a_q, s_token, w_packed, scales, out_dtype)


def w4a8_glu_gemm(
    a_q: torch.Tensor,
    s_token: torch.Tensor,
    w_glu: torch.Tensor,
    s_channel: Optional[torch.Tensor] = None,
    s_group: Optional[torch.Tensor] = None,
    *,
    group_size: int = -1,
    out_dtype: torch.dtype = torch.bfloat16,
    requant: Optional[bool] = None,
) -> torch.Tensor:
    """GLU-fused W4A8 GEMM: ``silu(a·W_gate)·(a·W_up)`` (M, I) from the
    fused weight of :func:`fuse_glu_layout`, routed as :func:`w4a8_gemm`."""
    name, scales = _route(a_q.shape[0], s_channel, s_group, group_size,
                          requant)
    return _GLU[name](a_q, s_token, w_glu, scales, out_dtype)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _fused_bn(K: int, N: int) -> int:
    """JAX's rule for the fused route (qqq_tpu/kernels/w4a8_gemm.py:
    _fused_bn, copied): the column tile whose whole-K weight slab fits the
    TPU's VMEM, or 0 when none does.  A TPU rule, kept so that the same
    linears take the fused route in both packages."""
    if K % PACK_BLOCK != 0:
        return 0
    for bn in (512, 256, 128):
        if N % bn == 0 and K * bn <= 3 * 1024 * 1024:
            return bn
    return 0


def w4a8_gemm_fused(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    s_channel: Optional[torch.Tensor] = None,
    s_group: Optional[torch.Tensor] = None,
    *,
    group_size: int = -1,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Single-launch W4A8 linear: ``x`` (M, K) bf16/f32 raw activations,
    quantized per token in the kernel's prologue, then the per-channel
    (``group_size=-1``, ``s_channel``) or exact g128 (``s_group``) GEMM →
    (M, N).  Takes the (K, N) that JAX's does (:func:`_fused_bn`)."""
    K, N = x.shape[1], w_packed.shape[1]
    if not _fused_bn(K, _round_up(N, 128)):
        raise ValueError(f"fused W4A8 GEMM: K={K}, N={N} has no fused tile")
    name, scales = _route(x.shape[0], s_channel, s_group, group_size, False)
    fn = w4a8_gemm_fused_channel if name == "channel" else \
        w4a8_gemm_fused_group
    return fn(x, w_packed, scales, out_dtype)


def w4a8_linear(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    s_channel: Optional[torch.Tensor] = None,
    s_group: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    *,
    group_size: int = -1,
    out_dtype: torch.dtype = torch.bfloat16,
    requant: Optional[bool] = None,
) -> torch.Tensor:
    """Quantized linear layer: per-token INT8 activation quantization (plain
    PyTorch, in front of the kernel as in JAX) + W4A8 GEMM + bias.  With
    ``FUSE_ACT_QUANT`` set, calls of M ≤ 64 rows whose (K, N) pass
    :func:`_fused_bn` take the fused kernels instead (``requant`` is then
    moot), as JAX's do.  ``x`` may have any leading shape ``(..., K)``."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    N = w_packed.shape[1]
    if FUSE_ACT_QUANT and x2.shape[0] <= 64 and _fused_bn(
            K, _round_up(N, 128)):
        out = w4a8_gemm_fused(x2.contiguous(), w_packed, s_channel, s_group,
                              group_size=group_size, out_dtype=out_dtype)
    else:
        a_q, s_tok = quantize_activations_per_token(x2)
        out = w4a8_gemm(a_q, s_tok, w_packed, s_channel, s_group,
                        group_size=group_size, out_dtype=out_dtype,
                        requant=requant)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.reshape(*lead, -1)


def _interleave_cols(a: torch.Tensor, b: torch.Tensor, bn: int) -> torch.Tensor:
    """(R, I) + (R, I) → (R, 2I) as [a_0 b_0 a_1 b_1 ...] tiles of bn cols."""
    R, I = a.shape
    t = I // bn
    return torch.stack([a.reshape(R, t, bn), b.reshape(R, t, bn)],
                       dim=2).reshape(R, 2 * I)


def fuse_glu_layout(gate: Dict[str, Any],
                    up: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Fuse packed gate/up linears into one GLU weight for
    :func:`w4a8_glu_linear`: columns tile-interleaved as
    ``[gate_j(256) | up_j(256)]``, bit for bit the JAX layout.  Returns None
    when not fusible (dense, biased, unequal shapes or schemes, or I not a
    multiple of 256)."""
    if "w_packed" not in gate or "w_packed" not in up:
        return None
    if "b" in gate or "b" in up:
        return None
    if gate["w_packed"].shape != up["w_packed"].shape:
        return None
    if ("s_group" in gate) != ("s_group" in up):
        return None
    I = gate["w_packed"].shape[1]
    if I % GLU_INTERLEAVE != 0:
        return None
    bn = GLU_INTERLEAVE
    fused = {"w_packed": _interleave_cols(gate["w_packed"], up["w_packed"],
                                          bn)}
    if "s_group" in gate:
        fused["s_group"] = _interleave_cols(gate["s_group"], up["s_group"], bn)
    else:
        fused["s_channel"] = _interleave_cols(
            gate["s_channel"].reshape(1, I), up["s_channel"].reshape(1, I), bn
        ).reshape(2 * I)
    return fused


def w4a8_glu_linear(
    x: torch.Tensor,
    glu: Dict[str, torch.Tensor],
    *,
    out_dtype: torch.dtype = torch.bfloat16,
    requant: Optional[bool] = None,
) -> torch.Tensor:
    """``silu(x·W_gate)·(x·W_up)`` through the GLU-fused kernel; ``glu``
    comes from :func:`fuse_glu_layout`."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    a_q, s_tok = quantize_activations_per_token(x2)
    group_size = PACK_BLOCK if "s_group" in glu else -1
    out = w4a8_glu_gemm(a_q, s_tok, glu["w_packed"], glu.get("s_channel"),
                        glu.get("s_group"), group_size=group_size,
                        out_dtype=out_dtype, requant=requant)
    return out.reshape(*lead, -1)


class _CallableModule(types.ModuleType):
    """This module, callable as its :func:`w4a8_gemm`: qqq_tpu/kernels
    exports the GEMM under the module's name, and the port's code and tests
    import the module by that name (``from qqq_tpu_torch.kernels import
    w4a8_gemm``)."""

    def __call__(self, *args, **kwargs) -> torch.Tensor:
        return w4a8_gemm(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule
