"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and odd shapes the checks of chip_smoke.py do not reach (hd = 64,
GQA up to g = 8, the split decode (whole-cache, S-tiled, paged) also at
g = 16, f32 I/O, ragged M and N, odd S, hd = 96 and 256, chunks after
cached keys; over the paged pool: block sizes 8, 16, 128 and 512,
scrambled tables, chunks that straddle blocks, rows past their table and
rows whose table is all null; the per-channel GEMM and GLU in each of
their two regimes, forced, at rows on both sides of the switch).

Needs an NVIDIA GPU with nvcc; skips without one.  Run on the card with
``python -m pytest tests/test_torch_cuda.py --noconftest -q`` (the suite's
conftest imports JAX, which the GPU machine need not have).
Tolerances as in chip_smoke.py: the GEMMs (per channel, exact g128,
requant and the activation-quant-fused ones) and the KV writes bit-exact
(the paged ones outside the null block, whose content is unspecified), the
GLU-fused GEMMs within two bf16
ulps of their largest output (another exp in the epilogue); attention
within two ulps of the output dtype at the largest output (bf16: 2^-6,
f32: 2^-22 relative to max |ref|, plus the flash, paged decode and S-tiled
decode kernels' bf16 probabilities: 2^-7 relative in f32), slot and paged
flash, the S-tiled decode and paged decode per output row, at its own
largest value; paged flash bit-equal to slot flash on the gathered pool,
for both QKᵀ routes (bf16, and int8 with ``qk_int8=True``, whose q codes and
scales are bit-exact); the seeded sampling noise's bits and uniforms
bit-equal to the CPU's, its Gumbel values within 2 ulps of max(|g|, 1).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


def _gemm_operands(dev, M, K, N, n_scales):
    """Random int8 activations, any int32 packed words (every nibble
    pattern) and positive scales: ``n_scales`` rows of N (0: per channel)."""
    g = _gen(dev)
    a = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    s_tok = torch.rand((M, 1), generator=g, device=dev) + 1e-3
    w = torch.randint(-2**31, 2**31 - 1, (K // 8, N), generator=g,
                      device=dev, dtype=torch.int32)
    shape = (n_scales, N) if n_scales else (N,)
    s = torch.rand(shape, generator=g, device=dev) * 0.01 + 1e-4
    return a, s_tok, w, s


def _launch_once(fn, *args, **kw):
    n0 = fn.launches
    out = fn(*args, **kw)
    assert fn.launches == n0 + 1
    return out


def _launch_channel(regime, glu, a, s_tok, w, s_ch, out_dtype):
    """The per-channel GEMM (GLU with ``glu``) with its regime forced
    through the route's ``regime``: one launch, counted on its wrapper."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    fn = k.w4a8_glu_channel if glu else k.w4a8_gemm_channel
    n0 = fn.launches
    out = k._channel(fn, a, s_tok, w, s_ch, out_dtype, glu, regime=regime)
    assert fn.launches == n0 + 1
    return out


#: rows on both sides of the per-channel regime switch, whole and ragged
#: 16-row stream tiles and 256-row tensor-core tiles
_SWITCH_MS = (1, 4, 16, 17, 64, 65, 128, 256, 513)
# K = 128: one group; 1152: nine groups, more than one stage of the stream's
# ring and of the tiles' K steps; 14336: Llama-3.1's down, 14 stages.  N =
# 24 narrower than a 32-column stream tile, 200 ragged, 96 narrower than a
# 128-column tensor-core tile; every grid here has fewer tiles than the
# card has SMs, so the tiles split K
_CHANNEL_SHAPES = ([(1, 128, 32), (3, 384, 96), (70, 256, 200)]
                   + [(M, K, N) for M in _SWITCH_MS
                      for K, N in ((128, 24), (1152, 200), (14336, 96))])


@pytest.mark.parametrize("M,K,N", _CHANNEL_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("regime", ["stream", "tiles"])
def test_w4a8_gemm_kernel_bit_exact(dev, regime, M, K, N, out_dtype):
    """The per-channel GEMM in each regime (the weight stream, the int8
    wgmma tiles), forced through the route's ``regime``: bit-exact, one
    launch."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    a, s_tok, w, s_ch = _gemm_operands(dev, M, K, N, 0)
    out = _launch_channel(regime, False, a, s_tok, w, s_ch, out_dtype)
    assert torch.equal(out, k.w4a8_gemm_channel_plain(a, s_tok, w, s_ch,
                                                      out_dtype))


@pytest.mark.parametrize("glu", [False, True])
def test_channel_cuda_calls_launch_the_kernel(dev, monkeypatch, glu):
    """Through ``w4a8_gemm`` / ``w4a8_glu_gemm`` (group_size -1), a CUDA
    call at every M of the switch launches the per-channel kernel once
    (the regime ``channel_regime`` names) and never the plain version: the
    plain functions are replaced by ones that fail."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    def refuse(*args, **kw):
        raise AssertionError("a CUDA call ran the plain version")

    monkeypatch.setattr(k, "w4a8_gemm_channel_plain", refuse)
    monkeypatch.setattr(k, "w4a8_glu_channel_plain", refuse)
    route = k.w4a8_glu_gemm if glu else k.w4a8_gemm
    name = "w4a8_glu_channel" if glu else "w4a8_gemm_channel"
    a, s_tok, w, s_ch = _gemm_operands(dev, max(_SWITCH_MS), 1152, 512, 0)
    regimes = set()
    for M in _SWITCH_MS:
        before = {n: f.launches for n, f in k.KERNEL_WRAPPERS.items()}
        out = route(a[:M], s_tok[:M], w, s_ch, group_size=-1)
        after = {n: f.launches for n, f in k.KERNEL_WRAPPERS.items()}
        assert {n: after[n] - before[n] for n in after} == {
            n: int(n == name) for n in after}
        assert out.shape == (M, 256 if glu else 512) and out.is_cuda
        regimes.add(k.channel_regime(M, glu))
    assert regimes == {"stream", "tiles"}


# K = 1152: nine groups, more than one stage of the exact kernel's ring;
# K = 128: one group; K = 14336: Llama-3.1's down, 14 stages through the
# 4-stage ring; N = 200 and 24: ragged and narrower than one 32-column
# tile; M = 8, 9, 16, 17, 64, 128 and 130: whole and ragged 8- and 16-row
# tiles (terms at two words a lane up to 8 rows, four from 9)
_G128_SHAPES = [(1, 128, 32), (3, 384, 96), (70, 1152, 200), (17, 256, 64),
                (1, 14336, 256), (5, 128, 24), (64, 1152, 200),
                (128, 384, 96), (8, 1152, 200), (9, 384, 96),
                (16, 1152, 64), (130, 1152, 200)]


@pytest.mark.parametrize("M,K,N", _G128_SHAPES)
@pytest.mark.parametrize("sg_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("route", ["group", "requant"])
def test_w4a8_g128_kernels_bit_exact(dev, route, M, K, N, sg_dtype,
                                     out_dtype):
    """Exact g128: the groups' f32 terms summed in group order on both
    sides; requant: one exact int32 dot.  Both bit-exact."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    a, s_tok, w, sg = _gemm_operands(dev, M, K, N, K // 128)
    sg = sg.to(sg_dtype)
    sg[:, 5] = 0  # an all-zero channel: s_extra 1
    fn = getattr(k, f"w4a8_gemm_{route}")
    plain = getattr(k, f"w4a8_gemm_{route}_plain")
    out = _launch_once(fn, a, s_tok, w, sg, out_dtype)
    assert torch.equal(out, plain(a, s_tok, w, sg, out_dtype))


def _misaligned(t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return flat[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("M,K,N", [(4, 256, 33), (9, 384, 70), (2, 128, 6),
                                   (4, 256, 64)])
@pytest.mark.parametrize("sg_dtype", [torch.bfloat16, torch.float32])
def test_w4a8_group_kernel_odd_widths(dev, M, K, N, sg_dtype):
    """N not a multiple of 4 (8 for bf16 s_group), or a weight and scales
    that do not start on a 16-byte boundary: the exact g128 kernel copies
    the codes a word at a time and the scales element by element, zero past
    N; rows 8-15 of a tile live (M = 9).  Bit-exact, one launch each."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    a, s_tok, w, sg = _gemm_operands(dev, M, K, N, K // 128)
    sg = sg.to(sg_dtype)
    out = _launch_once(k.w4a8_gemm_group, a, s_tok, w, sg, torch.float32)
    assert torch.equal(out, k.w4a8_gemm_group_plain(a, s_tok, w, sg,
                                                    torch.float32))
    w2, sg2 = _misaligned(w), _misaligned(sg)
    assert w2.data_ptr() % 16 and sg2.data_ptr() % 16
    out2 = _launch_once(k.w4a8_gemm_group, a, s_tok, w2, sg2, torch.float32)
    assert torch.equal(out2, out)


def test_w4a8_group_kernel_shapes_in_turn(dev):
    """The entry opts each kernel in to its shared memory once per device
    and keeps that: launches at decode, prefill and decode shapes in turn,
    with both s_group dtypes, each bit-exact."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    for M, K, N in ((4, 1152, 256), (128, 384, 96), (4, 1152, 256),
                    (1, 128, 32)):
        for sg_dtype in (torch.bfloat16, torch.float32):
            a, s_tok, w, sg = _gemm_operands(dev, M, K, N, K // 128)
            sg = sg.to(sg_dtype)
            out = _launch_once(k.w4a8_gemm_group, a, s_tok, w, sg)
            assert torch.equal(out, k.w4a8_gemm_group_plain(a, s_tok, w, sg))


@pytest.mark.parametrize("M,K,N", [(1, 128, 32), (130, 384, 200),
                                   (513, 1152, 1000), (512, 4096, 1024)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w4a8_requant_tensor_core_tiles(dev, M, K, N, out_dtype):
    """The requant kernel's 128 x 128 tiles at ragged M and N, and a grid
    too small for the card that splits K (M = 512, N = 1024, as the k/v
    projections): bit-exact, one launch."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    a, s_tok, w, sg = _gemm_operands(dev, M, K, N, K // 128)
    sg = sg.to(torch.bfloat16)
    out = _launch_once(k.w4a8_gemm_requant, a, s_tok, w, sg, out_dtype)
    assert torch.equal(out, k.w4a8_gemm_requant_plain(a, s_tok, w, sg,
                                                      out_dtype))


_GLU_SHAPES = [(1, 128, 256), (5, 384, 512), (70, 1152, 256),
               (512, 4096, 512), (513, 256, 2816), (513, 1152, 256)]
# the per-channel GLU in each regime, across the switch's rows
_GLU_CHANNEL_SHAPES = (_GLU_SHAPES
                       + [(M, K, 256) for M in _SWITCH_MS
                          for K in (128, 1152)]
                       + [(M, 14336, 256) for M in (4, 65, 513)])
# the exact g128 GLU on the weight stream at Llama-2-7B's and Llama-3.1-8B's
# gate/up (2I = 22016 and 28672): whole and ragged 8- and 16-row tiles, the
# bucket-128 prefill and past it
_GLU_GROUP_MS = (1, 4, 8, 9, 16, 17, 64, 128, 130)
_GLU_GROUP_SHAPES = [(M, 4096, I) for M in _GLU_GROUP_MS
                     for I in (11008, 14336)]


@pytest.mark.parametrize(
    "route,regime,M,K,I,sg_dtype",
    [(r, None, *sh, torch.bfloat16) for r in ("group", "requant")
     for sh in _GLU_SHAPES]
    + [("group", None, *sh, sg) for sh in _GLU_GROUP_SHAPES
       for sg in (torch.bfloat16, torch.float32)]
    + [("channel", g, *sh, None) for g in ("stream", "tiles")
       for sh in _GLU_CHANNEL_SHAPES])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w4a8_glu_kernels(dev, route, regime, M, K, I, sg_dtype, out_dtype):
    """GLU epilogue g·σ(g)·u: the kernel's expf and PyTorch's sigmoid may
    differ in the last bit.  bf16: two ulps at the largest output; f32:
    2^-20 of it (σ's own error and three roundings).  For the tensor-core
    tiles (256 rows x 64 outputs; requant, and per channel in its tile
    regime): M = 512, K = 4096, I = 512 has 16 tiles, fewer than the card's
    SMs, and splits K; M = 513 is ragged, with I = 2816 on 132 tiles (no
    split) and with I = 256 split.  The per-channel GLU runs in each regime
    (the weight stream's tile: 32 gate and 32 up columns), forced through
    the route's ``regime``.  The exact g128 GLU (the weight stream, 32 gate
    and 32 up columns with their s_group rows) also from a weight and
    scales that start off a 16-byte boundary, which the TMA unit refuses:
    its producer copies the codes and both scale boxes, and the result is
    the same."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    a, s_tok, w, s = _gemm_operands(dev, M, K, 2 * I,
                                    0 if route == "channel" else K // 128)
    if route != "channel":
        s = s.to(sg_dtype)
    fn = getattr(k, f"w4a8_glu_{route}")
    plain = getattr(k, f"w4a8_glu_{route}_plain")
    out = (_launch_once(fn, a, s_tok, w, s, out_dtype) if regime is None
           else _launch_channel(regime, True, a, s_tok, w, s, out_dtype))
    ref = plain(a, s_tok, w, s, out_dtype)
    assert out.shape == (M, I) and out.dtype == out_dtype
    tol = (2 * _ULP[torch.bfloat16] if out_dtype == torch.bfloat16
           else 2.0 ** -20) * float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= tol
    if route == "group":
        w2, s2 = _misaligned(w), _misaligned(s)
        assert w2.data_ptr() % 16 and s2.data_ptr() % 16
        assert torch.equal(_launch_once(fn, a, s_tok, w2, s2, out_dtype),
                           out)


def test_g128_stream_wrappers_launch_their_kernels(dev, monkeypatch):
    """Through ``w4a8_glu_gemm`` (group_size 128) and ``w4a8_gemm_fused``,
    each CUDA call adds one to its own wrapper's count and to no other, and
    never runs the plain version (the plain functions are replaced by ones
    that fail).  The built libraries hold the stream kernels
    (``stream::glu_kernel``, ``stream::fused_kernel``) and no ``__dp4a``
    g128 kernel: no ``glu_kernel`` outside namespace ``stream`` and no
    per-channel-block ``fused_kernel`` instantiated for g128 (its old
    template list, ``<BM, kGroup, ...>``, began with an int and a bool)."""
    import re

    from qqq_tpu_torch.kernels import build
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    def refuse(*args, **kw):
        raise AssertionError("a CUDA call ran the plain version")

    for name in ("w4a8_glu_group_plain", "w4a8_gemm_fused_group_plain",
                 "w4a8_gemm_group_plain"):
        monkeypatch.setattr(k, name, refuse)
    a, s_tok, w, sg = _gemm_operands(dev, 64, 1024, 512, 8)
    x = torch.randn((64, 1024), generator=_gen(dev), device=dev).to(
        torch.bfloat16)
    calls = [("w4a8_glu_group", lambda M: k.w4a8_glu_gemm(
                 a[:M], s_tok[:M], w, None, sg, group_size=128)),
             ("w4a8_gemm_fused_group", lambda M: k.w4a8_gemm_fused(
                 x[:M], w, None, sg, group_size=128))]
    for name, call in calls:
        for M in (1, 4, 17, 64):
            for _ in range(2):
                before = {n: f.launches for n, f in k.KERNEL_WRAPPERS.items()}
                out = call(M)
                after = {n: f.launches for n, f in k.KERNEL_WRAPPERS.items()}
                assert {n: after[n] - before[n] for n in after} == {
                    n: int(n == name) for n in after}
                assert out.is_cuda and out.shape[0] == M
    torch.cuda.synchronize()
    group = build.load("w4a8_group")._name
    fused = build.load("w4a8_fused")._name
    syms = {p: set(re.findall(rb"_Z[A-Za-z0-9_]+", open(p, "rb").read()))
            for p in (group, fused)}
    glu = [m for m in syms[group] if b"10glu_kernel" in m]
    assert glu and all(b"6stream10glu_kernel" in m for m in glu)
    assert any(b"6stream12fused_kernel" in m for m in syms[fused])
    assert not [m for m in syms[fused]
                if re.search(rb"(?<!6stream)12fused_kernelILi\d+ELb", m)]


def test_w4a8_g128_route_follows_m(dev):
    """requant=None: M >= 512 launches the requant kernel, fewer rows the
    exact one; each launch counts on its own wrapper only."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    a, s_tok, w, sg = _gemm_operands(dev, 512, 256, 64, 2)
    for rows, route in ((512, "requant"), (511, "group")):
        before = {n: f.launches for n, f in k.KERNEL_WRAPPERS.items()}
        k.w4a8_gemm(a[:rows], s_tok[:rows], w, None, sg, group_size=128)
        after = {n: f.launches for n, f in k.KERNEL_WRAPPERS.items()}
        assert {n: after[n] - before[n] for n in after} == {
            n: int(n == f"w4a8_gemm_{route}") for n in after}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kv_write_kernel_bit_exact(dev, dtype):
    from qqq_tpu_torch.kernels.kv_write import (
        slot_decode_write_int8, slot_decode_write_int8_plain,
    )

    g = _gen(dev)
    B, nkv, S, hd = 3, 2, 256, 64
    bufs = [torch.zeros((B, nkv, S, hd), dtype=torch.int8, device=dev),
            torch.zeros((B, nkv, S), device=dev),
            torch.zeros((B, nkv, S, hd), dtype=torch.int8, device=dev),
            torch.zeros((B, nkv, S), device=dev)]
    kn = torch.randn((B, 1, nkv, hd), generator=g, device=dev).to(dtype)
    vn = torch.randn((B, 1, nkv, hd), generator=g, device=dev).to(dtype)
    clen = torch.tensor([0, 100, S + 3], dtype=torch.int32, device=dev)
    mine = [t.clone() for t in bufs]
    ref = [t.clone() for t in bufs]
    slot_decode_write_int8(*mine, kn, vn, clen)
    slot_decode_write_int8_plain(*ref, kn, vn, clen)
    for x, y in zip(mine, ref):
        assert torch.equal(x, y)


def _cache(dev, B, nkv, S, hd):
    g = _gen(dev)
    kc = torch.randint(-128, 128, (B, nkv, S, hd), generator=g, device=dev,
                       dtype=torch.int8)
    vc = torch.randint(-128, 128, (B, nkv, S, hd), generator=g, device=dev,
                       dtype=torch.int8)
    ks = torch.rand((B, nkv, S), generator=g, device=dev) * 0.02 + 1e-3
    vs = torch.rand((B, nkv, S), generator=g, device=dev) * 0.02 + 1e-3
    return kc, ks, vc, vs


_ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23}


def _per_row_ulps(out, ref, dtype):
    """Worst (row, head) |diff| over two ulps of its own largest output
    (bf16 probabilities in f32: 2^-7); the rows agree when it is ≤ 1."""
    ulps = 2 * _ULP[dtype] if dtype == torch.bfloat16 else 2.0 ** -7
    d = (out.float() - ref.float()).abs().amax(dim=-1)
    tol = ulps * ref.float().abs().amax(dim=-1)
    return float(torch.where(d > 0, d / tol, torch.zeros_like(d)).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nh,nkv,hd,S", [
    pytest.param(4, 2, 64, 384, id="4-2-64"),
    pytest.param(8, 1, 128, 384, id="8-1-128"),
    pytest.param(2, 2, 32, 384, id="2-2-32"),
    pytest.param(16, 1, 128, 300, id="g16-S300"),   # S not a multiple of 128
    pytest.param(8, 2, 96, 1000, id="hd96-S1000"),
    pytest.param(4, 2, 256, 2047, id="hd256-S2047"),
])
def test_decode_attention_kernel(dev, dtype, nh, nkv, hd, S):
    """The whole-cache decode on the split kernel (f32 numerics, one tile
    of S keys): a one-key row beside a mid row and a full-cache row, one
    launch; each (row, head) within two ulps of the output dtype at its own
    largest output, plus 1e-6 in f32 (reassociation over up to S terms)."""
    from qqq_tpu_torch.kernels.attention import (
        decode_attention_int8, decode_attention_int8_plain,
    )

    B = 3
    q = torch.randn((B, nh, hd), generator=_gen(dev), device=dev).to(dtype)
    clen = torch.tensor([1, 200, S], dtype=torch.int32, device=dev)
    args = (q, *_cache(dev, B, nkv, S, hd), clen)
    out = _launch_once(decode_attention_int8, *args)
    ref = decode_attention_int8_plain(*args)
    d = (out.float() - ref.float()).abs().amax(dim=-1)
    tol = 2 * _ULP[dtype] * ref.float().abs().amax(dim=-1)
    if dtype == torch.float32:
        tol = tol + 1e-6
    assert bool((d <= tol).all())


@pytest.mark.parametrize("kernel", ["kv_write", "decode", "flash",
                                    "paged_write", "paged_decode",
                                    "paged_flash"])
def test_cpu_cache_len_beside_cuda_tensors_raises(dev, kernel):
    """A host pointer must never reach a kernel."""
    from qqq_tpu_torch.kernels.attention import (
        decode_attention_int8, flash_attention_int8,
        paged_decode_attention_int8, paged_flash_attention_int8,
    )
    from qqq_tpu_torch.kernels.kv_write import (
        paged_decode_write_int8, slot_decode_write_int8,
    )

    B, nh, nkv, S, hd = 2, 4, 2, 128, 64
    cache = _cache(dev, B, nkv, S, hd)
    pool = _cache(dev, 5, nkv, 16, hd)  # 5 blocks of 16 as a pool
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev)
    clen = torch.tensor([3, 7], dtype=torch.int32)  # on the CPU
    q = torch.randn((B, nh, hd), generator=_gen(dev), device=dev)
    new = torch.randn((B, 1, nkv, hd), generator=_gen(dev), device=dev)
    if kernel == "kv_write":
        fn, args = slot_decode_write_int8, (*cache, new, new, clen)
    elif kernel == "decode":
        fn, args = decode_attention_int8, (q, *cache, clen)
    elif kernel == "flash":
        fn, args = flash_attention_int8, (q[:, :, None], *cache, clen)
    elif kernel == "paged_write":
        fn, args = paged_decode_write_int8, (*pool, new, new, tables, clen)
    elif kernel == "paged_decode":
        fn, args = paged_decode_attention_int8, (q, *pool, tables, clen)
    else:
        fn, args = paged_flash_attention_int8, (q[:, :, None], *pool, tables,
                                                clen)
    n0 = fn.launches
    with pytest.raises(ValueError, match="cache_len: on cpu"):
        fn(*args)
    assert fn.launches == n0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nh,nkv,hd,T,clen", [(4, 2, 64, 16, (0, 20)),
                                              (2, 2, 128, 100, (0, 37)),
                                              (8, 2, 128, 100, (0, 37)),
                                              (4, 2, 96, 100, (0, 37)),
                                              (4, 2, 256, 100, (0, 37))])
def test_flash_attention_kernel(dev, dtype, nh, nkv, hd, T, clen):
    """GQA up to g = 4, chunks after cached keys, T not a multiple of the
    kernel's 64-row block, hd = 64, 96, 128 and 256; each output row within
    two ulps of its own largest value (bf16 probabilities in f32: 2^-7)."""
    from qqq_tpu_torch.kernels.attention import (
        flash_attention_int8, flash_attention_int8_plain,
    )

    B, S = 2, 256
    q = torch.randn((B, nh, T, hd), generator=_gen(dev), device=dev).to(dtype)
    cl = torch.tensor(clen, dtype=torch.int32, device=dev)
    args = (q, *_cache(dev, B, nkv, S, hd), cl)
    out = _launch_once(flash_attention_int8, *args)
    ref = flash_attention_int8_plain(*args)
    assert _per_row_ulps(out, ref, dtype) <= 1


# ---------------------------------------------------------------------------
# the paged pool


def _tables(dev, B, nbmax, null_row):
    """Scrambled distinct pool blocks per row; ``null_row``'s table is all
    null, as an empty slot's is."""
    g = torch.Generator().manual_seed(1)
    t = (torch.randperm(B * nbmax, generator=g) + 1).reshape(B, nbmax)
    t[null_row] = 0
    return t.to(torch.int32).to(dev)


def _assert_equal_but_null(mine, ref):
    for x, y in zip(mine, ref):
        assert torch.equal(x[1:], y[1:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs", [8, 16, 128])
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
def test_paged_write_kernels_bit_exact(dev, dtype, bs, hd):
    """Decode: rows mid-block, past the table, and on a null table.  Chunk:
    2·bs tokens from mid-block (three blocks), a row that runs past its
    table, a null-table row.  hd 64, 128 and 256 take the kernel's vector
    lanes (hd / 32 values a lane), 96 the lane-strided ones; K/V rows off
    their vector alignment take the strided ones too, with the same
    result."""
    from qqq_tpu_torch.kernels.kv_write import (
        paged_chunk_write_int8, paged_chunk_write_int8_plain,
        paged_decode_write_int8, paged_decode_write_int8_plain,
    )

    B, nkv, nbmax = 3, 2, 6
    g = _gen(dev)
    pool = list(_cache(dev, 1 + B * nbmax, nkv, bs, hd))
    tables = _tables(dev, B, nbmax, null_row=2)
    for fn, plain, T, clen in (
        (paged_decode_write_int8, paged_decode_write_int8_plain, 1,
         (2 * bs + 3, nbmax * bs + 1, 5)),
        (paged_chunk_write_int8, paged_chunk_write_int8_plain, 2 * bs,
         (bs // 2, nbmax * bs - bs, 5)),
    ):
        kn = torch.randn((B, T, nkv, hd), generator=g, device=dev).to(dtype)
        vn = torch.randn((B, T, nkv, hd), generator=g, device=dev).to(dtype)
        kn[0, 0, 1] = 0  # an all-zero head row: the tiny-scale guard
        cl = torch.tensor(clen, dtype=torch.int32, device=dev)
        mine = [t.clone() for t in pool]
        ref = [t.clone() for t in pool]
        _launch_once(fn, *mine, kn, vn, tables, cl)
        plain(*ref, kn, vn, tables, cl)
        _assert_equal_but_null(mine, ref)
        assert not torch.equal(mine[0][1:], pool[0][1:])
        off = [t.clone() for t in pool]
        _launch_once(fn, *off, _misaligned(kn), _misaligned(vn), tables, cl)
        _assert_equal_but_null(off, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs,hd", [
    pytest.param(8, 64, id="8"), pytest.param(16, 64, id="16"),
    pytest.param(128, 128, id="128"), pytest.param(16, 96, id="16-hd96"),
    pytest.param(128, 256, id="128-hd256"),
])
def test_paged_flash_kernel(dev, dtype, bs, hd):
    """GQA g = 4, a chunk of 2·bs + 5 keys (over three blocks or more) after
    cached keys, one row on an all-null table; hd = 64, 96, 128, 256."""
    from qqq_tpu_torch.kernels.attention import (
        paged_flash_attention_int8, paged_flash_attention_int8_plain,
    )

    B, nh, nkv, nbmax = 3, 8, 2, 6
    T = 2 * bs + 5
    q = torch.randn((B, nh, T, hd), generator=_gen(dev), device=dev).to(dtype)
    args = (q, *_cache(dev, 1 + B * nbmax, nkv, bs, hd),
            _tables(dev, B, nbmax, null_row=2),
            torch.tensor([bs // 2, 3 * bs - 7, 0], dtype=torch.int32,
                         device=dev))
    out = _launch_once(paged_flash_attention_int8, *args)
    ref = paged_flash_attention_int8_plain(*args)
    assert _per_row_ulps(out, ref, dtype) <= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs", [8, 16, 128])
def test_paged_flash_is_slot_flash_on_gathered_pool(dev, dtype, bs):
    """Only the key rows' addresses differ between the two layouts: the
    paged kernel on a pool equals, bit for bit, the slot kernel on the pool
    gathered through the tables (stages spanning several blocks, a row on
    an all-null table)."""
    from qqq_tpu_torch.kernels.attention import (
        flash_attention_int8, paged_flash_attention_int8,
    )
    from qqq_tpu_torch.serve.paged_kv import gather

    B, nh, nkv, nbmax = 3, 8, 2, 6
    hd = 128 if bs == 128 else 64
    T = 2 * bs + 5
    q = torch.randn((B, nh, T, hd), generator=_gen(dev), device=dev).to(dtype)
    pool = _cache(dev, 1 + B * nbmax, nkv, bs, hd)
    tables = _tables(dev, B, nbmax, null_row=2)
    cl = torch.tensor([bs // 2, 3 * bs - 7, 0], dtype=torch.int32,
                      device=dev)
    out = _launch_once(paged_flash_attention_int8, q, *pool, tables, cl)
    slot = flash_attention_int8(q, *(gather(t, tables) for t in pool), cl)
    assert torch.equal(out, slot)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs,nh,nkv,hd,clen", [
    (8, 8, 2, 64, None), (16, 8, 2, 64, None), (128, 8, 2, 128, None),
    (512, 8, 2, 128, None),
    # rows ending on a 128-key chunk and on a 256-key tile, one key past
    (512, 8, 2, 128, (128, 129, 256, 257)),
    # one long row beside rows of one key
    (128, 8, 2, 128, (1, 2040, 1, 1)),
    # g = 16
    (128, 32, 2, 128, (200, 512, 1, 9)),
    # blocks of 16 < the 128-key chunk: a chunk spans eight blocks
    (16, 8, 2, 64, (1, 129, 320, 9)),
    # hd = 96: six of a key row's eight 16-byte columns live
    (128, 8, 2, 96, None),
    # hd = 256: sixteen columns a key row
    (128, 4, 2, 256, None),
], ids=["8-8-2-None", "16-8-2-None", "128-8-2-None", "512-8-2-None",
        "512-8-2-clen4", "128-8-2-clen5", "128-32-2-clen6", "16-8-2-clen7",
        "128-8-2-hd96", "128-4-2-hd256"])
def test_paged_decode_kernel(dev, dtype, bs, nh, nkv, hd, clen):
    """GQA; by default cache lengths of one key, mid-table and the whole
    table, and one row on an all-null table (bs = 512 walks two 256-key
    tiles per block, as JAX does); then chunk and tile edges, one long row
    beside one-key rows, g = 16, chunks spanning blocks, hd = 96 and 256.
    One wrapper call, each (row, head) within two ulps of its own largest
    output."""
    from qqq_tpu_torch.kernels.attention import (
        paged_decode_attention_int8, paged_decode_attention_int8_plain,
    )

    B = 4
    nbmax = max(2, 640 // bs, -(-max(clen or (0,)) // bs))
    if clen is None:
        clen = (1, nbmax * bs // 2 + 3, nbmax * bs, 9)
    q = torch.randn((B, nh, hd), generator=_gen(dev), device=dev).to(dtype)
    tables = _tables(dev, B, nbmax, null_row=3)
    args = (q, *_cache(dev, 1 + B * nbmax, nkv, bs, hd), tables,
            torch.tensor(clen, dtype=torch.int32, device=dev))
    out = _launch_once(paged_decode_attention_int8, *args)
    ref = paged_decode_attention_int8_plain(*args)
    assert _per_row_ulps(out, ref, dtype) <= 1


# ---------------------------------------------------------------------------
# the S-tiled decode and the activation-quant-fused GEMMs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nh,nkv,hd,S,sblk,clen", [
    (4, 4, 128, 1999, None, None),   # g = 1, odd S: JAX's walk-down gives S
    (8, 2, 128, 4096, 512, None),    # g = 4, eight tiles
    (7, 1, 64, 3001, None, None),    # g = 7
    (16, 2, 128, 2048, 256, None),   # g = 8
    (32, 2, 128, 2048, 256, None),   # g = 16
    # rows ending on a 128-key chunk and on a tile, one key past each
    (8, 2, 128, 4096, 512, (128, 129, 512, 513)),
    # one long row beside rows of one key
    (8, 2, 128, 8192, 2048, (1, 8191, 1, 1)),
    # hd = 96: six of a key row's eight 16-byte columns live
    (8, 2, 96, 2048, 512, None),
    # hd = 256: sixteen columns a key row
    (4, 2, 256, 2048, 512, None),
])
def test_flash_decode_kernel(dev, dtype, nh, nkv, hd, S, sblk, clen):
    """By default cache lengths of one key, mid-tile, on a tile boundary
    and the whole cache; then chunk and tile edges, one long row beside
    one-key rows, hd = 96 and 256.  One wrapper call, each (row, head)
    within two ulps of its own largest output (bf16 probabilities)."""
    from qqq_tpu_torch.kernels.attention import (
        flash_decode_attention_int8, flash_decode_attention_int8_plain,
        flash_decode_tile,
    )

    B = 4
    tile = flash_decode_tile(nkv, S, hd, nh // nkv, sblk)
    if clen is None:
        clen = (1, S // 2 + 3, min(2 * tile, S), S)
    q = torch.randn((B, nh, hd), generator=_gen(dev), device=dev).to(dtype)
    args = (q, *_cache(dev, B, nkv, S, hd),
            torch.tensor(clen, dtype=torch.int32, device=dev))
    out = _launch_once(flash_decode_attention_int8, *args, sblk=sblk)
    ref = flash_decode_attention_int8_plain(*args, sblk=sblk)
    assert _per_row_ulps(out, ref, dtype) <= 1


def test_flash_decode_whole_cache_tile(dev):
    """hd = 64 at S = 16384 makes JAX's tile the whole cache: its 128
    chunks' maxima meet in one running maximum, and the scores of every
    head live in the workspace the wrapper allocates; one launch, each
    (row, head) within two ulps of the plain version over the same tile,
    and over 2048-key tiles."""
    from qqq_tpu_torch.kernels.attention import (
        decode_workspace_bytes, flash_decode_attention_int8,
        flash_decode_attention_int8_plain, flash_decode_tile,
    )

    B, nh, nkv, S, hd = 1, 8, 2, 16384, 64
    assert flash_decode_tile(nkv, S, hd, nh // nkv) == S
    assert decode_workspace_bytes(B, nh, nkv, S, hd, S) > 4 * B * nh * S
    assert decode_workspace_bytes(B, nh, nkv, S, hd, 0) < 0
    q = torch.randn((B, nh, hd), generator=_gen(dev), device=dev)
    for clen in (S, 9001):
        args = (q, *_cache(dev, B, nkv, S, hd),
                torch.tensor([clen], dtype=torch.int32, device=dev))
        for sblk in (None, 2048):
            out = _launch_once(flash_decode_attention_int8, *args, sblk=sblk)
            ref = flash_decode_attention_int8_plain(*args, sblk=sblk)
            assert _per_row_ulps(out, ref, q.dtype) <= 1


def test_split_decode_shapes_in_turn(dev):
    """The entry keeps each kernel's grid size and shared-memory opt-in
    per block size: at hd = 256 a block needs more than the default 48 KiB,
    so a kept answer must still launch after a call that needed fewer
    bytes (B = 4, then 1, then 4 again), each within two ulps a (row,
    head)."""
    from qqq_tpu_torch.kernels.attention import (
        flash_decode_attention_int8, flash_decode_attention_int8_plain,
    )

    nh, nkv, S, hd = 4, 2, 1024, 256
    for B in (4, 1, 4):
        q = torch.randn((B, nh, hd), generator=_gen(dev), device=dev)
        args = (q, *_cache(dev, B, nkv, S, hd),
                torch.tensor((S, 700, 129, 1)[:B], dtype=torch.int32,
                             device=dev))
        out = _launch_once(flash_decode_attention_int8, *args, sblk=512)
        ref = flash_decode_attention_int8_plain(*args, sblk=512)
        assert _per_row_ulps(out, ref, q.dtype) <= 1


# K = 24576: the largest K that _fused_bn admits (96 groups, 12 stages of
# the ring); K = 32768: past what 8 rows of codes of the old per-channel
# block could stage in shared memory (the stream has no limit on K); M = 1,
# 3, 4, 8, 17 and 64: decode, ragged and whole 8-row (bf16 x) and 4-row
# (f32 x) blocks.  N = 200 ragged against the 32-column tiles; N = 33 and
# 517: widths the TMA unit refuses (the producer copies the codes and
# scales)
@pytest.mark.parametrize("M,K,N", [(1, 128, 33), (3, 384, 96),
                                   (33, 1152, 200), (64, 256, 517),
                                   (8, 1152, 200), (8, 32768, 96)]
                         + [(M, 24576, 200) for M in (1, 4, 17, 64)])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("route", ["channel", "group"])
def test_w4a8_fused_kernels_bit_exact(dev, route, M, K, N, x_dtype,
                                      out_dtype):
    """Activation quantization in the prologue, then the per-channel or
    exact g128 sum (s_group in bf16 and in f32); an all-zero row; bit-exact,
    one launch each."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    _, _, w, s = _gemm_operands(dev, M, K, N,
                                0 if route == "channel" else K // 128)
    x = (torch.randn((M, K), generator=_gen(dev), device=dev) * 3).to(x_dtype)
    x[0] = 0
    fn = getattr(k, f"w4a8_gemm_fused_{route}")
    plain = getattr(k, f"w4a8_gemm_fused_{route}_plain")
    for sc in ([s] if route == "channel" else [s.to(torch.bfloat16), s]):
        out = _launch_once(fn, x, w, sc, out_dtype)
        assert out.shape == (M, N) and out.dtype == out_dtype
        assert torch.equal(out, plain(x, w, sc, out_dtype))
        assert not out[0].any()


def test_w4a8_fused_group_quantizes_every_bf16_value(dev):
    """The g128 fused kernel divides by each row's scale through its
    reciprocal and two FMA corrections (csrc/w4a8_fused.cu:div_rn) where
    the scale is at least 2^-100, by IEEE division below.  Row i holds every
    finite bf16 value v with |v| <= A_i (zeros after), so its codes cover
    every bf16 input at that scale; the rows' maxima A_i span both paths and
    the boundary between them (2^-90: s ~ 2^-97; 2^-95: s ~ 2^-102).  f32
    out, so one code that differs shows: bit-exact against the plain
    version's IEEE divisions."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    maxima = [1.0, 2.0 ** -7, 3.140625, 30080.0, 2.0 ** -90, 2.0 ** -95]
    bits = torch.arange(0, 0x7F81, dtype=torch.int32)  # +0 .. +inf
    pos = bits.to(torch.int16).view(torch.bfloat16).float()
    rows = []
    for amax in maxima:
        v = pos[pos <= amax]
        rows.append(torch.cat([v, -v[1:]]))
    K = -(-max(len(r) for r in rows) // 128) * 128
    x = torch.zeros((len(rows), K))
    for i, r in enumerate(rows):
        x[i, :len(r)] = r
    x = x.to(torch.bfloat16).to(dev)
    _, _, w, s = _gemm_operands(dev, len(rows), K, 64, K // 128)
    out = _launch_once(k.w4a8_gemm_fused_group, x, w, s, torch.float32)
    assert torch.equal(out, k.w4a8_gemm_fused_group_plain(x, w, s,
                                                          torch.float32))


def test_w4a8_fused_too_large_raises(dev):
    """8 rows of K = 32768 codes are more than the old per-channel block
    could stage in shared memory, and its entry refused them; the weight
    stream has no limit on K.  8 and 4 rows launch once each, bit-exact,
    also from a weight and scales off a 16-byte boundary (the producer's
    copy path)."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    K, N = 32768, 64
    _, _, w, s = _gemm_operands(dev, 8, K, N, 0)
    x = torch.randn((8, K), generator=_gen(dev), device=dev).to(torch.bfloat16)
    for rows in (8, 4):
        out = _launch_once(k.w4a8_gemm_fused_channel, x[:rows], w, s)
        assert torch.equal(out, k.w4a8_gemm_fused_channel_plain(x[:rows], w,
                                                                s))
        w2, s2 = _misaligned(w), _misaligned(s)
        assert w2.data_ptr() % 16 and s2.data_ptr() % 16
        assert torch.equal(
            _launch_once(k.w4a8_gemm_fused_channel, x[:rows], w2, s2), out)


def test_fused_channel_runs_on_the_stream(dev, monkeypatch):
    """Through ``w4a8_gemm_fused`` (group_size -1), each CUDA call adds one
    to the per-channel fused wrapper's count and to no other, and never
    runs the plain version (replaced by one that fails).  The built library
    holds #4 as the stream's ``channel_kernel`` over ``QuantizedX`` and no
    ``fused_kernel`` outside namespace ``stream`` (the old CUDA-core
    block)."""
    import re

    from qqq_tpu_torch.kernels import build
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    def refuse(*args, **kw):
        raise AssertionError("a CUDA call ran the plain version")

    monkeypatch.setattr(k, "w4a8_gemm_fused_channel_plain", refuse)
    _, _, w, s = _gemm_operands(dev, 64, 1024, 512, 0)
    x = torch.randn((64, 1024), generator=_gen(dev), device=dev)
    for xd in (torch.bfloat16, torch.float32):
        for M in (1, 4, 17, 64):
            before = {n: f.launches for n, f in k.KERNEL_WRAPPERS.items()}
            out = k.w4a8_gemm_fused(x[:M].to(xd), w, s, None, group_size=-1)
            after = {n: f.launches for n, f in k.KERNEL_WRAPPERS.items()}
            assert {n: after[n] - before[n] for n in after} == {
                n: int(n == "w4a8_gemm_fused_channel") for n in after}
            assert out.is_cuda and out.shape == (M, 512)
    torch.cuda.synchronize()
    syms = set(re.findall(rb"_Z[A-Za-z0-9_]+",
                          open(build.load("w4a8_fused")._name, "rb").read()))
    assert [m for m in syms
            if b"6stream14channel_kernel" in m and b"10QuantizedX" in m]
    assert not [m for m in syms if re.search(rb"(?<!6stream)12fused_kernel",
                                             m)]


@pytest.mark.parametrize("group_size", [-1, 128])
def test_fused_route_launches_under_flag(dev, monkeypatch, group_size):
    """``FUSE_ACT_QUANT`` on: w4a8_linear at M = 4 launches the fused
    kernel alone (its own count), at M = 65 the two-step route, and with
    the flag off never the fused one."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    K, N = 512, 256
    _, _, w, s = _gemm_operands(dev, 65, K, N,
                                0 if group_size == -1 else K // 128)
    sc, sg = (s, None) if group_size == -1 else (None, s)
    x = torch.randn((65, K), generator=_gen(dev), device=dev).to(
        torch.bfloat16)
    fused = ("w4a8_gemm_fused_channel" if group_size == -1
             else "w4a8_gemm_fused_group")
    plain = "w4a8_gemm_channel" if group_size == -1 else "w4a8_gemm_group"
    for flag, rows, expect in ((True, 4, fused), (True, 65, plain),
                               (False, 4, plain)):
        monkeypatch.setattr(k, "FUSE_ACT_QUANT", flag)
        before = {n: f.launches for n, f in k.KERNEL_WRAPPERS.items()}
        k.w4a8_linear(x[:rows], w, sc, sg, group_size=group_size,
                      requant=False)
        after = {n: f.launches for n, f in k.KERNEL_WRAPPERS.items()}
        assert {n: after[n] - before[n] for n in after} == {
            n: int(n == expect) for n in after}


# ---------------------------------------------------------------------------
# the slot write (#9) at the served shapes, and the captured decode tick


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
@pytest.mark.parametrize("nkv,S", [(32, 2048), (8, 32768)])
def test_slot_write_bit_exact_at_served_shapes(dev, nkv, S, hd, dtype):
    """``write_kernel`` over ``SlotDest`` at chip_smoke's 3a and 3e caches
    (B = 4), rows at cache_len 0, S - 1 and past S (the clamp): codes and
    scales bit-exact, one launch."""
    from qqq_tpu_torch.kernels.kv_write import (
        slot_decode_write_int8, slot_decode_write_int8_plain,
    )

    g = _gen(dev)
    B = 4
    bufs = [torch.randint(-128, 128, (B, nkv, S, hd), generator=g,
                          device=dev, dtype=torch.int8),
            torch.rand((B, nkv, S), generator=g, device=dev)]
    bufs += [bufs[0].flip(0).contiguous(), bufs[1].flip(0).contiguous()]
    kn = torch.randn((B, 1, nkv, hd), generator=g, device=dev).to(dtype)
    vn = torch.randn((B, 1, nkv, hd), generator=g, device=dev).to(dtype)
    clen = torch.tensor([0, S - 1, S, S + 7], dtype=torch.int32, device=dev)
    mine = [t.clone() for t in bufs]
    ref = [t.clone() for t in bufs]
    _launch_once(slot_decode_write_int8, *mine, kn, vn, clen)
    slot_decode_write_int8_plain(*ref, kn, vn, clen)
    for x, y in zip(mine, ref):
        assert torch.equal(x, y)


#: the captured-tick tests' model: g128, gate/up GLU-fused, hd = 64
_TICK_CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2)
_TICK_MODES = {
    "slot": dict(max_batch=4, max_len=128, prefill_buckets=(16, 64)),
    # 12 usable blocks of 8 for requests that grow to 2 + 4 + 6 + 8:
    # growth and recompute preemption change the tables between replays
    "paged": dict(max_batch=4, max_len=128, paged=True, block_size=8,
                  prefill_chunk=32, prefill_batch=2, num_blocks=13),
}


@pytest.fixture(scope="module")
def tick_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from qqq_tpu_torch.models import (
        ModelConfig, init_params, quantize_params_rtn,
    )

    dev = torch.device("cuda")
    cfg = ModelConfig(**_TICK_CFG)
    params = quantize_params_rtn(
        init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev), cfg, 128)
    return params, cfg


def _serve(tick_model, mode, eager, steps=1, sampling=None):
    """4 requests through Engine on the card (``eager``: the engine's
    private eager-tick switch; ``sampling`` one SamplingParams for all or a
    list of four); returns the engine, its requests and each wrapper's
    launches during the run."""
    from qqq_tpu_torch.kernels import counted_wrappers
    from qqq_tpu_torch.serve.engine import Engine, Request
    from qqq_tpu_torch.serve.sampling import SamplingParams

    params, cfg = tick_model
    rng = np.random.default_rng(0)
    eng = Engine(params, cfg, steps_per_tick=steps, **_TICK_MODES[mode])
    eng._eager_tick = eager
    if not isinstance(sampling, list):
        sampling = [sampling or SamplingParams(max_new_tokens=14)] * 4
    reqs = [Request([int(t) for t in rng.integers(0, 256, n)], sp)
            for n, sp in zip((6, 19, 38, 56), sampling)]
    counters = counted_wrappers()
    before = {n: f.launches for n, f in counters.items()}
    eng.run(reqs)
    torch.cuda.synchronize()
    return eng, reqs, {n: f.launches - before[n] for n, f in counters.items()}


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("mode", sorted(_TICK_MODES))
def test_captured_tick_matches_eager(tick_model, mode, steps):
    """Greedy tokens of the captured tick equal the eager tick's, slot and
    paged, one step and four a tick; every tick but each graph's first
    replays it; the launch counts after the replays equal the eager run's
    (each replay adds its graph's launches); the engine's static inputs and
    caches keep their addresses.  In paged mode the tight pool grows and
    preempts, so the tables change between replays, and the next replay
    reads them (its tokens equal the eager run's)."""
    from qqq_tpu_torch.serve.engine import Request

    eng_e, reqs_e, n_e = _serve(tick_model, mode, eager=True, steps=steps)
    eng, reqs, n = _serve(tick_model, mode, eager=False, steps=steps)
    ptrs = [eng._tick_in.data_ptr()] + [
        t.data_ptr() for c in eng.caches for t in c.values()]
    if mode == "paged":
        ptrs.append(eng._tables_dev.data_ptr())
        assert eng.stats["preemptions"] > 0
    assert [r.output_tokens for r in reqs] == \
        [r.output_tokens for r in reqs_e]
    st = eng.stats
    assert st["graph_replays"] > 0 and eng_e.stats["graph_replays"] == 0
    assert st["graph_replays"] + st["graph_captures"] == st["decode_ticks"]
    assert st["graph_captures"] == len(eng._graphs)
    assert n == n_e and n["w4a8_glu_group"] > 0
    assert st["decode_steps"] == eng_e.stats["decode_steps"]
    eng.run([Request([1, 2, 3])])  # more replays, new tables
    assert ptrs[0] == eng._tick_in.data_ptr()
    assert ptrs[1:] == [t.data_ptr() for c in eng.caches
                        for t in c.values()] + (
        [eng._tables_dev.data_ptr()] if mode == "paged" else [])


def test_sampled_replays_draw_new_noise(dev, tick_model):
    """The engine's generator is registered with each graph: a captured
    Gumbel draw gives new noise on every replay; sampled engine ticks run
    on the sampled branch's graph."""
    from qqq_tpu_torch.serve.sampling import SAMPLED, SamplingParams, gumbel
    from qqq_tpu_torch.serve.tick_graph import TickGraph

    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.Stream()
    gumbel((4, 1000), gen, dev)  # warm-up
    graph = TickGraph(lambda: gumbel((4, 1000), gen, dev), gen, stream)
    first = graph.replay().clone()
    second = graph.replay().clone()
    assert not torch.equal(first, second)
    assert torch.isfinite(first).all() and torch.isfinite(second).all()

    eng, reqs, _ = _serve(tick_model, "slot", eager=False, steps=4,
                          sampling=SamplingParams(max_new_tokens=14,
                                                  temperature=1.0))
    assert {k[1] for k in eng._graphs} == {SAMPLED}
    assert eng.stats["graph_replays"] > 0
    assert all(len(r.output_tokens) == 14 and all(
        0 <= t < 256 for t in r.output_tokens) for r in reqs)


def _extras_samplings(seeded_only=False):
    """Four requests: seeded sampled rows (one filtered), or a batch that
    mixes a guided row (its path forced by a bias through a 7-token
    candidate, so that its one-wide guided plane repeats over ticks), a
    penalized one, a seeded one and a biased one with top-N logprobs."""
    from qqq_tpu_torch.serve.sampling import SamplingParams

    if seeded_only:
        return [SamplingParams(max_new_tokens=14, temperature=0.9,
                               seed=100 + i, top_k=40 if i == 3 else 0)
                for i in range(4)]
    return [
        SamplingParams(max_new_tokens=14, guided_choice=(
            (5, 6, 7, 8, 9, 10, 11), (5, 6, 12)), logit_bias=((12, -100.0),)),
        SamplingParams(max_new_tokens=14, presence_penalty=1.5,
                       frequency_penalty=0.5, repetition_penalty=1.3),
        SamplingParams(max_new_tokens=14, temperature=0.8, seed=7),
        SamplingParams(max_new_tokens=14, logit_bias=((3, -100.0),
                                                      (9, 4.0)),
                       top_logprobs=3),
    ]


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("mode", sorted(_TICK_MODES))
def test_seeded_tokens_equal_eager_and_captured(tick_model, mode, steps):
    """Seeded sampled rows (their noise a function of seed, generation
    index and token) give the same tokens from eager and captured ticks,
    slot and paged, one step and four a tick; the seeded graph replays."""
    eng_e, reqs_e, _ = _serve(tick_model, mode, eager=True, steps=steps,
                              sampling=_extras_samplings(seeded_only=True))
    eng, reqs, _ = _serve(tick_model, mode, eager=False, steps=steps,
                          sampling=_extras_samplings(seeded_only=True))
    assert [r.output_tokens for r in reqs] == \
        [r.output_tokens for r in reqs_e]
    assert all(len(r.output_tokens) == 14 for r in reqs)
    assert any(k[3].seeded and g.replays > 0 for k, g in eng._graphs.items())


@pytest.mark.parametrize("mode", sorted(_TICK_MODES))
def test_extras_batch_replays_its_graph(tick_model, mode):
    """A guided, penalized, seeded and biased batch with top-N logprobs:
    the captured ticks replay graphs keyed by those extras and give the
    eager ticks' tokens, logprobs and top-N lists; the guided row ends on
    a candidate."""
    from qqq_tpu_torch.serve.engine import TickExtras

    eng_e, reqs_e, n_e = _serve(tick_model, mode, eager=True,
                                sampling=_extras_samplings())
    eng, reqs, n = _serve(tick_model, mode, eager=False,
                          sampling=_extras_samplings())
    assert [r.output_tokens for r in reqs] == \
        [r.output_tokens for r in reqs_e]
    assert [r.token_logprobs for r in reqs] == \
        [r.token_logprobs for r in reqs_e]
    assert [r.top_logprobs for r in reqs] == [r.top_logprobs for r in reqs_e]
    assert reqs[0].output_tokens == [5, 6, 7, 8, 9, 10, 11]
    assert reqs[0].finish_reason == "stop"
    assert 3 not in reqs[3].output_tokens
    assert len(reqs[3].top_logprobs) == len(reqs[3].output_tokens)
    assert n == n_e
    replayed = [k[3] for k, g in eng._graphs.items() if g.replays]
    assert any(ex.penalties and ex.seeded for ex in replayed)
    assert any(ex.bias_k and ex.n_top == 3 for ex in replayed)
    assert all(k[3] != TickExtras() for k in eng._graphs)
    guided = [ex for ex in replayed if ex.allow_k and ex.penalties
              and ex.seeded]
    # the paged pool preempts rows in and out, which changes the key
    # between the guided row's ticks; the slot run keeps it
    assert guided or mode == "paged", sorted(eng._graphs)
    assert any(k[3].allow_k for k in eng._graphs)


def test_score_prompt_while_the_worker_captures(tick_model):
    """The server's echo scoring from other threads while its worker
    captures new graphs: scoring runs on the worker between scheduling
    rounds, so every capture succeeds, the tokens equal an eager run's and
    every score equals the one taken before the server started."""
    import threading

    from qqq_tpu_torch.cli.serve import EngineWorker
    from qqq_tpu_torch.serve.engine import Engine, Request

    params, cfg = tick_model
    _, reqs_e, _ = _serve(tick_model, "slot", eager=True,
                          sampling=_extras_samplings())
    eng = Engine(params, cfg, **_TICK_MODES["slot"])
    prompt = list(range(1, 40))
    want = eng.score_prompt(prompt)
    worker = EngineWorker(eng)
    reqs = [Request(r.prompt_tokens, r.sampling) for r in reqs_e]
    scores, stop = [], threading.Event()

    def score():
        while not stop.is_set():
            scores.append(worker.score_prompt(prompt))

    threads = [threading.Thread(target=score) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for r in reqs:
            worker.submit(r)
        for r in reqs:
            worker.wait(r, timeout=300)
    finally:
        stop.set()
        for t in threads:
            t.join(60)
        worker.stop()
    assert worker.error is None
    assert [r.output_tokens for r in reqs] == \
        [r.output_tokens for r in reqs_e]
    assert eng.stats["graph_captures"] >= 2 and eng.stats["graph_replays"]
    assert scores and all(s == want for s in scores)


@pytest.fixture(scope="module")
def prefill_models(tick_model):
    """The tick model's weights quantized both ways: {"g128": ...,
    "channel": ...} of (params, config)."""
    from qqq_tpu_torch.models import init_params, quantize_params_rtn

    _, cfg = tick_model
    dense = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device=torch.device("cuda"))
    return {"g128": tick_model,
            "channel": (quantize_params_rtn(dense, cfg, -1), cfg)}


#: (rows, bucket) in the order the captured-prefill test dispatches them:
#: every warm-up key (rows 1, 2, 4 and prefill_batch 7 in each bucket),
#: then keys again, interleaved, so that the graphs that share one pool
#: replay in an order other than their capture's
_PREFILL_KEYS = ([(b, pb) for b in (16, 64, 128) for pb in (1, 2, 4, 7)]
                 + [(64, 4), (128, 7), (64, 4), (16, 1), (128, 2), (16, 1),
                    (128, 7)])


def _prefill_dispatches(params, cfg, eager):
    """Each of ``_PREFILL_KEYS`` as one ``_admit_batch`` into the next
    free slots (slots wrap around, so later dispatches overwrite earlier
    rows), on an engine of 8 slots and ``prefill_batch`` 7; returns the
    engine and, per dispatch, its rows' first tokens, their
    log-probabilities and a copy of every cache buffer after it."""
    from qqq_tpu_torch.serve.engine import Engine, Request
    from qqq_tpu_torch.serve.sampling import SamplingParams

    eng = Engine(params, cfg, max_batch=8, max_len=128, prefill_batch=7,
                 prefill_buckets=(16, 64, 128))
    eng._eager_tick = eager
    rng = np.random.default_rng(3)
    out, nxt = [], 0
    for bucket, pb in _PREFILL_KEYS:
        lo = {16: 1, 64: 17, 128: 65}[bucket]
        reqs = [Request([int(t) for t in rng.integers(
            0, 256, int(rng.integers(lo, bucket + 1)))],
            SamplingParams(max_new_tokens=4)) for _ in range(pb)]
        slots = [(nxt + i) % 8 for i in range(pb)]
        nxt = (nxt + pb) % 8
        eng._admit_batch(reqs, slots, bucket)
        torch.cuda.synchronize()
        out.append(([r.output_tokens[0] for r in reqs],
                    [r.token_logprobs[0] for r in reqs],
                    [t.clone() for c in eng.caches for t in c.values()]))
        for s in slots:  # free the slots, the KV stays
            eng.slot_req[s] = None
    return eng, out


@pytest.mark.parametrize("scheme", ["g128", "channel"])
def test_captured_prefill_matches_eager(prefill_models, scheme):
    """A whole-bucket prefill replayed from its captured graph equals the
    eager one bit for bit: each row's first token and its
    log-probability, and every slot's KV codes and scales after every
    dispatch, at every warm-up key (rows 1, 2, 4 and prefill_batch 7 in
    buckets 16, 64 and 128: the exact, requant, stream and tile GEMM
    routes), g128 and per channel, with the keys' graphs replayed
    interleaved out of their capture order in their one shared pool.
    Each key captures once and every later dispatch of it replays;
    replays and captures add up to the dispatches; the launch counts
    equal the eager run's; the records say which ran."""
    from qqq_tpu_torch.kernels import counted_wrappers

    params, cfg = prefill_models[scheme]
    counters = counted_wrappers()
    before = {n: f.launches for n, f in counters.items()}
    eng_e, want = _prefill_dispatches(params, cfg, eager=True)
    n_e = {n: f.launches - before[n] for n, f in counters.items()}
    before = {n: f.launches for n, f in counters.items()}
    eng, got = _prefill_dispatches(params, cfg, eager=False)
    n = {n: f.launches - before[n] for n, f in counters.items()}
    for i, ((tw, lw, cw), (tg, lg, cg)) in enumerate(zip(want, got)):
        assert tg == tw, (i, _PREFILL_KEYS[i])
        assert lg == lw, (i, _PREFILL_KEYS[i])
        for a, b in zip(cg, cw):
            assert torch.equal(a, b), (i, _PREFILL_KEYS[i])
    st, keys = eng.stats, set(_PREFILL_KEYS)
    assert st["prefill_graph_captures"] == len(eng._prefill_graphs) \
        == len(keys)
    assert st["prefill_graph_replays"] + st["prefill_graph_captures"] \
        == st["prefill_dispatches"] == len(_PREFILL_KEYS)
    assert eng_e.stats["prefill_graph_replays"] \
        == eng_e.stats["prefill_graph_captures"] == 0
    assert not eng._graphs  # no tick ran
    assert n == n_e
    seen = set()
    for key, rec in zip(_PREFILL_KEYS,
                        [r for r in eng.dispatch_log
                         if r["kind"] == "prefill"]):
        assert rec["graph"] == ("replay" if key in seen else "capture")
        seen.add(key)
    assert all(r["graph"] is None for r in eng_e.dispatch_log)


# ---------------------------------------------------------------------------
# the rest of the scheduler: speculative verify, chunked slot prefill, the
# paged prefix cache


def _spec_serve(tick_model, mode, eager):
    """Speculative decoding (2-gram drafts, 4 a tick) on the tick model:
    three greedy rows whose prompts repeat (drafts), one with its top 3
    logprobs, and a seeded sampled row.  Returns the engine and its
    requests."""
    from qqq_tpu_torch.serve.engine import Engine, Request
    from qqq_tpu_torch.serve.sampling import SamplingParams

    params, cfg = tick_model
    rng = np.random.default_rng(1)
    eng = Engine(params, cfg, spec_ngram=2, spec_k=4, **_TICK_MODES[mode])
    eng._eager_tick = eager
    sps = [SamplingParams(max_new_tokens=20),
           SamplingParams(max_new_tokens=20, top_logprobs=3),
           SamplingParams(max_new_tokens=20),
           SamplingParams(max_new_tokens=20, temperature=0.8, seed=5)]
    reqs = []
    for n, sp in zip((6, 9, 12, 7), sps):
        p = [int(t) for t in rng.integers(0, 256, n)]
        reqs.append(Request(p * 3, sp))
    eng.run(reqs)
    torch.cuda.synchronize()
    return eng, reqs


@pytest.mark.parametrize("mode", sorted(_TICK_MODES))
def test_captured_verify_matches_eager(tick_model, mode):
    """The speculative verify replayed from its captured graph gives the
    eager verify's tokens, logprobs and top-N lists, bit-equal, slot (the
    forward over the cache read as a pool) and paged (the tight pool
    preempts); drafts are verified through replays of ("spec", k, ...)
    graphs, which the engine keeps beside the plain ticks'."""
    eng_e, reqs_e = _spec_serve(tick_model, mode, eager=True)
    eng, reqs = _spec_serve(tick_model, mode, eager=False)
    for got, want in ((r, e) for r, e in zip(reqs, reqs_e)):
        assert got.output_tokens == want.output_tokens
        assert got.token_logprobs == want.token_logprobs
        assert got.top_logprobs == want.top_logprobs
    st = eng.stats
    assert st["spec_drafted"] > 0 and st["spec_ticks"] > 0
    assert st["spec_accepted"] == eng_e.stats["spec_accepted"]
    assert sum(g.replays for k, g in eng._graphs.items()
               if k[0] == "spec") > 0
    assert st["graph_replays"] + st["graph_captures"] == st["decode_ticks"]
    if mode == "paged":
        assert st["preemptions"] > 0


@pytest.mark.parametrize("kv_quantized", [True, False])
def test_slot_chunk_prefill_equals_gathered_rows(tick_model, kv_quantized):
    """Chunked prefill in slot mode writes, through the cache read as a
    pool of max_len-token blocks, the bytes that the route JAX takes
    writes: gather the slots' whole rows, one slot-cache forward at
    ``cache_len``, scatter the rows back."""
    from qqq_tpu_torch.models import llama as M
    from qqq_tpu_torch.serve import kv_cache
    from qqq_tpu_torch.serve.engine import Engine, Request
    from qqq_tpu_torch.serve.sampling import SamplingParams

    params, cfg = tick_model
    rng = np.random.default_rng(2)
    lens, C = (40, 17, 70), 32
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in lens]
    eng = Engine(params, cfg, max_batch=3, max_len=128, prefill_chunk=C,
                 kv_quantized=kv_quantized)
    eng.run([Request(p, SamplingParams(max_new_tokens=1)) for p in prompts])
    assert eng.stats["prefill_chunks"] == sum(-(-n // C) for n in lens)

    ref = kv_cache.init(cfg, 3, 128, quantized=kv_quantized,
                        dtype=torch.bfloat16, device="cuda")
    fused = M.fuse_inference_params(params, cfg)
    for start in range(0, max(lens), C):
        slots = [s for s, n in enumerate(lens) if n > start]
        toks = torch.zeros((len(slots), C), dtype=torch.int64, device="cuda")
        for i, s in enumerate(slots):
            part = prompts[s][start:start + C]
            toks[i, :len(part)] = torch.tensor(part)
        idx = torch.tensor(slots, device="cuda")
        rows = [{k: v[idx] for k, v in c.items()} for c in ref]
        M.forward(fused, cfg, toks, caches=rows,
                  cache_len=torch.full((len(slots),), start,
                                       dtype=torch.int32, device="cuda"))
        for c, r in zip(ref, rows):
            for k in c:
                c[k][idx] = r[k]
    for c, r in zip(eng.caches, ref):
        for k in c:
            for s, n in enumerate(lens):
                assert torch.equal(c[k][s, :, :n], r[k][s, :, :n]), (k, s)


def test_adopted_prefix_block_equals_a_fresh_prefill(tick_model):
    """A paged prefix-cache block adopted by a second request holds the
    bytes that a fresh chunked prefill of the same prefix writes (KV
    depends on token and position alone), and the adoption is counted."""
    from qqq_tpu_torch.serve.engine import Engine, Request
    from qqq_tpu_torch.serve.sampling import SamplingParams

    params, cfg = tick_model
    rng = np.random.default_rng(3)
    system = [int(t) for t in rng.integers(0, 256, 24)]
    a, b = system + [1, 2, 3, 4, 5], system + [9, 8, 7]
    kw = dict(max_batch=2, max_len=128, paged=True, block_size=8,
              prefill_chunk=16, prefix_cache=True)
    eng = Engine(params, cfg, **kw)
    eng.run([Request(a, SamplingParams(max_new_tokens=2))])
    eng.run([Request(b, SamplingParams(max_new_tokens=2))])
    assert (eng.stats["prefix_hits"], eng.stats["prefix_tokens_reused"]) \
        == (1, 24)
    fresh = Engine(params, cfg, **kw)
    fresh.run([Request(b, SamplingParams(max_new_tokens=2))])
    for i in range(3):
        key = tuple(system[:8 * (i + 1)])
        blk, blk_f = eng._bh_key2blk[0][key], fresh._bh_key2blk[0][key]
        for c, cf in zip(eng.caches, fresh.caches):
            for k in c:
                assert torch.equal(c[k][blk], cf[k][blk_f]), (i, k)


# ---------------------------------------------------------------------------
# calibration on the card against the same code on the CPU (no kernel: the
# card runs PyTorch's own ops, full f32 products, no TF32).  GPTQ to the
# CPU parity rule of tests/test_torch_calib.py: under 2 % of the dequantized
# entries differ at rtol 1e-4, atol 1e-5; scale and zero bit-equal without
# the MSE grid; the loss within 1e-3 relative (5e-3 where a code flipped).
# The MSE grid: at most 1 % of the scales differ.  os+ migration: the same
# candidate (the chosen scale within rtol 1e-5).


def _calib_problem(dev, K, N, tokens=1024, seed=0):
    from qqq_tpu_torch.calib.gptq import hessian_init, hessian_update

    g = torch.Generator(device=dev).manual_seed(seed)
    W = torch.randn((K, N), generator=g, device=dev) * 0.02
    X = torch.randn((tokens, K), generator=g, device=dev)
    X = X @ (torch.eye(K, device=dev)
             + 0.1 * torch.randn((K, K), generator=g, device=dev))
    H, n = hessian_init(K, dev)
    for xb in X.split(256):
        H, n = hessian_update(H, n, xb)
    return W, H


@pytest.mark.parametrize("group_size,actorder,mse", [
    (-1, True, False), (128, True, False), (128, False, True),
    (-1, False, True)])
def test_gptq_on_the_card_matches_the_cpu(dev, group_size, actorder, mse):
    from qqq_tpu_torch.calib.gptq import gptq_quantize_matrix
    from qqq_tpu_torch.core.quant import QuantSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    W, H = _calib_problem(dev, 512, 384)
    spec = QuantSpec(bits=4, group_size=group_size, mse=mse)
    kw = dict(actorder=actorder, scale_store_dtype=torch.bfloat16)
    card = gptq_quantize_matrix(W, H, spec, **kw)
    cpu = gptq_quantize_matrix(W.cpu(), H.cpu(), spec, **kw)
    differ = ~torch.isclose(card.w_deq.cpu(), cpu.w_deq, rtol=1e-4,
                            atol=1e-5)
    assert differ.float().mean() < 0.02
    if mse:
        assert (card.scale.cpu() != cpu.scale).float().mean() <= 0.01
    else:
        assert torch.equal(card.scale.cpu(), cpu.scale)
    assert torch.equal(card.zero.cpu(), cpu.zero)
    flips = bool((card.q4.cpu() != cpu.q4).any())
    assert abs(float(card.loss) / float(cpu.loss) - 1) < (
        5e-3 if flips else 1e-3)


@pytest.mark.parametrize("group_size", [-1, 128])
def test_mse_grid_on_the_card_matches_the_cpu(dev, group_size):
    from qqq_tpu_torch.core.quant import QuantSpec, find_params_weight

    g = torch.Generator(device=dev).manual_seed(1)
    w = torch.randn((1024, 640), generator=g, device=dev) * 0.02
    spec = QuantSpec(bits=4, group_size=group_size, mse=True)
    s, z = find_params_weight(w, spec)
    s_cpu, z_cpu = find_params_weight(w.cpu(), spec)
    assert (s.cpu() != s_cpu).float().mean() <= 0.01
    assert torch.equal(z.cpu(), z_cpu)


def test_os_plus_migrate_on_the_card_matches_the_cpu(dev):
    from qqq_tpu_torch.calib.smooth import migrate
    from qqq_tpu_torch.models.config import ModelConfig
    from qqq_tpu_torch.models.llama import rope_inv_freq

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(vocab_size=256, hidden_size=256,
                      intermediate_size=512, num_hidden_layers=1,
                      num_attention_heads=4, num_key_value_heads=2)
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((1, 64, 256), generator=g, device=dev)
    x[..., 11] *= 15.0  # an outlier channel
    w = torch.randn((256, 256 + 2 * 128), generator=g, device=dev) * 0.05
    pos = torch.arange(64, dtype=torch.int32, device=dev)[None]

    def extra(d):
        return {"config": cfg, "positions": pos.to(d),
                "inv_freq": rope_inv_freq(cfg, d)}

    s = migrate("qkv", x, w, extra(dev), method="os+", n_grid=24)
    s_cpu = migrate("qkv", x.cpu(), w.cpu(), extra("cpu"), method="os+",
                    n_grid=24)
    torch.testing.assert_close(s.cpu(), s_cpu, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# flash attention's qk_int8 route (s8 tensor cores for QKᵀ) and the seeded
# sampling noise


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
def test_quantize_q_kernel_bit_exact(dev, dtype, hd):
    """The route's q quantization kernel: codes and row scales equal the
    plain version's on the card and on the CPU bit for bit, an all-zero row
    (scale flushed to 0) and rows not a multiple of the kernel's 8 among
    them."""
    from qqq_tpu_torch.kernels.attention import (
        quantize_q_int8, quantize_q_int8_plain,
    )

    q = (torch.randn((2, 4, 37, hd), generator=_gen(dev), device=dev)
         * 3).to(dtype)
    q[0, 1, 3] = 0
    codes, qs = quantize_q_int8(q)
    for ref_c, ref_s in (quantize_q_int8_plain(q),
                         quantize_q_int8_plain(q.cpu())):
        assert torch.equal(codes.cpu(), ref_c.cpu())
        assert torch.equal(qs.cpu().view(torch.int32),
                           ref_s.cpu().view(torch.int32))
    assert float(qs[0, 1, 3]) == 0.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nh,nkv,hd,T,clen", [(4, 2, 64, 16, (0, 20)),
                                              (2, 2, 128, 100, (0, 37)),
                                              (8, 2, 128, 100, (0, 37)),
                                              (4, 2, 96, 100, (0, 37)),
                                              (4, 2, 256, 100, (0, 37))])
def test_flash_qk_int8_kernel(dev, dtype, nh, nkv, hd, T, clen):
    """The s8·s8→s32 QKᵀ route of slot flash at test_flash_attention_
    kernel's shapes: one counted call (two kernels), counted on the route
    too; each output row within two ulps of its own largest value of the
    plain version (the scores are exact on both sides)."""
    from qqq_tpu_torch.kernels.attention import (
        flash_attention_int8, flash_attention_int8_plain,
    )

    B, S = 2, 256
    q = torch.randn((B, nh, T, hd), generator=_gen(dev), device=dev).to(dtype)
    cl = torch.tensor(clen, dtype=torch.int32, device=dev)
    args = (q, *_cache(dev, B, nkv, S, hd), cl)
    n0 = flash_attention_int8.qk_int8_launches
    out = _launch_once(flash_attention_int8, *args, qk_int8=True)
    assert flash_attention_int8.qk_int8_launches == n0 + 1
    ref = flash_attention_int8_plain(*args, True, True)
    assert _per_row_ulps(out, ref, dtype) <= 1
    assert torch.equal(flash_attention_int8(*args, qk_int8=True), out)
    _launch_once(flash_attention_int8, *args)
    assert flash_attention_int8.qk_int8_launches == n0 + 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bs,hd", [(8, 64), (16, 96), (128, 128),
                                   (128, 256)])
def test_paged_flash_qk_int8_kernel(dev, dtype, bs, hd):
    """The qk_int8 route over the pool (a chunk over three blocks or more
    after cached keys, a row on an all-null table): within two ulps of the
    plain version per row, and bit-equal to the slot route on the pool
    gathered through the tables."""
    from qqq_tpu_torch.kernels.attention import (
        flash_attention_int8, paged_flash_attention_int8,
        paged_flash_attention_int8_plain,
    )
    from qqq_tpu_torch.serve.paged_kv import gather

    B, nh, nkv, nbmax = 3, 8, 2, 6
    T = 2 * bs + 5
    q = torch.randn((B, nh, T, hd), generator=_gen(dev), device=dev).to(dtype)
    pool = _cache(dev, 1 + B * nbmax, nkv, bs, hd)
    tables = _tables(dev, B, nbmax, null_row=2)
    cl = torch.tensor([bs // 2, 3 * bs - 7, 0], dtype=torch.int32,
                      device=dev)
    n0 = paged_flash_attention_int8.qk_int8_launches
    out = _launch_once(paged_flash_attention_int8, q, *pool, tables, cl,
                       qk_int8=True)
    assert paged_flash_attention_int8.qk_int8_launches == n0 + 1
    ref = paged_flash_attention_int8_plain(q, *pool, tables, cl, True, True)
    assert _per_row_ulps(out, ref, dtype) <= 1
    slot = flash_attention_int8(q, *(gather(t, tables) for t in pool), cl,
                                qk_int8=True)
    assert torch.equal(out, slot)


@pytest.mark.parametrize("V", [32000, 128256])
def test_seeded_noise_card_equals_cpu(dev, V):
    """JAX's seeded noise (threefry2x32, fold_in, the partitionable bits)
    in torch ops: the card's bits and uniforms equal the CPU's bit for bit;
    the Gumbel noise within 2 ulps of max(|g|, 1) (each log may round the
    other way)."""
    from qqq_tpu_torch.serve import sampling as S

    seeds = torch.tensor([0, 1, 1234, 0x7FFFFFFF, 987654321],
                         dtype=torch.int32)
    ngen = torch.tensor([0, 5, 1, 77, 100000], dtype=torch.int32)
    on = (seeds.to(dev), ngen.to(dev))
    assert torch.equal(S.seeded_bits(*on, V).cpu(),
                       S.seeded_bits(seeds, ngen, V))
    assert torch.equal(S.seeded_uniform(*on, V).cpu().view(torch.int32),
                       S.seeded_uniform(seeds, ngen, V).view(torch.int32))
    g, ref = S.seeded_gumbel(*on, V).cpu(), S.seeded_gumbel(seeds, ngen, V)
    scale = torch.clamp_min(ref.abs(), 1.0)
    ulp = torch.nextafter(scale, torch.full_like(scale, 2.0 ** 60)) - scale
    assert ((g - ref).abs() <= 2 * ulp).all()


@pytest.mark.parametrize("H", [64, 896, 4096, 5120])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_rows_do_not_depend_on_their_neighbours(dev, H, dtype):
    """The card's RMSNorm (models/llama.py:_mean_square, two stages of
    fixed layout) gives a row the same bits among the first n of 40 rows,
    n = 1 .. 40, as alone, as a data shard of the engine needs; within
    2^-20 relative of the one-pass f32 mean (another summation order)."""
    from qqq_tpu_torch.models import llama as M

    x = (torch.randn((40, 1, H), generator=_gen(dev), device=dev) * 3
         ).to(dtype)
    w = (torch.rand((H,), generator=_gen(dev), device=dev) + 0.5).to(dtype)
    alone = torch.cat([M.rms_norm(x[i:i + 1], w, 1e-5) for i in range(40)])
    for n in range(1, 41):
        assert torch.equal(M.rms_norm(x[:n], w, 1e-5), alone[:n]), n
    x32 = x.float()
    ms = M._mean_square(x32)
    one_pass = torch.mean(x32 * x32, dim=-1, keepdim=True)
    assert torch.allclose(ms, one_pass, rtol=2.0 ** -20, atol=0)


# -- the device timer (utils/benchmark.py: measure_op) ------------------------


def _gemm_group_args(dev, M=64, K=4096, N=4096):
    g = _gen(dev)
    a = torch.randint(-128, 128, (M, K), generator=g, device=dev,
                      dtype=torch.int8)
    s_tok = torch.rand((M, 1), generator=g, device=dev) * 0.05 + 1e-3
    w = torch.randint(-2**31, 2**31 - 1, (K // 8, N), generator=g,
                      device=dev, dtype=torch.int32)
    s = (torch.rand((K // 128, N), generator=g, device=dev) * 0.01
         + 1e-4).to(torch.bfloat16)
    return a, s_tok, w, s


def test_measure_op_times_a_captured_op(dev, monkeypatch):
    """A kernel wrapper timed by ``measure_op``: finite, positive seconds,
    and its launches grow by what the captures called (two eager calls
    and ``n`` captured ones a run), not by the replays."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k
    from qqq_tpu_torch.utils import benchmark

    counts = []
    scan = benchmark._run_scan

    def spy(op, perturb, args, n):
        counts.append(n)
        return scan(op, perturb, args, n)

    monkeypatch.setattr(benchmark, "_run_scan", spy)
    args = _gemm_group_args(dev)
    n0 = k.w4a8_gemm_group.launches
    secs = benchmark.measure_op(k.w4a8_gemm_group, args, target_secs=0.05)
    assert np.isfinite(secs) and 0 < secs < 1e-2
    assert counts[:2] == [8, 64] and len(counts) == 4
    assert k.w4a8_gemm_group.launches - n0 == sum(n + 2 for n in counts)


@pytest.mark.parametrize("block_host_s", [0.0, 1e-3, 0.25])
@pytest.mark.parametrize("n", [37, 1000])
def test_measure_op_blocks_run_n_iterations(dev, monkeypatch, block_host_s,
                                            n):
    """Blocks of k iterations and the graph of the rest run exactly n: the
    carry adds 1 an iteration, from 0 at every run."""
    from qqq_tpu_torch.utils import benchmark

    monkeypatch.setattr(benchmark, "BLOCK_HOST_S", block_host_s)
    x = torch.randn((256, 256), device=dev)
    run = benchmark._run_scan(torch.relu, benchmark._perturb_first_float,
                              (x,), n)
    assert float(run((x,))) == n
    assert float(run((x,))) == n


@pytest.mark.parametrize("kind", ["item", "nonzero", "branch",
                                  "only_when_captured"])
def test_measure_op_raises_on_an_op_it_cannot_capture(dev, kind):
    """Syncing ops raise before any capture; one that syncs only inside a
    capture breaks the capture, and measure_op must leave the stream and
    the default generator usable after it."""
    from qqq_tpu_torch.utils import measure_op

    ops = {
        "item": lambda x: x * float(x.max()),
        "nonzero": lambda x: x[torch.nonzero(x > 0, as_tuple=True)],
        "branch": lambda x: x * 2 if bool((x > 0).any()) else x,
        "only_when_captured": lambda x: (
            x * float(x.max()) if torch.cuda.is_current_stream_capturing()
            else x * 2),
    }
    stream = torch.cuda.current_stream(dev)
    x = torch.randn((64, 64), device=dev)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        measure_op(ops[kind], (x,), target_secs=0.01)
    assert torch.cuda.current_stream(dev) == stream
    assert torch.isfinite(torch.randn(8, device=dev)).all()
    assert measure_op(torch.relu, (x,), target_secs=0.01) > 0


def test_measure_op_repeats(dev):
    """Two calls on the same op land within 2x of each other."""
    from qqq_tpu_torch.utils import measure_op

    a = torch.randn((2048, 2048), device=dev, dtype=torch.bfloat16)
    b = torch.randn((2048, 2048), device=dev, dtype=torch.bfloat16)
    first = measure_op(torch.matmul, (a, b))
    second = measure_op(torch.matmul, (a, b))
    assert 0.5 <= second / first <= 2.0, (first, second)


def test_dispatch_spans_contain_their_kernels(tick_model):
    """Slot and paged engines, a few prefills and captured ticks under
    ``torch.profiler``, the trace mapped onto ``time.monotonic()`` (kineto
    stamps on the realtime clock, paired with a monotonic read): each
    kernel goes to the dispatch whose host span holds its launch call
    (matched by correlation id), and lies inside that dispatch's device
    span within 0.1 ms at each end; no span starts on the device more than
    0.05 ms before the host stamp taken before its first launch; spans and
    gaps tile the run (no overlap, no hole)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from qqq_tpu_torch.serve.engine import Engine, Request
    from qqq_tpu_torch.serve.sampling import SamplingParams

    CUDA = torch.autograd.DeviceType.CUDA
    params, cfg = tick_model
    rng = np.random.default_rng(0)
    for mode in sorted(_TICK_MODES):
        eng = Engine(params, cfg, **_TICK_MODES[mode])

        def reqs():
            return [Request([int(t) for t in rng.integers(0, 256, n)],
                            SamplingParams(max_new_tokens=6))
                    for n in (6, 19, 38, 56)]

        eng.run(reqs())  # first calls and the graph's capture
        torch.cuda.synchronize()
        since = eng.dispatch_log[-1]["seq"] + 1
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            off = [time.time_ns() - time.monotonic_ns()]
            eng.run(reqs())
            torch.cuda.synchronize()
            off.append(time.time_ns() - time.monotonic_ns())
        assert abs(off[1] - off[0]) < 20_000, off
        recs = [r for r in eng.dispatch_log if r["seq"] >= since]
        assert {r["kind"] for r in recs} == {"prefill", "decode"}

        def mono(ns):
            return (ns - (off[0] + off[1]) / 2) * 1e-9

        events = prof.profiler.kineto_results.events()
        launched = {e.correlation_id(): mono(e.start_ns()) for e in events
                    if e.device_type() != CUDA and e.name().startswith("cu")}
        kernels = [e for e in events if e.device_type() == CUDA
                   and not e.name().startswith(("Memcpy", "Memset"))]
        assert kernels and launched
        per: dict = {}
        unmatched = []
        for k in kernels:
            t = launched.get(k.correlation_id())
            r = next((r for r in recs if t is not None
                      and r["t_start"] <= t <= r["t_end"]), None)
            if r is None:
                unmatched.append((k.name()[:60], t))
                continue
            per.setdefault(r["seq"], []).append(
                (mono(k.start_ns()), mono(k.end_ns())))
        assert not unmatched, (mode, len(unmatched), len(kernels),
                               unmatched[:5], recs[0]["t_start"],
                               recs[-1]["t_end"])
        for r in recs:
            ks = per.get(r["seq"])
            assert ks, (mode, r)
            first = r["t_start"] if r["kind"] == "prefill" else r["t_packed"]
            assert r["device_start"] >= first - 5e-5, (mode, r)
            assert min(a for a, _ in ks) >= r["device_start"] - 1e-4, \
                (mode, r, min(ks))
            assert max(b for _, b in ks) <= r["device_end"] + 1e-4, \
                (mode, r, max(ks, key=lambda x: x[1]))
        busy = sum(r["device_end"] - r["device_start"] for r in recs)
        gaps = [r["gap_before_s"] for r in recs[1:]]
        assert min(gaps) >= 0
        whole = recs[-1]["device_end"] - recs[0]["device_start"]
        assert abs(busy + sum(gaps) - whole) <= 0.01 * whole, \
            (mode, busy, sum(gaps), whole)


def test_dispatch_recording_cost(dev):
    """Host µs that recording adds to a dispatch, around a device op of
    ~0.3 ms and the sync a dispatch makes anyway, in the engine's order
    (its own ``_log_dispatch``, ``_synced`` and ``DeviceSpans``).  On the
    dispatch's path: its start event and stamps, the stamps after the sync
    (and, once a second, an anchor event); while the device works: the
    read of the previous dispatch's event and the writing and hand-over of
    this one's record (a tick's rows' contexts among it).  Ticks,
    prefills and unrecorded dispatches take turns, in 5 blocks of 200 each
    after 100 that fill the pool; the host's speed varies from block to
    block (other work shares it), so the block medians are printed and the
    least of them is held to 10 µs, on the path and as a dispatch's wall
    over an unrecorded one's."""
    import collections
    import time
    import types

    from qqq_tpu_torch.serve.engine import Engine
    from qqq_tpu_torch.utils.profiling import DeviceSpans

    mono, clock = time.monotonic, time.perf_counter
    slot_len = np.arange(64, dtype=np.int32)
    active = np.ones(64, bool)
    x = torch.zeros(64, device=dev)

    def work(kind):
        torch.cuda._sleep(500_000)  # the forward or the graph launch
        if kind == "prefill":
            x.add_(0)  # the KV copy

    def recorded(eng, kind):
        """One dispatch: (s on its path, s while the device works)."""
        c0 = clock()
        t_start = mono()
        start = eng._device_spans.mark()
        t_packed = mono()
        c1 = clock()
        work(kind)
        c2 = clock()
        if kind == "decode":
            rec = Engine._log_dispatch(
                eng, start, t_packed, kind="decode",
                rows=slot_len[active].tolist(), steps=1, t_start=t_start,
                t_packed=t_packed, t_launched=mono())
        else:
            rec = Engine._log_dispatch(
                eng, start, t_start, kind="prefill", rows=[(0, 100)],
                heads=1, padded=128, t_start=t_start, t_forward=mono())
        c3 = clock()
        x.sum().cpu()  # the sync
        c4 = clock()
        Engine._synced(eng, rec)
        rec["t_end"] = mono()
        c5 = clock()
        return (c1 - c0) + (c5 - c4), c3 - c2

    engs = {k: types.SimpleNamespace(
        _dispatches=0, _device_spans=DeviceSpans(dev),
        _dispatch_log=collections.deque(maxlen=65536))
        for k in ("decode", "prefill")}
    got = {k: {"path": [], "under": [], "wall": []}
           for k in ("decode", "prefill")}
    for block in range(6):
        acc = {k: {"path": [], "under": [], "wall": [], "plain": []}
               for k in got}
        for _ in range(200 if block else 100):
            for kind in ("decode", "prefill"):
                t = clock()
                p, h = recorded(engs[kind], kind)
                acc[kind]["wall"].append(clock() - t)
                acc[kind]["path"].append(p)
                acc[kind]["under"].append(h)
                t = clock()
                work(kind)
                x.sum().cpu()
                acc[kind]["plain"].append(clock() - t)
        if not block:
            continue  # the pool fills
        for kind, a in acc.items():
            med = {k: 1e6 * float(np.median(v)) for k, v in a.items()}
            got[kind]["path"].append(med["path"])
            got[kind]["under"].append(med["under"])
            got[kind]["wall"].append(med["wall"] - med["plain"])
    for kind, eng in engs.items():
        assert len(eng._device_spans._pool) <= 3
        assert all(r["device_start"] is not None
                   for r in list(eng._dispatch_log)[:-1])
        print(f"recording a {kind} on {torch.cuda.get_device_name(dev)}, "
              f"medians of 5 blocks of 200, µs: on its path "
              f"{[round(v, 2) for v in got[kind]['path']]}; while the "
              f"device works {[round(v, 2) for v in got[kind]['under']]}; "
              f"its wall over an unrecorded one's "
              f"{[round(v, 2) for v in got[kind]['wall']]}")
    assert all(min(g["path"]) <= 10.0 and min(g["wall"]) <= 10.0
               for g in got.values()), got
