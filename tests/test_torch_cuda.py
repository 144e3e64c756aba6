"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small and odd shapes the Llama-2-7B checks of chip_smoke.py do not reach
(hd = 64, GQA, f32 I/O, ragged M and N, chunks after cached keys).

Needs an NVIDIA GPU with nvcc; skips without one.  Run on the card with
``python -m pytest tests/test_torch_cuda.py --noconftest -q`` (the suite's
conftest imports JAX, which the GPU machine need not have).
Tolerances as in chip_smoke.py: the GEMMs (per channel, exact g128 and
requant) and the KV write bit-exact, the GLU-fused GEMMs within two bf16
ulps of their largest output (another exp in the epilogue); attention
within two ulps of the output dtype at the largest output (bf16: 2^-6,
f32: 2^-22 relative to max |ref|, plus the flash kernel's bf16
probabilities: 2^-7 relative in f32).
"""

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


def _launch_once(fn, *args):
    n0 = fn.launches
    out = fn(*args)
    assert fn.launches == n0 + 1
    return out


@pytest.mark.parametrize("M,K,N", [(1, 128, 32), (3, 384, 96), (70, 256, 200)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w4a8_gemm_kernel_bit_exact(dev, M, K, N, out_dtype):
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    a, s_tok, w, s_ch = _gemm_operands(dev, M, K, N, 0)
    out = _launch_once(k.w4a8_gemm_channel, a, s_tok, w, s_ch, out_dtype)
    assert torch.equal(out, k.w4a8_gemm_channel_plain(a, s_tok, w, s_ch,
                                                      out_dtype))


# K = 1152: nine groups, more than the exact kernel's eight warps take at once
_G128_SHAPES = [(1, 128, 32), (3, 384, 96), (70, 1152, 200), (17, 256, 64)]


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


@pytest.mark.parametrize("M,K,I", [(1, 128, 256), (5, 384, 512),
                                   (70, 1152, 256)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("route", ["channel", "group", "requant"])
def test_w4a8_glu_kernels(dev, route, M, K, I, out_dtype):
    """GLU epilogue g·σ(g)·u: the kernel's expf and PyTorch's sigmoid may
    differ in the last bit.  bf16: two ulps at the largest output; f32:
    2^-20 of it (σ's own error and three roundings)."""
    from qqq_tpu_torch.kernels import w4a8_gemm as k

    a, s_tok, w, s = _gemm_operands(dev, M, K, 2 * I,
                                    0 if route == "channel" else K // 128)
    if route != "channel":
        s = s.to(torch.bfloat16)
    fn = getattr(k, f"w4a8_glu_{route}")
    plain = getattr(k, f"w4a8_glu_{route}_plain")
    out = _launch_once(fn, a, s_tok, w, s, out_dtype)
    ref = plain(a, s_tok, w, s, out_dtype)
    assert out.shape == (M, I) and out.dtype == out_dtype
    tol = (2 * _ULP[torch.bfloat16] if out_dtype == torch.bfloat16
           else 2.0 ** -20) * float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= tol


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nh,nkv,hd", [(4, 2, 64), (8, 1, 128), (2, 2, 32)])
def test_decode_attention_kernel(dev, dtype, nh, nkv, hd):
    from qqq_tpu_torch.kernels.attention import (
        decode_attention_int8, decode_attention_int8_plain,
    )

    B, S = 3, 384
    q = torch.randn((B, nh, hd), generator=_gen(dev), device=dev).to(dtype)
    clen = torch.tensor([1, 200, S], dtype=torch.int32, device=dev)
    args = (q, *_cache(dev, B, nkv, S, hd), clen)
    out = decode_attention_int8(*args)
    ref = decode_attention_int8_plain(*args)
    tol = 2 * _ULP[dtype] * float(ref.float().abs().max())
    if dtype == torch.float32:
        tol += 1e-6  # f32 reassociation over up to S terms
    assert float((out.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize("kernel", ["kv_write", "decode", "flash"])
def test_cpu_cache_len_beside_cuda_tensors_raises(dev, kernel):
    """A host pointer must never reach a kernel."""
    from qqq_tpu_torch.kernels.attention import (
        decode_attention_int8, flash_attention_int8,
    )
    from qqq_tpu_torch.kernels.kv_write import slot_decode_write_int8

    B, nh, nkv, S, hd = 2, 4, 2, 128, 64
    cache = _cache(dev, B, nkv, S, hd)
    clen = torch.tensor([3, 7], dtype=torch.int32)  # on the CPU
    q = torch.randn((B, nh, hd), generator=_gen(dev), device=dev)
    if kernel == "kv_write":
        new = torch.randn((B, 1, nkv, hd), generator=_gen(dev), device=dev)
        fn, args = slot_decode_write_int8, (*cache, new, new, clen)
    elif kernel == "decode":
        fn, args = decode_attention_int8, (q, *cache, clen)
    else:
        fn, args = flash_attention_int8, (q[:, :, None], *cache, clen)
    n0 = fn.launches
    with pytest.raises(ValueError, match="cache_len: on cpu"):
        fn(*args)
    assert fn.launches == n0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nh,nkv,hd,T,clen", [(4, 2, 64, 16, (0, 20)),
                                              (2, 2, 128, 100, (0, 37))])
def test_flash_attention_kernel(dev, dtype, nh, nkv, hd, T, clen):
    from qqq_tpu_torch.kernels.attention import (
        flash_attention_int8, flash_attention_int8_plain,
    )

    B, S = 2, 256
    q = torch.randn((B, nh, T, hd), generator=_gen(dev), device=dev).to(dtype)
    cl = torch.tensor(clen, dtype=torch.int32, device=dev)
    args = (q, *_cache(dev, B, nkv, S, hd), cl)
    out = flash_attention_int8(*args)
    ref = flash_attention_int8_plain(*args)
    # bf16 probabilities: a flipped rounding of one is 2^-8 of its term
    ulps = 2 * _ULP[dtype] if dtype == torch.bfloat16 else 2.0 ** -7
    assert float((out.float() - ref.float()).abs().max()) \
        <= ulps * float(ref.float().abs().max())
