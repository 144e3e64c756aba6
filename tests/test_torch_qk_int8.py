"""Port (qqq_tpu_torch) against the JAX package: the ``qk_int8=True``
branch of flash attention over the INT8 slot cache and the paged pool.
The JAX Pallas kernels run in interpret mode, the port's plain versions on
the CPU, on the same INT8 caches made from a numpy seed.

Tolerances: q's codes and row scales equal JAX's bit for bit (the
quantization XLA compiles: rs = f32(1/√hd), codes round(q · ((127 / qa) ·
rs)) with an IEEE division, qs = qa · f32(1/127) with a subnormal flushed
to 0), so both sides form the same exact s32 scores and
rescale them by the same two products.  Only the online softmax's steps
differ (JAX's 1024-key tile, or the block size over the pool, against the
CUDA kernel's 32 keys), which moves the bf16 rounding of the probabilities
against the running maximum: 2e-3 absolute, the bound of
tests/test_torch_attention.py::test_flash_attention_matches_jax.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qqq_tpu.kernels.attention import (
    flash_attention_int8 as jax_flash,
    paged_flash_attention_int8 as jax_paged_flash,
)

from qqq_tpu_torch.kernels.attention import (
    flash_attention_int8, flash_attention_int8_plain,
    paged_flash_attention_int8, quantize_q_int8,
)
from qqq_tpu_torch.serve.paged_kv import gather

ATOL = 2e-3


@functools.partial(jax.jit, static_argnames=("nkv",))
def _jax_quantize(q, nkv):
    """The lines of JAX's flash_attention_int8 that quantize q
    (qqq_tpu/kernels/attention.py:317-331), its reshapes included, jitted
    as the wrapper is (XLA then folds the two row factors of the codes
    into one, as it does in the wrapper's own compiled code); returned in
    q's (B, nh, T) row order."""
    B, nh, T, hd = q.shape
    g = nh // nkv
    M = g * T
    qf = (q.reshape(B, nkv, g, T, hd).reshape(B, nkv, M, hd)
          .astype(jnp.float32) / jnp.sqrt(jnp.float32(hd)))
    qa = jnp.max(jnp.abs(qf), axis=-1, keepdims=True)
    qa = jnp.maximum(qa, jnp.finfo(jnp.float32).tiny)
    qg = jnp.clip(jnp.round(qf * (127.0 / qa)), -127, 127).astype(jnp.int8)
    return qg.reshape(B, nh, T, hd), (qa / 127.0).reshape(B, nh, T)


def _cache(rng, B, nkv, S, hd):
    kc = rng.integers(-128, 128, size=(B, nkv, S, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, size=(B, nkv, S, hd)).astype(np.int8)
    ks = (rng.random((B, nkv, S)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((B, nkv, S)) * 0.02 + 1e-3).astype(np.float32)
    return kc, ks, vc, vs


def _both(*arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(np.array(a)) for a in arrs])


@pytest.mark.parametrize("hd", [64, 96, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_q_codes_and_scales_equal_jax(hd, dtype):
    """Codes and row scales bit-equal to JAX's, from f32 and from bf16 q
    (the model's), a row of zeros (qa = tiny) and a row of one value
    among them."""
    rng = np.random.default_rng(hd)
    q = (rng.standard_normal((2, 4, 37, hd)) * 3).astype(np.float32)
    q[0, 1, 3] = 0.0
    q[1, 2, 5] = 0.75
    jq = jnp.asarray(q).astype(dtype)
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    want_c, want_s = (np.asarray(x) for x in _jax_quantize(jq, nkv=2))
    codes, qs = quantize_q_int8(tq)
    assert codes.dtype == torch.int8 and qs.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), want_c)
    np.testing.assert_array_equal(qs.numpy().view(np.uint32),
                                  want_s.view(np.uint32))
    assert (codes[0, 1, 3] == 0).all() and int(codes.abs().max()) == 127


@pytest.mark.parametrize("B,nh,nkv,T,S,clen,hd", [
    # GQA, prefill and a chunk after 20 keys
    pytest.param(2, 4, 2, 16, 64, (0, 20), 64, id="hd64-clen0-20"),
    # g = 1, a chunk after 45 cached keys
    pytest.param(1, 2, 2, 32, 128, (45,), 128, id="hd128-clen45"),
    pytest.param(2, 4, 2, 16, 64, (0, 20), 96, id="hd96"),
    pytest.param(1, 2, 1, 16, 64, (30,), 256, id="hd256"),
    # a 2048-key cache: JAX's two 1024-key tiles, the chunks straddling
    # their boundary
    pytest.param(2, 2, 1, 64, 2048, (1000, 1500), 128, id="across-tiles"),
])
def test_flash_qk_int8_matches_jax(B, nh, nkv, T, S, clen, hd):
    rng = np.random.default_rng(T + S + hd)
    q = rng.standard_normal((B, nh, T, hd)).astype(np.float32)
    j, t = _both(q, *_cache(rng, B, nkv, S, hd), np.array(clen, np.int32))
    ref = np.asarray(jax_flash(*j, causal=True, qk_int8=True))
    out = flash_attention_int8(*t, causal=True, qk_int8=True)
    assert out.shape == (B, nh, T, hd)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    # the route is a different computation from the bf16 one
    assert not torch.equal(flash_attention_int8(*t, causal=True), out)


@pytest.mark.parametrize("B,nh,nkv,bs,nbmax,T,hd", [
    (2, 8, 4, 128, 4, 16, 64),     # chunked prefill, GQA
    (1, 4, 4, 64, 6, 8, 64),       # MHA, small blocks
    (2, 4, 2, 64, 5, 40, 128),     # hd 128, a chunk across blocks
])
def test_paged_flash_qk_int8_matches_jax(B, nh, nkv, bs, nbmax, T, hd):
    """Over scrambled tables, against JAX's paged kernel with qk_int8; the
    port's paged version equals its slot version on the gathered pool bit
    for bit, as the CUDA kernels must."""
    rng = np.random.default_rng(bs + T + hd)
    nb = 1 + B * nbmax
    q = rng.standard_normal((B, nh, T, hd)).astype(np.float32)
    kp, ks, vp, vs = _cache(rng, nb, nkv, bs, hd)
    tables = np.stack([1 + rng.permutation(B * nbmax)[:nbmax]
                       for _ in range(B)]).astype(np.int32)
    clen = rng.integers(T, bs * nbmax - bs - T, size=(B,)).astype(np.int32)
    j, t = _both(q, kp, ks, vp, vs, tables, clen)
    ref = np.asarray(jax_paged_flash(*j, causal=True, qk_int8=True))
    out = paged_flash_attention_int8(*t, causal=True, qk_int8=True)
    assert out.shape == (B, nh, T, hd)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    tq, tkp, tks, tvp, tvs, ttab, tcl = t
    slot = flash_attention_int8_plain(
        tq, gather(tkp, ttab), gather(tks, ttab), gather(tvp, ttab),
        gather(tvs, ttab), tcl, True, True)
    assert torch.equal(out, slot)


def test_qk_int8_switch_and_default():
    """``qk_int8=None`` (the default, which the model, the engine and the
    CLIs pass) is off, as in JAX; only ``qk_int8=True`` takes the route,
    slot and paged."""
    rng = np.random.default_rng(3)
    B, nh, nkv, T, S, hd = 1, 4, 2, 16, 64, 64
    q = rng.standard_normal((B, nh, T, hd)).astype(np.float32)
    _, t = _both(q, *_cache(rng, B, nkv, S, hd), np.array([10], np.int32))
    off = flash_attention_int8(*t)
    assert torch.equal(off, flash_attention_int8(*t, qk_int8=None))
    assert torch.equal(off, flash_attention_int8(*t, qk_int8=False))
    assert not torch.equal(flash_attention_int8(*t, qk_int8=True), off)
    tq, kc, ks, vc, vs, cl = t
    tables = torch.tensor([[0]], dtype=torch.int32)
    pool = [x.reshape(1, *x.shape[1:]) for x in (kc, ks, vc, vs)]
    assert torch.equal(paged_flash_attention_int8(tq, *pool, tables, cl),
                       off)
    assert torch.equal(
        paged_flash_attention_int8(tq, *pool, tables, cl, qk_int8=True),
        flash_attention_int8(*t, qk_int8=True))
