"""Port (qqq_tpu_torch) against the JAX package: attention over the INT8
slot cache.  The JAX Pallas kernels run in interpret mode, the port's plain
versions on the CPU, on the same INT8 cache made from a numpy seed.

Tolerances: the decode path is f32 throughout, and the two sides sum in
other orders (one XLA einsum against the kernel's loop; the port's one-pass
softmax) — 1e-6 absolute on outputs of size ~1 (measured: 1.5e-7).  The flash path rounds q,
the dequantized K/V and the probabilities to bf16 at the same points on both
sides, so only f32 summation order differs, which can flip a bf16 rounding
of a probability (2^-8 relative on one term): 2e-3 absolute (measured:
2.4e-7, no flip at these seeds).  Over a 2048-key cache the two sides also
tile the online softmax differently (JAX 1024 keys, the port the CUDA
kernel's 32), so the probabilities are rounded to bf16 against different
running maxima: same 2e-3 (measured: 4.6e-4 and 8.9e-4 at outputs up to
0.50 and 1.49).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qqq_tpu.kernels.attention import (
    decode_attention_int8 as jax_decode, flash_attention_int8 as jax_flash,
)

from qqq_tpu_torch.kernels.attention import (
    decode_attention_auto, decode_attention_int8, flash_attention_int8,
)


def _cache(rng, B, nkv, S, hd):
    kc = rng.integers(-128, 128, size=(B, nkv, S, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, size=(B, nkv, S, hd)).astype(np.int8)
    ks = (rng.random((B, nkv, S)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((B, nkv, S)) * 0.02 + 1e-3).astype(np.float32)
    return kc, ks, vc, vs


def _both(*arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(np.array(a)) for a in arrs])


@pytest.mark.parametrize("B,nh,nkv,S,hd", [
    (2, 4, 2, 128, 64), (3, 8, 1, 256, 32),
    (2, 16, 1, 200, 64),   # g = 16; S not a multiple of the 128-key chunk
    (2, 4, 2, 160, 96),    # hd = 96
    (2, 2, 1, 256, 256),   # hd = 256
])
def test_decode_attention_matches_jax(B, nh, nkv, S, hd):
    """Any g and any hd ≤ 256 (hd % 16 == 0), as JAX's kernel takes them;
    a row of only the current token beside a full-cache row."""
    rng = np.random.default_rng(S + nh)
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    clen = rng.integers(1, S + 1, size=B).astype(np.int32)
    clen[0] = 1  # only the current token
    clen[-1] = S  # the whole cache
    j, t = _both(q, *_cache(rng, B, nkv, S, hd), clen)
    ref = np.asarray(jax_decode(*j))
    out = decode_attention_int8(*t)
    assert out.shape == (B, nh, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    assert torch.equal(decode_attention_auto(*t), out)


def test_decode_attention_auto_waits_for_s_tiled_kernel(monkeypatch):
    """Past the whole-cache switch (S = 16384 at hd = 128) the port
    dispatches to the S-tiled decode, as JAX does, instead of raising; the
    S-tiled plain version runs once and gives the output.  (The name is
    the one this test had while the S-tiled kernel was still to come.)"""
    from qqq_tpu_torch.kernels import attention as ta

    B, nh, nkv, S, hd = 1, 2, 1, 16384, 128
    rng = np.random.default_rng(16384)
    q = torch.from_numpy(rng.standard_normal((B, nh, hd)).astype(np.float32))
    cache = [torch.from_numpy(a) for a in _cache(rng, B, nkv, S, hd)]
    clen = torch.tensor([S - 5], dtype=torch.int32)
    plain, calls = ta.flash_decode_attention_int8_plain, []

    def spy(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(ta, "flash_decode_attention_int8_plain", spy)
    out = decode_attention_auto(q, *cache, clen)
    assert len(calls) == 1
    assert torch.equal(out, plain(q, *cache, clen))


@pytest.mark.parametrize("B,nh,nkv,T,S,clen,hd", [
    # GQA, prefill and a chunk after 20 keys
    pytest.param(2, 4, 2, 16, 64, (0, 20), 64, id="2-4-2-16-64-clen0"),
    # g = 1, chunk in the middle of the cache
    pytest.param(1, 2, 2, 32, 128, (45,), 64, id="1-2-2-32-128-clen1"),
    # the other head dims the CUDA kernel is instantiated at
    pytest.param(2, 4, 2, 16, 64, (0, 20), 96, id="hd96"),
    pytest.param(1, 2, 1, 16, 64, (30,), 256, id="hd256"),
])
def test_flash_attention_matches_jax(B, nh, nkv, T, S, clen, hd):
    rng = np.random.default_rng(T + S)
    q = rng.standard_normal((B, nh, T, hd)).astype(np.float32)
    j, t = _both(q, *_cache(rng, B, nkv, S, hd), np.array(clen, np.int32))
    ref = np.asarray(jax_flash(*j, causal=True))
    out = flash_attention_int8(*t, causal=True)
    assert out.shape == (B, nh, T, hd)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-3)


@pytest.mark.parametrize("clen", [(1000, 1500), (0, 1980)])
def test_flash_attention_matches_jax_across_key_tiles(clen):
    """The main path's hd = 128 over a 2048-key cache: JAX walks it in two
    1024-key tiles, the port in 64 tiles of 32, and the chunks' keys straddle
    JAX's tile boundary."""
    B, nh, nkv, T, S, hd = 2, 2, 1, 64, 2048, 128
    rng = np.random.default_rng(sum(clen))
    q = rng.standard_normal((B, nh, T, hd)).astype(np.float32)
    j, t = _both(q, *_cache(rng, B, nkv, S, hd), np.array(clen, np.int32))
    ref = np.asarray(jax_flash(*j, causal=True))
    out = flash_attention_int8(*t, causal=True)
    assert out.shape == (B, nh, T, hd)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-3)
