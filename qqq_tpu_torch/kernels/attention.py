"""Attention over the INT8 slot cache (port of qqq_tpu/kernels/attention.py:
decode_attention_int8, decode_attention_auto and flash_attention_int8 with
``qk_int8=False``).

On CUDA tensors the wrappers launch csrc/decode_attention.cu and
csrc/flash_attention.cu; on CPU tensors they run the plain PyTorch versions
below.  The decode version is the JAX kernel's one-pass f32 softmax; the
kernel takes it online over 128-key tiles, which only reassociates f32 sums.
The flash version repeats the CUDA kernel's online softmax over 32-key
tiles, because there the order matters beyond f32: probabilities are
rounded to bf16 against the running row maximum, so the tiling changes
which bf16 values feed P·V (the JAX kernel tiles by 1024 keys).  The tests
state the tolerances that follow.  The S-tiled decode kernel
(_flash_decode_kernel, S > 8192) and the paged kernels arrive in later
slices.
"""

from __future__ import annotations

import torch

from qqq_tpu_torch.kernels import build

_NEG_INF = -1e30
_IO_DTYPES = (torch.bfloat16, torch.float32)

#: decode_attention_int8 is the path up to this many positions at hd = 128
#: (qqq_tpu/kernels/attention.py:_DECODE_WHOLE_S_LIMIT); past it the JAX
#: package switches to _flash_decode_kernel, which is not ported yet
_DECODE_WHOLE_S_LIMIT = 8192
_DECODE_MAX_G = 8


def _sqrt_hd(hd: int) -> torch.Tensor:
    return torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))


def _check_args(q, k_cache, k_scale, v_cache, v_scale, cache_len, nkv, S):
    B, nh, hd = q.shape[0], q.shape[1], q.shape[-1]
    for t, dt, shape, name in (
        (q, q.dtype, tuple(q.shape), "q"),
        (k_cache, torch.int8, (B, nkv, S, hd), "k_cache"),
        (v_cache, torch.int8, (B, nkv, S, hd), "v_cache"),
        (k_scale, torch.float32, (B, nkv, S), "k_scale"),
        (v_scale, torch.float32, (B, nkv, S), "v_scale"),
        (cache_len, torch.int32, (B,), "cache_len"),
    ):
        build.require(t, dt, shape, name, q.device)


# ---------------------------------------------------------------------------
# decode (T = 1)


def decode_attention_int8_plain(q, k_cache, k_scale, v_cache, v_scale,
                                cache_len):
    """The JAX kernel's f32 arithmetic in one pass: scores
    ``(q/√hd)·K_i8ᵀ·k_scale``, mask ``s ≥ cache_len``, softmax,
    ``·v_scale``, ``·V_i8``."""
    B, nh, hd = q.shape
    nkv, S = k_cache.shape[1], k_cache.shape[2]
    g = nh // nkv
    qg = q.reshape(B, nkv, g, hd).to(torch.float32) / _sqrt_hd(hd).to(q.device)
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.to(torch.float32))
    scores = scores * k_scale[:, :, None, :]
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < cache_len.to(torch.int64)[:, None]  # (B, S)
    scores = torch.where(valid[:, None, None, :], scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True) * v_scale[:, :, None, :]
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.to(torch.float32))
    return out.reshape(B, nh, hd).to(q.dtype)


def decode_attention_int8(
    q: torch.Tensor,        # (B, n_heads, hd), RoPE'd current-step queries
    k_cache: torch.Tensor,  # (B, n_kv, S, hd) int8 (current k written)
    k_scale: torch.Tensor,  # (B, n_kv, S) f32
    v_cache: torch.Tensor,
    v_scale: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) int32 ≥ 1: valid tokens incl. current
) -> torch.Tensor:
    """Returns (B, n_heads, hd) attention output in q.dtype."""
    B, nh, hd = q.shape
    nkv, S = k_cache.shape[1], k_cache.shape[2]
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, k_cache, k_scale, v_cache,
                                           v_scale, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8: device {q.device}")
    if q.dtype not in _IO_DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {_IO_DTYPES}")
    if nh % nkv or nh // nkv > _DECODE_MAX_G or hd > 128 or hd % 16:
        raise ValueError(f"decode kernel takes nh/nkv ≤ {_DECODE_MAX_G}, "
                         f"hd ≤ 128 and hd % 16 == 0 (nh={nh}, nkv={nkv}, "
                         f"hd={hd})")
    _check_args(q, k_cache, k_scale, v_cache, v_scale, cache_len, nkv, S)
    out = torch.empty_like(q)
    fn = build.bind("decode_attention", "decode_attention_int8",
                    "pppppppiiiiiip")
    build.check(fn(q.data_ptr(), k_cache.data_ptr(), k_scale.data_ptr(),
                   v_cache.data_ptr(), v_scale.data_ptr(),
                   cache_len.data_ptr(), out.data_ptr(), B, nh, nkv, S, hd,
                   int(q.dtype == torch.bfloat16), build.stream_of(q)),
                "decode_attention_int8")
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0  # kernel launches; only CUDA counts


def decode_attention_auto(q, k_cache, k_scale, v_cache, v_scale, cache_len):
    """Decode attention with the JAX package's kernel selection: the
    whole-cache kernel up to S = 8192 (at hd = 128).  Longer caches take
    the S-tiled kernel there, which this slice does not port yet."""
    S = k_cache.shape[2]
    hd = q.shape[-1]
    if S * (hd + 8) * 2 > _DECODE_WHOLE_S_LIMIT * (128 + 8) * 2:
        raise NotImplementedError(
            f"decode attention at S={S} needs the S-tiled kernel "
            "(_flash_decode_kernel), which a later slice ports"
        )
    return decode_attention_int8(q, k_cache, k_scale, v_cache, v_scale,
                                 cache_len)


# ---------------------------------------------------------------------------
# chunked prefill


#: keys per online-softmax step of csrc/flash_attention.cu (its BK); this
#: must follow the kernel's BK whenever the kernel is retiled
_FLASH_KEY_TILE = 32


def flash_attention_int8_plain(q, k_cache, k_scale, v_cache, v_scale,
                               cache_len, causal: bool = True):
    """The CUDA kernel's arithmetic, tile for tile: bf16 q (scaled in f32),
    bf16 dequantized K/V, f32 scores, an online softmax over 32-key tiles
    whose probabilities are rounded to bf16 against the running maximum
    before P·V, and an f32 denominator of the unrounded ones.  Tiles past
    the last visible key change nothing and are skipped.

    The tile is the kernel's BK (``_FLASH_KEY_TILE``), not JAX's 1024-key
    tile, so that the card check can hold the kernel to two bf16 ulps; a
    retiled kernel changes ``_FLASH_KEY_TILE`` with it.  The link back to
    JAX is tests/test_torch_attention.py, which holds this version to the
    JAX kernel, several of its 1024-key tiles included."""
    B, nh, T, hd = q.shape
    nkv, S = k_cache.shape[1], k_cache.shape[2]
    g = nh // nkv
    M = g * T
    bf, f32 = torch.bfloat16, torch.float32
    qf = (q.reshape(B, nkv, M, hd).to(f32)
          / _sqrt_hd(hd).to(q.device)).to(bf).to(f32)
    kt = (k_cache.to(bf) * k_scale.to(bf)[..., None]).to(f32)
    vt = (v_cache.to(bf) * v_scale.to(bf)[..., None]).to(f32)
    clen = cache_len.to(torch.int64)
    t_row = torch.arange(M, device=q.device) % T
    m = torch.full((B, nkv, M, 1), _NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, nkv, M, 1), dtype=f32, device=q.device)
    acc = torch.zeros((B, nkv, M, hd), dtype=f32, device=q.device)
    for s0 in range(0, min(S, int(clen.max()) + T), _FLASH_KEY_TILE):
        s1 = min(s0 + _FLASH_KEY_TILE, S)
        key = torch.arange(s0, s1, device=q.device)
        sc = qf @ kt[:, :, s0:s1].transpose(-1, -2)  # (B, nkv, M, kb)
        valid = (key[None, :] < (clen + T)[:, None])[:, None, :]  # (B, 1, kb)
        if causal:
            valid = valid & (key[None, None, :]
                             <= (clen[:, None] + t_row[None, :])[:, :, None])
        sc = torch.where(valid[:, None], sc, _NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        e = torch.exp(sc - m_new)
        l = l * alpha + e.sum(dim=-1, keepdim=True)
        acc = acc * alpha + e.to(bf).to(f32) @ vt[:, :, s0:s1]
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(B, nh, T, hd).to(q.dtype)


def flash_attention_int8(
    q: torch.Tensor,        # (B, n_heads, T, hd) RoPE'd queries
    k_cache: torch.Tensor,  # (B, n_kv, S, hd) int8, chunk keys written
    k_scale: torch.Tensor,  # (B, n_kv, S) f32
    v_cache: torch.Tensor,
    v_scale: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) int32: valid keys BEFORE this chunk
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Chunked-prefill attention over the INT8 cache: query t of the chunk
    sits at ``cache_len + t`` and attends keys ``[0, cache_len + t]``
    (causal).  Returns (B, n_heads, T, hd) in q.dtype."""
    B, nh, T, hd = q.shape
    nkv, S = k_cache.shape[1], k_cache.shape[2]
    if q.device.type == "cpu":
        return flash_attention_int8_plain(q, k_cache, k_scale, v_cache,
                                          v_scale, cache_len, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_int8: device {q.device}")
    if q.dtype not in _IO_DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {_IO_DTYPES}")
    if nh % nkv or hd not in (64, 128):
        raise ValueError(f"flash kernel takes hd in (64, 128) and nh % nkv "
                         f"== 0 (nh={nh}, nkv={nkv}, hd={hd})")
    _check_args(q, k_cache, k_scale, v_cache, v_scale, cache_len, nkv, S)
    out = torch.empty_like(q)
    fn = build.bind("flash_attention", "flash_attention_int8",
                    "pppppppiiiiiiiip")
    build.check(fn(q.data_ptr(), k_cache.data_ptr(), k_scale.data_ptr(),
                   v_cache.data_ptr(), v_scale.data_ptr(),
                   cache_len.data_ptr(), out.data_ptr(), B, nh, nkv, T, S,
                   hd, int(causal), int(q.dtype == torch.bfloat16),
                   build.stream_of(q)),
                "flash_attention_int8")
    flash_attention_int8.launches += 1
    return out


flash_attention_int8.launches = 0  # kernel launches; only CUDA counts
