"""Attention over the INT8 slot cache and the paged INT8 block pool (port
of qqq_tpu/kernels/attention.py: decode_attention_int8,
flash_decode_attention_int8, decode_attention_auto, flash_attention_int8,
paged_flash_attention_int8 and paged_decode_attention_int8, with
``qk_int8=False``).

On CUDA tensors the wrappers launch csrc/split_decode_attention.cu and
csrc/flash_attention.cu; on CPU tensors they run the plain PyTorch versions
below.  The whole-cache slot decode version is the JAX kernel's one-pass
f32 softmax; the split kernel takes it as one tile of S keys cut into
128-key segments across blocks, which only reassociates f32 sums.  The
flash version repeats the
CUDA kernels' online softmax over 32-key steps, because there the order
matters beyond f32: probabilities are rounded to bf16 against the running
row maximum, so the step changes which bf16 values feed P·V (the JAX
kernel tiles by 1024 keys, or by the block size over the pool).  The flash
kernel steps its softmax 32 keys at a time whatever its load stage (64
keys for its tensor cores).  Over the pool it is the same kernel with each
key row looked up through the tables, and the paged flash version gathers
the pool through the tables and is then the flash version.  The S-tiled
decode (caches past the whole-cache switch) and paged decode share
numerics of their own (bf16 q, bf16 probabilities times v_scale, rounded
against the running maximum after each of JAX's key tiles) and one
kernel, which splits each row's keys across blocks in 128-key chunks;
their plain version follows the split's order, which keeps JAX's rounding
points.  The tests state the tolerances that follow.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from qqq_tpu_torch.kernels import build

_NEG_INF = -1e30
_IO_DTYPES = (torch.bfloat16, torch.float32)

#: decode_attention_int8 is the path up to this many positions at hd = 128
#: (qqq_tpu/kernels/attention.py:_DECODE_WHOLE_S_LIMIT); past it the S-tiled
#: flash_decode_attention_int8 takes over
_DECODE_WHOLE_S_LIMIT = 8192


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
    """Whole-cache decode (any g = nh/nkv, hd ≤ 256 with hd % 16 == 0).
    Returns (B, n_heads, hd) in q.dtype.  The split decode kernel with the
    JAX kernel's f32 numerics over one tile of S keys: three launches over
    a workspace allocated here (:func:`_split_decode`); ``.launches``
    counts calls, one per call."""
    B, nh, hd = q.shape
    nkv, S = k_cache.shape[1], k_cache.shape[2]
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, k_cache, k_scale, v_cache,
                                           v_scale, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_int8: device {q.device}")
    _check_split_args(q, nkv, "whole-cache")
    _check_args(q, k_cache, k_scale, v_cache, v_scale, cache_len, nkv, S)
    out = _split_decode(
        "decode_attention_int8", "ppppppppiiiiiip", q, S, S,
        (q, k_cache, k_scale, v_cache, v_scale, cache_len),
        (B, nh, nkv, S, hd))
    decode_attention_int8.launches += 1
    return out


decode_attention_int8.launches = 0  # wrapper calls on CUDA tensors


#: keys a block of the split decode kernel takes
#: (csrc/split_decode_attention.cu:kChunk); the plain version cuts each JAX
#: tile into segments of this many keys as the kernel does, so it must
#: follow the kernel whenever the chunk changes
_DECODE_KEY_CHUNK = 128


def _tiled_decode_plain(q, kc, ks, vc, vs, cache_len, tile: int):
    """The JAX S-tiled and paged decode kernels' arithmetic over a
    contiguous (B, nkv, S, hd) cache, in the split kernel's order: q scaled
    in f32 and rounded to bf16; each tile of ``tile`` keys cut into
    segments of at most ``_DECODE_KEY_CHUNK`` keys (a segment never
    straddles a tile); f32 scores ``(q·K_i8)·k_scale`` masked at ``s ≥
    cache_len`` and their maximum per segment; the tile's running maximum
    m_t as the running max of those (a max is exact, so m_t is JAX's);
    per segment the partial sum of the unrounded ``e = exp(s - m_t)`` and
    the partial P·V of ``bf16(e·v_scale)``; then JAX's chain over the
    tiles, ``acc = acc·alpha_t + acc_t`` with ``alpha_t = exp(m_{t-1} -
    m_t)``, as the kernel's combine takes it: each tile's summed partials
    times ``exp(m_t - M)``, M the row's last running maximum (the product
    of the later alphas as one exponential, an f32 reassociation); ``acc /
    max(l, 1e-30)``.  Tiles past the last live key are skipped, and a tile
    or segment past one row's last key changes nothing for that row (its
    ``e`` is 0 and its maximum the one before)."""
    B, nh, hd = q.shape
    nkv, S = kc.shape[1], kc.shape[2]
    g = nh // nkv
    f32 = torch.float32
    qg = (q.reshape(B, nkv, g, hd).to(f32)
          / _sqrt_hd(hd).to(q.device)).to(torch.bfloat16).to(f32)
    clen = cache_len.to(torch.int64)
    live = min(S, int(clen.max()))
    seg = min(tile, _DECODE_KEY_CHUNK)
    m = torch.full((B, nkv, g, 1), _NEG_INF, dtype=f32, device=q.device)
    m_t, l_t, acc_t = [], [], []  # per tile
    for t0 in range(0, live, tile):
        t1 = min(t0 + tile, live)
        ns = -(-(t1 - t0) // seg)
        pad = ns * seg - (t1 - t0)
        key = torch.arange(t0, t1, device=q.device)
        valid = (key[None, :] < clen[:, None])[:, None, None, :]
        sc = (qg @ kc[:, :, t0:t1].to(f32).transpose(-1, -2)) \
            * ks[:, :, None, t0:t1]
        sc = torch.where(valid, sc, _NEG_INF)
        seg_max = F.pad(sc, (0, pad), value=_NEG_INF) \
            .reshape(B, nkv, g, ns, seg).amax(dim=-1)
        m_new = torch.maximum(m, seg_max.amax(dim=-1, keepdim=True))
        e = torch.where(valid, torch.exp(sc - m_new), 0.0)
        ev = (e * vs[:, :, None, t0:t1]).to(torch.bfloat16).to(f32)
        l_seg = F.pad(e, (0, pad)).reshape(B, nkv, g, ns, seg).sum(dim=-1)
        v_seg = F.pad(vc[:, :, t0:t1].to(f32), (0, 0, 0, pad)) \
            .reshape(B, nkv, ns, seg, hd)
        pv_seg = torch.einsum(
            "bhgcs,bhcsd->bhgcd",
            F.pad(ev, (0, pad)).reshape(B, nkv, g, ns, seg), v_seg)
        m_t.append(m_new)
        l_t.append(l_seg.sum(dim=-1, keepdim=True))
        acc_t.append(pv_seg.sum(dim=-2))
        m = m_new
    if not m_t:
        return torch.zeros_like(q)
    f = torch.exp(torch.stack(m_t) - m)  # each tile's later alphas
    l = (torch.stack(l_t) * f).sum(dim=0)
    acc = (torch.stack(acc_t) * f).sum(dim=0)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(B, nh, hd).to(q.dtype)


def _pick_decode_tiles(nkv: int, S: int, hd: int, g: int):
    """(hblk, sblk) of the JAX S-tiled decode kernel (copied from
    qqq_tpu/kernels/attention.py:_pick_decode_tiles: the biggest head ×
    sequence tile whose K+V fits a ~4.5 MB TPU buffer, sblk | S, ties
    preferring sblk ≈ 2048).  It is a TPU rule, but sblk sets where the
    bf16 roundings meet the running maximum, so the port walks the same
    tiles; hblk has no counterpart here."""
    del g
    budget = 9 * 1024 * 1024 // 2

    def key(hblk, sblk):
        return (hblk * sblk, -abs(sblk - 2048))

    best = (1, min(S, 1024))
    for hblk in range(nkv, 0, -1):
        if nkv % hblk:
            continue
        sblk = min(S, budget // (hblk * 2 * (hd + 4)))
        sblk = (sblk // 512) * 512
        while sblk >= 512 and S % sblk:
            sblk -= 512
        if sblk >= 512 and key(hblk, sblk) > key(*best):
            best = (hblk, sblk)
    return best


def flash_decode_tile(nkv: int, S: int, hd: int, g: int,
                      sblk: Optional[int] = None) -> int:
    """Keys per online-softmax step of the S-tiled decode: ``sblk`` or
    JAX's pick, walked down as JAX walks it (through multiples of 128 to a
    divisor of S, else S itself)."""
    if sblk is None:
        sblk = _pick_decode_tiles(nkv, S, hd, g)[1]
    while S % sblk and sblk > 128:
        sblk -= 128
    if S % sblk:
        sblk = S
    return sblk


def flash_decode_attention_int8_plain(q, k_cache, k_scale, v_cache, v_scale,
                                      cache_len, *, sblk=None):
    """The JAX S-tiled decode kernel's arithmetic over its own key tile
    (:func:`flash_decode_tile`), which the CUDA kernel walks too."""
    B, nh, hd = q.shape
    nkv, S = k_cache.shape[1], k_cache.shape[2]
    tile = flash_decode_tile(nkv, S, hd, nh // nkv, sblk)
    return _tiled_decode_plain(q, k_cache, k_scale, v_cache, v_scale,
                               cache_len, tile)


def flash_decode_attention_int8(
    q: torch.Tensor,        # (B, n_heads, hd), RoPE'd current-step queries
    k_cache: torch.Tensor,  # (B, n_kv, S, hd) int8 (current k written)
    k_scale: torch.Tensor,  # (B, n_kv, S) f32
    v_cache: torch.Tensor,
    v_scale: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) int32 ≥ 1: valid tokens incl. current
    *,
    sblk: Optional[int] = None,
) -> torch.Tensor:
    """S-tiled decode for caches past the whole-cache kernel's switch (any
    S, any g = nh/nkv).  Returns (B, n_heads, hd) in q.dtype.  The kernel
    splits each row's keys across blocks in three launches over a workspace
    allocated here (:func:`_split_decode`); ``.launches`` counts calls, one
    per call."""
    B, nh, hd = q.shape
    nkv, S = k_cache.shape[1], k_cache.shape[2]
    if q.device.type == "cpu":
        return flash_decode_attention_int8_plain(
            q, k_cache, k_scale, v_cache, v_scale, cache_len, sblk=sblk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attention_int8: device {q.device}")
    _check_split_args(q, nkv, "S-tiled")
    tile = flash_decode_tile(nkv, S, hd, nh // nkv, sblk)
    _check_args(q, k_cache, k_scale, v_cache, v_scale, cache_len, nkv, S)
    out = _split_decode(
        "flash_decode_attention_int8", "ppppppppiiiiiiip", q, S, tile,
        (q, k_cache, k_scale, v_cache, v_scale, cache_len),
        (B, nh, nkv, S, hd, tile))
    flash_decode_attention_int8.launches += 1
    return out


flash_decode_attention_int8.launches = 0  # wrapper calls on CUDA tensors


def _check_split_args(q, nkv: int, which: str) -> None:
    nh, hd = q.shape[1], q.shape[-1]
    if q.dtype not in _IO_DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {_IO_DTYPES}")
    if nh % nkv or hd > 256 or hd % 16:
        raise ValueError(f"{which} decode kernel takes nh % nkv == 0, hd ≤ "
                         f"256 and hd % 16 == 0 (nh={nh}, nkv={nkv}, "
                         f"hd={hd})")


@functools.lru_cache(maxsize=None)
def decode_workspace_bytes(B: int, nh: int, nkv: int, smax: int, hd: int,
                           tile: int) -> int:
    """Bytes of the f32 workspace of the split decode kernel
    (csrc/split_decode_attention.cu, the one place its layout lives) for
    rows of ``smax`` keys walked in JAX tiles of ``tile``; negative: minus
    a CUDA error for arguments it refuses.  Kept per shape: the decode
    asks in every layer of every tick."""
    fn = build.bind("split_decode_attention", "decode_workspace_bytes",
                    "iiiiii", ret="q")
    return int(fn(B, nh, nkv, smax, hd, tile))


def _split_decode(entry: str, sig: str, q, smax: int, tile: int, tensors,
                  ints):
    """Allocates the output and the workspace and calls ``entry`` of the
    split decode kernel: ``tensors`` (inputs, then the output and the
    workspace are appended), then ``ints``, the dtype flag and the
    stream.  The kernel makes three launches on the current stream."""
    B, nh, hd = q.shape
    nkv = ints[2]
    what = (f"{entry} at nh={nh}, nkv={nkv}, hd={hd}, {smax} keys a row, "
            f"tiles of {tile}")
    ws_bytes = decode_workspace_bytes(B, nh, nkv, smax, hd, tile)
    if ws_bytes < 0:
        raise RuntimeError(f"{what}: CUDA error {-ws_bytes} sizing the "
                           "workspace")
    ws = torch.empty(ws_bytes // 4, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    fn = build.bind("split_decode_attention", entry, sig)
    build.check(fn(*(t.data_ptr() for t in (*tensors, out, ws)), *ints,
                   int(q.dtype == torch.bfloat16), build.stream_of(q)),
                what)
    return out


def decode_attention_auto(q, k_cache, k_scale, v_cache, v_scale, cache_len):
    """Decode attention with the JAX package's kernel selection: the
    whole-cache kernel up to S = 8192 (at hd = 128), the S-tiled kernel
    beyond."""
    S = k_cache.shape[2]
    hd = q.shape[-1]
    if S * (hd + 8) * 2 <= _DECODE_WHOLE_S_LIMIT * (128 + 8) * 2:
        return decode_attention_int8(q, k_cache, k_scale, v_cache, v_scale,
                                     cache_len)
    return flash_decode_attention_int8(q, k_cache, k_scale, v_cache, v_scale,
                                       cache_len)


# ---------------------------------------------------------------------------
# chunked prefill


#: the head dims csrc/flash_attention.cu is instantiated at
_FLASH_HDS = (64, 96, 128, 256)


def _check_flash_args(nh: int, nkv: int, hd: int) -> None:
    if nh % nkv or hd not in _FLASH_HDS:
        raise ValueError(f"flash kernel takes hd in {_FLASH_HDS} and nh % "
                         f"nkv == 0 (nh={nh}, nkv={nkv}, hd={hd})")


#: keys per online-softmax step of both kernels of csrc/flash_attention.cu
#: (BK of the slot kernel, whatever its 64-key load stage; PK of the paged
#: one); it must follow them whenever they change the step
_FLASH_KEY_TILE = 32


def flash_attention_int8_plain(q, k_cache, k_scale, v_cache, v_scale,
                               cache_len, causal: bool = True):
    """The CUDA kernel's arithmetic, tile for tile: bf16 q (scaled in f32),
    bf16 dequantized K/V, f32 scores, an online softmax over 32-key tiles
    whose probabilities are rounded to bf16 against the running maximum
    before P·V, and an f32 denominator of the unrounded ones.  Tiles past
    the last visible key change nothing and are skipped.

    The step is the kernels' (``_FLASH_KEY_TILE``), not JAX's 1024-key
    tile, so that the card check can hold the kernels to two bf16 ulps; a
    kernel that changes its step changes ``_FLASH_KEY_TILE`` with it.  The
    link back to JAX is tests/test_torch_attention.py, which holds this
    version to the JAX kernel, several of its 1024-key tiles included."""
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
    _check_flash_args(nh, nkv, hd)
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


# ---------------------------------------------------------------------------
# over the paged pool (serve/paged_kv.py)


def _check_paged(q, k_pool, k_scale, v_pool, v_scale, tables, cache_len):
    nb, nkv, bs, hd = k_pool.shape
    B = q.shape[0]
    for t, dt, shape, name in (
        (q, q.dtype, tuple(q.shape), "q"),
        (k_pool, torch.int8, (nb, nkv, bs, hd), "k_pool"),
        (v_pool, torch.int8, (nb, nkv, bs, hd), "v_pool"),
        (k_scale, torch.float32, (nb, nkv, bs), "k_scale"),
        (v_scale, torch.float32, (nb, nkv, bs), "v_scale"),
        (tables, torch.int32, (B, tables.shape[1]), "tables"),
        (cache_len, torch.int32, (B,), "cache_len"),
    ):
        build.require(t, dt, shape, name, q.device)


def paged_flash_attention_int8_plain(q, k_pool, k_scale, v_pool, v_scale,
                                     tables, cache_len, causal: bool = True):
    """The pool gathered through the tables into the slot cache's
    contiguous (B, nkv, nbmax·bs, hd) layout (codes and scales, not
    dequantized), then :func:`flash_attention_int8_plain`: the kernel's
    arithmetic tile for tile."""
    from qqq_tpu_torch.serve.paged_kv import gather

    return flash_attention_int8_plain(
        q, gather(k_pool, tables), gather(k_scale, tables),
        gather(v_pool, tables), gather(v_scale, tables), cache_len, causal)


def paged_flash_attention_int8(
    q: torch.Tensor,        # (B, n_heads, T, hd) RoPE'd queries
    k_pool: torch.Tensor,   # (nb, n_kv, bs, hd) int8, chunk keys written
    k_scale: torch.Tensor,  # (nb, n_kv, bs) f32
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    tables: torch.Tensor,   # (B, nbmax) int32: pool block per virtual block
    cache_len: torch.Tensor,  # (B,) int32: valid keys BEFORE this chunk
    *,
    causal: bool = True,
) -> torch.Tensor:
    """:func:`flash_attention_int8` over the block pool: key ``s`` of row
    b lives in block ``tables[b, s // bs]``.  Returns (B, n_heads, T, hd)
    in q.dtype."""
    B, nh, T, hd = q.shape
    nkv, bs = k_pool.shape[1], k_pool.shape[2]
    nbmax = tables.shape[1]
    if q.device.type == "cpu":
        return paged_flash_attention_int8_plain(
            q, k_pool, k_scale, v_pool, v_scale, tables, cache_len, causal)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention_int8: device {q.device}")
    if q.dtype not in _IO_DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {_IO_DTYPES}")
    _check_flash_args(nh, nkv, hd)
    _check_paged(q, k_pool, k_scale, v_pool, v_scale, tables, cache_len)
    out = torch.empty_like(q)
    fn = build.bind("flash_attention", "paged_flash_attention_int8",
                    "ppppppppiiiiiiiiip")
    build.check(fn(q.data_ptr(), k_pool.data_ptr(), k_scale.data_ptr(),
                   v_pool.data_ptr(), v_scale.data_ptr(), tables.data_ptr(),
                   cache_len.data_ptr(), out.data_ptr(), B, nh, nkv, T, bs,
                   nbmax, hd, int(causal), int(q.dtype == torch.bfloat16),
                   build.stream_of(q)),
                "paged_flash_attention_int8")
    paged_flash_attention_int8.launches += 1
    return out


paged_flash_attention_int8.launches = 0  # kernel launches; only CUDA counts


def paged_decode_tile(bs: int) -> int:
    """Keys per online-softmax step of paged decode: JAX's in-block
    sub-tile (qqq_tpu/kernels/attention.py:593), which the kernel and the
    plain version both walk."""
    return 256 if bs % 256 == 0 else bs


def paged_decode_attention_int8_plain(q, k_pool, k_scale, v_pool, v_scale,
                                      tables, cache_len):
    """The JAX paged decode kernel's arithmetic, tile for tile over the
    pool gathered through the tables: the S-tiled decode's numerics
    (:func:`_tiled_decode_plain`) with tiles of :func:`paged_decode_tile`
    keys."""
    from qqq_tpu_torch.serve.paged_kv import gather

    return _tiled_decode_plain(
        q, gather(k_pool, tables), gather(k_scale, tables),
        gather(v_pool, tables), gather(v_scale, tables), cache_len,
        paged_decode_tile(k_pool.shape[2]))


def paged_decode_attention_int8(
    q: torch.Tensor,        # (B, n_heads, hd), RoPE'd current-step queries
    k_pool: torch.Tensor,   # (nb, n_kv, bs, hd) int8 (current k written)
    k_scale: torch.Tensor,  # (nb, n_kv, bs) f32
    v_pool: torch.Tensor,
    v_scale: torch.Tensor,
    tables: torch.Tensor,   # (B, nbmax) int32
    cache_len: torch.Tensor,  # (B,) int32: valid keys INCLUDING the current
) -> torch.Tensor:
    """Decode attention over the block pool (any g = nh/nkv).  Returns
    (B, n_heads, hd) in q.dtype.  The S-tiled decode's split kernel with
    each key row looked up through the table: three launches over a
    workspace allocated here; ``.launches`` counts calls, one per call."""
    B, nh, hd = q.shape
    nkv, bs = k_pool.shape[1], k_pool.shape[2]
    nbmax = tables.shape[1]
    if q.device.type == "cpu":
        return paged_decode_attention_int8_plain(
            q, k_pool, k_scale, v_pool, v_scale, tables, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_int8: device {q.device}")
    _check_split_args(q, nkv, "paged")
    sub = paged_decode_tile(bs)
    _check_paged(q, k_pool, k_scale, v_pool, v_scale, tables, cache_len)
    out = _split_decode(
        "paged_decode_attention_int8", "pppppppppiiiiiiiip", q, nbmax * bs,
        sub, (q, k_pool, k_scale, v_pool, v_scale, tables, cache_len),
        (B, nh, nkv, bs, nbmax, hd, sub))
    paged_decode_attention_int8.launches += 1
    return out


paged_decode_attention_int8.launches = 0  # wrapper calls on CUDA tensors
