"""Port (qqq_tpu_torch) against the JAX package: the paged INT8 KV path —
the block pool and its writes, paged flash and paged decode attention, and
``Engine(paged=True)`` with chunked prefill and recompute preemption.

Inputs come from a numpy seed and go to both packages; the port runs its
plain versions on the CPU, the JAX Pallas kernels run in interpret mode and
the JAX pool writes take their default block-granular XLA path.  Tables are
scrambled (non-monotone), as a real allocator leaves them.

Tolerances:
* the writes (codes and scales) and the dequantized read-back: bit-exact on
  every block but the null block 0, whose content the pool leaves
  unspecified (rows that land there collide in any order);
* paged flash: the slot flash tolerance of tests/test_torch_attention.py,
  2e-3 absolute (both sides round q, K/V and the probabilities to bf16 at
  the same points; JAX tiles the keys by the block size, the port by the
  CUDA kernel's 32, so a probability's bf16 rounding against another
  running maximum can move an output by 2^-8 of one term; measured:
  7.3e-4 to 1.1e-3 at outputs up to 1.26);
* paged decode: 1e-5 absolute.  Both sides walk JAX's key tile and round
  ``q/√hd`` and ``e·v_scale`` to bf16 at the same points; only f32 sums in
  another order differ (measured: 7.5e-8, no bf16 flip at these seeds).
  The slot decode kernel's all-f32 numerics on the same gathered cache
  differ from JAX by 4e-4 to 3e-3 per row, and the test asserts that they
  fail this bound, so it tells the two numerics apart;
* the engines: greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qqq_tpu.kernels.attention import (
    paged_decode_attention_int8 as jax_paged_decode,
    paged_flash_attention_int8 as jax_paged_flash,
)
from qqq_tpu.kernels.kv_write import (
    paged_chunk_write_int8 as jax_chunk_write,
    paged_decode_write_int8 as jax_decode_write,
)
from qqq_tpu.models import ModelConfig as JConfig
from qqq_tpu.models import init_params as jax_init_params
from qqq_tpu.serve import paged_kv as jpkv
from qqq_tpu.serve.engine import generate as jax_generate
from qqq_tpu.serve.sampling import SamplingParams as JSampling

from qqq_tpu_torch.kernels.attention import (
    decode_attention_int8_plain, paged_decode_attention_int8,
    paged_flash_attention_int8,
)
from qqq_tpu_torch.kernels.kv_write import (
    paged_chunk_write_int8, paged_decode_write_int8,
)
from qqq_tpu_torch.models import (
    ModelConfig, params_from_numpy, quantize_params_rtn,
)
from qqq_tpu_torch.serve import paged_kv as tpkv
from qqq_tpu_torch.serve.engine import Engine, Request, generate
from qqq_tpu_torch.serve.sampling import SamplingParams

_POOL = ("k", "k_scale", "v", "v_scale")


class _Cfg:
    num_key_value_heads = 2
    head_dim = 64
    num_hidden_layers = 1


def _scrambled_tables(rng, B, nbmax, null_rows=()):
    """Distinct shuffled pool blocks per row (block 0 never handed out);
    rows in ``null_rows`` stay all-null, as an empty slot's do."""
    blocks = rng.permutation(np.arange(1, 1 + B * nbmax)).astype(np.int32)
    t = blocks.reshape(B, nbmax)
    t[list(null_rows)] = 0
    return t


def _pool_np(pool):
    return {k: np.asarray(pool[k]) for k in _POOL}


def _assert_pools_equal_but_null(got, want):
    for k in _POOL:
        np.testing.assert_array_equal(got[k][1:], want[k][1:], err_msg=k)


# ---------------------------------------------------------------------------
# the pool and its writes


@pytest.mark.parametrize("T,off0", [(1, 0), (64, 0), (64, 13), (96, 31),
                                    (5, 60)])
def test_paged_kv_write_and_read_match_jax(T, off0):
    """paged_kv.write (port: the paged write kernels' plain versions) against
    JAX's default block-granular path: history of ``off0`` tokens, then a
    chunk of T tokens at offsets that straddle blocks; row 2 overflows its
    table (its tail lands in the null block) and row 3 has an all-null
    table.  Then read() of the live span, dequantized."""
    rng = np.random.default_rng(T * 100 + off0)
    B, nkv, hd, bs, nbmax = 4, 2, 64, 32, 6
    tables = _scrambled_tables(rng, B, nbmax, null_rows=(3,))
    jpool = jpkv.init(_Cfg, num_blocks=1 + B * nbmax, block_size=bs)[0]
    tpool = tpkv.init(_Cfg, num_blocks=1 + B * nbmax, block_size=bs,
                      device="cpu")[0]
    tab_j, tab_t = jnp.asarray(tables), torch.from_numpy(tables)
    starts = [np.zeros(B, np.int32)]
    if off0:
        starts.append(np.full(B, off0, np.int32))
    # row 2 runs past its table
    starts[-1][2] = nbmax * bs - T // 2 if T > 1 else nbmax * bs + 3
    for i, off in enumerate(starts):
        n = off0 if i == 0 and off0 else T
        k = rng.standard_normal((B, n, nkv, hd)).astype(np.float32)
        v = rng.standard_normal((B, n, nkv, hd)).astype(np.float32)
        k[0, 0, 1] = 0.0  # an all-zero head row: the tiny-scale guard
        jpool = jpkv.write(jpool, jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(off), tab_j)
        tpkv.write(tpool, torch.from_numpy(k), torch.from_numpy(v),
                   torch.from_numpy(off), tab_t)
    _assert_pools_equal_but_null(_pool_np(tpool), _pool_np(jpool))
    S = nbmax * bs
    kj, vj = jpkv.read(jpool, tab_j, S, jnp.float32)
    kt, vt = tpkv.read(tpool, tab_t, S, torch.float32)
    live = slice(0, 3)  # row 3 reads the null block
    np.testing.assert_array_equal(kt.numpy()[live], np.asarray(kj)[live])
    np.testing.assert_array_equal(vt.numpy()[live], np.asarray(vj)[live])


@pytest.mark.parametrize("T", [1, 48])
def test_paged_write_plains_match_jax_kernels(T):
    """The two write plains against the JAX Pallas write kernels, bf16
    input, scrambled tables, one row past its table."""
    rng = np.random.default_rng(T)
    B, nkv, hd, bs, nbmax = 3, 2, 64, 32, 5
    tables = _scrambled_tables(rng, B, nbmax)
    pools = {k: rng.integers(-128, 128, (1 + B * nbmax, nkv, bs, hd)
                             ).astype(np.int8) for k in ("k", "v")}
    pools.update({k: rng.random((1 + B * nbmax, nkv, bs)).astype(np.float32)
                  for k in ("k_scale", "v_scale")})
    k = jnp.asarray(rng.standard_normal((B, T, nkv, hd)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, T, nkv, hd)), jnp.bfloat16)
    clen = np.array([7, 100, nbmax * bs - 1], np.int32)
    jfn, tfn = ((jax_decode_write, paged_decode_write_int8) if T == 1
                else (jax_chunk_write, paged_chunk_write_int8))
    want = jfn(*(jnp.asarray(pools[n]) for n in _POOL), k, v,
               jnp.asarray(tables), jnp.asarray(clen))
    got = [torch.from_numpy(pools[n].copy()) for n in _POOL]

    def t(x):
        return torch.from_numpy(np.array(x).view(np.uint16)).view(
            torch.bfloat16)

    tfn(*got, t(k), t(v), torch.from_numpy(tables), torch.from_numpy(clen))
    _assert_pools_equal_but_null({n: g.numpy() for n, g in zip(_POOL, got)},
                                 {n: np.asarray(w) for n, w in
                                  zip(_POOL, want)})


def test_block_allocator_invariants():
    a = tpkv.BlockAllocator(8)
    assert a.available == 7  # the null block is reserved
    blocks = a.alloc(7)
    assert 0 not in blocks and sorted(blocks) == list(range(1, 8))
    with pytest.raises(RuntimeError):
        a.alloc(1)
    a.free(blocks[:3])
    assert a.available == 3
    with pytest.raises(ValueError):
        a.free([0])


# ---------------------------------------------------------------------------
# paged attention


def _pool_inputs(rng, B, nkv, bs, nbmax, hd):
    nb = 1 + B * nbmax
    kp = rng.integers(-128, 128, (nb, nkv, bs, hd)).astype(np.int8)
    vp = rng.integers(-128, 128, (nb, nkv, bs, hd)).astype(np.int8)
    ks = (rng.random((nb, nkv, bs)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((nb, nkv, bs)) * 0.02 + 1e-3).astype(np.float32)
    return kp, ks, vp, vs, _scrambled_tables(rng, B, nbmax)


def _both(*arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(np.array(a)) for a in arrs])


@pytest.mark.parametrize("B,nh,nkv,bs,nbmax,T,causal", [
    (2, 8, 4, 128, 4, 1, False),    # decode shape
    (2, 8, 4, 128, 4, 16, True),    # chunked prefill, GQA
    (1, 4, 4, 64, 6, 8, True),      # MHA, small blocks
])
def test_paged_flash_matches_jax(B, nh, nkv, bs, nbmax, T, causal):
    """The shapes of tests/test_paged_kv.py::test_paged_flash_matches_
    contiguous, over scrambled tables."""
    hd = 64
    rng = np.random.default_rng(bs + T)
    q = rng.standard_normal((B, nh, T, hd)).astype(np.float32)
    *pool, tables = _pool_inputs(rng, B, nkv, bs, nbmax, hd)
    clen = rng.integers(T, bs * nbmax - bs - T, size=(B,)).astype(np.int32)
    j, t = _both(q, *pool, tables, clen)
    ref = np.asarray(jax_paged_flash(*j, causal=causal))
    out = paged_flash_attention_int8(*t, causal=causal)
    assert out.shape == (B, nh, T, hd)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-3)


@pytest.mark.parametrize("bs,nbmax,clen,nh,nkv,hd", [
    (8, 12, (1, 37, 96), 8, 2, 64),        # one key; mid-block; whole table
    (512, 2, (300, 777, 1024), 8, 2, 64),  # JAX's 256-key sub-tiles a block
    # rows ending on a 128-key chunk and on a 256-key tile, one key past
    (512, 2, (128, 129, 256, 257), 8, 2, 64),
    # one long row beside rows of one key (the split's imbalance)
    (128, 8, (1, 1000, 1), 8, 2, 64),
    # g = 16, which JAX serves and the port used to refuse
    (128, 4, (200, 512, 1), 32, 2, 64),
    # blocks of 16 < the 128-key chunk: a chunk spans eight blocks (tiles)
    (16, 20, (1, 129, 320), 8, 2, 64),
    # hd = 96 (six of eight 16-byte columns a key row live) and hd = 256
    (128, 4, (1, 129, 500), 8, 2, 96),
    (128, 4, (257, 512), 4, 2, 256),
], ids=["8-12-clen0", "512-2-clen1", "512-2-chunk-edges",
        "128-8-imbalanced", "128-4-g16", "16-20-chunk-spans-blocks",
        "128-4-hd96", "128-4-hd256"])
def test_paged_decode_matches_jax(bs, nbmax, clen, nh, nkv, hd):
    B = len(clen)
    rng = np.random.default_rng(bs)
    q = rng.standard_normal((B, nh, hd)).astype(np.float32)
    *pool, tables = _pool_inputs(rng, B, nkv, bs, nbmax, hd)
    j, t = _both(q, *pool, tables, np.array(clen, np.int32))
    ref = np.asarray(jax_paged_decode(*j))
    out = paged_decode_attention_int8(*t)
    assert out.shape == (B, nh, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    # the slot kernel's f32 numerics on the same keys miss the bound in
    # every row
    qt, kp, ks, vp, vs, tab, cl = t
    f32 = decode_attention_int8_plain(
        qt, tpkv.gather(kp, tab), tpkv.gather(ks, tab), tpkv.gather(vp, tab),
        tpkv.gather(vs, tab), cl).float().numpy()
    assert (np.abs(f32 - ref).reshape(B, -1).max(1) > 1e-5).all()


# ---------------------------------------------------------------------------
# the paged engine

# tests/test_paged_engine.py's model
_DENSE = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=128)
# tests/test_torch_g128.py's model (widths a multiple of 128)
_G128 = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=512)
_PAGED = dict(max_batch=4, max_len=64, kv_quantized=True, paged=True,
              block_size=8)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_jax(tree):
    """Port params → JAX params with the same bits (bf16 included)."""
    if isinstance(tree, dict):
        return {k: _tree_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_jax(v) for v in tree]
    if tree is None:
        return None
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def dense():
    jparams = jax_init_params(JConfig(**_DENSE), jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    tparams = params_from_numpy(_tree_np(jparams), ModelConfig(**_DENSE),
                                device="cpu")
    rng = np.random.default_rng(1234)
    prompts = [[int(t) for t in rng.integers(0, 128, size=n)]
               for n in (6, 11, 3)]
    return jparams, tparams, prompts


@pytest.fixture(scope="module")
def dense_want(dense):
    jparams, _, prompts = dense
    return jax_generate(jparams, JConfig(**_DENSE), prompts,
                        JSampling(max_new_tokens=8), dtype=jnp.float32,
                        **_PAGED)


def _run(params, cfg, prompts, n_new, **kw):
    eng = Engine(params, ModelConfig(**cfg), dtype=torch.float32,
                 device="cpu", **{**_PAGED, **kw})
    reqs = [Request(p, SamplingParams(max_new_tokens=n_new))
            for p in prompts]
    eng.run(reqs)
    return eng, reqs


def test_paged_engine_dense_greedy_matches_jax(dense, dense_want):
    """Dense f32 weights, INT8 pool of 8-token blocks, the default chunk
    (64: every prompt in one chunk, three rows padded to four)."""
    _, tparams, prompts = dense
    eng, reqs = _run(tparams, _DENSE, prompts, 8)
    assert [r.output_tokens for r in reqs] == dense_want
    assert eng.stats["preemptions"] == 0
    # one dispatch of 4 rows (3 requests and a padding row) of 64 tokens
    assert [(r["padded"], len(r["rows"])) for r in eng.dispatch_log
            if r["kind"] == "prefill"] == [(4 * 64, 3)]
    assert eng.allocators[0].available == eng.num_blocks - 1


def test_paged_scheduler_matches_jax_under_preemption(dense):
    """chip_smoke's phase 3d at 1/16 scale: prompts of 6/19/38/56 tokens
    and 4 new tokens end up holding 2 + 3 + 6 + 8 blocks of 8 against 12
    usable; 32-token chunks straddle blocks, two rows per dispatch.  Both
    engines preempt, dispatch, chunk and tick the same number of times and
    give the same tokens."""
    from qqq_tpu.serve.engine import Engine as JEngine, Request as JRequest

    jparams, tparams, _ = dense
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, 128, size=n)]
               for n in (6, 19, 38, 56)]
    kw = dict(max_len=128, prefill_chunk=32, prefill_batch=2, num_blocks=13)
    jeng = JEngine(jparams, JConfig(**_DENSE), dtype=jnp.float32,
                   **{**_PAGED, **kw})
    jreqs = [JRequest(prompt_tokens=p, sampling=JSampling(max_new_tokens=4))
             for p in prompts]
    jeng.run(jreqs)
    eng, reqs = _run(tparams, _DENSE, prompts, 4, **kw)
    assert [r.output_tokens for r in reqs] == [r.output_tokens for r in jreqs]
    for k in ("preemptions", "prefill_dispatches", "prefill_chunks",
              "decode_ticks", "prefills"):
        assert eng.stats[k] == jeng.stats[k], k
    assert eng.stats["preemptions"] > 0
    assert eng.allocators[0].available == eng.num_blocks - 1


def test_paged_engine_g128_fused_greedy_matches_jax():
    """g128-packed weights, both engines with the default ``fuse=True``
    (gate/up through the GLU-fused GEMM).  The port packs them (bit-exact
    with JAX's RTN, tests/test_torch_g128.py) and JAX gets the same bits."""
    cfg = ModelConfig(**_G128)
    dense_j = jax_init_params(JConfig(**_G128), jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    tparams = quantize_params_rtn(
        params_from_numpy(_tree_np(dense_j), cfg, device="cpu"), cfg,
        group_size=128)
    jparams = _tree_jax(tparams)
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, 256, size=n)]
               for n in (40, 9)]
    want = jax_generate(jparams, JConfig(**_G128), prompts,
                        JSampling(max_new_tokens=4), dtype=jnp.float32,
                        **_PAGED)
    eng, reqs = _run(tparams, _G128, prompts, 4)
    assert all("gate_up_glu" in layer for layer in eng.params["layers"])
    assert [r.output_tokens for r in reqs] == want
    assert [r["padded"] for r in eng.dispatch_log
            if r["kind"] == "prefill"] == [2 * 64]


def test_paged_preemption_exact(dense, dense_want):
    """A pool of 6 usable blocks for 3 requests that end up holding 7
    (after tests/test_paged_engine.py::test_paged_preemption_exact): the
    tokens equal the roomy run's, and every block returns to the pool."""
    _, tparams, prompts = dense
    eng, reqs = _run(tparams, _DENSE, prompts, 8, num_blocks=7)
    assert [r.output_tokens for r in reqs] == dense_want
    assert eng.stats["preemptions"] > 0
    assert eng.allocators[0].available == eng.num_blocks - 1
    assert all(r is None for r in eng.slot_req) and not eng.slot_prefill


def test_paged_pool_too_small_rejects(dense):
    """A prompt that cannot fit the pool even alone finishes with "error"
    at admission; the request that fits still runs, as in a roomy pool."""
    _, tparams, _ = dense
    eng = Engine(tparams, ModelConfig(**_DENSE), dtype=torch.float32,
                 device="cpu", **{**_PAGED, "max_batch": 2, "num_blocks": 3})
    bad = Request(list(range(1, 30)), SamplingParams(max_new_tokens=4))
    ok = Request([3, 5, 7], SamplingParams(max_new_tokens=4))
    eng.run([bad, ok])
    assert bad.done and bad.finish_reason == "error" and not bad.output_tokens
    _, (roomy,) = _run(tparams, _DENSE, [[3, 5, 7]], 4)
    assert ok.done and ok.output_tokens == roomy.output_tokens


def test_paged_growth_exhaustion_finishes_length(dense):
    """A request that outgrows a 2-usable-block pool with nothing left to
    preempt finishes with "length", keeping its tokens (the roomy pool's
    stream up to there), and frees every block (fp pool: the dense-gather
    attention path)."""
    _, tparams, _ = dense
    prompt = [int(t) for t in np.random.default_rng(7).integers(0, 128, 4)]
    kw = dict(max_batch=2, kv_quantized=False)
    eng, (req,) = _run(tparams, _DENSE, [prompt], 30, num_blocks=3, **kw)
    assert req.done and req.finish_reason == "length"
    assert 0 < len(req.output_tokens) < 30
    _, (roomy,) = _run(tparams, _DENSE, [prompt], 30, **kw)
    assert req.output_tokens == roomy.output_tokens[:len(req.output_tokens)]
    assert eng.allocators[0].available == eng.num_blocks - 1
    assert all(r is None for r in eng.slot_req)


def test_generate_paged_default_chunk_and_pool():
    """The paged defaults: the widest chunk ≤ 512 that divides max_len in
    whole blocks, and a pool that covers every slot's max_len."""
    cfg = ModelConfig(**_DENSE)
    params = params_from_numpy(
        _tree_np(jax_init_params(JConfig(**_DENSE), jax.random.PRNGKey(1),
                                 dtype=jnp.float32)), cfg, device="cpu")
    eng = Engine(params, cfg, max_batch=3, max_len=640, paged=True,
                 block_size=64, device="cpu", dtype=torch.float32)
    assert eng.prefill_chunk == 320 and eng.num_blocks == 1 + 3 * 10
    assert eng.caches[0]["k"].shape == (31, 2, 64, 16)
    out = generate(params, cfg, [[1, 2, 3]], SamplingParams(max_new_tokens=2),
                   dtype=torch.float32, device="cpu", **_PAGED)
    assert len(out[0]) == 2
