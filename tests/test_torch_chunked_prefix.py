"""Port (qqq_tpu_torch) against the JAX package: chunked prefill in slot
mode, the slot-level prefix cache and the paged block-level prefix cache of
``Engine``.

The JAX engine tests' toy model (tests/test_engine.py, dense f32 weights
from ``PRNGKey(0)``) goes to both packages with the same bits; prompts come
from a numpy seed.  The port runs its plain versions on the CPU (the slot
cache's chunks through the paged write and paged flash over the cache read
as a pool of max_len-token blocks), the JAX engine its Pallas kernels in
interpret mode.  Tolerances: greedy tokens, finish reasons and the
schedulers' counts equal; after a run, the paged pool is whole: the
allocator's free blocks and the prefix cache's unreferenced ones make up
every usable block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qqq_tpu.models import ModelConfig as JConfig
from qqq_tpu.models import init_params as jax_init_params
from qqq_tpu.serve.engine import Engine as JEngine
from qqq_tpu.serve.engine import Request as JRequest
from qqq_tpu.serve.sampling import SamplingParams as JSampling

from qqq_tpu_torch.models import ModelConfig, params_from_numpy
from qqq_tpu_torch.serve.engine import Engine, Request
from qqq_tpu_torch.serve.sampling import SamplingParams

_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
JCFG, TCFG = JConfig(**_CFG), ModelConfig(**_CFG)
#: the counts both engines keep, compared after every run
STATS = ("prefills", "prefill_chunks", "prefill_tokens",
         "prefill_dispatches", "decode_ticks", "prefix_hits",
         "prefix_tokens_reused", "spec_drafted", "spec_accepted",
         "preemptions")


@pytest.fixture(scope="module")
def params():
    jparams = jax_init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      TCFG, device="cpu")


def _toks(rng, n):
    return [int(t) for t in rng.integers(0, 128, size=n)]


class Pair:
    """The JAX engine and the port's on the same weights and arguments;
    :meth:`run` serves the same requests through both and holds them
    equal."""

    def __init__(self, params, **kw):
        self.jeng = JEngine(params[0], JCFG, dtype=jnp.float32, **kw)
        self.eng = Engine(params[1], TCFG, dtype=torch.float32,
                          device="cpu", **kw)

    def run(self, prompts, **sp):
        jreqs = [JRequest(prompt_tokens=p, sampling=JSampling(**sp))
                 for p in prompts]
        reqs = [Request(p, SamplingParams(**sp)) for p in prompts]
        self.jeng.run(jreqs)
        self.eng.run(reqs)
        assert [r.output_tokens for r in reqs] == \
            [r.output_tokens for r in jreqs]
        assert [r.finish_reason for r in reqs] == \
            [r.finish_reason for r in jreqs]
        for k in STATS:
            assert self.eng.stats[k] == self.jeng.stats[k], k
        return reqs

    def pool_whole(self) -> bool:
        eng = self.eng
        return (eng.allocators[0].available + len(eng._bh_lru[0])
                == eng.num_blocks - 1
                == self.jeng.allocators[0].available
                + len(self.jeng._bh_lru[0]))


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_chunked_slot_prefill_matches_jax(params, kv_quantized):
    """JAX :439 and :614: ragged prompts against 8-token chunks, one
    shorter than a chunk, 3 requests over 2 slots; dense and INT8 KV.
    13 → 2 chunks, 21 → 3, 3 → 1."""
    rng = np.random.default_rng(5)
    pair = Pair(params, max_batch=2, max_len=64, kv_quantized=kv_quantized,
                prefill_chunk=8)
    pair.run([_toks(rng, n) for n in (13, 21, 3)], max_new_tokens=5)
    st = pair.eng.stats
    assert (st["prefill_chunks"], st["prefills"], st["prefill_tokens"]) \
        == (6, 3, 13 + 21 + 3)
    # a dispatch takes exactly its slots: no padding rows in slot mode
    assert all(r["padded"] == 8 * len(r["rows"])
               for r in pair.eng.dispatch_log if r["kind"] == "prefill")


def test_chunked_slot_prefill_interleaves_decode(params):
    """JAX :461: while a 40-token prompt prefills in five chunks, the
    short request admitted beside it keeps decoding: its tokens arrive
    before the long request's first one.  A prompt longer than the largest
    bucket is served: only whole-bucket prefill rejects it."""
    rng = np.random.default_rng(6)
    short, long = _toks(rng, 4), _toks(rng, 40)
    pair = Pair(params, max_batch=2, max_len=64, kv_quantized=False,
                prefill_chunk=8, prefill_buckets=(16,))
    order = []
    pair.eng.on_token = lambda req, tok: order.append(len(req.prompt_tokens))
    jreqs = [JRequest(prompt_tokens=p, sampling=JSampling(max_new_tokens=n))
             for p, n in ((short, 8), (long, 3))]
    reqs = [Request(p, SamplingParams(max_new_tokens=n))
            for p, n in ((short, 8), (long, 3))]
    pair.jeng.run(jreqs)
    pair.eng.run(reqs)
    assert [r.output_tokens for r in reqs] == \
        [r.output_tokens for r in jreqs]
    assert len(reqs[1].output_tokens) == 3
    assert order.index(40) >= 4, order
    for k in STATS:
        assert pair.eng.stats[k] == pair.jeng.stats[k], k


def test_slot_prefix_cache_multiturn_and_divergent(params):
    """JAX :535 and :565 on one engine.  A follow-up turn (turn 1 + its
    reply + 5 new tokens) reuses the freed slot's KV: the cache held turn 1
    + outputs[:-1] = 23 tokens, 16 after rounding to the chunk.  A prompt
    diverging at token 10 then reuses 8, an unrelated one nothing."""
    rng = np.random.default_rng(7)
    pair = Pair(params, max_batch=2, max_len=64, kv_quantized=False,
                prefill_chunk=8, prefix_cache=True)
    st = pair.eng.stats
    turn1 = _toks(rng, 18)
    r1 = pair.run([turn1], max_new_tokens=6)[0]
    turn2 = turn1 + r1.output_tokens + _toks(rng, 5)
    pair.run([turn2], max_new_tokens=6)
    assert (st["prefix_hits"], st["prefix_tokens_reused"]) == (1, 16)
    assert st["prefill_tokens"] == len(turn1) + len(turn2) - 16
    div = turn2[:10] + [(t + 1) % 128 for t in turn2[10:24]] + turn2[:4]
    pair.run([div], max_new_tokens=4)
    assert (st["prefix_hits"], st["prefix_tokens_reused"]) == (2, 24)
    pair.run([_toks(rng, 9)], max_new_tokens=4)
    assert st["prefix_hits"] == 2
    # a freed slot keeps its prefix (slot_len = the kept tokens), so the
    # masked rows of later ticks write past it
    kept = [len(t) for t in pair.eng.slot_tokens]
    assert list(pair.eng.slot_len) == kept and max(kept) > 0


def test_slot_prefix_cache_int8_interleaved(params):
    """INT8 KV, 3 slots: two chat turns reuse their own slots while a
    third request decodes beside them."""
    rng = np.random.default_rng(8)
    pair = Pair(params, max_batch=3, max_len=64, kv_quantized=True,
                prefill_chunk=8, prefix_cache=True)
    a, b = _toks(rng, 17), _toks(rng, 26)
    ra, rb = pair.run([a, b], max_new_tokens=5)
    pair.run([a + ra.output_tokens + _toks(rng, 3),
              b + rb.output_tokens + _toks(rng, 2), _toks(rng, 11)],
             max_new_tokens=5)
    assert pair.eng.stats["prefix_hits"] == 2


def test_prefix_cache_needs_chunked_prefill(params):
    with pytest.raises(ValueError, match="chunked prefill"):
        Engine(params[1], TCFG, prefix_cache=True, device="cpu")
    with pytest.raises(ValueError, match="multiple of prefill_chunk"):
        Engine(params[1], TCFG, max_len=64, prefill_chunk=24, device="cpu")
    with pytest.raises(ValueError, match="block_size"):
        Engine(params[1], TCFG, max_len=64, paged=True, block_size=8,
               prefill_chunk=12, prefix_cache=True, device="cpu")


_PAGED = dict(max_len=64, kv_quantized=True, paged=True, block_size=8,
              prefix_cache=True)


def test_paged_prefix_cache_reuse_and_dedup(params):
    """tests/test_paged_engine.py:145 and :164.  A follow-up turn adopts
    its first turn's registered blocks; two requests that share a 24-token
    system prompt over one slot dedup its three full blocks."""
    rng = np.random.default_rng(9)
    pair = Pair(params, max_batch=2, prefill_chunk=8, **_PAGED)
    base = _toks(rng, 16)
    r1 = pair.run([base], max_new_tokens=4)[0]
    pair.run([base + r1.output_tokens + [5, 9]], max_new_tokens=4)
    # 16 + 3 written tokens → two full blocks; the follow-up adopts both
    assert pair.eng.stats["prefix_tokens_reused"] == 16
    assert pair.pool_whole()

    pair = Pair(params, max_batch=1, **_PAGED)
    system = _toks(rng, 24)
    pair.run([system + [3, 7], system + [9, 11, 2]], max_new_tokens=4)
    assert (pair.eng.stats["prefix_hits"],
            pair.eng.stats["prefix_tokens_reused"]) == (1, 24)
    assert pair.pool_whole()


def test_paged_prefix_cache_eviction(params):
    """tests/test_paged_engine.py:185 and :303: 8 usable blocks serve four
    15-token requests in turn only by evicting the cached blocks of the
    earlier ones (LRU); two 12-token requests of 20 new tokens over 6
    usable blocks preempt, and the victim's registered blocks, parked on
    the LRU, are evicted to grow the survivor."""
    rng = np.random.default_rng(10)
    pair = Pair(params, max_batch=2, num_blocks=9, **_PAGED)
    for i in range(4):
        pair.run([_toks(rng, 14) + [i]], max_new_tokens=4)
        assert pair.pool_whole()
    assert 0 < len(pair.eng._bh_lru[0]) <= 8

    pair = Pair(params, max_batch=2, num_blocks=7,
                **{**_PAGED, "kv_quantized": False})
    reqs = pair.run([_toks(rng, 12), _toks(rng, 12)], max_new_tokens=20)
    assert pair.eng.stats["preemptions"] > 0
    assert all(r.done for r in reqs)
    assert pair.pool_whole()
