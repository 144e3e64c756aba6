"""Port (qqq_tpu_torch) against the JAX package: the fused multi-step decode
(``Engine(steps_per_tick=n)``, JAX's ``_decode_multi`` scan), slot and
paged, and the sampler's host-decided branch.

A small g128 model with gate/up GLU-fused (the engines' default); JAX gets
the port's packed bits.  The port runs its plain versions on the CPU, the
JAX Pallas kernels run in interpret mode.  Tolerances: greedy tokens and
the schedulers' counts equal; the sampler's tokens equal to those of the
branch decided from the device tensors, as the sampler decided before.
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

from qqq_tpu_torch.models import (
    ModelConfig, params_from_numpy, quantize_params_rtn,
)
from qqq_tpu_torch.serve import sampling as S
from qqq_tpu_torch.serve.engine import Engine, Request

_CFG = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=512)
JCFG, TCFG = JConfig(**_CFG), ModelConfig(**_CFG)
STEPS = 4
#: prompt lengths and max_new_tokens (7: not a multiple of STEPS); the
#: second request stops at an EOS that its third generated token hits
PROMPT_LENS = (9, 30, 5)
MAX_NEW = 7
EOS_REQUEST, EOS_AT = 1, 2
#: slot: 2 slots for 3 requests (continuous admission), buckets of 16 and
#: 32; paged: blocks of 8, chunks of 16, 9 blocks (8 usable) for requests
#: that end up holding 3 + 5 + 2: recompute preemption
MODES = {
    "slot": dict(max_batch=2, max_len=128, prefill_buckets=(16, 32)),
    "paged": dict(max_batch=4, max_len=64, paged=True, block_size=8,
                  prefill_chunk=16, num_blocks=9),
}


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
def models():
    dense = jax_init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tdense = params_from_numpy(jax.tree.map(np.asarray, dense), TCFG,
                               device="cpu")
    tparams = quantize_params_rtn(tdense, TCFG, group_size=128)
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(0, 256, size=n)]
               for n in PROMPT_LENS]
    return _tree_jax(tparams), tparams, prompts


def _samplings(eos):
    return [dict(max_new_tokens=MAX_NEW,
                 eos_token_id=eos if i == EOS_REQUEST else None)
            for i in range(len(PROMPT_LENS))]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_multistep_engine_matches_jax(models, monkeypatch, mode):
    """``steps_per_tick=4`` on both engines: equal greedy tokens, finish
    reasons and scheduler counts (decode ticks once a tick, as JAX counts
    them), and the port's tokens equal to its one-step ticks'; the EOS
    lands mid-chunk and drops the chunk's overshoot; the CPU engine never
    builds a CUDA graph."""
    jparams, tparams, prompts = models
    kw = dict(MODES[mode], kv_quantized=True)
    # one step a tick, no EOS: the EOS is the second request's third token
    probe = Engine(tparams, TCFG, dtype=torch.float32, device="cpu", **kw)
    single = [Request(p, S.SamplingParams(max_new_tokens=MAX_NEW))
              for p in prompts]
    probe.run(single)
    eos = single[EOS_REQUEST].output_tokens[EOS_AT]

    jeng = JEngine(jparams, JCFG, dtype=jnp.float32, steps_per_tick=STEPS,
                   **kw)
    jreqs = [JRequest(prompt_tokens=p, sampling=JSampling(**sp))
             for p, sp in zip(prompts, _samplings(eos))]
    jeng.run(jreqs)

    def no_graph(*a, **k):
        raise AssertionError("a CPU engine built a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    eng = Engine(tparams, TCFG, dtype=torch.float32, device="cpu",
                 steps_per_tick=STEPS, **kw)
    reqs = [Request(p, S.SamplingParams(**sp))
            for p, sp in zip(prompts, _samplings(eos))]
    eng.run(reqs)

    assert [r.output_tokens for r in reqs] == \
        [r.output_tokens for r in jreqs]
    assert [r.output_tokens for r in reqs] == [
        r.output_tokens[:EOS_AT] if i == EOS_REQUEST else r.output_tokens
        for i, r in enumerate(single)]
    assert [r.finish_reason for r in reqs] == \
        [r.finish_reason for r in jreqs]
    stop = reqs[EOS_REQUEST]
    assert stop.finish_reason == "stop" and len(stop.output_tokens) == EOS_AT
    assert all(len(r.output_tokens) == MAX_NEW
               for i, r in enumerate(reqs) if i != EOS_REQUEST)
    # JAX counts dispatches and chunks of chunked prefill only
    chunked = ("prefill_dispatches", "prefill_chunks") if kw.get("paged") \
        else ()
    for k in ("decode_ticks", "prefills", "preemptions", "generated_tokens",
              *chunked):
        assert eng.stats[k] == jeng.stats[k], k
    assert eng.stats["decode_ticks"] < sum(len(r.output_tokens)
                                           for r in reqs) - len(reqs)
    assert eng.stats["graph_captures"] == eng.stats["graph_replays"] == 0
    if mode == "paged":
        assert eng.stats["preemptions"] > 0
        assert eng.allocators[0].available == eng.num_blocks - 1


_PLANES = {  # temperature, top_k, top_p, min_p of 4 rows
    S.GREEDY: ([0.0, 0.0, 0.0, 0.0], [0, 0, 0, 0], [1.0] * 4, [0.0] * 4),
    # a greedy row's top-k counts for the filter, as on the device before
    S.FILTERED: ([0.0, 0.8, 0.8, 1.0], [3, 0, 0, 0], [1.0, 1.0, 0.7, 1.0],
                 [0.0, 0.0, 0.0, 0.1]),
    S.SAMPLED: ([0.0, 0.8, 1.5, 1.0], [0] * 4, [1.0] * 4, [0.0] * 4),
}


@pytest.mark.parametrize("branch", sorted(_PLANES))
def test_host_branch_gives_the_device_decisions_tokens(branch):
    """On seeded logits, the branch :func:`sampling_branch` takes from host
    arrays gives the tokens of the sampler as it was, deciding from the
    device tensors, with the same noise."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(
        (rng.standard_normal((4, 64)) * 2).astype(np.float32))
    planes = [np.array(a, dt) for a, dt in zip(
        _PLANES[branch], (np.float32, np.int32, np.float32, np.float32))]
    assert S.sampling_branch(*planes) == branch
    temp, topk, topp, minp = (torch.from_numpy(a) for a in planes)

    def old_sampler(gen):  # the device-side decision it replaces
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        if not bool((temp > 0.0).any()):
            return greedy
        scaled = logits / torch.clamp_min(temp, 1e-6)[:, None]
        if bool((topk > 0).any() | (topp < 1.0).any() | (minp > 0.0).any()):
            scaled = S._topk_topp_filter(scaled, topk, topp, minp)
        g = S.gumbel((4, 64), gen, logits.device)
        return torch.where(temp <= 0.0, greedy,
                           torch.argmax(scaled + g, dim=-1).to(torch.int32))

    for seed in range(3):
        got = S.sample_batched(logits, torch.Generator().manual_seed(seed),
                               temp, topk, topp, minp, branch=branch)
        want = old_sampler(torch.Generator().manual_seed(seed))
        assert torch.equal(got, want), seed
