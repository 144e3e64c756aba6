"""Port (qqq_tpu_torch) against the JAX package: the per-request sampling
extras (penalties, logit bias, guided choice, seeds, top-N logprobs) and the
engine's serving hooks (on_token and cancel, score_prompt,
latency_summary).

A toy dense f32 model (JAX's tests/test_engine.py geometry) from a JAX seed,
converted bit for bit; prompts from a numpy seed.  Both engines run with an
f32 KV cache.  Tolerances: greedy tokens, finish reasons and top-N token ids
equal; chosen-token and top-N logprobs within 1e-5 of the largest |logprob|
(f32 forwards summed in other orders); the sampling functions within 1e-6
(bit-exact but for f32 division order).  Seeded tokens are the port's own
(its noise is a hash of (seed, generation index, token id)), so they are
held to JAX's property instead: equal across batch position, slot and paged
mode and steps per tick.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qqq_tpu.models import ModelConfig as JConfig
from qqq_tpu.models import init_params as jax_init_params
from qqq_tpu.serve import sampling as JS
from qqq_tpu.serve.engine import Engine as JEngine
from qqq_tpu.serve.engine import Request as JRequest

from qqq_tpu_torch.models import ModelConfig, forward, params_from_numpy
from qqq_tpu_torch.serve import sampling as S
from qqq_tpu_torch.serve.engine import Engine, Request

_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
JCFG, TCFG = JConfig(**_CFG), ModelConfig(**_CFG)
LP_TOL = 1e-5
#: slot: 2 slots for 4 requests; paged: 8-token blocks, 16-token chunks,
#: 6 usable blocks for requests that need up to 3 + 4 + 3 + 3:
#: recompute preemption; steps: 4 decode steps a tick (guided rows force
#: 1 while they run)
MODES = {
    "slot": dict(max_batch=2, max_len=64, prefill_buckets=(16, 32)),
    "paged": dict(max_batch=4, max_len=64, paged=True, block_size=8,
                  prefill_chunk=16, num_blocks=7),
    "steps4": dict(max_batch=2, max_len=64, prefill_buckets=(16, 32),
                   steps_per_tick=4),
}


@pytest.fixture(scope="module")
def models():
    jparams = jax_init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), TCFG,
                                device="cpu")
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, 128, size=n)]
               for n in (6, 19, 9, 12)]
    return jparams, tparams, prompts


def _port(tparams, mode, **kw):
    return Engine(tparams, TCFG, dtype=torch.float32, device="cpu",
                  kv_quantized=False, **{**MODES[mode], **kw})


def _jax(jparams, mode):
    return JEngine(jparams, JCFG, dtype=jnp.float32, kv_quantized=False,
                   **MODES[mode])


def _greedy(tparams, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        logits, _ = forward(tparams, TCFG, torch.tensor([toks]))
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _mixed(prompts, plain0):
    """Four requests, one extra each: penalties (repetition over the
    prompt too), a per-request bias (the first greedy token banned, one
    boosted), guided choice with prefix candidates and an EOS, top-3
    logprobs with an EOS."""
    return [
        dict(max_new_tokens=12, presence_penalty=5.0, frequency_penalty=0.5,
             repetition_penalty=1.3),
        dict(max_new_tokens=8, logit_bias=((plain0, -100.0), (7, 3.5))),
        dict(max_new_tokens=10, guided_choice=((17, 42, 99), (17, 3),
                                               (88,), (17,)),
             eos_token_id=0),
        dict(max_new_tokens=6, top_logprobs=3),
    ]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_extras_greedy_match_jax(models, mode):
    """A batch mixing every extra, against JAX's engine on the same
    params: greedy tokens (the first included), finish reasons, chosen and
    top-N logprobs; a paged pool tight enough to preempt on both sides."""
    jparams, tparams, prompts = models
    plain0 = _greedy(tparams, prompts[1], 1)[0]
    sps = _mixed(prompts, plain0)
    jeng = _jax(jparams, mode)
    jreqs = [JRequest(prompt_tokens=p, sampling=JS.SamplingParams(**sp))
             for p, sp in zip(prompts, sps)]
    jeng.run(jreqs)
    eng = _port(tparams, mode)
    reqs = [Request(p, S.SamplingParams(**sp)) for p, sp in zip(prompts, sps)]
    eng.run(reqs)
    assert [r.output_tokens for r in reqs] == \
        [r.output_tokens for r in jreqs]
    assert [r.finish_reason for r in reqs] == \
        [r.finish_reason for r in jreqs]
    assert plain0 not in reqs[1].output_tokens
    assert tuple(reqs[2].output_tokens) in sps[2]["guided_choice"]
    assert reqs[2].finish_reason == "stop"
    for r, jr in zip(reqs, jreqs):
        assert len(r.token_logprobs) == len(r.output_tokens)
        big = max(abs(x) for x in jr.token_logprobs)
        np.testing.assert_allclose(r.token_logprobs, jr.token_logprobs,
                                   rtol=0, atol=LP_TOL * big)
        assert [[t for t, _ in pos] for pos in r.top_logprobs] == \
            [[t for t, _ in pos] for pos in jr.top_logprobs]
        if r.top_logprobs:
            got = np.array([[v for _, v in pos] for pos in r.top_logprobs])
            want = np.array([[v for _, v in pos] for pos in jr.top_logprobs])
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=LP_TOL * np.abs(want).max())
    assert len(reqs[3].top_logprobs) == len(reqs[3].output_tokens)
    assert [r.top_logprobs for r in reqs[:3]] == [[], [], []]
    if mode == "paged":
        assert eng.stats["preemptions"] == jeng.stats["preemptions"] > 0
        assert eng.allocators[0].available == eng.num_blocks - 1


def test_penalties_and_first_token_match_jax(models):
    """The repetition penalty covers the prompt, so it can flip the first
    token: a prompt where it does (searched as JAX's test searches), whole
    and chunked prefill, against JAX's engine and a naive penalized loop."""
    jparams, tparams, _ = models
    sp = dict(max_new_tokens=16, presence_penalty=2.0,
              frequency_penalty=0.5, repetition_penalty=2.5)
    search = np.random.default_rng(7)
    prompt = None
    for _ in range(60):
        cand = [int(t) for t in search.integers(0, 128, size=8)]
        raw = _greedy(tparams, cand, 1)[0]
        cand = cand[:-1] + [raw]  # its argmax now in the prompt
        logits, _ = forward(tparams, TCFG, torch.tensor([cand]))
        mask = torch.zeros((1, 128), dtype=torch.bool)
        mask[0, cand] = True
        pen = S.apply_penalties(
            logits[:, -1], torch.zeros((1, 128), dtype=torch.int32), mask,
            torch.zeros(1), torch.zeros(1), torch.full((1,), 2.5))
        if int(pen.argmax()) != int(logits[0, -1].argmax()):
            prompt = cand
            break
    assert prompt is not None
    want = None
    for mode in ("slot", "paged"):
        jeng = _jax(jparams, mode)
        jr = JRequest(prompt_tokens=prompt, sampling=JS.SamplingParams(**sp))
        jeng.run([jr])
        eng = _port(tparams, mode)
        r = Request(prompt, S.SamplingParams(**sp))
        eng.run([r])
        assert r.output_tokens == jr.output_tokens, mode
        want = want or r.output_tokens
        assert r.output_tokens == want
    assert want != _greedy(tparams, prompt, 16)
    assert want[0] != _greedy(tparams, prompt, 1)[0]


def test_top_logprobs_same_length_after_eos(models):
    """An EOS pops the stop token from the output, its logprob and its
    top-N entry: the three lists stay equal in length, as in JAX."""
    jparams, tparams, prompts = models
    plain = _greedy(tparams, prompts[0], 6)
    eos = plain[3]
    sp = dict(max_new_tokens=8, eos_token_id=eos, top_logprobs=2)
    eng = _port(tparams, "slot")
    r = Request(prompts[0], S.SamplingParams(**sp))
    eng.run([r])
    jeng = _jax(jparams, "slot")
    jr = JRequest(prompt_tokens=prompts[0], sampling=JS.SamplingParams(**sp))
    jeng.run([jr])
    assert r.finish_reason == jr.finish_reason == "stop"
    assert r.output_tokens == jr.output_tokens == plain[:plain.index(eos)]
    assert len(r.top_logprobs) == len(r.output_tokens) \
        == len(r.token_logprobs) == len(jr.top_logprobs)


def test_seeded_sampling_reproducible_across_modes(models):
    """A seeded sampled request gives the same tokens alone, beside a
    batchmate (another slot and batch position), in paged mode under
    preemption and with 4 steps a tick; another seed diverges; the
    unseeded batchmate still samples."""
    _, tparams, prompts = models
    sp = S.SamplingParams(max_new_tokens=8, temperature=0.9, seed=1234)

    def run(mode, first=None):
        eng = _port(tparams, mode)
        other = [Request(p, S.SamplingParams(max_new_tokens=5,
                                             temperature=0.7))
                 for p in prompts[1:]]
        me = Request(prompts[0], sp)
        reqs = ([me] if first is None
                else other[:first] + [me] + other[first:])
        eng.run(reqs)
        return me.output_tokens, eng

    base, _ = run("slot")
    assert len(base) == 8
    assert run("slot", first=1)[0] == base
    toks, eng = run("paged", first=2)
    assert toks == base and eng.stats["preemptions"] > 0
    assert run("steps4", first=0)[0] == base
    eng = _port(tparams, "slot")
    r = Request(prompts[0], S.SamplingParams(max_new_tokens=8,
                                             temperature=0.9, seed=77))
    eng.run([r])
    assert r.output_tokens != base


def test_cancel_via_on_token_hook(models):
    """A hook that cancels after 3 tokens ends the request at exactly 3
    (logprobs too, "stop") while its batchmate runs to completion; both
    streams are plain greedy's."""
    _, tparams, prompts = models
    eng = _port(tparams, "slot", steps_per_tick=2)
    reqs = [Request(p, S.SamplingParams(max_new_tokens=8))
            for p in prompts[:2]]
    seen = []

    def hook(req, tok):
        seen.append((id(req), tok))
        if req is reqs[0] and req._emitted >= 3:
            eng.cancel(req)

    eng.on_token = hook
    eng.run(reqs)
    assert reqs[0].cancelled and reqs[0].finish_reason == "stop"
    assert len(reqs[0].output_tokens) == len(reqs[0].token_logprobs) == 3
    assert reqs[0].output_tokens == _greedy(tparams, prompts[0], 3)
    assert reqs[1].output_tokens == _greedy(tparams, prompts[1], 8)
    assert [t for i, t in seen if i == id(reqs[1])] == reqs[1].output_tokens


def test_score_prompt_and_latency_match_jax(models):
    """``score_prompt`` equals JAX's within 1e-5 of the largest |logprob|
    (None first); ``latency_summary`` has JAX's keys, and every finished
    request's TPOT is JAX's formula over its own stamps."""
    jparams, tparams, prompts = models
    eng = _port(tparams, "slot")
    jeng = _jax(jparams, "slot")
    got = eng.score_prompt(prompts[1])
    want = jeng.score_prompt(prompts[1])
    assert got[0] is None and want[0] is None and len(got) == len(want)
    np.testing.assert_allclose(got[1:], want[1:], rtol=0,
                               atol=LP_TOL * max(abs(x) for x in want[1:]))
    assert eng.score_prompt([]) == []
    with pytest.raises(ValueError):
        eng.score_prompt(list(range(40)))  # past the largest bucket
    reqs = [Request(p, S.SamplingParams(max_new_tokens=4)) for p in prompts]
    eng.run(reqs)
    summary = eng.latency_summary()
    assert set(summary) == set(jeng.latency_summary())
    assert summary["requests"] == 4 and summary["tpot_p50_s"] > 0
    for r in reqs:
        assert r.tpot == (r.t_done - r.t_first_token) / 3


def test_submit_call_runs_on_the_loop_thread(models):
    """A call submitted from another thread runs on the thread of
    ``run``, between scheduling rounds, and hands back its result."""
    import threading

    _, tparams, prompts = models
    eng = _port(tparams, "slot")
    threads = []
    futs = [eng.submit_call(lambda: threads.append(
        threading.get_ident()) or "ran")]
    eng.add_request(Request(prompts[0], S.SamplingParams(max_new_tokens=2)))
    box = {}
    t = threading.Thread(target=lambda: box.update(r=eng.run([])))
    t.start()
    t.join(60)
    assert futs[0].result(0) == "ran"
    assert threads == [t.ident]
    bad = eng.submit_call(lambda: eng.score_prompt(list(range(40))))
    eng.run([])
    with pytest.raises(ValueError):
        bad.result(0)


@pytest.mark.parametrize("fn", ["penalties", "allowed", "bias"])
def test_logit_stack_matches_jax(fn):
    """The sampler's logit-altering functions on random rows, against
    JAX's: penalties with some rows off, guided masks with pad-only rows,
    biases with pads and repeated pad ids."""
    rng = np.random.default_rng(9)
    B, V = 4, 64
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    if fn == "penalties":
        counts = rng.integers(0, 3, (B, V)).astype(np.int32)
        mask = rng.random((B, V)) < 0.2
        pres = np.array([0, 1.5, 0, 0.3], np.float32)
        freq = np.array([0, 0.5, 0, 0.2], np.float32)
        rep = np.array([1, 1.3, 2.0, 1], np.float32)
        args = (counts, mask, pres, freq, rep)
        got = S.apply_penalties(torch.from_numpy(logits),
                                *map(torch.from_numpy, args))
        want = JS.apply_penalties(jnp.asarray(logits),
                                  *map(jnp.asarray, args))
    elif fn == "allowed":
        ids = np.full((B, 4), V, np.int32)
        ids[0, :3] = (5, 9, 63)
        ids[2, :1] = (0,)
        got = S.apply_allowed_mask(torch.from_numpy(logits),
                                   torch.from_numpy(ids))
        want = JS.apply_allowed_mask(jnp.asarray(logits), jnp.asarray(ids))
    else:
        ids = np.zeros((B, 4), np.int32)
        vals = np.zeros((B, 4), np.float32)
        ids[1, :2], vals[1, :2] = (3, 60), (-100.0, 2.5)
        ids[3, :1], vals[3, :1] = (0,), (7.0,)
        got = S.apply_logit_bias(torch.from_numpy(logits),
                                 torch.from_numpy(ids),
                                 torch.from_numpy(vals))
        want = JS.apply_logit_bias(jnp.asarray(logits), jnp.asarray(ids),
                                   jnp.asarray(vals))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
