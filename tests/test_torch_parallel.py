"""Port (qqq_tpu_torch.parallel, the model's TP / SP, the sharded sampler
and ``Engine(mesh=)``) against the JAX package's on the CPU.

JAX's side runs in this process over conftest's 8 virtual CPU devices
(Pallas in interpret mode, as tests/test_sharding.py runs it) and writes
its inputs and outputs under ``tmp_path``.  The port's side runs in two
spawned gloo worlds, one of 2 processes (``make_mesh(1, 2)``) and one of 4
(``make_mesh(2, 2)``), each joined with a 60 s timeout, so a hung
collective fails the tests instead of stalling the suite; each rank writes
its results beside JAX's.  Weights come from the JAX package (seeded
``init_params``, RTN-packed by ``__graft_entry__._quantize_params``) and
cross as numpy through ``models/convert.py``.

Tolerances: dense f32 logits 2e-5 (tests/test_sharding.py:48-50); W4A8
logits 2e-3 absolute (tests/test_torch_model.py: an f32 last-bit
difference can flip one INT8 activation code); sequence-parallel and the
overlapped decode against the port's own TP forward 1e-4
(__graft_entry__.py:140-155, :250-253); the port's TP against its own
single device 0.05 · max|logits| (a row-parallel linear quantizes its
local K-slice per token: tests/test_sharding.py:83-89); tokens and shards
exact.
"""

import os
import pickle
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as JP

from __graft_entry__ import _quantize_params as jax_rtn
from qqq_tpu import parallel as JPar
from qqq_tpu.models import ModelConfig as JConfig
from qqq_tpu.models import init_params as jax_init
from qqq_tpu.models import llama as JM
from qqq_tpu.serve import kv_cache as jkv
from qqq_tpu.serve import paged_kv as jpkv
from qqq_tpu.serve.engine import Engine as JEngine
from qqq_tpu.serve.engine import Request as JRequest
from qqq_tpu.serve.sampling import SamplingParams as JSampling

from qqq_tpu_torch.models import ModelConfig, params_from_numpy
from qqq_tpu_torch.parallel import param_pspecs, shard_params
from qqq_tpu_torch.parallel.collectives import Axis
from qqq_tpu_torch.parallel.shard import Mesh
from qqq_tpu_torch.serve.engine import Engine, Request
from qqq_tpu_torch.serve.sampling import SamplingParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 60

#: the dense f32 model of tests/test_sharding.py
CFG_D = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
             num_hidden_layers=2, num_attention_heads=8,
             num_key_value_heads=4, max_position_embeddings=256)
#: W4A8: every K-shard at TP = 2 whole 128-row pack blocks (o: 128, down:
#: 256)
CFG_Q = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=256)
CFG_T = dict(CFG_D, num_hidden_layers=1, tie_word_embeddings=True)
CFGS = {"dense": CFG_D, "pc": CFG_Q, "g128": CFG_Q, "tied": CFG_T}
MAX_LEN, BS = 32, 8
ENGINE_KW = dict(max_batch=4, max_len=64, kv_quantized=True,
                 prefill_buckets=(16,))
PROMPT_LENS = (6, 11, 4, 9, 5)
EXTRAS = {
    "chunked": (dict(prefill_chunk=8, prefill_buckets=(32,)),
                [dict(max_new_tokens=5, presence_penalty=0.4)] * 5),
    "spec": (dict(spec_ngram=1, spec_k=3, max_len=128),
             [dict(max_new_tokens=16)] * 5),
    "multistep": (dict(steps_per_tick=3),
                  [dict(max_new_tokens=7), dict(max_new_tokens=6,
                                                temperature=0.9)] * 2
                  + [dict(max_new_tokens=5)]),
}


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, 256, size=n)] for n in lens]


def _sampling_rows():
    """Greedy rows beside seeded temperature rows (one with top-k), so
    that every token is JAX's wherever the logits are."""
    return [dict(max_new_tokens=6),
            dict(max_new_tokens=6, temperature=0.8, seed=11),
            dict(max_new_tokens=5),
            dict(max_new_tokens=6, temperature=1.1, top_k=20, seed=5),
            dict(max_new_tokens=4)]


def _paged_tables(B, nb):
    """Scrambled block tables: row b owns blocks 1 + a permutation."""
    perm = np.random.default_rng(7).permutation(B * nb) + 1
    return perm.reshape(B, nb).astype(np.int32)


def _jax_paged_fwd(mesh, specs, cfg, caches):
    cspec = JPar.paged_cache_pspec(caches)
    return jax.jit(shard_map(
        lambda p, t, c, cl, tb: JM.forward(
            p, cfg, t, caches=c, cache_len=cl, tp_axis="model",
            block_tables=tb),
        mesh=mesh,
        in_specs=(specs, JP("data", None), cspec, JP("data"),
                  JP("data", None)),
        out_specs=(JP("data", None, None), cspec), check_vma=False))


def _run_jax_engine(params, cfg, mesh, prompts, rows, **kw):
    eng = JEngine(params, cfg, dtype=jnp.float32, mesh=mesh,
                  **{**ENGINE_KW, **kw})
    reqs = [JRequest(prompt_tokens=p, sampling=JSampling(**r))
            for p, r in zip(prompts, rows)]
    eng.run(reqs)
    return ([r.output_tokens for r in reqs],
            [list(map(float, r.token_logprobs)) for r in reqs],
            dict(eng.stats))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The weights (JAX's, RTN-packed under jit) and the inputs, written
    where the port's worlds read them."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    out = tmp_path_factory.mktemp("parallel")
    params = {}
    for name, cfgd in CFGS.items():
        cfg = JConfig(**cfgd)
        p = jax_init(cfg, jax.random.PRNGKey(len(name)), dtype=jnp.float32)
        if name in ("pc", "g128"):
            gs = -1 if name == "pc" else 128
            p = jax.jit(lambda q, cfg=cfg, gs=gs: jax_rtn(q, cfg,
                                                          group_size=gs))(p)
        params[name] = p
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, size=(4, 8)).astype(np.int32)
    inp = dict(params={k: _np_tree(v) for k, v in params.items()},
               tokens=tokens, tables=_paged_tables(4, MAX_LEN // BS),
               prompts=_prompts(1, PROMPT_LENS), rows=_sampling_rows())
    with open(out / "inputs.pkl", "wb") as fh:
        pickle.dump(inp, fh)
    return out, params, inp


@pytest.fixture(scope="module")
def worlds(inputs):
    """Both gloo worlds, started before JAX's side computes (they read
    only the inputs), so that the two overlap."""
    return {n: _launch_world(inputs[0], n) for n in (2, 4)}


@pytest.fixture(scope="module")
def jax_side(inputs, worlds):
    """Every JAX reference."""
    out, params, inp = inputs
    tokens = inp["tokens"]
    ref = {}
    m12 = JPar.make_mesh(data=1, model=2)
    m22 = JPar.make_mesh(data=2, model=2)
    for name, p in params.items():
        cfg = JConfig(**CFGS[name])
        specs = JPar.param_pspecs(p)
        sp = JPar.shard_params(p, m12, specs)
        ref[f"fwd_{name}"] = np.asarray(
            JPar.tp_forward_fn(cfg, m12, specs)(sp, jnp.asarray(tokens)))
    # data × model: the per-channel model over mesh(2, 2)
    cfg = JConfig(**CFG_Q)
    specs = JPar.param_pspecs(params["pc"])
    ref["fwd_pc_22"] = np.asarray(JPar.tp_forward_fn(cfg, m22, specs)(
        JPar.shard_params(params["pc"], m22, specs), jnp.asarray(tokens)))
    # sequence parallelism on the dense model, with and without the ring
    cfg = JConfig(**CFG_D)
    specs = JPar.param_pspecs(params["dense"])
    sp = JPar.shard_params(params["dense"], m12, specs)
    for key, kw in (("sp", dict(sp=True)), ("ring", dict(overlap=True))):
        ref[f"{key}_dense"] = np.asarray(JPar.tp_forward_fn(
            cfg, m12, specs, **kw)(sp, jnp.asarray(tokens)))
    # prefill then one decode step over the INT8 slot cache and the paged
    # pool, g128
    cfg = JConfig(**CFG_Q)
    specs = JPar.param_pspecs(params["g128"])
    sp = JPar.shard_params(params["g128"], m12, specs)
    caches = jkv.init(cfg, 4, MAX_LEN, quantized=True, dtype=jnp.float32)
    f = JPar.tp_forward_fn(cfg, m12, specs, with_cache=True,
                           caches_spec=JPar.cache_pspec(caches))
    lg, caches = f(sp, jnp.asarray(tokens), caches,
                   jnp.zeros((4,), jnp.int32))
    ref["slot_prefill"] = np.asarray(lg)
    lg, _ = f(sp, jnp.asarray(tokens[:, :1]), caches,
              jnp.full((4,), 8, jnp.int32))
    ref["slot_decode"] = np.asarray(lg)
    nb = MAX_LEN // BS
    tables = inp["tables"]
    pool = jpkv.init(cfg, 1 + 4 * nb, BS, quantized=True, dtype=jnp.float32)
    g = _jax_paged_fwd(m12, specs, cfg, pool)
    lg, pool = g(sp, jnp.asarray(tokens), pool, jnp.zeros((4,), jnp.int32),
                 jnp.asarray(tables))
    ref["paged_prefill"] = np.asarray(lg)
    lg, _ = g(sp, jnp.asarray(tokens[:, :1]), pool,
              jnp.full((4,), 8, jnp.int32), jnp.asarray(tables))
    ref["paged_decode"] = np.asarray(lg)
    # the engine under mesh(1, 2), slot and paged, greedy and seeded rows
    prompts, rows = inp["prompts"], inp["rows"]
    for mode, kw in (("slot", {}), ("paged", dict(paged=True,
                                                  block_size=BS))):
        ref[f"engine_{mode}"] = _run_jax_engine(
            params["dense"], JConfig(**CFG_D), m12, prompts, rows, **kw)
    return out, inp, ref


WORKER = r'''
import datetime, os, pickle, sys, traceback
import numpy as np
import torch
import torch.distributed as dist

rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(2)

from qqq_tpu_torch.models import ModelConfig, params_from_numpy
from qqq_tpu_torch.models import llama as M
from qqq_tpu_torch.parallel import (
    initialize_distributed, make_hybrid_mesh, make_mesh, param_pspecs,
    shard_params, tp_decode_overlapped_fn, tp_forward_fn,
)
initialize_distributed(device="cpu", init_method=f"tcp://127.0.0.1:{port}",
                       world_size=world, rank=rank,
                       timeout=datetime.timedelta(seconds=45))
from qqq_tpu_torch.parallel.shard import local_config
from qqq_tpu_torch.serve import kv_cache, paged_kv
from qqq_tpu_torch.serve.engine import Engine, Request
from qqq_tpu_torch.serve.sampling import (
    SAMPLED, SamplingParams, chosen_logprob, chosen_logprob_sharded,
    sample_batched, sample_batched_sharded,
)

CFGS = %(cfgs)r
MAX_LEN, BS = %(max_len)d, %(bs)d
ENGINE_KW = %(engine_kw)r
with open(os.path.join(out, "inputs.pkl"), "rb") as fh:
    inp = pickle.load(fh)
cfgs = {k: ModelConfig(**v) for k, v in CFGS.items()}
params = {k: params_from_numpy(v, cfgs[k], device="cpu")
          for k, v in inp["params"].items()}
tokens = torch.from_numpy(inp["tokens"]).to(torch.int64)
res = {}


def case(fn):
    try:
        res[fn.__name__] = fn()
    except Exception:
        res[fn.__name__] = {"error": traceback.format_exc()}
    return fn


def np_(t):
    return t.detach().to(torch.float32).cpu().numpy()


def sampler_cases(mesh, tag):
    tp, da = mesh.axis("model"), mesh.axis("data")
    rng = np.random.default_rng(3)
    B, V = 4, 256
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32))
    logits[0, 3] = logits[0, 200] = 50.0  # a tie across the shards
    temp = torch.tensor([0.0, 0.7, 1.3, 0.0])
    Bl, Vl = B // da.size, V // tp.size
    rows = slice(da.index * Bl, (da.index + 1) * Bl)
    local = logits[rows, tp.index * Vl:(tp.index + 1) * Vl].contiguous()
    got, want = [], []
    for seed in range(4):
        g1 = torch.Generator().manual_seed(seed)
        g2 = torch.Generator().manual_seed(seed)
        want.append(sample_batched(logits, g1, temp, torch.zeros(B, dtype=torch.int32),
                                   torch.ones(B), branch=SAMPLED)[rows])
        got.append(sample_batched_sharded(
            local, g2, temp[rows], tp, V, da if da.size > 1 else None,
            branch=SAMPLED))
    tok = torch.stack(want)[0]
    lp = chosen_logprob_sharded(local, tok, tp, V)
    # tied embeddings: replicated logits
    rep = sample_batched_sharded(logits[rows].contiguous(),
                                 torch.Generator().manual_seed(9), temp[rows],
                                 tp, V, da if da.size > 1 else None,
                                 branch=SAMPLED)
    rep_want = sample_batched(logits, torch.Generator().manual_seed(9), temp,
                              torch.zeros(B, dtype=torch.int32), torch.ones(B),
                              branch=SAMPLED)[rows]
    return dict(got=np.stack([t.numpy() for t in got]),
                want=np.stack([t.numpy() for t in want]),
                lp=lp.numpy(), lp_want=chosen_logprob(logits[rows], tok).numpy(),
                rep=rep.numpy(), rep_want=rep_want.numpy(),
                greedy_tie=int(sample_batched_sharded(
                    local, None, temp[rows] * 0, tp, V, None,
                    branch="greedy")[0]) if da.index == 0 else 3)


#: the scheduler's other features under a mesh, as JAX runs them there
#: (tests/test_engine.py:629, :1130, :1179): chunked slot prefill with a
#: presence penalty, prompt-lookup speculation, fused multi-step ticks
#: over greedy and unseeded temperature rows (the sharded sampler)
EXTRAS = %(extras)r


def extras(mesh):
    out = {}
    for name, (kw, rows) in EXTRAS.items():
        e, reqs = engine_run(mesh, params["dense"], cfgs["dense"],
                             inp["prompts"], rows, **kw)
        out[name] = dict(tokens=[r.output_tokens for r in reqs],
                         spec_ticks=e.stats["spec_ticks"],
                         ticks=e.stats["decode_ticks"])
    return out


def engine_run(mesh, p, cfg, prompts, rows, **kw):
    eng = Engine(p, cfg, dtype=torch.float32, mesh=mesh, device="cpu",
                 **{**ENGINE_KW, **kw})
    reqs = [Request(prompt_tokens=pr, sampling=SamplingParams(**r))
            for pr, r in zip(prompts, rows)]
    eng.run(reqs)
    return eng, reqs


if world == 2:
    mesh = make_mesh(1, 2, device="cpu")

    for name in CFGS:
        def fwd(name=name):
            p = params[name]
            f = tp_forward_fn(cfgs[name], mesh, param_pspecs(p))
            return np_(f(shard_params(p, mesh), tokens))
        fwd.__name__ = f"fwd_{name}"
        case(fwd)
        if name in ("pc", "g128") and rank == 0:
            def single(name=name):
                return np_(M.forward(params[name], cfgs[name], tokens)[0])
            single.__name__ = f"single_{name}"
            case(single)

    cfg = cfgs["dense"]
    sp_dense = shard_params(params["dense"], mesh)
    for key, kw in (("sp", dict(sp=True)), ("ring", dict(overlap=True))):
        def spf(kw=kw):
            f = tp_forward_fn(cfg, mesh, param_pspecs(params["dense"]), **kw)
            return np_(f(sp_dense, tokens))
        spf.__name__ = f"{key}_dense"
        case(spf)

    @case
    def sp_raises():
        try:
            M.forward_sp(sp_dense, cfg, tokens[:, :7], tp=mesh.axis("model"))
        except ValueError as e:
            return str(e)
        return "no error"

    cfg = cfgs["g128"]
    p128 = shard_params(params["g128"], mesh)
    lcfg = local_config(cfg, 2)
    spec = param_pspecs(params["g128"])

    def slot_run(**kw):
        caches = kv_cache.init(lcfg, 4, MAX_LEN, quantized=True,
                               dtype=torch.float32)
        f = tp_forward_fn(cfg, mesh, spec, with_cache=True, **kw)
        pre, caches = f(p128, tokens, caches, torch.zeros(4, dtype=torch.int32))
        dec, _ = tp_forward_fn(cfg, mesh, spec, with_cache=True)(
            p128, tokens[:, :1], caches, torch.full((4,), 8, dtype=torch.int32))
        return np_(pre), np_(dec)

    @case
    def slot():
        return slot_run()

    @case
    def slot_sp():
        return slot_run(sp=True)

    @case
    def slot_ring():
        return slot_run(overlap=True)

    @case
    def paged():
        nb = MAX_LEN // BS
        pool = paged_kv.init(lcfg, 1 + 4 * nb, BS, quantized=True,
                             dtype=torch.float32)
        tabs = torch.from_numpy(inp["tables"])
        tp = mesh.axis("model")
        pre, _ = M.forward(p128, cfg, tokens, caches=pool,
                           cache_len=torch.zeros(4, dtype=torch.int32),
                           block_tables=tabs, tp=tp)
        dec, _ = M.forward(p128, cfg, tokens[:, :1], caches=pool,
                           cache_len=torch.full((4,), 8, dtype=torch.int32),
                           block_tables=tabs, tp=tp)
        return np_(pre), np_(dec)

    @case
    def overlapped():
        f = tp_forward_fn(cfg, mesh, spec, with_cache=True)
        chains = []
        for m in range(2):
            c = kv_cache.init(lcfg, 2, MAX_LEN, quantized=True,
                              dtype=torch.float32)
            _, c = f(p128, tokens[2 * m:2 * m + 2], c,
                     torch.zeros(2, dtype=torch.int32))
            chains.append(c)
        plain = []
        for m in range(2):
            c = kv_cache.init(lcfg, 2, MAX_LEN, quantized=True,
                              dtype=torch.float32)
            _, c = f(p128, tokens[2 * m:2 * m + 2], c,
                     torch.zeros(2, dtype=torch.int32))
            lg, _ = f(p128, tokens[2 * m:2 * m + 2, :1], c,
                      torch.full((2,), 8, dtype=torch.int32))
            plain.append(np_(lg[:, -1]))
        ov = tp_decode_overlapped_fn(cfg, mesh, spec, None, micro=2)
        outs, _ = ov(p128, tuple(tokens[2 * m:2 * m + 2, :1] for m in range(2)),
                     tuple(chains),
                     tuple(torch.full((2,), 8, dtype=torch.int32)
                           for _ in range(2)))
        return np.concatenate([np_(o) for o in outs]), np.concatenate(plain)

    @case
    def sampler():
        return sampler_cases(mesh, "12")

    @case
    def engine_extras():
        return extras(mesh)

    prompts, rows = inp["prompts"], inp["rows"]
    for mode, kw in (("slot", {}), ("paged", dict(paged=True, block_size=BS))):
        def eng(kw=kw):
            e, reqs = engine_run(mesh, params["dense"], cfgs["dense"],
                                 prompts, rows, **kw)
            # unseeded temperature rows: the sharded sampler's path
            e2, reqs2 = engine_run(
                mesh, params["dense"], cfgs["dense"], prompts,
                [dict(max_new_tokens=5, temperature=0.9)] * len(prompts), **kw)
            return dict(tokens=[r.output_tokens for r in reqs],
                        logprobs=[list(map(float, r.token_logprobs))
                                  for r in reqs],
                        stats={k: v for k, v in e.stats.items()
                               if not k.endswith("_s")},
                        temp_tokens=[r.output_tokens for r in reqs2],
                        temp_logprobs=[list(map(float, r.token_logprobs))
                                       for r in reqs2],
                        replays=e.stats["graph_replays"])
        eng.__name__ = f"engine_{mode}"
        case(eng)

else:
    mesh = make_mesh(2, 2, device="cpu")

    @case
    def hybrid():
        # LOCAL_WORLD_SIZE=2: two hosts of two ranks
        hm = make_hybrid_mesh(2, 1, 2, device="cpu")
        try:
            make_hybrid_mesh(1, 1, 4, device="cpu")
            wide = "no error"
        except ValueError as e:
            wide = str(e)
        return dict(coords=hm.coords, shape=hm.shape,
                    model_ranks=hm.axis("model").ranks,
                    data_ranks=hm.axis("data").ranks, wide=wide,
                    backend=hm.backend)

    @case
    def fwd_pc_22():
        p = params["pc"]
        f = tp_forward_fn(cfgs["pc"], mesh, param_pspecs(p))
        return np_(f(shard_params(p, mesh), tokens))

    @case
    def sampler():
        return sampler_cases(mesh, "22")

    @case
    def engine_extras():
        return extras(mesh)

    @case
    def engine_dp():
        cfg = cfgs["dense"]
        e, reqs = engine_run(mesh, params["dense"], cfg, [[1, 2, 3, 4, 5]] * 4,
                             [dict(max_new_tokens=3)] * 4, paged=True,
                             block_size=BS, prefix_cache=True, max_len=32)
        whole = [a.available + len(lru) == e.num_blocks - 1
                 for a, lru in zip(e.allocators, e._bh_lru)]
        # a shared prefix of two whole blocks on both shards, twice: the
        # second round adopts each shard's own cached blocks
        shared = inp["prompts"][1] + inp["prompts"][3]
        more = [shared + [7, 8], shared + [9], shared + [7, 8], shared]
        e2 = Engine(params["dense"], cfg, dtype=torch.float32, mesh=mesh,
                    device="cpu", **{**ENGINE_KW, "paged": True,
                                     "block_size": BS, "prefix_cache": True})
        rounds = []
        for _ in range(2):
            rs = [Request(prompt_tokens=m,
                          sampling=SamplingParams(max_new_tokens=6))
                  for m in more]
            e2.run(rs)
            rounds.append([r.output_tokens for r in rs])
        whole += [a.available + len(lru) == e2.num_blocks - 1
                  for a, lru in zip(e2.allocators, e2._bh_lru)]
        return dict(tokens=[r.output_tokens for r in reqs],
                    allocators=len(e.allocators), dp=e.dp, whole=whole,
                    hits=e2.stats["prefix_hits"], more=rounds)

with open(os.path.join(out, f"w{world}_rank{rank}.pkl"), "wb") as fh:
    pickle.dump(res, fh)
dist.barrier()
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_world(out, world):
    """Start the worker in a gloo world of ``world`` processes."""
    src = out / f"worker{world}.py"
    src.write_text(WORKER % dict(cfgs=CFGS, max_len=MAX_LEN, bs=BS,
                                 engine_kw=ENGINE_KW, extras=EXTRAS))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               LOCAL_WORLD_SIZE="2")
    env.pop("JAX_PLATFORMS", None)
    port = str(_free_port())
    logs = [open(out / f"w{world}_{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(src), str(r), str(world),
                               port, str(out)], env=env, cwd=REPO,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    return out, procs, logs, time.monotonic() + JOIN_S


def _join_world(launched):
    """Every rank must exit 0 within JOIN_S seconds of its start; a rank
    still running then is killed and the world fails.  Returns each
    rank's results."""
    out, procs, logs, deadline = launched
    world = len(procs)
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(0.1, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            codes.append(None)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    for fh in logs:
        fh.close()
    if codes != [0] * world:
        tails = "\n".join((out / f"w{world}_{r}.log").read_text()[-3000:]
                          for r in range(world))
        pytest.fail(f"{world}-process world: exit codes {codes} (None: "
                    f"killed {JOIN_S} s after its start)\n{tails}")
    results = []
    for r in range(world):
        with open(out / f"w{world}_rank{r}.pkl", "rb") as fh:
            results.append(pickle.load(fh))
    return results


@pytest.fixture(scope="module")
def world2(worlds):
    return _join_world(worlds[2])


@pytest.fixture(scope="module")
def world4(worlds):
    return _join_world(worlds[4])


def _get(results, name, rank=0):
    r = results[rank][name]
    if isinstance(r, dict) and "error" in r:
        pytest.fail(f"rank {rank}, {name}:\n{r['error']}")
    return r


# -- (a) specs and shards -----------------------------------------------------


def _fake_mesh(data, model, rank):
    """A Mesh object for ``rank`` without a process group: shard_params
    reads only its shape, coordinates and device."""
    axes = {"model": Axis("model", model, rank % model, ()),
            "data": Axis("data", data, rank // model, ())}
    return Mesh(data, model, torch.device("cpu"), None, rank, axes)


def _leaves(tree, path=""):
    if tree is None:
        yield path, None
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else k)
    elif isinstance(tree, list):  # the layers; a spec (tuple) is a leaf
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("name", list(CFGS))
def test_param_pspecs_match_jax(jax_side, name):
    """The same spec tree as JAX's, a PartitionSpec read as a tuple; the
    tied model's lm_head passes through as None."""
    _, inputs, _ = jax_side
    jp = inputs["params"][name]
    want = dict(_leaves(JPar.param_pspecs(jp)))
    tp = params_from_numpy(jp, ModelConfig(**CFGS[name]), device="cpu")
    got = dict(_leaves(param_pspecs(tp)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == (None if want[k] is None else tuple(want[k])), k
    assert ("lm_head" in got and got["lm_head"] is None) == (name == "tied")


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("name", ["dense", "pc", "g128", "tied"])
def test_shard_params_bit_equal_to_jax(jax_side, name, shape):
    """Each rank's slices equal the addressable shard of JAX's
    ``shard_params`` on the device at the same mesh position."""
    _, inputs, _ = jax_side
    jp = inputs["params"][name]
    jmesh = JPar.make_mesh(*shape)
    jsh = JPar.shard_params(jax.tree.map(jnp.asarray, jp), jmesh)
    cfg = ModelConfig(**CFGS[name])
    full = params_from_numpy(jp, cfg, device="cpu")
    jleaves = dict(_leaves(jsh))
    for rank in range(shape[0] * shape[1]):
        dev = jmesh.devices[rank // shape[1], rank % shape[1]]
        mine = dict(_leaves(shard_params(full, _fake_mesh(*shape, rank))))
        assert mine.keys() == jleaves.keys()
        for k, x in mine.items():
            if x is None:
                assert jleaves[k] is None
                continue
            arr = next(s.data for s in jleaves[k].addressable_shards
                       if s.device == dev)
            assert np.array_equal(x.to(torch.float32).numpy(),
                                  np.asarray(arr).astype(np.float32)), \
                (rank, k)


def test_shard_params_refuses_a_cut_pack_block(jax_side):
    """K / model must keep whole 128-row pack blocks: the quantized
    model's o_proj (K 128) does not split over model = 4."""
    _, inputs, _ = jax_side
    full = params_from_numpy(inputs["params"]["pc"], ModelConfig(**CFG_Q),
                             device="cpu")
    with pytest.raises(ValueError, match="pack block"):
        shard_params(full, _fake_mesh(1, 4, 0))


# -- (b) TP forward ---------------------------------------------------------


@pytest.mark.parametrize("name,tol", [("dense", 2e-5), ("tied", 2e-5),
                                      ("pc", 2e-3), ("g128", 2e-3)])
def test_tp_forward_matches_jax(jax_side, world2, name, tol):
    ref = jax_side[2][f"fwd_{name}"]
    for rank in range(2):
        got = _get(world2, f"fwd_{name}", rank)
        np.testing.assert_allclose(got, ref, rtol=tol if tol < 1e-4 else 0,
                                   atol=tol)


def test_tp_forward_data_and_model_axes_match_jax(jax_side, world4):
    """mesh(2, 2): each rank returns its data rows of JAX's global
    logits."""
    ref = jax_side[2]["fwd_pc_22"]
    for rank in range(4):
        got = _get(world4, "fwd_pc_22", rank)
        rows = slice((rank // 2) * 2, (rank // 2) * 2 + 2)
        np.testing.assert_allclose(got, ref[rows], rtol=0, atol=2e-3)


@pytest.mark.parametrize("name", ["pc", "g128"])
def test_tp_forward_near_single_device(world2, name):
    single = _get(world2, f"single_{name}")
    got = _get(world2, f"fwd_{name}")
    np.testing.assert_allclose(got, single,
                               atol=0.05 * np.abs(single).max())


@pytest.mark.parametrize("mode", ["slot", "paged"])
def test_tp_prefill_then_decode_matches_jax(jax_side, world2, mode):
    ref = jax_side[2]
    for rank in range(2):
        pre, dec = _get(world2, mode, rank)
        np.testing.assert_allclose(pre, ref[f"{mode}_prefill"], rtol=0,
                                   atol=2e-3)
        np.testing.assert_allclose(dec, ref[f"{mode}_decode"], rtol=0,
                                   atol=2e-3)


# -- (c) sequence parallelism -------------------------------------------------


@pytest.mark.parametrize("key", ["sp", "ring"])
def test_sequence_parallel_matches_tp_and_jax(jax_side, world2, key):
    ref = jax_side[2]
    for rank in range(2):
        got = _get(world2, f"{key}_dense", rank)
        np.testing.assert_allclose(got, ref[f"{key}_dense"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got, _get(world2, "fwd_dense", rank),
                                   rtol=0, atol=1e-4)
        pre, dec = _get(world2, f"slot_{key}", rank)
        tp_pre, tp_dec = _get(world2, "slot", rank)
        np.testing.assert_allclose(pre, tp_pre, rtol=0, atol=1e-4)
        np.testing.assert_allclose(dec, tp_dec, rtol=0, atol=1e-4)


def test_sequence_parallel_needs_t_divisible(world2):
    for rank in range(2):
        assert "T % tp == 0" in _get(world2, "sp_raises", rank)


# -- (d) the overlapped decode ------------------------------------------------


def test_overlapped_decode_matches_plain_tp(world2):
    for rank in range(2):
        got, plain = _get(world2, "overlapped", rank)
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-4)


# -- (e) the sharded sampler -------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_sample_batched_sharded_bit_equal(world2, world4, world):
    """Tokens bit-equal to ``sample_batched`` with the same generator,
    greedy and temperature rows, a tie across the shards resolved to the
    lowest index, the data axis off (mesh(1, 2)) and on (mesh(2, 2)),
    and with replicated (tied) logits; the sharded log-probability within
    1e-6."""
    res = world2 if world == 2 else world4
    for rank in range(world):
        r = _get(res, "sampler", rank)
        assert np.array_equal(r["got"], r["want"])
        assert np.array_equal(r["rep"], r["rep_want"])
        np.testing.assert_allclose(r["lp"], r["lp_want"], rtol=0, atol=1e-6)
        assert r["greedy_tie"] == 3


# -- (f) Engine(mesh=make_mesh(1, 2)) -----------------------------------------

#: the stats JAX's engine tests compare
STATS = ("prefills", "prefill_tokens", "prefill_chunks", "generated_tokens",
         "decode_ticks", "preemptions", "prefix_hits")


def _single_engine(jax_side, rows, **kw):
    _, inputs, _ = jax_side
    p = params_from_numpy(inputs["params"]["dense"], ModelConfig(**CFG_D),
                          device="cpu")
    eng = Engine(p, ModelConfig(**CFG_D), dtype=torch.float32, device="cpu",
                 fuse=False, **{**ENGINE_KW, **kw})
    reqs = [Request(prompt_tokens=pr, sampling=SamplingParams(**r))
            for pr, r in zip(inputs["prompts"], rows)]
    eng.run(reqs)
    return reqs


@pytest.mark.parametrize("mode", ["slot", "paged"])
def test_engine_tp_mesh_matches_jax(jax_side, world2, mode):
    jt, jlp, jstats = jax_side[2][f"engine_{mode}"]
    r0 = _get(world2, f"engine_{mode}", 0)
    r1 = _get(world2, f"engine_{mode}", 1)
    assert r0["tokens"] == jt
    assert r1["tokens"] == r0["tokens"]
    assert r1["temp_tokens"] == r0["temp_tokens"]
    for a, b in zip(r0["logprobs"], jlp):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    for k in STATS:
        assert r0["stats"][k] == jstats[k], k
    assert r0["replays"] == 0  # the CPU never captures


@pytest.mark.parametrize("mode", ["slot", "paged"])
def test_engine_tp_mesh_sampled_matches_single_device(jax_side, world2, mode):
    """Unseeded temperature rows take the in-place sharded sampler, whose
    noise is the global field of the single-device sampler: equal tokens."""
    kw = dict(paged=True, block_size=BS) if mode == "paged" else {}
    rows = [dict(max_new_tokens=5, temperature=0.9)] * len(PROMPT_LENS)
    single = _single_engine(jax_side, rows, **kw)
    r0 = _get(world2, f"engine_{mode}", 0)
    assert r0["temp_tokens"] == [r.output_tokens for r in single]


# -- (g) Engine(mesh=make_mesh(2, 2)), paged, prefix cache --------------------


def test_engine_data_parallel_paged_prefix_cache(jax_side, world4):
    """Identical prompts on both data shards give one stream; two pools,
    each whole after the run; shared-prefix traffic hits the cache and
    keeps the single-device engine's greedy tokens."""
    _, inputs, _ = jax_side
    results = [_get(world4, "engine_dp", r) for r in range(4)]
    for r in results:
        assert r == results[0]
    r = results[0]
    assert r["dp"] == 2 and r["allocators"] == 2
    assert all(r["whole"])
    assert len({tuple(t) for t in r["tokens"]}) == 1
    shared = inputs["prompts"][1] + inputs["prompts"][3]
    more = [shared + [7, 8], shared + [9], shared + [7, 8], shared]
    p = params_from_numpy(inputs["params"]["dense"], ModelConfig(**CFG_D),
                          device="cpu")
    eng = Engine(p, ModelConfig(**CFG_D), dtype=torch.float32, device="cpu",
                 **{**ENGINE_KW, "paged": True, "block_size": BS,
                    "prefix_cache": True})
    for got in r["more"]:
        reqs = [Request(prompt_tokens=m, sampling=SamplingParams(
            max_new_tokens=6)) for m in more]
        eng.run(reqs)
        assert got == [q.output_tokens for q in reqs]
    assert r["hits"] == eng.stats["prefix_hits"] == 4


@pytest.mark.parametrize("name", list(EXTRAS))
@pytest.mark.parametrize("world", [2, 4])
def test_engine_mesh_scheduler_features(jax_side, world2, world4, world,
                                        name):
    """Chunked slot prefill (with a penalty: the gathered sampler),
    speculation (the verify under the mesh) and fused multi-step ticks
    (greedy and unseeded temperature rows: the sharded sampler, its noise
    drawn as the single-device engine draws it) give the single-device
    engine's tokens on mesh(1, 2) and on mesh(2, 2), every rank alike."""
    res = world2 if world == 2 else world4
    kw, rows = EXTRAS[name]
    _, inputs, _ = jax_side
    p = params_from_numpy(inputs["params"]["dense"], ModelConfig(**CFG_D),
                          device="cpu")
    eng = Engine(p, ModelConfig(**CFG_D), dtype=torch.float32, device="cpu",
                 **{**ENGINE_KW, **kw})
    reqs = [Request(prompt_tokens=m, sampling=SamplingParams(**r))
            for m, r in zip(inputs["prompts"], rows)]
    eng.run(reqs)
    got = [_get(res, "engine_extras", r)[name] for r in range(world)]
    assert all(g == got[0] for g in got)
    assert got[0]["tokens"] == [r.output_tokens for r in reqs]
    assert got[0]["ticks"] == eng.stats["decode_ticks"]
    if name == "spec":
        assert got[0]["spec_ticks"] == eng.stats["spec_ticks"] > 0


def test_hybrid_mesh_keeps_the_model_axis_in_a_host(world4):
    """Two hosts of two ranks (LOCAL_WORLD_SIZE=2): make_hybrid_mesh(2, 1,
    2) is make_mesh(2, 2) with each model group inside one host; a model
    axis wider than a host raises; the default backend on the CPU is
    gloo."""
    for rank in range(4):
        r = _get(world4, "hybrid", rank)
        assert tuple(r["coords"]) == (rank // 2, rank % 2)
        assert r["shape"] == {"data": 2, "model": 2}
        assert len({x // 2 for x in r["model_ranks"]}) == 1
        assert tuple(r["data_ranks"]) == (rank % 2, rank % 2 + 2)
        assert "must divide" in r["wide"]
        assert r["backend"] == "gloo"
