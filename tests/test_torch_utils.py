"""Port (qqq_tpu_torch) against the JAX package: the device timer
(utils/benchmark.py: ``measure_op``), the single-config sampler and the
sampling planes (serve/sampling.py: ``sample``, ``sampling_arrays``), and
the package surface (every name a ``qqq_tpu`` package exports).

* The timer's iteration schedule: ``_run_scan`` and ``_best`` patched on
  both sides to record each count and return the same fake times; the
  counts, repetitions and returned seconds must be equal.  Nothing is
  jitted or timed there.
* Its contract on CPU tensors (the eager loop, host clock): finite,
  positive seconds; ``ValueError`` without a float argument on both sides;
  the default perturb leaves f32 and bf16 outputs bit-equal (and equal to
  JAX's perturb) up to the largest carry a run reaches, 20000; a custom
  perturb runs once an iteration.
* The sampler: ``sampling_arrays`` equal to JAX's; greedy ``sample`` equal
  to JAX's (argmax) bit for bit; JAX's four configs give (B,) int32 tokens
  in range.
* The surface, read from ``qqq_tpu``'s ``__init__.py`` files with ``ast``
  (no JAX module is imported for it); importing the port's packages builds
  no kernel and needs no ``nvcc``.

Card tests of ``measure_op`` (the captured graph) are in
tests/test_torch_cuda.py.
"""

import ast
import importlib
import math
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qqq_tpu.utils.benchmark as jbench
import qqq_tpu_torch.utils.benchmark as tbench
from qqq_tpu.serve import sampling as jsamp
from qqq_tpu_torch.serve import sampling as tsamp

REPO = pathlib.Path(__file__).resolve().parents[1]

# -- measure_op: the iteration schedule --------------------------------------


def _schedule(mod, monkeypatch, times):
    """Patch ``mod``'s ``_run_scan`` and ``_best``: each scan is its
    count, and ``_best`` returns the next (fixed, per-iteration) cost of
    ``times`` at that count.  Returns the list that collects (n, reps) of
    each ``_best`` call and the one that collects the perturbs handed to
    ``_run_scan``."""
    calls, perturbs = [], []
    fake = iter(times)

    def run_scan(op, perturb, args, n):
        perturbs.append(perturb)
        return n

    def best(run, args, reps):
        calls.append((run, reps))
        base, per_iter = next(fake)
        return base + run * per_iter

    monkeypatch.setattr(mod, "_run_scan", run_scan)
    monkeypatch.setattr(mod, "_best", best)
    return calls, perturbs


@pytest.mark.parametrize("per_iter", [1e-9, 2e-6, 3e-5, 4e-3, 0.05])
@pytest.mark.parametrize("target_secs", [0.02, 0.3, 2.0])
def test_measure_op_schedule_matches_jax(monkeypatch, per_iter, target_secs):
    rng = np.random.default_rng(int(per_iter * 1e9) % 1000)
    # a fixed cost with noise around the linear cost, which can make a
    # pilot slope or the final slope negative (both sides clamp it)
    times = [(float(rng.uniform(0.0, 0.02)),
              per_iter * float(rng.uniform(0.5, 1.5))) for _ in range(4)]
    out = {}
    for name, mod in (("jax", jbench), ("torch", tbench)):
        calls, _ = _schedule(mod, monkeypatch, times)
        secs = mod.measure_op(lambda x: x, (None,), target_secs=target_secs)
        out[name] = (calls, secs)
        monkeypatch.undo()
    assert out["torch"] == out["jax"]
    calls = out["torch"][0]
    assert [n for n, _ in calls[:2]] == [8, 64]
    assert [r for _, r in calls] == [2, 2, 3, 3]
    assert 128 <= calls[3][0] <= 20000
    assert math.isfinite(out["torch"][1]) and out["torch"][1] >= 1e-9


# -- measure_op: the contract on CPU tensors ---------------------------------


def test_measure_op_seconds_on_cpu():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn((64, 64), generator=g), torch.randn((64, 64),
                                                          generator=g)
    secs = tbench.measure_op(torch.matmul, (a, b), target_secs=0.02)
    assert math.isfinite(secs) and secs > 0


def test_measure_op_needs_a_float_arg():
    with pytest.raises(ValueError, match="no float arg to perturb"):
        jbench.measure_op(lambda x: x + 1, (jnp.zeros((4,), jnp.int8),))
    with pytest.raises(ValueError, match="no float arg to perturb"):
        tbench.measure_op(lambda x: x + 1, (torch.zeros(4, dtype=torch.int8),))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_default_perturb_keeps_values(monkeypatch, dtype):
    """The default perturb at carries 0 .. 20000 (the most a run reaches):
    the op's output bit-equal to the unperturbed one's, and the perturbed
    input equal to JAX's default perturb's on the same bits."""
    rng = np.random.default_rng(1)
    x32 = rng.normal(size=(8, 32)).astype(np.float32)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(x32).to(tdt)
    tw = torch.from_numpy(w).to(tdt)
    idx = torch.zeros(3, dtype=torch.int32)  # not float: left alone

    def op(i, x, w):
        return x @ w

    _, jperturbs = _schedule(jbench, monkeypatch, [(0.0, 1e-6)] * 4)
    jbench.measure_op(op, (None,))
    jperturb = jperturbs[0]
    monkeypatch.undo()
    jx = jnp.asarray(x32).astype(getattr(jnp, dtype))
    jidx = jnp.zeros((3,), jnp.int32)
    ref = op(idx, x, tw)
    for c in (0.0, 1.0, 8.0, 64.0, 12345.0, 20000.0):
        args = tbench._perturb_first_float(
            (idx, x, tw), torch.tensor(c, dtype=torch.float32))
        assert args[0] is idx and args[2] is tw
        assert torch.equal(args[1], x)
        assert torch.equal(op(*args), ref)
        jargs = jperturb((jidx, jx), jnp.float32(c))
        np.testing.assert_array_equal(
            np.asarray(jargs[1].astype(jnp.float32)),
            args[1].float().numpy())


def test_custom_perturb_runs_every_iteration(monkeypatch):
    counts, calls = [], []
    scan = tbench._run_scan

    def spy(op, perturb, args, n):
        counts.append(n)
        return scan(op, perturb, args, n)

    def best(run, args, reps):
        calls.append(reps)
        return tbench_best(run, args, reps)

    tbench_best = tbench._best
    monkeypatch.setattr(tbench, "_run_scan", spy)
    monkeypatch.setattr(tbench, "_best", best)
    seen = []

    def perturb(args, c):
        seen.append(float(c))
        return (args[0] + c * 0,)

    secs = tbench.measure_op(torch.relu, (torch.ones(16),), perturb=perturb,
                             target_secs=0.005)
    assert math.isfinite(secs) and secs > 0
    # each run: the warm call and ``reps`` timed calls of n iterations,
    # each starting from carry 0 and adding about 1 an iteration
    assert len(seen) == sum(n * (r + 1) for n, r in zip(counts, calls))
    assert seen[:3] == [0.0, 1.0, 2.0]


@pytest.mark.parametrize("n", [8, 37])
def test_cpu_scan_runs_n_iterations(n):
    """The carry adds 1 (and max(out)·1e-30) an iteration."""
    x = torch.ones(16)
    run = tbench._run_scan(torch.relu, tbench._perturb_first_float, (x,), n)
    assert float(run((x,))) == n
    assert float(run((x,))) == n  # each run starts from carry 0


# -- the sampler --------------------------------------------------------------

_ROWS = [
    jsamp.SamplingParams(temperature=0.8, top_k=10, top_p=0.9, min_p=0.05),
    None,
    jsamp.SamplingParams(temperature=1.0, top_p=0.5),
    jsamp.SamplingParams(),
]


def _port_params(sp):
    if sp is None:
        return None
    return tsamp.SamplingParams(temperature=sp.temperature, top_k=sp.top_k,
                                top_p=sp.top_p, min_p=sp.min_p)


@pytest.mark.parametrize("n", [None, 2, 4, 7])
def test_sampling_arrays_match_jax(n):
    j = jsamp.sampling_arrays(_ROWS, n)
    t = tsamp.sampling_arrays([_port_params(sp) for sp in _ROWS], n)
    assert len(t) == 4
    for a, b in zip(j, t):
        assert isinstance(b, np.ndarray)
        assert b.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b, np.asarray(a))


def test_greedy_sample_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(4, 50)).astype(np.float32)
    j = jsamp.sample(jnp.asarray(logits), jax.random.PRNGKey(1),
                     jsamp.SamplingParams())
    t = tsamp.sample(torch.from_numpy(logits),
                     torch.Generator().manual_seed(1), tsamp.SamplingParams())
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("sp", [
    dict(temperature=0.0),
    dict(temperature=0.8, top_k=10),
    dict(temperature=1.0, top_p=0.9),
    dict(temperature=0.7, top_k=5, top_p=0.8),
])
def test_sample_configs_shapes(sp):
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(3, 50)).astype(np.float32))
    toks = tsamp.sample(logits, torch.Generator().manual_seed(0),
                        tsamp.SamplingParams(**sp))
    assert toks.shape == (3,)
    assert toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 50


# -- the package surface ------------------------------------------------------


def _exports(init: pathlib.Path):
    names = []
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [a.asname or a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return names


_INITS = sorted((REPO / "qqq_tpu").glob("*/__init__.py"))


@pytest.mark.parametrize("init", _INITS + [REPO / "qqq_tpu" / "__init__.py"],
                         ids=lambda p: p.parent.name)
def test_port_exports_every_name(init):
    sub = init.parent.relative_to(REPO / "qqq_tpu").as_posix()
    mod = importlib.import_module(
        "qqq_tpu_torch" + ("" if sub == "." else "." + sub))
    missing = [n for n in _exports(init) if not hasattr(mod, n)]
    assert not missing, (mod.__name__, missing)


def test_kernels_w4a8_gemm_is_the_gemm():
    """``qqq_tpu_torch.kernels.w4a8_gemm`` is the module and, called, the
    GEMM, whose output equals JAX's ``qqq_tpu.kernels.w4a8_gemm``'s (per
    channel, bit for bit)."""
    from qqq_tpu import kernels as jk
    from qqq_tpu_torch import kernels as tk
    from qqq_tpu_torch.core.packing import pack_int4

    assert "KERNEL_WRAPPERS" in dir(tk.w4a8_gemm)
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, (4, 128)).astype(np.int8)
    s_tok = rng.uniform(1e-3, 0.05, (4, 1)).astype(np.float32)
    codes = rng.integers(-8, 8, (128, 128)).astype(np.int8)
    s_ch = rng.uniform(1e-4, 1e-2, (128,)).astype(np.float32)
    w = pack_int4(torch.from_numpy(codes))
    t = tk.w4a8_gemm(torch.from_numpy(a), torch.from_numpy(s_tok), w,
                     torch.from_numpy(s_ch))
    assert torch.equal(t, tk.w4a8_gemm.w4a8_gemm(
        torch.from_numpy(a), torch.from_numpy(s_tok), w,
        torch.from_numpy(s_ch)))
    j = jk.w4a8_gemm(jnp.asarray(a), jnp.asarray(s_tok),
                     jnp.asarray(w.numpy()), jnp.asarray(s_ch))
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))


def test_import_builds_nothing():
    code = ("import sys, qqq_tpu_torch, qqq_tpu_torch.kernels, "
            "qqq_tpu_torch.serve, qqq_tpu_torch.utils; "
            "from qqq_tpu_torch.kernels import build; "
            "assert build.load.cache_info().currsize == 0; "
            "assert 'triton' not in sys.modules; "
            "assert not [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'qqq_tpu.'))]")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env.update(PYTHONPATH=str(REPO), PATH="/usr/bin:/bin")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)
