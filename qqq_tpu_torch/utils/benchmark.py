"""Device timer of the port (port of qqq_tpu/utils/benchmark.py).

A kernel launch costs microseconds of host time (Python, PyTorch's
dispatcher, the CUDA runtime), as much as many of the port's kernels take
on the card, so eager launches leave the card waiting on the host between
kernels and a host clock around them times the host.  Only a CUDA graph takes the
host out from between kernels.  ``measure_op`` therefore:

1. captures ``n`` iterations of the op in a CUDA graph and replays it; each
   iteration's f32 carry ``c`` both (a) perturbs an input (``perturb(args,
   c)``: no iteration is a copy of the one before) and (b) consumes
   ``max(out)`` (the op's output is used, and the iterations run in order);
2. reads the carry back to the host (``float(c)``), the fence, so a host
   clock around the replays is honest;
3. reports the slope between two iteration counts, which cancels the fixed
   cost of a run: the carry's reset, the graph launch and the fence.

A graph of ``n`` iterations holds ``n`` times the op's kernels and more:
the perturb's multiply, the ``max`` and the carry's adds are kernels of
their own on the card, where XLA fused them into the scan (a few µs an
iteration, in the result; time an identity op to see them).  So a graph
holds a block of at most as many iterations as the host dispatches
eagerly in ``BLOCK_HOST_S`` seconds (timed on one iteration before the
capture), and a run of ``n`` replays it ``n // k`` times, then a graph of
the ``n % k`` left over: exactly ``n`` iterations.  Each replay launches
its graph once more; the slope keeps that (one graph launch a block, a few
µs over its ``k`` iterations).

Every iteration reads the same buffers: a working set that fits the card's
50 MB L2 is read warm, not from HBM, as chip_smoke.py's
``Timer.device_ms`` reads it (its ``Timer.ms`` flushes the L2 before each
launch).  An op that cannot be captured (one that waits for the card or
branches on device data: ``.item()``, ``nonzero``, a host ``if`` on a
tensor) raises ``RuntimeError``, mostly before it is captured: the eager
iteration that sizes a block runs with PyTorch's synchronizing operations
made errors.  Nothing falls back to eager timing, which would time the
host's dispatch.  The capture calls the op's Python ``n``
times, so a kernel wrapper's ``launches`` count grows by ``n`` for the
capture and not at all for the replays.

On CPU tensors the same loop runs eagerly, timed by the host clock.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

#: host seconds of eager dispatch that one captured block may hold
BLOCK_HOST_S = 0.25


def _device(args) -> torch.device:
    for x in args:
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("no tensor in args: the op runs on the device of its "
                     "first tensor argument")


def _step(op: Callable, perturb: Callable, args, c: torch.Tensor):
    out = op(*perturb(args, c))
    return c + out.max().to(torch.float32) * 1e-30 + 1.0


def _uncapturable(e: BaseException) -> RuntimeError:
    return RuntimeError(
        "measure_op: the op cannot be captured in a CUDA graph (it waits for "
        f"the card or branches on device data); no eager timing is offered: "
        f"{e}")


def _capture(op: Callable, perturb: Callable, args, n: int,
             c: torch.Tensor):
    """[(graph, replays)] that together run ``n`` iterations from the
    carry in ``c`` and leave it there.  The op runs twice eagerly first:
    its first-call work, then once with PyTorch's synchronizing operations
    made errors (an op that waits for the card raises here, before any
    capture), timed on the host to size a block."""
    caller = torch.cuda.current_stream(c.device)
    stream = torch.cuda.Stream(c.device)
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        _step(op, perturb, args, c)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            _step(op, perturb, args, c)
            host = time.perf_counter() - t0
        except RuntimeError as e:
            raise _uncapturable(e) from e
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    caller.wait_stream(stream)
    k = max(1, min(n, int(BLOCK_HOST_S / max(host, 1e-9))))
    graphs = []
    for size, replays in ((k, n // k), (n % k, 1)):
        if not size:
            continue
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=stream):
                x = c
                for _ in range(size):
                    x = _step(op, perturb, args, x)
                c.copy_(x)
        except RuntimeError as e:
            # A capture that failed to end leaves the capture stream
            # current and the device's default generator in capture mode
            # (PyTorch ends that mode only on a capture that ends): restore
            # the stream, and give the generator a copy of its state.
            torch.cuda.set_stream(caller)
            gen = torch.cuda.default_generators[c.device.index]
            gen.graphsafe_set_state(gen.clone_state())
            # the op's own error, where ending the capture raised another
            raise _uncapturable(e.__context__ or e) from e
        graphs.append((graph, replays))
    return graphs


def _run_scan(op: Callable, perturb: Callable, args, n: int):
    """``run(args)`` → the f32 carry after ``n`` iterations; on the card
    the iterations are captured on the first call and replayed on its
    tensors at every call."""
    dev = _device(args)
    c = torch.zeros((), dtype=torch.float32, device=dev)
    if dev.type != "cuda":
        def run(args):
            x = c
            for _ in range(n):
                x = _step(op, perturb, args, x)
            return x

        return run
    graphs = []

    def run(args):
        if not graphs:
            graphs.extend(_capture(op, perturb, args, n, c))
        c.zero_()
        for graph, replays in graphs:
            for _ in range(replays):
                graph.replay()
        return c

    return run


def _perturb_first_float(args, c):
    """Multiplies the first floating tensor of ``args`` by ``(1 + 1e-30·c)``
    in its own dtype: 1 at every carry a run reaches, so the values stay
    as they are, but the input depends on the carry."""
    a = list(args)
    for i, x in enumerate(a):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            a[i] = x * (1 + 1e-30 * c).to(x.dtype)
            break
    else:
        raise ValueError("no float arg to perturb; pass perturb=")
    return tuple(a)


def measure_op(
    op: Callable,
    args: Sequence,
    perturb: Callable | None = None,
    target_secs: float = 0.3,
) -> float:
    """Seconds per execution of ``op(*args)`` on the args' device.

    ``perturb(args, c) -> args`` must make at least one input depend on the
    f32 scalar carry ``c`` (default: multiplies the first floating tensor
    by ``(1 + 1e-30·c)`` — numerically a no-op, structurally a data
    dependence).

    Iteration counts scale so that device work outweighs the fixed cost of
    a run: a pilot estimates the time of an iteration, then the final slope
    takes enough iterations to total about ``target_secs``.
    """
    if perturb is None:
        perturb = _perturb_first_float

    # pilot: slope between 8 and 64 iterations
    t8 = _best(_run_scan(op, perturb, args, 8), args, 2)
    t64 = _best(_run_scan(op, perturb, args, 64), args, 2)
    t_est = max((t64 - t8) / 56, 1e-7)

    n_hi = int(min(max(target_secs / t_est, 128), 20000))
    n_lo = max(n_hi // 8, 8)
    t_lo = _best(_run_scan(op, perturb, args, n_lo), args, 3)
    t_hi = _best(_run_scan(op, perturb, args, n_hi), args, 3)
    return max((t_hi - t_lo) / (n_hi - n_lo), 1e-9)


def _best(run, args, reps: int) -> float:
    float(run(args))  # capture (on the card) + warm
    return min(_timed(run, args) for _ in range(reps))


def _timed(run, args) -> float:
    t0 = time.perf_counter()
    float(run(args))  # reading the carry back is the fence
    return time.perf_counter() - t0
