#!/usr/bin/env python3
"""Which collectives each torch.distributed backend takes on card tensors.

    python3 scripts/probe_collectives.py [--device cuda|cpu] [--world 2]

Two parts, each printed as one JSON line:

* ``gloo``: for each collective that ``qqq_tpu_torch/parallel/collectives.py``
  makes, in each dtype the port sends, a gloo world of ``--world``
  processes (default 2) of its own, sharing the one card (every rank on
  ``cuda:0``), tries it natively on tensors of ``--device``: the result is
  "ok", "wrong" (it ran and gave another answer), the error's first line,
  or "crashed" (a rank died: gloo has been seen to abort the process,
  sending a card pointer as host memory) or "timeout".  Worlds run
  ``--parallel`` at a time.  This is the evidence for the module's table
  of host-staged operations (``GLOO_DEVICE_OPS``); the module itself never
  probes.
* ``nccl``: in this process, an NCCL world of one rank: an eager
  ``all_reduce``, the same call captured in a CUDA graph and replayed, and
  the CUDA kernels ``torch.profiler`` sees in one eager call (what a graph
  of a world of one holds).  Skipped with ``--device cpu``.

Every child is joined with a timeout; a child that hangs is killed and
reported as "timeout".
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import sys
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "i32": torch.int32}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cases(rank: int, world: int, dev):
    """(name, thunk) pairs; each thunk runs the collective and returns
    True when the result is the expected one."""

    def full(v, dtype, n=8):
        return torch.full((n,), v, dtype=dtype, device=dev)

    cases = []
    for dn, dt in DTYPES.items():
        def ar(dt=dt, op=dist.ReduceOp.SUM, want=None):
            t = full(rank + 1, dt)
            dist.all_reduce(t, op=op)
            return bool((t == want).all())

        tot = world * (world + 1) // 2
        cases.append((f"all_reduce_sum_{dn}", lambda dt=dt, tot=tot:
                      ar(dt, dist.ReduceOp.SUM, tot)))
        cases.append((f"all_reduce_max_{dn}", lambda dt=dt:
                      ar(dt, dist.ReduceOp.MAX, world)))
        cases.append((f"all_reduce_min_{dn}", lambda dt=dt:
                      ar(dt, dist.ReduceOp.MIN, 1)))

        def agt(dt=dt):
            src = full(rank, dt, 4)
            out = torch.empty((4 * world,), dtype=dt, device=dev)
            dist.all_gather_into_tensor(out, src)
            want = torch.arange(world, device=dev).repeat_interleave(4)
            return bool((out == want.to(dt)).all())

        def rst(dt=dt):
            src = torch.arange(4 * world, device=dev).to(dt)
            out = torch.empty((4,), dtype=dt, device=dev)
            dist.reduce_scatter_tensor(out, src)
            want = (torch.arange(4 * rank, 4 * rank + 4, device=dev)
                    * world).to(dt)
            return bool((out == want).all())

        def agl(dt=dt):
            src = full(rank, dt, 4)
            outs = [torch.empty_like(src) for _ in range(world)]
            dist.all_gather(outs, src)
            return all(bool((o == i).all()) for i, o in enumerate(outs))

        def bc(dt=dt):
            t = full(rank + 5, dt)
            dist.broadcast(t, src=0)
            return bool((t == 5).all())

        cases += [(f"all_gather_into_tensor_{dn}", agt),
                  (f"reduce_scatter_tensor_{dn}", rst),
                  (f"all_gather_list_{dn}", agl),
                  (f"broadcast_{dn}", bc)]

    # the result read right after the call, as a model reads it: a large
    # product writes the input just before the collective and another
    # reads the output just after, 50 times over fresh values
    def stream_order(op):
        def run():
            w = torch.randn((4096, 4096), device=dev)
            ok = True
            for i in range(50):
                x = torch.full((8, 4096), float(i + rank), device=dev)
                x = (x @ w) @ w.T  # a long producer kernel chain
                want = x.cpu()
                parts = [torch.empty_like(want) for _ in range(world)]
                dist.all_gather(parts, want)  # host tensors: the truth
                if op == "all_gather":
                    out = torch.empty((8 * world, 4096), device=dev)
                    dist.all_gather_into_tensor(out, x)
                    got, want = (out * 1.0).cpu(), torch.cat(parts)
                else:
                    dist.all_reduce(x)
                    got, want = (x * 1.0).cpu(), sum(parts[1:], parts[0])
                ok &= bool(torch.allclose(got, want, rtol=1e-3, atol=1e-3))
            return ok
        return run

    if dev.type == "cuda":
        cases += [("stream_order_all_gather", stream_order("all_gather")),
                  ("stream_order_all_reduce", stream_order("all_reduce"))]
    for dn, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        def ring(dt=dt):
            send = full(rank, dt)
            recv = torch.empty_like(send)
            ops = [dist.P2POp(dist.isend, send, (rank + 1) % world),
                   dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            return bool((recv == (rank - 1) % world).all())

        cases.append((f"batch_isend_irecv_{dn}", ring))
    return cases


def _child(rank, world, port, device, names, q):
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=30))
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        res = {}
        for name, fn in _cases(rank, world, dev):
            if name not in names:
                continue
            dist.barrier()
            try:
                res[name] = "ok" if fn() else "wrong"
                if dev.type == "cuda":
                    torch.cuda.synchronize()
            except Exception as e:  # noqa: BLE001 — the probe's answer
                res[name] = f"{type(e).__name__}: " + str(e).splitlines()[0]
        q.put((rank, res))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001
        q.put((rank, {"fatal": traceback.format_exc()}))


def _world(world: int, device: str, names, ctx):
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child,
                         args=(r, world, port, device, names, q))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, q


def _finish(procs, q, names, timeout: float):
    """Each rank's results, the queue drained before the ranks are joined;
    a rank that died or hung gives "crashed" or "timeout" for the world."""
    import queue
    import time

    out = {}
    deadline = time.monotonic() + timeout
    while len(out) < len(procs) and time.monotonic() < deadline:
        try:
            rank, res = q.get(timeout=1.0)
            out[rank] = res
        except queue.Empty:
            if all(p.exitcode is not None for p in procs):
                break  # every rank ended; what they sent is in out
    for p in procs:
        p.join(timeout=max(0.1, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()
    if len(out) < len(procs):
        why = ("crashed" if any(p.exitcode not in (0, -9) for p in procs)
               else "timeout")
        return {n: why for n in names}
    merged = {}
    for n in names:
        vals = {r[n] for r in out.values() if n in r}
        merged[n] = vals.pop() if len(vals) == 1 else sorted(vals)
    if any("fatal" in r for r in out.values()):
        merged["fatal"] = [r["fatal"] for r in out.values() if "fatal" in r]
    return merged


def probe_gloo(world: int, device: str, parallel: int = 6,
               timeout: float = 90.0):
    """Each case in a world of its own, ``parallel`` worlds at a time."""
    ctx = mp.get_context("spawn")
    names = [n for n, _ in _cases(0, world, torch.device(device))]
    out = {}
    for i in range(0, len(names), parallel):
        batch = [(n, *_world(world, device, [n], ctx))
                 for n in names[i:i + parallel]]
        for n, procs, q in batch:
            out.update(_finish(procs, q, [n], timeout))
    return out


def probe_nccl():
    """An NCCL world of one rank: eager, captured, and what it launches."""
    os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    dev = torch.device("cuda", 0)
    t = torch.arange(8, dtype=torch.bfloat16, device=dev)
    res = {}
    dist.all_reduce(t)
    torch.cuda.synchronize()
    res["eager"] = bool((t == torch.arange(8, device=dev)).all())
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dist.all_reduce(t)
        torch.cuda.synchronize()
    res["kernels_of_one_call"] = sorted({
        e.key for e in prof.key_averages()
        if getattr(e, "device_type", None) is not None
        and "CUDA" in str(e.device_type)})
    try:
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            for _ in range(2):
                t.mul_(1)
                dist.all_reduce(t)
        torch.cuda.current_stream().wait_stream(s)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            t.add_(1)
            dist.all_reduce(t)
        before = t.clone()
        g.replay()
        torch.cuda.synchronize()
        res["captured"] = bool((t == before + 1).all())
    except Exception as e:  # noqa: BLE001 — the probe's answer
        res["captured"] = f"{type(e).__name__}: " + str(e).splitlines()[0]
    dist.destroy_process_group()
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--parallel", type=int, default=6)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_collectives: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    gl = probe_gloo(args.world, args.device, args.parallel)
    print(json.dumps({"gloo": gl}), flush=True)
    if args.device == "cuda":
        print(json.dumps({"nccl_world_1": probe_nccl()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
