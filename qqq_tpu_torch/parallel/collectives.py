"""Every collective the port makes, in one place (the counterparts of the
``jax.lax`` collectives that qqq_tpu runs inside ``shard_map``).

The port is multi-controller: one process a rank, each holding its shard,
each calling these functions in the same order.  A function takes the
:class:`Axis` it reduces over (``mesh.axis("model")`` or
``mesh.axis("data")``) and is the identity on an axis of size 1, where it
launches nothing.

==============  =============================================  ============
function        JAX                                            torch
==============  =============================================  ============
:func:`psum`    ``lax.psum``                                   ``all_reduce`` SUM, in the tensor's own dtype
:func:`pmax`    ``lax.pmax``                                   ``all_reduce`` MAX
:func:`pmin`    ``lax.pmin``                                   ``all_reduce`` MIN
:func:`all_gather`   ``lax.all_gather(axis, tiled)``           ``all_gather_into_tensor``
:func:`psum_scatter` ``lax.psum_scatter(dimension, tiled)``    ``reduce_scatter_tensor``
:func:`ppermute`     ``lax.ppermute`` over the ring i → i + 1  ``batch_isend_irecv``
==============  =============================================  ============

**Transport.**  Under ``nccl`` every collective runs on the card and no
tensor leaves it.  Under ``gloo`` a CPU tensor goes to gloo as it is; a
card tensor goes to gloo as it is only for the operations in
:data:`GLOO_DEVICE_OPS`, and for every other operation it is copied to
host memory, the collective runs there, and the result is copied back
(host-staged).  The split is the table below, fixed from what gloo took on
an H100 (``scripts/probe_collectives.py``), and is chosen from the
backend when the mesh is built (:attr:`Axis.host_ops`), never by catching
an exception: a collective that fails raises.  ``chip_smoke.py`` prints
the table of each backend it runs.

``psum``, ``pmax`` and ``pmin`` reduce in place: the caller passes a
tensor it owns (a GEMM's fresh output) and gets the same tensor back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

#: the collectives, by the names the transport table uses
OPS = ("all_reduce", "all_gather", "reduce_scatter", "send_recv")

#: the collectives that gloo runs on card tensors itself: all-reduce,
#: all-gather and reduce-scatter gave the right values in bf16, f32 and
#: int32 on an H100 (torch 2.11.0+cu128, scripts/probe_collectives.py),
#: also when a long kernel chain writes the input just before the call and
#: a kernel reads the output just after it; its send and receive aborted
#: the process (a card pointer written to the socket as host memory), so
#: the ring's batch_isend_irecv is host-staged
GLOO_DEVICE_OPS = frozenset({"all_reduce", "all_gather", "reduce_scatter"})


def host_ops(backend: Optional[str], device: torch.device) -> frozenset:
    """The operations staged through host memory for ``backend`` on
    ``device``: none under nccl or on the CPU, under gloo on the card those
    outside :data:`GLOO_DEVICE_OPS`."""
    if backend == "gloo" and device.type == "cuda":
        return frozenset(OPS) - GLOO_DEVICE_OPS
    return frozenset()


@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One named axis of a mesh as this rank sees it: its size, this rank's
    coordinate on it, the global ranks along it in axis order, its process
    group (None when the size is 1) and the operations that are
    host-staged on it."""
    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Optional[object] = None
    host_ops: frozenset = frozenset()

    def transport(self) -> dict:
        """{operation: "device" | "host"} on a card tensor."""
        return {op: "host" if op in self.host_ops else "device"
                for op in OPS}


def _staged(op: str, x: torch.Tensor, axis: Axis) -> bool:
    return x.is_cuda and op in axis.host_ops


def _all_reduce(x: torch.Tensor, axis: Axis, op, async_op: bool):
    if axis.size == 1:
        return _Done(x) if async_op else x
    if not x.is_contiguous():
        raise ValueError("all_reduce: the tensor must be contiguous")
    if _staged("all_reduce", x, axis):
        h = x.cpu()
        dist.all_reduce(h, op=op, group=axis.group)
        x.copy_(h)
        return _Done(x) if async_op else x
    if async_op:
        return _Pending(dist.all_reduce(x, op=op, group=axis.group,
                                        async_op=True), x)
    dist.all_reduce(x, op=op, group=axis.group)
    return x


def psum(x: torch.Tensor, axis: Axis, async_op: bool = False):
    """Sum over ``axis`` in ``x``'s dtype, in place.  With ``async_op`` the
    reduction is issued and a handle returned whose ``wait()`` gives the
    sum (under nccl it then runs while the caller's next kernels do)."""
    return _all_reduce(x, axis, dist.ReduceOp.SUM, async_op)


def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _all_reduce(x, axis, dist.ReduceOp.MAX, False)


def pmin(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _all_reduce(x, axis, dist.ReduceOp.MIN, False)


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """The shards of every rank along ``axis``, in axis order: concatenated
    along ``dim`` (``tiled``) or stacked in a new dimension ``dim``."""
    if not tiled:
        return all_gather(x.unsqueeze(dim), axis, dim, tiled=True)
    if axis.size == 1:
        return x
    dim = dim % x.dim()
    xt = x.movedim(dim, 0).contiguous()
    host = _staged("all_gather", xt, axis)
    src = xt.cpu() if host else xt
    out = src.new_empty((axis.size * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=axis.group)
    if host:
        out = out.to(x.device)
    return out.movedim(0, dim)


def psum_scatter(x: torch.Tensor, axis: Axis, dim: int = 0,
                 tiled: bool = True) -> torch.Tensor:
    """Sum over ``axis``, this rank keeping its slice along ``dim`` (the
    ``index``-th of ``size`` equal parts; without ``tiled`` the dim has
    size ``size`` and is dropped)."""
    if not tiled:
        if x.shape[dim] != axis.size:
            raise ValueError(f"psum_scatter: dim {dim} has {x.shape[dim]} "
                             f"entries, the axis {axis.size}")
        return psum_scatter(x, axis, dim, tiled=True).squeeze(dim)
    dim = dim % x.dim()
    if x.shape[dim] % axis.size:
        raise ValueError(f"psum_scatter: dim {dim} of {x.shape[dim]} does "
                         f"not split over {axis.size}")
    if axis.size == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    host = _staged("reduce_scatter", xt, axis)
    src = xt.cpu() if host else xt
    out = src.new_empty((src.shape[0] // axis.size, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=axis.group)
    if host:
        out = out.to(x.device)
    return out.movedim(0, dim)


def ppermute(x: torch.Tensor, axis: Axis, async_op: bool = False):
    """Ring shift over ``axis``: this rank sends ``x`` to coordinate
    ``index + 1`` and receives coordinate ``index - 1``'s (JAX's
    ``perm=[(i, (i + 1) % n)]``).  With ``async_op`` the send and receive
    are issued and a handle returned whose ``wait()`` gives the received
    tensor."""
    if axis.size == 1:
        return _Done(x) if async_op else x
    nxt = axis.ranks[(axis.index + 1) % axis.size]
    prv = axis.ranks[(axis.index - 1) % axis.size]
    host = _staged("send_recv", x, axis)
    src = x.contiguous().cpu() if host else x.contiguous()
    recv = torch.empty_like(src)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, nxt, group=axis.group),
        dist.P2POp(dist.irecv, recv, prv, group=axis.group),
    ])
    if host:
        for w in works:
            w.wait()
        out = recv.to(x.device)
        return _Done(out) if async_op else out
    pending = _Pending(works, recv)
    return pending if async_op else pending.wait()


class _Pending:
    """An issued collective: ``wait()`` makes the caller's stream wait for
    it and returns its result."""

    def __init__(self, works, result: torch.Tensor):
        self.works = works if isinstance(works, list) else [works]
        self.result = result

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        return self.result


class _Done(_Pending):
    """A collective that completed when it was issued (size 1, or
    host-staged)."""

    def __init__(self, result: torch.Tensor):
        super().__init__([], result)
