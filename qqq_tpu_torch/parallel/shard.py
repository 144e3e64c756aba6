"""Megatron-style tensor × data parallelism for the quantized model (port of
qqq_tpu/parallel/shard.py) over ``torch.distributed``.

JAX runs one controller over a ``Mesh`` of devices and ``shard_map``s the
model; the port runs one process a rank (``torchrun``, or any launcher that
sets the rank and world size), each holding its shard and calling explicit
collectives (parallel/collectives.py).  The layout is JAX's:

* q/k/v, gate/up and the lm_head (column-parallel): the output dim N on
  the ``model`` axis — ``w_packed (K//8, N)`` → ``(None, "model")``, the
  scales and bias follow N;
* o_proj, down (row-parallel): the input dim K on ``model`` —
  ``w_packed`` → ``("model", None)``, g128 ``s_group`` → ``("model",
  None)``, ``s_channel`` and bias replicated; the partial products are
  summed in the model (models/llama.py ``_row_parallel``);
* embed and norms replicated; the vocab-sharded logits are gathered unless
  the caller samples them sharded (serve/sampling.py);
* KV caches: batch on ``data``, kv heads on ``model``.

A spec is a tuple of axis names (or None) per dimension, the port's ``P``,
equal to JAX's ``PartitionSpec`` read as a tuple.

Rank ``r`` of a ``data × model`` mesh sits at (``r // model``, ``r %
model``), JAX's row-major device order, so a ``model`` group is ``model``
consecutive ranks: with torchrun's host-major ranks it stays inside a host
(:func:`make_hybrid_mesh`).  Several ranks may share one card (the device
defaults to ``cuda:{local_rank % device_count}``); NCCL refuses two ranks
on one card, gloo takes them, host-staging what it cannot run on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from qqq_tpu_torch.models.config import ModelConfig
from qqq_tpu_torch.parallel.collectives import Axis, host_ops
from qqq_tpu_torch.utils.device import resolve_device


def P(*names) -> tuple:
    """A partition spec: one axis name (or None, replicated) a dimension."""
    return tuple(names)


class Mesh:
    """This rank's view of a ``data × model`` mesh: ``axis_names``,
    ``shape`` ({axis: size}, as JAX's), ``devices`` (the (data, model)
    array of global ranks, JAX's ``mesh.devices`` with ranks for devices),
    this rank's ``coords``, one :class:`Axis` (process group) per axis, the
    torch ``device`` it computes on and the ``backend``."""

    axis_names = ("data", "model")

    def __init__(self, data: int, model: int, device: torch.device,
                 backend: Optional[str], rank: int,
                 axes: Dict[str, Axis]):
        self.shape = {"data": data, "model": model}
        self.devices = np.arange(data * model).reshape(data, model)
        self.device = device
        self.backend = backend
        self.rank = rank
        self.coords = (rank // model, rank % model)
        self._axes = axes

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    def with_device(self, device) -> "Mesh":
        """The same ranks, groups and backend computing on ``device``: the
        CPU twin of a card mesh, for a reference run of the plain versions
        (the collectives take CPU tensors as they are)."""
        device = resolve_device(device)
        axes = {k: dataclasses.replace(a, host_ops=host_ops(self.backend,
                                                            device))
                for k, a in self._axes.items()}
        return Mesh(self.shape["data"], self.shape["model"], device,
                    self.backend, self.rank, axes)

    def transport(self) -> Dict[str, str]:
        """{collective: "device" | "host"} for card tensors (the model
        axis's and the data axis's are the same table)."""
        return self._axes["model"].transport()

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model="
                f"{self.shape['model']}, rank={self.rank}, device="
                f"{self.device}, backend={self.backend})")


def initialize_distributed(*, backend: Optional[str] = None, device=None,
                           **kw) -> None:
    """Join the process group: call once per process before building a
    mesh (JAX: ``jax.distributed.initialize``).  Reads torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``) unless ``init_method``, ``rank`` and ``world_size``
    are given.  ``backend`` defaults to ``nccl`` on the card and ``gloo``
    when ``device="cpu"``."""
    if backend is None:
        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend=backend, **kw)


def make_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A ``data × model`` mesh over every rank of the process group
    (``data · model`` must equal the world size).  ``device``: this rank's
    device; by default ``cuda:{local_rank % device_count}``, so ranks may
    share a card; ``"cpu"`` computes on the CPU (the plain versions).  A
    single process with no process group gets a 1 × 1 mesh with no
    collectives."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh ({data}, {model})")
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        rank, world, backend = 0, 1, None
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks, the process group has {world}")
    if device is None:
        resolve_device(None)  # raises without a card
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    staged = host_ops(backend, device)
    d0, m0 = rank // model, rank % model
    axes: Dict[str, Axis] = {}
    # every rank creates every group, in one order (new_group's contract)
    model_rows = [tuple(d * model + m for m in range(model))
                  for d in range(data)]
    data_cols = [tuple(d * model + m for d in range(data))
                 for m in range(model)]
    for name, lines, idx, mine in (("model", model_rows, m0, d0),
                                   ("data", data_cols, d0, m0)):
        group = None
        for i, ranks in enumerate(lines):
            g = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if i == mine:
                group = g
        axes[name] = Axis(name, len(lines[mine]), idx, lines[mine], group,
                          staged)
    return Mesh(data, model, device, backend, rank, axes)


def make_hybrid_mesh(dcn_data: int = 1, ici_data: int = 1,
                     ici_model: int = 1, device=None) -> Mesh:
    """Multi-host mesh: data-parallel replicas across hosts, the model axis
    (and optional extra data parallelism) within each host, so that the
    per-token all-reduces of the row-parallel linears never leave a host.
    Ranks are host-major (torchrun), so this is :func:`make_mesh` of
    (``dcn_data · ici_data``, ``ici_model``) once ``ici_model`` divides
    the ranks of a host (``LOCAL_WORLD_SIZE``); on one host it is exactly
    that, as JAX's degrades to a reshape.

    Example (Llama-2-70B on 2 hosts × 8 cards, ``torchrun --nnodes 2
    --nproc-per-node 8``): ``initialize_distributed(); mesh =
    make_hybrid_mesh(2, 1, 8)``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local % ici_model or world % local:
        raise ValueError(f"ici_model {ici_model} must divide the "
                         f"{local} ranks of a host")
    if dcn_data * ici_data * ici_model != world:
        raise ValueError(f"a ({dcn_data}, {ici_data}, {ici_model}) mesh "
                         f"needs {dcn_data * ici_data * ici_model} ranks, "
                         f"the process group has {world}")
    return make_mesh(dcn_data * ici_data, ici_model, device)


def _linear_pspec(lin: Dict[str, Any], col_parallel: bool) -> Dict[str, tuple]:
    """Column-parallel shards N; row-parallel shards K."""
    spec: Dict[str, tuple] = {}
    for key in lin:
        if key in ("w", "w_packed"):
            spec[key] = P(None, "model") if col_parallel else P("model", None)
        elif key == "s_channel":
            spec[key] = P("model") if col_parallel else P(None)
        elif key == "s_group":
            spec[key] = P(None, "model") if col_parallel else P("model", None)
        elif key == "b":
            spec[key] = P("model") if col_parallel else P(None)
    return spec


_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW = ("o_proj", "down_proj")


def param_pspecs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The spec tree matching the params tree (unfused layers: the fused
    ``qkv_proj`` / ``gate_up_glu`` are single-device layouts)."""
    layers = []
    for layer in params["layers"]:
        lp: Dict[str, Any] = {
            "input_layernorm": P(None),
            "post_attention_layernorm": P(None),
        }
        for name in _COL:
            lp[name] = _linear_pspec(layer[name], col_parallel=True)
        for name in _ROW:
            lp[name] = _linear_pspec(layer[name], col_parallel=False)
        layers.append(lp)
    spec: Dict[str, Any] = {
        "embed": P(None, None),
        "layers": layers,
        "norm": P(None),
    }
    if params.get("lm_head") is not None:
        spec["lm_head"] = _linear_pspec(params["lm_head"], col_parallel=True)
    else:
        spec["lm_head"] = None
    return spec


def cache_pspec(caches) -> Any:
    """Slot caches (head-major, serve/kv_cache.py): batch on data, kv heads
    on model; the scale planes are rank 3."""
    def one(c):
        return {k: (P("data", "model", None, None) if c[k].dim() == 4
                    else P("data", "model", None)) for k in c}
    return [one(c) for c in caches]


def paged_cache_pspec(caches, *, blocks_axis: Optional[str] = None) -> Any:
    """Paged pools (serve/paged_kv.py, (num_blocks, n_kv, bs[, hd])): kv
    heads on model; blocks replicated (default) or on ``blocks_axis`` — the
    Engine's data > 1 mode gives each data shard a pool slice of its own,
    indexed by shard-local block ids."""
    def one(c):
        return {k: (P(blocks_axis, "model", None, None) if c[k].dim() == 4
                    else P(blocks_axis, "model", None)) for k in c}
    return [one(c) for c in caches]


#: rows of a packed weight that one 128-row pack block (and one g128 group)
#: spans: a K-shard must keep them whole
_PACK_ROWS = 16


def _shard_leaf(x: torch.Tensor, spec: tuple, mesh: Mesh,
                where: str) -> torch.Tensor:
    if len(spec) > x.dim():
        raise ValueError(f"{where}: spec {spec} for a rank-{x.dim()} leaf")
    for dim, name in enumerate(spec):
        if name is None:
            continue
        n = mesh.shape[name]
        idx = mesh.coords[0] if name == "data" else mesh.coords[1]
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"{where}: dim {dim} of {size} does not split "
                             f"over {name} = {n}")
        part = size // n
        if where.endswith("w_packed") and dim == 0 and part % _PACK_ROWS:
            raise ValueError(
                f"{where}: a K-shard of {part * 8} rows would cut a "
                f"128-row pack block (K / {name} must be a multiple of 128)")
        x = x.narrow(dim, idx * part, part)
    return x.contiguous().to(mesh.device)


def _walk(tree, spec, fn, where: str):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(v, spec[k], fn, f"{where}.{k}" if where else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, s, fn, f"{where}[{i}]")
                for i, (v, s) in enumerate(zip(tree, spec))]
    return fn(tree, spec, where)


def shard_params(params: Dict[str, Any], mesh: Mesh,
                 specs: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """This rank's slice of every leaf (per ``specs``, default
    :func:`param_pspecs`) on ``mesh.device``; a None leaf (tied
    embeddings' lm_head) passes through.  Raises on a split that is not
    even or that would cut a 128-row pack block or a g128 group."""
    specs = specs or param_pspecs(params)
    return _walk(params, specs,
                 lambda x, s, w: _shard_leaf(x, s, mesh, w), "")


def local_config(config: ModelConfig, tp: int) -> ModelConfig:
    """The geometry one rank of a ``tp``-wide model axis holds: its share
    of the attention and kv heads, the head dim kept (the shape of its
    KV caches)."""
    nh, nkv = config.num_attention_heads, config.num_key_value_heads
    if nh % tp or nkv % tp:
        raise ValueError(f"{nh} heads / {nkv} kv heads do not split over "
                         f"model = {tp}")
    return dataclasses.replace(config, num_attention_heads=nh // tp,
                               num_key_value_heads=nkv // tp,
                               head_dim=config.head_dim)


def _data_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch: the ``data`` coordinate's
    contiguous share."""
    dp = mesh.shape["data"]
    if x.shape[0] % dp:
        raise ValueError(f"batch {x.shape[0]} does not split over data = "
                         f"{dp}")
    b = x.shape[0] // dp
    return x[mesh.coords[0] * b:(mesh.coords[0] + 1) * b]


def tp_forward_fn(
    config: ModelConfig,
    mesh: Mesh,
    params_spec: Dict[str, Any],
    *,
    with_cache: bool = False,
    caches_spec: Any = None,
    sp: bool = False,
    overlap: bool = False,
):
    """The forward under the mesh: ``f(params, tokens[, caches, cache_len])
    → logits`` (``(logits, caches)`` with caches), ``params`` this rank's
    shards (:func:`shard_params`), ``tokens`` (B, T) and ``cache_len``
    (B,) the GLOBAL batch, ``caches`` this rank's shard of the global
    caches (its data rows, its kv heads: ``caches_spec``).

    **Where the port differs from JAX**: JAX returns one global array of
    (B, T, V); here each rank takes its ``data`` rows of the batch and
    returns their logits, (B / dp, T, V), replicated over the model axis.

    ``sp=True`` runs the sequence-parallel forward (models/llama.forward_sp:
    prefill and scoring only, T divisible by the model axis);
    ``overlap=True`` (implies sp) also fuses each collective with its GEMM
    as a ring collective matmul."""
    from qqq_tpu_torch.models import llama as M

    del params_spec, caches_spec  # the leaves carry their shard shapes
    tp = mesh.axis("model")
    if overlap:
        sp = True

    def fwd(params, tokens, caches=None, cache_len=None):
        t = _data_rows(mesh, tokens.to(mesh.device))
        cl = None
        if cache_len is not None:
            cl = torch.as_tensor(cache_len, dtype=torch.int32)
            cl = _data_rows(mesh, cl.expand(tokens.shape[0])
                            .to(mesh.device))
        if sp:
            logits, caches = M.forward_sp(params, config, t, caches=caches,
                                          cache_len=cl, tp=tp,
                                          overlap=overlap)
        else:
            logits, caches = M.forward(params, config, t, caches=caches,
                                       cache_len=cl, tp=tp)
        return (logits, caches) if with_cache else logits

    return fwd


def tp_decode_overlapped_fn(
    config: ModelConfig,
    mesh: Mesh,
    params_spec: Dict[str, Any],
    caches_spec: Any,
    micro: int = 2,
):
    """Micro-batch-interleaved TP decode step (collective / compute
    overlap).  Returns ``f(params, (tokens…), (caches…), (clen…)) →
    ((logits…), (caches…))``: ``micro`` decode chains, each its own global
    (B_i, 1) tokens and cache_len and this rank's shard of its own caches
    (pre-split, as in JAX), each returning its data rows' last-position
    logits (B_i / dp, V).

    JAX leaves the interleaving to XLA's latency-hiding scheduler; here it
    is written out layer by layer: chain c's o_proj (and down) partial sum
    is issued as an asynchronous all-reduce while the next chain's GEMMs
    run, and is waited on just before its first use (under nccl the
    reduction then runs beside those GEMMs).  Same sums as :func:`tp_forward_fn`'s decode, in the same
    order, so the logits are equal."""
    from qqq_tpu_torch.models import llama as M
    from qqq_tpu_torch.parallel.collectives import psum

    del params_spec, caches_spec
    tp = mesh.axis("model")

    def fwd(params, tokens_t, caches_t, clen_t):
        if not (len(tokens_t) == len(caches_t) == len(clen_t) == micro):
            raise ValueError(f"{micro} chains expected")
        inv_freq = M.rope_inv_freq(config, mesh.device)
        xs, pos, cls = [], [], []
        for t, cl in zip(tokens_t, clen_t):
            cl = torch.as_tensor(cl, dtype=torch.int32).expand(t.shape[0])
            t = _data_rows(mesh, t.to(mesh.device))
            cl = _data_rows(mesh, cl.to(mesh.device)).contiguous()
            xs.append(params["embed"][t])
            cls.append(cl)
            pos.append(cl[:, None] + torch.arange(
                t.shape[1], dtype=torch.int32, device=mesh.device)[None])
        eps = config.rms_norm_eps
        # per chain: its last down_proj reduction still in flight
        pend: list = [None] * micro
        for i, layer in enumerate(params["layers"]):
            attn = []
            for c in range(micro):  # attention halves, reductions in flight
                if pend[c] is not None:
                    xs[c] = xs[c] + pend[c].wait()
                h = M.rms_norm(xs[c], layer["input_layernorm"], eps)
                part, _ = M.attention(layer, h, pos[c], inv_freq, config,
                                      caches_t[c][i], cls[c], tp=tp,
                                      reduce="none")
                attn.append(psum(part, tp, async_op=True))
            for c in range(micro):
                xs[c] = xs[c] + attn[c].wait()
                h = M.rms_norm(xs[c], layer["post_attention_layernorm"], eps)
                pend[c] = psum(M.mlp(layer, h, tp=tp, reduce="none"), tp,
                               async_op=True)
        for c in range(micro):
            if pend[c] is not None:
                xs[c] = xs[c] + pend[c].wait()
        outs = []
        for c in range(micro):
            x = M.rms_norm(xs[c], params["norm"], eps)[:, -1]
            outs.append(M.lm_head(params, x, tp))
        return tuple(outs), tuple(caches_t)

    return fwd
