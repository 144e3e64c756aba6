"""Inference engine: continuous batching with a prefill/decode split
(port of qqq_tpu/serve/engine.py), on one device or over a data × model
mesh.

* ``max_batch`` decode slots; every tick decodes ``steps_per_tick`` tokens
  (fewer near a row's budget or the cache's end) for all slots at once,
  each step's token feeding the next (inactive rows compute and are
  ignored, as in JAX's scan);
* on the card a tick is one replay of a CUDA graph (serve/tick_graph.py),
  captured at its first use and kept per (steps, sampling branch, GEMM
  route flag): JAX's one jitted program a tick.  The tick's small inputs
  travel as one packed host→device copy into the graph's static tensors,
  and its tokens and log-probabilities come back in one copy.  A
  whole-bucket prefill (slot mode) is one replay too, of the graph
  captured per (rows, bucket) from the embedding to the copy of its KV
  into the slots, every such graph in one shared memory pool; its first
  tokens are sampled eagerly after it.  Prefill stays eager on the CPU,
  under a mesh, with the private ``_eager_tick`` switch, and for chunked
  prefill and :meth:`Engine.score_prompt`;
* continuous batching is the host loop of :meth:`Engine.run`: a freed slot
  admits the next pending request at the next scheduling round;
* the KV cache is INT8 by default and is updated in place.

Two KV layouts, as in JAX:

* **slot mode** (default): a fixed (max_batch, max_len) cache; prompts
  prefill whole, padded to a bucket; same-bucket pending requests prefill
  together in power-of-two sub-batches into a bucket-sized scratch cache,
  whose rows are then copied into their slots.  With ``prefill_chunk`` a
  request claims its slot at once and prefills ``prefill_chunk`` tokens
  per scheduling round instead, up to ``prefill_batch`` slots per (g, C)
  dispatch, straight into its slot: the (max_batch, nkv, max_len, hd)
  cache is read as a block pool of ``max_batch`` blocks of ``max_len``
  tokens, each row's table the one entry [slot], so the chunk runs
  through the paged write and paged flash kernels with no copy of a
  slot's rows;
* **paged mode** (``paged=True``): a pool of ``num_blocks`` blocks of
  ``block_size`` tokens shared by all slots (serve/paged_kv.py), with
  per-slot block tables grown on demand, so KV memory follows the tokens
  in flight.  Prefill is always chunked, straight into the blocks; when
  the pool runs dry the engine first evicts unreferenced prefix-cache
  blocks (LRU), then preempts the latest-admitted request (its blocks
  free, and it re-enters the queue to re-prefill prompt + generated
  tokens: the vLLM recompute policy).

Scheduler features, as in JAX: ``prefix_cache`` (chunked prefill only)
reuses KV across requests, at slot granularity in slot mode (a freed slot
keeps its KV and a prompt sharing its prefix is admitted into it) and by
content-hashed full blocks in paged mode (adopted read-only, reference
counted); ``spec_ngram`` turns on prompt-lookup speculative decoding:
each tick drafts up to ``spec_k`` tokens per row from the row's own
history and verifies them in one (max_batch, 1 + spec_k) forward, on the
card one replay of a captured graph beside the decode ticks'; a tick where
no row drafts takes the plain (multi-step) tick.

Both run the JAX engine's default GEMM fusion (``fuse=True``: gate/up
through the GLU-fused kernel) and every per-request sampling feature:
penalties, logit bias, guided choice, seeds and top-N logprobs, the first
token included.  Their per-row planes ride in the tick's packed input,
the (B, V) generated-token counts and prompt masks are device tensors
that the tick updates in place, and what JAX makes static (penalties,
bias width, guided width, seeds, N) keys the captured graphs, so the
common greedy tick keeps its graph and does no extra work.

Serving hooks, as in JAX: ``on_token(req, token)`` fires for every
delivered token, :meth:`Engine.cancel` finishes a request at its last
delivered token, :meth:`Engine.add_request` is safe from any thread (an
inbox drained each scheduling round), :meth:`Engine.submit_call` runs a
function on the thread of :meth:`Engine.run` between rounds (the HTTP
server scores prompts that way, so no other thread touches the card while
a graph is captured), and :meth:`Engine.latency_summary` reports TTFT and
TPOT percentiles.

**Under a mesh** (``mesh=``, parallel/shard.py ``make_mesh``) every rank
builds the Engine with the same arguments and runs the same scheduler on
the same requests, so their host decisions stay identical; each holds its
shard.  The ``model`` axis shards the weights and the KV heads
Megatron-style (the model's collectives, models/llama.py); the ``data``
axis splits the slots into ``dp`` contiguous shards of ``max_batch / dp``
(and, paged, gives each shard a pool slice of its own: its own null
block, allocator and prefix maps, block ids shard-local).  A rank's
layers run its own slots; in every tick and every final prefill chunk the
final hidden states of every data shard are gathered over the data axis
before the lm_head, so that every rank computes the head over the whole
batch and samples every row, and every rank's scheduler sees the same
tokens.  The hidden states are the smallest tensor there (B × H against
the logits' B × V), and the head's weight read costs the same for all
rows as for a shard's.  A layer's arithmetic is per row and does not
depend on the rows beside it (on the card the RMSNorm's mean square is
taken in two stages of fixed layout for that, models/llama.py:_mean_square,
which needs a hidden size divisible by 16: the Engine refuses a data axis
on the card otherwise), so a data shard's greedy tokens are the
single-device engine's (chip_smoke.py phase 9c).  A decode tick samples the vocab-sharded logits in place
(:func:`~qqq_tpu_torch.serve.sampling.sample_batched_sharded`) when no
row needs more than greedy or plain temperature sampling (JAX's rule);
otherwise the logits are gathered over the model axis.  Prefill in slot mode runs every admitted row on every
data shard (replicated, as JAX does), each shard keeping its own slots'
KV; chunked prefill with ``data > 1`` is shard-grouped: each dispatch
gives each shard its own rows (JAX :1695).
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from qqq_tpu_torch.kernels import w4a8_gemm
from qqq_tpu_torch.models import llama as M
from qqq_tpu_torch.models.config import ModelConfig
from qqq_tpu_torch.serve import kv_cache, paged_kv
from qqq_tpu_torch.parallel.collectives import all_gather
from qqq_tpu_torch.parallel.shard import Mesh, local_config, shard_params
from qqq_tpu_torch.serve.sampling import (
    SamplingParams, apply_allowed_mask, apply_logit_bias, apply_penalties,
    bias_arrays, chosen_logprob, chosen_logprob_sharded, penalty_arrays,
    sample_batched, sample_batched_sharded, sampling_arrays, sampling_branch,
    top_logprobs,
)
from qqq_tpu_torch.serve.tick_graph import TickGraph
from qqq_tpu_torch.utils.device import resolve_device
from qqq_tpu_torch.utils.profiling import DeviceSpans


@dataclasses.dataclass
class Request:
    prompt_tokens: List[int]
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # filled by the engine:
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    #: raw-model log P(token | prefix) for each entry of ``output_tokens``
    token_logprobs: List[float] = dataclasses.field(default_factory=list)
    #: with ``sampling.top_logprobs`` = N > 0: per generated token, the N
    #: highest raw logprobs as [(token_id, logprob), ...]; else empty
    top_logprobs: List[List[Tuple[int, float]]] = dataclasses.field(
        default_factory=list)
    done: bool = False
    #: "stop" (EOS / stop token / completed guided choice / cancel),
    #: "length" (max_new_tokens or out of cache room) or "error" (prompt
    #: too long or empty) once ``done``
    finish_reason: Optional[str] = None
    #: set by :meth:`Engine.cancel`: the request finishes at the last token
    #: delivered
    cancelled: bool = False
    #: set when the engine preempts the request (paged mode, pool dry): the
    #: token stream to re-prefill on re-admission (prompt + generated so
    #: far), so that generation continues where it left off
    _resume: Optional[List[int]] = None
    #: tokens of ``output_tokens`` already delivered (counted in
    #: ``generated_tokens`` and passed to ``on_token``)
    _emitted: int = 0
    # latency bookkeeping (monotonic seconds, filled by the engine):
    # enqueued, first given a slot (a preempted request keeps it), first
    # token delivered, finished
    t_enqueue: Optional[float] = None
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def ttft(self) -> Optional[float]:
        """Seconds from enqueue to the first delivered token (None when no
        token survived: an instant EOS)."""
        if self.t_enqueue is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_enqueue

    @property
    def tpot(self) -> Optional[float]:
        """Mean seconds per output token after the first."""
        if (self.t_first_token is None or self.t_done is None
                or len(self.output_tokens) < 2):
            return None
        return ((self.t_done - self.t_first_token)
                / (len(self.output_tokens) - 1))


#: max requests prefilled in one dispatch
_PREFILL_BATCH = 8

#: records kept in :attr:`Engine.dispatch_log`, the newest
DISPATCH_LOG_SIZE = 65536

#: rows of the packed per-tick input (JAX: Engine._TICK_ROWS): tokens,
#: cache_len, active, temperature, top_k, top_p, min_p, presence,
#: frequency, repetition, seeded, seed, generation index; the floats ride
#: bitcast as int32
_TICK_ROWS = 13


@dataclasses.dataclass(frozen=True, order=True)
class TickExtras:
    """What a tick's sampling does beyond the plain sampler, decided on the
    host (JAX's static arguments) and part of its graph's key: penalties
    over the device counts, the padded width of the logit-bias and guided
    planes (0 → none), seeded rows, and top-N logprobs (0 → none)."""
    penalties: bool = False
    bias_k: int = 0
    allow_k: int = 0
    seeded: bool = False
    n_top: int = 0


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


class Engine:
    def __init__(
        self,
        params: Dict[str, Any],
        config: ModelConfig,
        *,
        max_batch: int = 8,
        max_len: int = 2048,
        kv_quantized: bool = True,
        prefill_buckets=(128, 512, 2048),
        steps_per_tick: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        mesh=None,
        fuse: bool = True,
        prefill_batch: Optional[int] = None,
        prefill_chunk: int = 0,
        spec_ngram: int = 0,
        spec_k: int = 4,
        prefix_cache: bool = False,
        paged: bool = False,
        block_size: int = 128,
        num_blocks: Optional[int] = None,
        device=None,
    ):
        """Arguments keep the JAX engine's names and meaning.  ``device``
        defaults to the CUDA card (``"cpu"`` runs the plain versions);
        ``params`` must already live there.  ``fuse`` applies
        :func:`~qqq_tpu_torch.models.llama.fuse_inference_params` (gate/up
        → the GLU-fused kernel; a no-op for dense params), as JAX does
        without a mesh.

        ``mesh``: a data × model :class:`~qqq_tpu_torch.parallel.shard.Mesh`
        (see the module docstring).  Every rank passes the same arguments,
        ``params`` unsharded (on any device: each rank takes its slices
        with :func:`~qqq_tpu_torch.parallel.shard.shard_params` onto
        ``mesh.device``); ``fuse`` does not apply, as in JAX, and
        ``max_batch`` must divide by the data axis.  Two backends:
        under ``nccl`` the decode tick and verify graphs are captured
        with their collectives inside, as without a mesh; under ``gloo``
        (ranks that share one card, or the CPU) some collectives are
        staged through host memory, which a graph cannot capture, so
        every tick runs eagerly and ``stats["graph_replays"]`` stays 0.

        ``paged=True`` serves from a block pool (see the module docstring).
        ``max_len`` must be a multiple of ``block_size``; ``prefill_chunk``
        defaults to the widest chunk ≤ 512 that divides ``max_len`` and is
        a whole number of blocks; ``num_blocks`` (null block included)
        defaults to ``1 + max_batch · max_len / block_size``, which never
        preempts — size it down to oversubscribe.

        ``prefill_chunk > 0`` in slot mode chunks the prefill as paged
        mode does (``max_len`` must be a multiple of it);
        ``prefix_cache`` needs chunked prefill (and, paged, chunks of
        whole blocks); ``spec_ngram > 0`` drafts by matching the last
        ``spec_ngram`` tokens against the request's own history and
        verifies up to ``spec_k`` drafted tokens a tick."""
        if steps_per_tick < 1:
            raise ValueError(f"steps_per_tick {steps_per_tick} < 1")
        self.mesh = mesh
        #: data-axis degree: slots partition into dp contiguous shards of
        #: spb = max_batch / dp; this rank's forwards run rows [lo, hi)
        self.dp = 1
        self.tp = self._data_axis = None
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a qqq_tpu_torch.parallel "
                                f"Mesh, not {type(mesh).__name__}")
            if device is not None:
                d = resolve_device(device)
                if d.type != mesh.device.type or d.index not in (
                        None, mesh.device.index):
                    raise ValueError(f"device {device} is not the mesh's "
                                     f"{mesh.device}")
            self.device = mesh.device
            self.tp = mesh.axis("model")
            self._data_axis = mesh.axis("data")
            self.dp = mesh.shape["data"]
            if max_batch % self.dp:
                raise ValueError(f"max_batch {max_batch} must be divisible "
                                 f"by the mesh data axis {self.dp}")
            if (self.dp > 1 and self.device.type == "cuda"
                    and config.hidden_size % M.SQ_CHUNKS):
                # a shard's rows would not norm as the whole batch's do
                raise ValueError(
                    f"a data axis on the card needs hidden_size "
                    f"{config.hidden_size} divisible by {M.SQ_CHUNKS} "
                    f"(models/llama.py:_mean_square)")
            params = shard_params(params, mesh)
        else:
            self.device = resolve_device(device)
            if params["embed"].device.type != self.device.type:
                raise ValueError(f"params live on {params['embed'].device}, "
                                 f"the engine runs on {self.device}")
            if fuse:
                params = M.fuse_inference_params(params, config)
        self.spb = max_batch // self.dp
        d0 = mesh.coords[0] if mesh is not None else 0
        self._lo, self._hi = d0 * self.spb, (d0 + 1) * self.spb
        #: the geometry of this rank's caches (its kv heads)
        self.caches_config = local_config(config, 1 if self.tp is None
                                          else self.tp.size)
        #: captured ticks: not under gloo, whose host-staged collectives a
        #: graph cannot hold
        self._capture = mesh is None or mesh.backend != "gloo"
        self.params = params
        self.config = config
        self.max_batch = max_batch
        self.max_len = max_len
        self.steps_per_tick = steps_per_tick
        self.dtype = dtype
        self.kv_quantized = kv_quantized
        self.prefill_buckets = tuple(
            b for b in prefill_buckets if b <= max_len
        ) or (max_len,)
        self.paged = paged
        if paged:
            if max_len % block_size:
                raise ValueError(f"max_len {max_len} must be a multiple of "
                                 f"block_size {block_size}")
            if not prefill_chunk:
                # the widest chunk ≤ 512 that divides max_len and is a whole
                # number of blocks (JAX: chunk width is dispatch width)
                c = min(512, max_len)
                while c > block_size and (max_len % c or c % block_size):
                    c -= block_size
                prefill_chunk = max(c, block_size)
            if prefix_cache and prefill_chunk % block_size:
                raise ValueError(
                    "paged prefix_cache needs prefill_chunk % block_size "
                    f"== 0, got {prefill_chunk} % {block_size}")
            self.block_size = block_size
            #: per-slot virtual-block capacity (max_len tokens)
            self._nbmax = max_len // block_size
            if num_blocks is None:
                num_blocks = 1 + self.spb * self._nbmax
            #: pool size per data shard (null block included); each shard
            #: owns a slice with its own null block 0 and allocator, and the
            #: tables hold shard-local ids (JAX :248-259)
            self.num_blocks = num_blocks
            self.allocators = [paged_kv.BlockAllocator(num_blocks)
                               for _ in range(self.dp)]
            #: (max_batch, nbmax) pool block per (slot, virtual block); 0 =
            #: the null block
            self.tables = np.zeros((max_batch, self._nbmax), np.int32)
            #: device copy of ``tables``, copied into again only when dirty:
            #: one tensor for the engine's life, which the graphs read
            self._tables_dev = torch.zeros((max_batch, self._nbmax),
                                           dtype=torch.int32,
                                           device=self.device)
            self._tables_dirty = True
            self.slot_blocks: List[List[int]] = [[] for _ in range(max_batch)]
            # the block-level prefix cache (JAX :284-299), one map a data
            # shard: full blocks registered under the tuple of every token
            # up to their end, adopted read-only by later requests of the
            # same shard; a reference count of slot owners per registered
            # block, 0 = evictable, oldest first
            self._bh_key2blk: List[Dict[tuple, int]] = [
                {} for _ in range(self.dp)]
            self._bh_blk2key: List[Dict[int, tuple]] = [
                {} for _ in range(self.dp)]
            self._bh_ref: List[Dict[int, int]] = [{} for _ in range(self.dp)]
            self._bh_lru: List["collections.OrderedDict[int, None]"] = [
                collections.OrderedDict() for _ in range(self.dp)]
            #: per slot: leading ``slot_blocks`` already registered or
            #: adopted (skipped by _register_blocks)
            self.slot_reg = [0] * max_batch
            # this rank's pool slice: its shard's blocks, its kv heads
            self.caches = paged_kv.init(self.caches_config, num_blocks, block_size,
                                        quantized=kv_quantized, dtype=dtype,
                                        device=self.device)
        else:
            # this rank's slots [lo, hi), its kv heads
            self.caches = kv_cache.init(self.caches_config, self.spb, max_len,
                                        quantized=kv_quantized, dtype=dtype,
                                        device=self.device)
            #: the slot cache read as a pool of spb blocks of max_len
            #: tokens: local row b's table is [b] (the verify forward's
            #: tables; a chunk dispatch takes its rows' local slots)
            self._slot_tables = torch.arange(
                self.spb, dtype=torch.int32, device=self.device)[:, None]
        if prefill_chunk and max_len % prefill_chunk:
            # every C-wide chunk then ends inside the cache: no write clamps
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"prefill_chunk {prefill_chunk}")
        if prefix_cache and not prefill_chunk:
            raise ValueError("prefix_cache needs chunked prefill "
                             "(prefill_chunk > 0)")
        self.spec_ngram = spec_ngram
        self.spec_k = spec_k
        self.prefix_cache = prefix_cache
        #: positions a masked row may write past a freed slot's kept prefix
        #: in one tick (JAX :355): keeps those writes inside the cache
        self._free_margin = max(steps_per_tick,
                                spec_k + 1 if spec_ngram else 1)
        #: slot mode with prefix_cache: the tokens whose KV a freed slot
        #: still holds (its slot_len stays their count)
        self.slot_tokens: List[List[int]] = [[] for _ in range(max_batch)]
        self.prefill_chunk = prefill_chunk
        if prefill_batch is None:
            # each admitted row costs a bucket-sized KV scratch across every
            # layer; cap the group so the scratch stays under
            # QQQ_TPU_PREFILL_SCRATCH_MB (default 1536).  Sized by the
            # largest bucket the engine can actually use, or the chunk
            # (JAX: engine.py:321-332).
            budget = int(os.environ.get(
                "QQQ_TPU_PREFILL_SCRATCH_MB", "1536")) << 20
            bucket = max(self.prefill_buckets[-1], prefill_chunk)
            scale_bytes = 4 if kv_quantized else 0
            store_bytes = 1 if kv_quantized else dtype.itemsize
            per_row = (config.num_hidden_layers * config.num_key_value_heads
                       * bucket * 2
                       * (config.head_dim * store_bytes + scale_bytes))
            prefill_batch = min(_PREFILL_BATCH,
                                max(1, budget // max(per_row, 1)))
        self.prefill_batch = max(1, prefill_batch)
        # slot state (host)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_len = np.zeros(max_batch, np.int32)
        self.slot_last_tok = np.zeros(max_batch, np.int32)
        #: slot → prompt tokens not yet prefilled (chunked prefill); a slot
        #: present here is mid-prefill and excluded from decode
        self.slot_prefill: Dict[int, List[int]] = {}
        #: admission order per slot: preemption evicts the latest admitted
        self._admit_seq = 0
        self.slot_seq = [0] * max_batch
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        #: the decode tick's packed inputs (_TICK_ROWS, max_batch) on the
        #: device, one tensor for the engine's life, and the (pinned, on the
        #: card) host buffer that each tick fills and copies into it; with
        #: spec_ngram, spec_k more rows hold each slot's drafts
        rows = _TICK_ROWS + (spec_k if spec_ngram else 0)
        self._tick_in = torch.zeros((rows, max_batch),
                                    dtype=torch.int32, device=self.device)
        self._tick_host = self._tick_in
        if self.device.type == "cuda":
            self._tick_host = torch.zeros_like(self._tick_in, device="cpu",
                                              pin_memory=True)
        #: per-slot generated-token counts and prompt-token masks (B, V),
        #: the penalties' state: written at admission for penalized rows,
        #: counted into by every tick that has a penalized row (in place:
        #: the graphs read these tensors)
        V = config.vocab_size
        self.counts = torch.zeros((max_batch, V), dtype=torch.int32,
                                  device=self.device)
        self.rep_mask = torch.zeros((max_batch, V), dtype=torch.bool,
                                    device=self.device)
        #: ("bias" | "allow", K) → (host buffer, device tensor) of the
        #: tick's padded per-row planes, each made once at first use
        self._planes: Dict[Tuple[str, int], Tuple[torch.Tensor,
                                                  torch.Tensor]] = {}
        #: (steps, sampling branch, FUSE_ACT_QUANT, TickExtras) → the
        #: captured tick
        self._graphs: Dict[tuple, TickGraph] = {}
        self._graph_stream = None  # the side stream of warm-ups and captures
        #: run the decode tick and the whole-bucket prefill eagerly on the
        #: card too: for comparisons with the captured ones only (the CPU
        #: never captures)
        self._eager_tick = False
        #: (rows, bucket, FUSE_ACT_QUANT) → the captured whole-bucket
        #: prefill, every one in the memory pool ``_prefill_pool``, and its
        #: static input: (pinned host buffer, device tensor) of the packed
        #: tokens, lengths and destination slots
        self._prefill_graphs: Dict[tuple, TickGraph] = {}
        self._prefill_in: Dict[tuple, Tuple[torch.Tensor,
                                            torch.Tensor]] = {}
        self._prefill_pool = None
        #: the queue of the thread in :meth:`run`; other threads submit
        #: through ``_inbox`` (add_request) and ``_jobs`` (submit_call),
        #: both drained at the top of every scheduling round
        self._pending: List[Request] = []
        self._inbox: List[Request] = []
        self._jobs: List[Tuple[Callable[[], Any],
                               concurrent.futures.Future]] = []
        self._inbox_lock = threading.Lock()
        #: (ttft, tpot) of the last ≤ 1000 finished requests
        self._latency: List[Tuple[float, Optional[float]]] = []
        #: on_token(req, token): called for every delivered token (an EOS
        #: or stop token is never delivered), on the thread of run()
        self.on_token: Optional[Callable[[Request, int], None]] = None
        self.stats = {
            "prefills": 0, "prefill_tokens": 0, "prefill_chunks": 0,
            "prefill_dispatches": 0,
            "generated_tokens": 0, "decode_ticks": 0, "preemptions": 0,
            "spec_drafted": 0, "spec_accepted": 0,
            "prefix_hits": 0, "prefix_tokens_reused": 0,
            "prefill_s": 0.0, "decode_s": 0.0,
            # decode steps of the plain ticks (a tick fuses up to
            # steps_per_tick), speculative ticks (one verify forward each;
            # decode_ticks counts both kinds), ticks replayed from a
            # captured graph, graphs captured and the seconds of the ticks
            # that captured (their eager run included)
            "decode_steps": 0, "spec_ticks": 0,
            "graph_replays": 0, "graph_captures": 0,
            "graph_capture_s": 0.0,
            # whole-bucket prefills replayed from a captured graph, graphs
            # captured and the seconds of their captures (an eager run
            # before one included), apart from the decode tick's
            "prefill_graph_replays": 0, "prefill_graph_captures": 0,
            "prefill_graph_capture_s": 0.0,
        }
        self._dispatch_log: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=DISPATCH_LOG_SIZE)
        self._dispatches = 0
        self._device_spans = DeviceSpans(self.device)

    @property
    def dispatch_log(self) -> "collections.deque[Dict[str, Any]]":
        """One record (a dict) per prefill dispatch, decode tick and verify,
        oldest first, the newest :data:`DISPATCH_LOG_SIZE` kept:

        * ``seq`` (0, 1, .. over the engine's life) and ``kind``:
          "prefill", "decode" or "verify";
        * the shape: a prefill's ``rows`` as (start position, tokens) per
          row run, ``heads`` (rows whose prompt it completes, each sampling
          a first token) and ``padded`` (token positions computed, padding
          included); a tick's or verify's ``rows`` as each active row's
          context before it, and ``steps`` (a verify: 1);
        * a prefill's ``graph``: "replay" where a whole-bucket prefill
          replayed its captured graph, "capture" where it captured it, and
          None where it ran eagerly (the CPU, a mesh, ``_eager_tick``,
          chunked prefill);
        * host phases on ``time.monotonic()`` (the clock of the request
          stamps): a prefill's ``t_start``, ``t_forward`` (its forward
          enqueued, and in slot mode the copy of its KV into the slots),
          ``t_synced`` (the sampled tokens back, or the wait for a chunk
          with none), ``t_end``; a tick's or verify's ``t_start``,
          ``t_packed`` (inputs packed and copied, the start event
          recorded), ``t_launched`` (the graph launch returned; eager: the
          forward enqueued), ``t_synced`` (the report back),
          ``t_delivered`` and ``t_end``;
        * on the card, ``device_start`` (its first device work: a tick's
          graph launch) and ``device_end`` (the sync, past its last device
          work) in host-clock seconds, and ``gap_before_s``, the device's
          idle since the previous dispatch's end
          (:class:`~qqq_tpu_torch.utils.profiling.DeviceSpans`; None on the
          CPU, and for the first dispatch's gap).

        Reading it waits for the device: read it on the thread of
        :meth:`run`, or between runs."""
        self._device_spans.flush()
        return self._dispatch_log

    def _log_dispatch(self, start, t_mark: float, **fields
                      ) -> Dict[str, Any]:
        """Append a dispatch's record, once its device work is enqueued and
        before its sync (while the device works), with its first device
        event ``start``, marked at host time ``t_mark``."""
        self._device_spans.fill()  # the last dispatch's event, read now
        rec = dict(fields, seq=self._dispatches, device_start=None,
                   device_end=None, gap_before_s=None)
        self._dispatches += 1
        self._dispatch_log.append(rec)
        self._device_spans.close(rec, start, t_mark)
        return rec

    def _synced(self, rec: Dict[str, Any]) -> None:
        """Stamp a dispatch's sync, right after it returns."""
        rec["t_synced"] = time.monotonic()
        self._device_spans.synced(rec["t_synced"])

    # -- per-row sampling planes (host) -------------------------------------

    @staticmethod
    def _row_params(rows: List[Optional[Request]]):
        """Each row's SamplingParams; ``None`` for an empty row (greedy,
        no extras)."""
        return [r.sampling if r is not None else None for r in rows]

    @staticmethod
    def _seed_arrays(rows: List[Optional[Request]]):
        """(seeded, seed, generation index) int32 host arrays for the rows
        that sample with a seed (JAX: _seed_arrays), or None when no row
        does; the index makes a seeded request's i-th token draw the same
        noise in every batch, slot and mode."""
        n = len(rows)
        out = np.zeros((3, n), np.int32)
        for i, r in enumerate(rows):
            if r is not None and r.sampling.seed is not None \
                    and r.sampling.temperature > 0.0:
                out[:, i] = (1, r.sampling.seed & 0x7FFFFFFF,
                             len(r.output_tokens))
        return out if out[0].any() else None

    def _allowed_arrays(self, rows: List[Optional[Request]]):
        """(n, K) allowed token ids of the guided rows (pads = vocab size,
        K the largest set rounded up to a power of two), or None when no
        row is guided (JAX: _allowed_arrays).  A candidate consistent with
        the row's output contributes its next token; at a completed
        candidate EOS joins the set."""
        V = self.config.vocab_size
        sets: List[set] = []
        for r in rows:
            s: set = set()
            if r is not None and r.sampling.guided_choice:
                out = tuple(r.output_tokens)
                m = len(out)
                complete = False
                for cand in r.sampling.guided_choice:
                    cand = tuple(cand)
                    if len(cand) > m and cand[:m] == out:
                        s.add(int(cand[m]))
                    elif cand == out:
                        complete = True
                if complete and r.sampling.eos_token_id is not None:
                    s.add(int(r.sampling.eos_token_id))
            sets.append(s)
        if not any(r is not None and r.sampling.guided_choice for r in rows):
            return None
        kmax = max(1, max(len(s) for s in sets))
        ids = np.full((len(rows), 1 << (kmax - 1).bit_length()), V, np.int32)
        for i, s in enumerate(sets):
            ids[i, :len(s)] = sorted(s)
        return ids

    def _prefill_pen(self, rows: List[Optional[Request]]):
        """(counts, prompt mask, presence, frequency, repetition) host
        arrays for a prefill's sample, or None when no row is penalized
        (JAX: _prefill_pen): a resumed row's counts are its output so far,
        the mask covers the prompt when the repetition penalty is set."""
        if not any(r is not None and r.sampling.has_penalties for r in rows):
            return None
        V = self.config.vocab_size
        counts = np.zeros((len(rows), V), np.int32)
        pmask = np.zeros((len(rows), V), bool)
        for i, r in enumerate(rows):
            if r is None or not r.sampling.has_penalties:
                continue
            if r.output_tokens:
                counts[i] = np.bincount(r.output_tokens, minlength=V)[:V]
            if r.sampling.repetition_penalty != 1.0 and r.prompt_tokens:
                pmask[i, r.prompt_tokens] = True
        pens = penalty_arrays(self._row_params(rows))
        return (counts, pmask) + pens

    @staticmethod
    def _ntop(rows: List[Optional[Request]]) -> int:
        """The widest top-N asked by the rows (0: none)."""
        return max((r.sampling.top_logprobs for r in rows if r is not None),
                   default=0)

    @staticmethod
    def _top_list(req: Request, ids, vals) -> List[Tuple[int, float]]:
        m = req.sampling.top_logprobs
        return [(int(t), float(v)) for t, v in zip(ids[:m], vals[:m])]

    @staticmethod
    def _alter_logits(last: torch.Tensor, pen=None, bias=None, allow=None):
        """The logit-altering stack of a sample (JAX: _decode_step and
        _prefill_sample_logits): penalties, then bias, then the guided
        mask; each ``None`` is skipped."""
        if pen is not None:
            last = apply_penalties(last, *pen)
        if bias is not None:
            last = apply_logit_bias(last, *bias)
        if allow is not None:
            last = apply_allowed_mask(last, allow)
        return last

    # -- device work -------------------------------------------------------

    def _sample(self, last: torch.Tensor, rows: List[Optional[Request]]):
        """A prefill's first tokens, through the same stack as a decode
        step (penalties with host-built counts, bias, guided mask, seeds):
        (tokens, logprobs, (top ids, top values) or None) as host arrays,
        one device→host copy; ``None`` rows are masked to token 0."""
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        sps = self._row_params(rows)
        planes = sampling_arrays(sps)
        pen = self._prefill_pen(rows)
        if pen is not None:
            pen = tuple(put(a) for a in pen)
        bias = bias_arrays(sps)
        bias = None if bias[0] is None else tuple(put(a) for a in bias)
        allow = self._allowed_arrays(rows)
        seeds = self._seed_arrays(rows)
        x = self._alter_logits(last, pen, bias,
                               None if allow is None else put(allow))
        seeded = () if seeds is None else (put(seeds[0] != 0),
                                           put(seeds[1]), put(seeds[2]))
        tok = sample_batched(x, self.generator, *(put(a) for a in planes),
                             *seeded, branch=sampling_branch(*planes))
        tok = torch.where(put(np.array([r is not None for r in rows])),
                          tok, 0)
        parts = [tok.to(torch.float32), chosen_logprob(last, tok)]
        n_top = self._ntop(rows)
        if n_top:
            vals, ids = top_logprobs(last, n_top)
            parts += [*ids.T.to(torch.float32), *vals.T]
        both = torch.stack(parts).cpu().numpy()  # one copy back
        tops = (both[2:2 + n_top].T, both[2 + n_top:].T) if n_top else None
        return both[0].astype(np.int32), both[1], tops

    def _install_penalty_state(self, slot: int, req: Request,
                               first: int) -> None:
        """A penalized request entering decode: its slot's counts become
        its output so far plus its first token (a resumed request's carry
        over), and its prompt mask is set when the repetition penalty is
        (JAX: the admission branches of _admit_batch and
        _finish_chunk_prefill)."""
        sp = req.sampling
        if not sp.has_penalties:
            return
        V = self.config.vocab_size
        row = np.bincount(req.output_tokens + [first], minlength=V)[:V]
        self.counts[slot].copy_(torch.from_numpy(row.astype(np.int32)))
        if sp.repetition_penalty != 1.0:
            mask = np.zeros((V,), bool)
            mask[req.prompt_tokens] = True
            self.rep_mask[slot].copy_(torch.from_numpy(mask))

    def _start_decode(self, slot: int, req: Request, first: int, lp: float,
                      tops_row) -> None:
        """Install a prefill's sampled first token and hand the slot to
        decode (JAX: the tail of _admit_batch and _finish_chunk_prefill)."""
        self._install_penalty_state(slot, req, first)
        req.output_tokens.append(first)
        req.token_logprobs.append(lp)
        if tops_row is not None and req.sampling.top_logprobs:
            req.top_logprobs.append(self._top_list(req, *tops_row))
        self.slot_last_tok[slot] = first
        self.stats["prefills"] += 1
        self._maybe_finish(slot)
        self._emit(req)
        self._release_if_cancelled(slot)

    @torch.inference_mode()
    def _admit_batch(self, reqs: List[Request], slots: List[int],
                     bucket: int) -> None:
        """Prefill ``reqs`` together (B = len(reqs)) into a bucket-sized
        scratch cache and copy each row's KV into its slot
        (:meth:`_prefill_whole`), then sample each row's first token.  On
        the card without a mesh that is one replay of the graph of (B,
        bucket) (:meth:`_prefill_graph`), the sampler eager after it.
        Under a mesh every data shard runs every row (the logits whole
        over the model axis, the same tokens everywhere) and keeps its own
        slots' rows."""
        t0 = time.perf_counter()
        t_start = time.monotonic()
        start = self._device_spans.mark()
        pb = len(reqs)
        n = pb * bucket
        key = (pb, bucket, w4a8_gemm.FUSE_ACT_QUANT)
        graphed = (self.device.type == "cuda" and self.mesh is None
                   and not self._eager_tick)
        mine = [i for i, s in enumerate(slots) if self._lo <= s < self._hi]
        # the packed input: tokens (pb, bucket), lengths, destination slots
        if graphed:
            host, inp = self._prefill_input(key, n + 2 * pb)
            h = host.numpy()
            h[:] = 0
        else:
            h = np.zeros(n + 2 * pb, np.int64)
        toks = h[:n].reshape(pb, bucket)
        lens = h[n:n + pb]
        for i, r in enumerate(reqs):
            toks[i, :len(r.prompt_tokens)] = r.prompt_tokens
            lens[i] = len(r.prompt_tokens)
        h[n + pb:n + pb + len(mine)] = [slots[i] - self._lo for i in mine]
        if graphed:
            inp.copy_(host, non_blocking=True)
            logits, how = self._prefill_graph(
                key, lambda: self._prefill_whole(inp, pb, bucket))
        else:
            inp = torch.from_numpy(h).to(self.device)
            logits, how = self._prefill_whole(
                inp, pb, bucket, None if len(mine) == pb else mine), None
        rec = self._log_dispatch(
            start, t_start, kind="prefill", rows=[(0, int(k)) for k in lens],
            heads=pb, padded=n, graph=how, t_start=t_start,
            t_forward=time.monotonic())
        firsts, lps, tops = self._sample(logits[:, 0, :], reqs)
        self._synced(rec)
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_s"] += time.perf_counter() - t0
        for i, (req, slot) in enumerate(zip(reqs, slots)):
            if req.t_admit is None:
                req.t_admit = t_start
            self.slot_req[slot] = req
            self.slot_len[slot] = int(lens[i])
            self.stats["prefill_tokens"] += int(lens[i])
            self._start_decode(slot, req, int(firsts[i]), float(lps[i]),
                               None if tops is None
                               else (tops[0][i], tops[1][i]))
        rec["t_end"] = time.monotonic()

    def _prefill_whole(self, inp: torch.Tensor, pb: int, bucket: int,
                       rows: Optional[List[int]] = None) -> torch.Tensor:
        """The forward of a whole-bucket prefill of ``pb`` rows from the
        packed int64 input ``inp`` (pb · bucket tokens, pb lengths, pb
        destination slots, local to this rank) into a bucket-sized scratch
        cache, and the copy of the scratch's rows ``rows`` (this rank's,
        under a mesh; None: every row, in order) into their slots, before
        the logits leave, so that the dispatch's device work ends at the
        sampler's sync.  Returns the (pb, 1, V) f32 logits at each row's
        last prompt token.  This is what a prefill graph captures."""
        n = pb * bucket
        toks = inp[:n].view(pb, bucket)
        scratch = kv_cache.init(self.caches_config, pb, bucket,
                                quantized=self.kv_quantized,
                                dtype=self.dtype, device=self.device)
        logits, _ = M.forward(
            self.params, self.config, toks, caches=scratch,
            cache_len=torch.zeros((pb,), dtype=torch.int32,
                                  device=self.device),
            logits_at=inp[n:n + pb] - 1, tp=self.tp,
        )
        k = pb if rows is None else len(rows)
        if k:
            dst = inp[n + pb:n + pb + k]
            src = None if rows is None else torch.tensor(rows,
                                                         device=self.device)
            for big, small in zip(self.caches, scratch):
                for name, buf in big.items():
                    buf[dst, :, :bucket] = (small[name] if src is None
                                            else small[name][src])
        return logits

    def _prefill_input(self, key: tuple, size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pinned host buffer, device tensor) of ``size`` int64, the static
        input of the prefill graph of ``key``, made at its first use."""
        if key not in self._prefill_in:
            dev = torch.zeros(size, dtype=torch.int64, device=self.device)
            host = torch.zeros(size, dtype=torch.int64, pin_memory=True)
            self._prefill_in[key] = (host, dev)
        return self._prefill_in[key]

    def _prefill_graph(self, key: tuple, run: Callable[[], torch.Tensor]
                       ) -> Tuple[torch.Tensor, str]:
        """``run()`` through the prefill graph of ``key`` (rows, bucket,
        GEMM route flag): a replay, or at the key's first dispatch ``run()``
        eagerly on the capture stream (it does the kernels' first-call host
        work, and its output is the dispatch's), then its capture into the
        prefill graphs' shared pool, as :meth:`_run_graph` does for a tick.
        Returns (output, "replay" | "capture")."""
        graph = self._prefill_graphs.get(key)
        if graph is not None:
            self.stats["prefill_graph_replays"] += 1
            return graph.replay(), "replay"
        t0 = time.perf_counter()
        out = self._on_capture_stream(run)
        if self._prefill_pool is None:
            self._prefill_pool = torch.cuda.graph_pool_handle()
        self._prefill_graphs[key] = TickGraph(
            run, None, self._capture_stream(), self._prefill_pool)
        self.stats["prefill_graph_captures"] += 1
        self.stats["prefill_graph_capture_s"] += time.perf_counter() - t0
        return out, "capture"

    @torch.inference_mode()
    def _prefill_chunk(self, rows: List[Optional[int]]) -> None:
        """One (R, C) chunked-prefill dispatch, R = len(rows): each slot's
        next ``prefill_chunk`` prompt tokens at its ``slot_len``, written
        straight into its KV through its table row: its block table in
        paged mode, in slot mode the one block [slot] of the cache read as
        a pool of max_len-token blocks (a chunk ends at or below max_len,
        so no position leaves that block); ``None`` rows (paged mode) ride
        along on a null table.  The padded
        tail of a chunk is written too: positions past the allocated
        blocks land in the null block, the rest are rewritten by the next
        chunk or decode step before anything attends to them.  A slot
        whose prompt this chunk completes samples its first token (JAX:
        _prefill_chunk_step :792, _prefill_chunk_paged :835 and the
        dispatch half of _progress_chunk_prefills :1599 and _paged
        :1693).

        With ``data > 1`` the rows are shard-grouped (R = dp · g, shard d
        owning rows [d·g, (d+1)·g)): each rank runs its own g rows (slot
        mode: those that are not None), and a final chunk's logits are
        gathered over the data axis before the lm_head, so that every rank
        samples every row alike."""
        t0 = time.perf_counter()
        t_start = time.monotonic()
        start = self._device_spans.mark()
        C, R = self.prefill_chunk, len(rows)
        g = R // self.dp
        d0 = self._lo // self.spb
        toks = np.zeros((R, C), np.int64)
        ks = np.zeros((R,), np.int32)
        tns = np.ones((R,), np.int64)
        tabs = np.zeros((R, self._nbmax if self.paged else 1), np.int32)
        reqs: List[Optional[Request]] = [None] * R
        finals = [False] * R
        for i, slot in enumerate(rows):
            if slot is None:
                continue
            part = self.slot_prefill[slot][:C]
            toks[i, :len(part)] = part
            ks[i] = self.slot_len[slot]
            tns[i] = len(part)
            tabs[i] = self.tables[slot] if self.paged else slot - self._lo
            reqs[i] = self.slot_req[slot]
            finals[i] = len(self.slot_prefill[slot]) <= C
        # this rank's rows of the dispatch
        run = [i for i in range(d0 * g, (d0 + 1) * g)
               if self.paged or rows[i] is not None]
        dev = self.device
        hid = None
        if run:
            sel = np.asarray(run)
            hid, _ = M.forward(
                self.params, self.config, torch.from_numpy(toks[sel]).to(dev),
                caches=self.caches, cache_len=torch.from_numpy(ks[sel]).to(dev),
                block_tables=torch.from_numpy(tabs[sel]).to(dev), tp=self.tp,
                return_hidden=True,
            )
            hid = M.at_positions(hid, torch.from_numpy(tns[sel] - 1).to(dev))
        rec = self._log_dispatch(
            start, t_start, kind="prefill",
            rows=[(int(ks[i]), int(tns[i])) for i, s in enumerate(rows)
                  if s is not None],
            heads=sum(finals), padded=R * C, graph=None, t_start=t_start,
            t_forward=time.monotonic())
        if any(finals):  # only a final chunk's token is ever read
            if len(run) < R:  # shard-grouped: every shard's g rows, in order
                mine = torch.zeros((g, 1, self.config.hidden_size),
                                   dtype=self.params["embed"].dtype,
                                   device=dev)
                if run:
                    mine[torch.tensor(run, device=dev) - d0 * g] = hid
                hid = self._gather_rows(mine)
            last = M.lm_head(self.params, hid, self.tp)[:, 0, :]
            firsts, lps, tops = self._sample(
                last, [r if f else None for r, f in zip(reqs, finals)])
        elif dev.type == "cuda":
            # no token to fetch: wait here so that the chunk's device time
            # lands in prefill_s, not in the next decode tick's decode_s
            torch.cuda.synchronize(dev)
        self._synced(rec)
        self.stats["prefill_dispatches"] += 1
        self.stats["prefill_s"] += time.perf_counter() - t0
        for i, slot in enumerate(rows):
            if slot is None:
                continue
            self.slot_len[slot] = ks[i] + tns[i]
            self._register_blocks(slot)  # completed blocks adoptable
            self.slot_prefill[slot] = self.slot_prefill[slot][C:]
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_tokens"] += int(tns[i])
            if finals[i]:
                del self.slot_prefill[slot]
                reqs[i]._resume = None
                self._start_decode(slot, reqs[i], int(firsts[i]),
                                   float(lps[i]), None if tops is None
                                   else (tops[0][i], tops[1][i]))
        rec["t_end"] = time.monotonic()

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of every data shard, in shard order, from this rank's
        ``x`` (identity without a data axis)."""
        if self._data_axis is None:
            return x
        return all_gather(x, self._data_axis, dim=0)

    def _logits(self, hidden: torch.Tensor, sharded: bool = False
                ) -> torch.Tensor:
        """The head over the whole batch from this rank's final hidden
        states (spb, T, H): gathered over the data axis first (see the
        module docstring), the vocab-sharded logits gathered over the model
        axis unless ``sharded``."""
        return M.lm_head(self.params, self._gather_rows(hidden), self.tp,
                         gather_logits=not sharded)

    def _plane(self, kind: str, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(host buffer, device tensor) of a padded per-row plane: "bias"
        (2, B, K) int32 (ids; values bitcast) or "allow" (B, K) int32.  One
        pair per (kind, K) for the engine's life: the graphs read the
        device tensor."""
        key = (kind, K)
        if key not in self._planes:
            shape = ((2, self.max_batch, K) if kind == "bias"
                     else (self.max_batch, K))
            dev = torch.zeros(shape, dtype=torch.int32, device=self.device)
            host = dev
            if self.device.type == "cuda":
                host = torch.zeros(shape, dtype=torch.int32, pin_memory=True)
            self._planes[key] = (host, dev)
        return self._planes[key]

    def _tick_planes(self, ex: TickExtras):
        """The static tick inputs as the sampler takes them: (cache_len,
        active, the (temp, top_k, top_p, min_p) planes, penalty bundle,
        bias pair, guided ids), each extra ``None`` when ``ex`` lacks it."""
        buf = self._tick_in
        temp, topp, minp, pres, freq, rep = (
            buf[r].view(torch.float32) for r in (3, 5, 6, 7, 8, 9))
        pen = ((self.counts, self.rep_mask, pres, freq, rep)
               if ex.penalties else None)
        bias = None
        if ex.bias_k:
            planes = self._plane("bias", ex.bias_k)[1]
            bias = (planes[0], planes[1].view(torch.float32))
        allow = self._plane("allow", ex.allow_k)[1] if ex.allow_k else None
        return (buf[1], buf[2] != 0, (temp, buf[4], topp, minp), pen, bias,
                allow)

    def _seeded(self, ex: TickExtras, ahead: int):
        """The seeded rows' (mask, seed, generation index + ``ahead``)
        from the tick input, or () when no row has a seed."""
        buf = self._tick_in
        return (buf[10] != 0, buf[11], buf[12] + ahead) if ex.seeded else ()

    @staticmethod
    def _report(last: torch.Tensor, tok: torch.Tensor, n_top: int):
        """(2 + 2N, rows) f32: the tokens, their raw log-probabilities and
        with N = ``n_top`` the top ids and top values."""
        parts = [tok.to(torch.float32), chosen_logprob(last, tok)]
        if n_top:
            vals, ids = top_logprobs(last, n_top)
            parts += [*ids.T.to(torch.float32), *vals.T]
        return torch.stack(parts)

    def _decode_steps(self, n: int, branch: str, ex: TickExtras,
                      sharded: bool = False) -> torch.Tensor:
        """``n`` decode steps across all slots from the static tick inputs
        (JAX: _decode_multi's scan body over _decode_step): the extras'
        stack on each step's logits, each step's sampled token the next
        step's input and counted into ``counts``, inactive rows masked to
        token 0, ``cache_len + 1`` carried.  Returns (2 + 2N, max_batch, n)
        f32: tokens, their log-probabilities, then with N = ``ex.n_top``
        the top ids and top values.  This is what a graph captures.

        Under a mesh the layers run this rank's rows and the head every
        row (:meth:`_logits`); ``sharded`` (JAX: _decode_step_sharded /
        _decode_multi_sharded, no extras) samples the vocab-sharded logits
        in place, otherwise they are gathered over the model axis."""
        cache_len, active, planes, pen, bias, allow = self._tick_planes(ex)
        lo, hi = self._lo, self._hi
        tok = self._tick_in[0, lo:hi].to(torch.int64)
        clen = cache_len[lo:hi]
        tables = self._tables_dev[lo:hi] if self.paged else None
        V = self.config.vocab_size
        steps = []
        for s in range(n):
            hidden, _ = M.forward(
                self.params, self.config, tok[:, None], caches=self.caches,
                cache_len=clen, block_tables=tables, tp=self.tp,
                return_hidden=True)
            last = self._logits(hidden, sharded)[:, -1, :]
            if sharded:
                nxt = torch.where(active, sample_batched_sharded(
                    last, self.generator, planes[0], self.tp, V,
                    branch=branch), 0)
                steps.append(torch.stack([
                    nxt.to(torch.float32),
                    chosen_logprob_sharded(last, nxt, self.tp, V)]))
            else:
                x = self._alter_logits(last, pen, bias, allow)
                nxt = torch.where(active, sample_batched(
                    x, self.generator, *planes, *self._seeded(ex, s),
                    branch=branch), 0)
                if ex.penalties:  # the sampled token is now generated
                    self.counts.scatter_add_(
                        1, nxt.to(torch.int64)[:, None],
                        active.to(torch.int32)[:, None])
                steps.append(self._report(last, nxt, ex.n_top))
            tok = nxt[lo:hi].to(torch.int64)
            clen = clen + 1
        return torch.stack(steps, -1)

    def _verify_step(self, branch: str, ex: TickExtras) -> torch.Tensor:
        """The speculative verify (JAX: _spec_verify_step :719): one
        (max_batch, 1 + k) forward over each row's [last token, drafts]
        at ``cache_len``, the model's sampled continuation at every
        position.  Position 0 alone takes the extras' stack and is counted
        into ``counts`` (rows that alter logits never draft, so their
        later positions are never read); position j samples with
        generation index ``ngen + j``, so a seeded row draws the noise of
        its plain stream.  Returns (2 + 2N, max_batch, 1 + k) f32 as
        :meth:`_decode_steps` does.  In slot mode the forward reads the
        cache as a pool of max_len-token blocks (``_slot_tables``); the
        gate in :meth:`run` keeps every row's 1 + k writes below max_len.
        Under a mesh the layers run this rank's rows and the head every
        row (:meth:`_logits`).  This is what a verify graph captures."""
        cache_len, active, planes, pen, bias, allow = self._tick_planes(ex)
        buf, k = self._tick_in, self.spec_k
        lo, hi = self._lo, self._hi
        toks = torch.cat([buf[:1], buf[_TICK_ROWS:_TICK_ROWS + k]]).T
        tables = self._tables_dev[lo:hi] if self.paged else self._slot_tables
        hidden, _ = M.forward(
            self.params, self.config, toks[lo:hi].to(torch.int64),
            caches=self.caches, cache_len=cache_len[lo:hi],
            block_tables=tables, tp=self.tp, return_hidden=True)
        logits = self._logits(hidden)
        x0 = self._alter_logits(logits[:, 0], pen, bias, allow)
        cols = [torch.where(active, sample_batched(
            x0, self.generator, *planes, *self._seeded(ex, 0),
            branch=branch), 0)]
        for j in range(1, 1 + k):
            cols.append(sample_batched(
                logits[:, j], self.generator, *planes, *self._seeded(ex, j),
                branch=branch))
        if ex.penalties:
            self.counts.scatter_add_(1, cols[0].to(torch.int64)[:, None],
                                     active.to(torch.int32)[:, None])
        B, T, V = logits.shape
        samp = torch.stack(cols, 1)  # (B, T)
        out = self._report(logits.reshape(B * T, V), samp.reshape(B * T),
                           ex.n_top)
        return out.reshape(-1, B, T)

    def _run_graph(self, key: tuple, run: Callable[[], torch.Tensor]
                   ) -> torch.Tensor:
        """``run()`` eagerly on the CPU (and with ``_eager_tick``, or under
        a gloo mesh); on the card by replaying the graph kept under
        ``key``, which the first such tick captures after running eagerly
        on the capture stream: that run does every kernel's first-call host
        work."""
        if (self.device.type != "cuda" or self._eager_tick
                or not self._capture):
            return run()
        graph = self._graphs.get(key)
        if graph is not None:
            self.stats["graph_replays"] += 1
            return graph.replay()
        t0 = time.perf_counter()
        out = self._on_capture_stream(run)
        self._graphs[key] = TickGraph(run, self.generator,
                                      self._capture_stream())
        self.stats["graph_captures"] += 1
        self.stats["graph_capture_s"] += time.perf_counter() - t0
        return out

    def _capture_stream(self) -> torch.cuda.Stream:
        """The side stream of the eager runs before captures, and of the
        captures."""
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        return self._graph_stream

    def _on_capture_stream(self, run: Callable[[], torch.Tensor]
                           ) -> torch.Tensor:
        """``run()`` eagerly on the capture stream, ordered after and
        before the current stream's work."""
        stream, main = self._capture_stream(), torch.cuda.current_stream()
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            out = run()
        main.wait_stream(stream)
        return out

    def _run_tick(self, n: int, branch: str, ex: TickExtras,
                  sharded: bool = False) -> torch.Tensor:
        """``n`` decode steps through the graph of this (steps, branch,
        GEMM route flag, extras; "sharded" for the mesh's in-place
        sampler)."""
        key = (n, branch, w4a8_gemm.FUSE_ACT_QUANT, ex)
        return self._run_graph(key + ("sharded",) if sharded else key,
                               lambda: self._decode_steps(n, branch, ex,
                                                          sharded))

    def _run_verify(self, branch: str, ex: TickExtras) -> torch.Tensor:
        """The verify through the graph of ("spec", k, branch, GEMM route
        flag, extras)."""
        return self._run_graph(
            ("spec", self.spec_k, branch, w4a8_gemm.FUSE_ACT_QUANT, ex),
            lambda: self._verify_step(branch, ex))

    def _pack_tick(self, active: np.ndarray, rows: List[Optional[Request]],
                   drafts: Optional[List[List[int]]] = None
                   ) -> Tuple[str, TickExtras]:
        """Fill the tick's host buffers (JAX: _pack_tick_args), each slot's
        ``drafts`` in rows _TICK_ROWS.. of the same buffer, and copy them
        into the tick's device tensors; return the sampling branch and the
        extras of the active rows."""
        h = self._tick_host.numpy()
        h[:] = 0
        for slot, d in enumerate(drafts or ()):
            h[_TICK_ROWS:_TICK_ROWS + len(d), slot] = d
        h[0] = self.slot_last_tok
        h[1] = self.slot_len
        h[2] = active
        sps = self._row_params(rows)
        temp, topk, topp, minp = sampling_arrays(sps)
        pres, freq, rep = penalty_arrays(sps)
        for i, a in zip((3, 4, 5, 6, 7, 8, 9),
                        (temp, topk, topp, minp, pres, freq, rep)):
            h[i] = a.view(np.int32)
        seeds = self._seed_arrays(rows)
        if seeds is not None:
            h[10:13] = seeds
        copies = [(self._tick_host, self._tick_in)]
        bias_ids, bias_vals = bias_arrays(sps)
        if bias_ids is not None:
            host, dev = self._plane("bias", bias_ids.shape[1])
            host.numpy()[0] = bias_ids
            host.numpy()[1] = bias_vals.view(np.int32)
            copies.append((host, dev))
        allow = self._allowed_arrays(rows)
        if allow is not None:
            host, dev = self._plane("allow", allow.shape[1])
            host.numpy()[:] = allow
            copies.append((host, dev))
        for host, dev in copies:
            if host is not dev:
                dev.copy_(host, non_blocking=True)
        ex = TickExtras(
            penalties=any(r is not None and r.sampling.has_penalties
                          for r in rows),
            bias_k=0 if bias_ids is None else bias_ids.shape[1],
            allow_k=0 if allow is None else allow.shape[1],
            seeded=seeds is not None, n_top=self._ntop(rows))
        return sampling_branch(temp, topk, topp, minp), ex

    def _sync_tables(self) -> None:
        """Copy the block tables into their device tensor if they changed
        (paged mode)."""
        if self.paged and self._tables_dirty:
            self._tables_dev.copy_(torch.from_numpy(self.tables))
            self._tables_dirty = False

    def _deliver(self, slot: int, req: Request, toks, lps, tops) -> None:
        """Append one tick's tokens of a row in order (``tops``: its (N, n)
        top ids and values, or None), then emit (JAX :2064-2083 and
        :1537-1552): a row that finishes on one of them drops the rest, and
        in paged mode the row's newly completed blocks are registered."""
        for t, tok in enumerate(toks):
            if self.slot_req[slot] is None:
                break  # finished mid-tick: drop the overshoot
            req.output_tokens.append(int(tok))
            req.token_logprobs.append(float(lps[t]))
            if tops is not None and req.sampling.top_logprobs:
                req.top_logprobs.append(self._top_list(
                    req, tops[0][:, t], tops[1][:, t]))
            self.slot_len[slot] += 1
            self.slot_last_tok[slot] = tok
            self._maybe_finish(slot)
        if self.paged:
            self._register_blocks(slot)
        self._emit(req)
        self._release_if_cancelled(slot)

    @staticmethod
    def _unpack(out: np.ndarray, n_top: int):
        """(tokens, logprobs, (top ids, top values) or None) of a tick's
        (2 + 2N, max_batch, n) report."""
        tops = (out[2:2 + n_top], out[2 + n_top:]) if n_top else None
        return out[0].astype(np.int32), out[1], tops

    @torch.inference_mode()
    def _decode_tick(self, active: np.ndarray, n: int = 1) -> None:
        """``n`` fused decode steps across all slots (inactive rows are
        masked), then the emit loop of JAX's run: a row that finishes
        mid-chunk drops the rest of its chunk.  The masked rows still
        write their K/V from ``slot_len`` on: in paged mode through their
        table row (an empty slot's table is all null), in slot mode past a
        freed slot's kept prefix; a mid-prefill slot's positions are
        rewritten by its next chunk."""
        t0 = time.perf_counter()
        t_start = time.monotonic()
        rows = [r if active[i] else None for i, r in enumerate(self.slot_req)]
        branch, ex = self._pack_tick(active, rows)
        self._sync_tables()
        sharded = self._sharded_tick()
        start = self._device_spans.mark()
        t_packed = time.monotonic()
        out = self._run_tick(n, branch, ex, sharded)
        rec = self._log_dispatch(
            start, t_packed, kind="decode",
            rows=self.slot_len[active].tolist(), steps=n, t_start=t_start,
            t_packed=t_packed, t_launched=time.monotonic())
        out = out.cpu().numpy()  # one copy back
        self._synced(rec)
        toks, lps, tops = self._unpack(out, ex.n_top)
        self.stats["decode_ticks"] += 1
        self.stats["decode_steps"] += n
        self.stats["decode_s"] += time.perf_counter() - t0
        for slot, req in enumerate(self.slot_req):
            if req is not None and active[slot]:
                self._deliver(slot, req, toks[slot], lps[slot],
                              None if tops is None
                              else (tops[0][:, slot], tops[1][:, slot]))
        rec["t_delivered"] = rec["t_end"] = time.monotonic()

    def _sharded_tick(self) -> bool:
        """Whether the tick samples the vocab-sharded logits in place (JAX
        :2007-2015): under a mesh, when no occupied slot asks for top-k,
        top-p, min-p, a seed, top logprobs or altered logits."""
        return self.mesh is not None and all(
            r is None or (r.sampling.top_k == 0 and r.sampling.top_p >= 1.0
                          and r.sampling.min_p == 0.0
                          and r.sampling.seed is None
                          and r.sampling.top_logprobs == 0
                          and not r.sampling.alters_logits)
            for r in self.slot_req)

    def _propose_draft(self, req: Request) -> List[int]:
        """Prompt-lookup drafting (JAX :1459, vLLM's "[ngram]"): the
        continuation, up to ``spec_k`` tokens, of the latest earlier
        occurrence of the last ``spec_ngram`` tokens of the request's
        prompt + output."""
        n, k = self.spec_ngram, self.spec_k
        ctx = req.prompt_tokens + req.output_tokens
        if len(ctx) <= n:
            return []
        tail = ctx[-n:]
        for i in range(len(ctx) - n - 1, -1, -1):
            if ctx[i:i + n] == tail:
                return ctx[i + n:i + n + k]
        return []

    @torch.inference_mode()
    def _spec_tick(self, active: np.ndarray) -> bool:
        """One speculative tick (JAX :1474): drafts per active row (none
        for rows whose sampling alters logits), one verify across all
        slots, and per row the longest draft prefix equal to the model's
        own sampled tokens plus the token after it.  Returns False without
        touching the device when no row drafted: the caller then runs the
        plain tick."""
        drafts: List[List[int]] = [[] for _ in range(self.max_batch)]
        for slot, req in enumerate(self.slot_req):
            if active[slot] and not req.sampling.alters_logits:
                drafts[slot] = self._propose_draft(req)
        if not any(drafts):
            return False
        t0 = time.perf_counter()
        t_start = time.monotonic()
        rows = [r if active[i] else None for i, r in enumerate(self.slot_req)]
        branch, ex = self._pack_tick(active, rows, drafts)
        self._sync_tables()
        start = self._device_spans.mark()
        t_packed = time.monotonic()
        out = self._run_verify(branch, ex)
        rec = self._log_dispatch(
            start, t_packed, kind="verify",
            rows=self.slot_len[active].tolist(), steps=1, t_start=t_start,
            t_packed=t_packed, t_launched=time.monotonic())
        out = out.cpu().numpy()  # one copy back
        self._synced(rec)
        toks, lps, tops = self._unpack(out, ex.n_top)
        self.stats["decode_ticks"] += 1
        self.stats["spec_ticks"] += 1
        self.stats["decode_s"] += time.perf_counter() - t0
        for slot, req in enumerate(self.slot_req):
            if req is None or not active[slot]:
                continue
            d = drafts[slot]
            j = 0
            while j < len(d) and d[j] == toks[slot, j]:
                j += 1
            self.stats["spec_drafted"] += len(d)
            self.stats["spec_accepted"] += j
            self._deliver(slot, req, toks[slot, :j + 1], lps[slot, :j + 1],
                          None if tops is None
                          else (tops[0][:, slot, :j + 1],
                                tops[1][:, slot, :j + 1]))
        rec["t_delivered"] = rec["t_end"] = time.monotonic()
        return True

    def _chunk_len(self, active: np.ndarray) -> int:
        """Steps of the next tick (JAX :1984-1999): ``steps_per_tick``,
        1 while a guided row is active (its mask follows each token),
        clamped by each active row's room and ``max_new_tokens`` budget,
        and by each masked row's room (its writes must stay inside the
        cache)."""
        chunk = self.steps_per_tick
        if any(active[i] and r.sampling.guided_choice
               for i, r in enumerate(self.slot_req) if r is not None):
            chunk = 1
        for slot, req in enumerate(self.slot_req):
            if not active[slot]:
                chunk = max(1, min(chunk,
                                   self.max_len - int(self.slot_len[slot])))
                continue
            room = self.max_len - int(self.slot_len[slot]) - 1
            budget = req.sampling.max_new_tokens - len(req.output_tokens)
            chunk = max(1, min(chunk, room, budget))
        return chunk

    @torch.inference_mode()
    def score_prompt(self, tokens: List[int]) -> List[Optional[float]]:
        """log P(tokens[i] | tokens[:i]) per prompt token, None at index 0
        (the ``echo`` scoring path; JAX :929): one forward over the padded
        prefill bucket that touches no cache or slot.  It runs on the
        calling thread; a server calls it through :meth:`submit_call`, so
        that it runs on the thread of :meth:`run`."""
        n = len(tokens)
        if n < 1:
            return []
        bucket = _bucket(n, self.prefill_buckets)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :n] = tokens
        toks_d = torch.from_numpy(toks).to(self.device)
        logits, _ = M.forward(self.params, self.config, toks_d, tp=self.tp)
        lsm = torch.log_softmax(logits[0, :n - 1].to(torch.float32), dim=-1)
        lp = torch.gather(lsm, -1, toks_d[0, 1:n, None])[:, 0]
        return [None] + [float(x) for x in lp.cpu()]

    # -- host-side scheduling ---------------------------------------------

    def add_request(self, req: Request) -> None:
        """Submit a request; safe from any thread while :meth:`run` is live
        (it drains the inbox at its next scheduling round)."""
        if req.t_enqueue is None:
            req.t_enqueue = time.monotonic()
        with self._inbox_lock:
            self._inbox.append(req)

    def submit_call(self, fn: Callable[[], Any]
                    ) -> concurrent.futures.Future:
        """Run ``fn()`` on the thread of :meth:`run`, between two
        scheduling rounds; safe from any thread.  The future holds its
        result or exception.  This keeps every use of the card on one
        thread, so that no other thread's work can land inside a graph
        capture."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._inbox_lock:
            self._jobs.append((fn, fut))
        return fut

    def cancel(self, req: Request) -> None:
        """Finish ``req`` at its last delivered token: its slot frees at
        the next tick boundary, and a pending request is dropped before
        its prefill.  Safe from any thread, an ``on_token`` hook
        included."""
        req.cancelled = True

    def latency_summary(self) -> Dict[str, Optional[float]]:
        """p50 / p95 TTFT and TPOT (seconds) over the last ≤ 1000 finished
        requests."""
        def pct(vals, q):
            vals = sorted(v for v in vals if v is not None)
            if not vals:
                return None
            return vals[min(len(vals) - 1, int(q * len(vals)))]

        ttfts = [t for t, _ in self._latency]
        tpots = [p for _, p in self._latency]
        return {
            "requests": len(self._latency),
            "ttft_p50_s": pct(ttfts, 0.50), "ttft_p95_s": pct(ttfts, 0.95),
            "tpot_p50_s": pct(tpots, 0.50), "tpot_p95_s": pct(tpots, 0.95),
        }

    def _drain_inbox(self) -> None:
        """Move submitted requests to the queue and run submitted calls."""
        with self._inbox_lock:
            self._pending.extend(self._inbox)
            self._inbox.clear()
            jobs, self._jobs = self._jobs, []
        for fn, fut in jobs:
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 — the caller's
                fut.set_exception(e)

    def run(self, requests: List[Request]) -> List[Request]:
        """Run until every request completes (continuous batching loop);
        requests and calls submitted meanwhile from other threads join."""
        now = time.monotonic()
        for r in requests:
            if r.t_enqueue is None:
                r.t_enqueue = now
        self._pending.extend(requests)
        while (self._pending or self._inbox or self._jobs
               or any(r is not None for r in self.slot_req)):
            self._drain_inbox()
            self._reject_unservable()
            if self.prefill_chunk:
                self._admit_chunked()
                self._progress_chunk_prefills()
            else:
                self._admit_whole()
            if self.paged:
                self._grow_for_decode()
            active = np.array(
                [r is not None and i not in self.slot_prefill
                 for i, r in enumerate(self.slot_req)], bool)
            if not active.any():
                continue
            # every row's verify writes 1 + spec_k positions from its
            # slot_len (masked rows too): near max_len the whole tick takes
            # the plain path (JAX :1972-1982)
            if (self.spec_ngram
                    and int(self.slot_len.max()) + self.spec_k < self.max_len
                    and self._spec_tick(active)):
                continue
            self._decode_tick(active, self._chunk_len(active))
        return requests

    def _reject_unservable(self) -> None:
        """Finish the pending requests that can never run: cancelled
        ("stop"), no tokens asked ("length"), an empty prompt, one too
        long for ``max_len`` or, prefilled whole, for the largest bucket,
        or in paged mode one whose KV cannot fit the pool even with every
        other request preempted ("error"; a preempted request that grew
        past that has run out of room: "length")."""
        keep = []
        for r in self._pending:
            stream = r._resume or r.prompt_tokens
            if r.cancelled:
                r.done, r.finish_reason = True, "stop"
            elif r.sampling.max_new_tokens <= 0:
                # prefill always samples one token, which would leak out
                r.done, r.finish_reason = True, "length"
            elif (not stream or len(stream) + 1 > self.max_len
                  or (not self.prefill_chunk
                      and len(stream) > self.prefill_buckets[-1])
                  or (self.paged
                      and -(-(len(stream) + 1) // self.block_size)
                      > self.num_blocks - 1)):
                r.done = True
                r.finish_reason = "length" if r._resume else "error"
            else:
                keep.append(r)
        self._pending = keep

    def _admit_whole(self) -> None:
        """Slot mode: admit pending requests into free slots; same-bucket
        requests prefill together (the group may jump an earlier request of
        another bucket within one admission round)."""
        while self._pending and None in self.slot_req:
            free = [i for i, r in enumerate(self.slot_req) if r is None]
            bucket = _bucket(len(self._pending[0].prompt_tokens),
                             self.prefill_buckets)
            group, rest = [], []
            for r in self._pending:
                if (len(group) < len(free)
                        and _bucket(len(r.prompt_tokens),
                                    self.prefill_buckets) == bucket):
                    group.append(r)
                else:
                    rest.append(r)
            self._pending = rest
            while group:
                pb = min(self.prefill_batch,
                         1 << (len(group).bit_length() - 1))
                self._admit_batch(group[:pb], free[:pb], bucket)
                group, free = group[pb:], free[pb:]

    def _pick_slot(self, prompt: List[int]) -> Tuple[int, int]:
        """(free slot, reused tokens) for ``prompt`` (JAX :1035): with
        ``prefix_cache`` the free slot whose kept KV shares the longest
        prefix with it, the reuse capped at len(prompt) - 1 (one token must
        run to give logits) and rounded down to a multiple of the chunk
        (every later chunk then ends inside the cache)."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        if not self.prefix_cache:
            return free[0], 0
        best, best_m = free[0], 0
        for i in free:
            m = 0
            for a, b in zip(self.slot_tokens[i], prompt):
                if a != b:
                    break
                m += 1
            m = min(m, len(prompt) - 1)
            m = (m // self.prefill_chunk) * self.prefill_chunk
            if m > best_m:
                best, best_m = i, m
        return best, best_m

    def _admit_chunked(self) -> None:
        """Chunked prefill: each pending request claims a free slot at once
        (JAX :1896-1920), with the prefix cache the one holding the longest
        reusable prefix (slot mode) or the first, adopting the cached
        blocks of its prefix (paged mode); :meth:`_progress_chunk_prefills`
        then prefills the rest of its prompt (a preempted one's prompt +
        generated tokens) chunk by chunk."""
        while self._pending and None in self.slot_req:
            req = self._pending.pop(0)
            stream = req._resume or req.prompt_tokens
            if self.paged and self.prefix_cache:
                slot = self.slot_req.index(None)
                reuse = self._adopt_prefix(slot, stream)
            else:
                slot, reuse = self._pick_slot(stream)
            self.slot_req[slot] = req
            if req.t_admit is None:
                req.t_admit = time.monotonic()
            self._admit_seq += 1
            self.slot_seq[slot] = self._admit_seq
            self.slot_len[slot] = reuse
            self.slot_prefill[slot] = list(stream[reuse:])
            self.slot_tokens[slot] = []
            if reuse:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_reused"] += reuse

    def _progress_chunk_prefills(self) -> None:
        """Advance every mid-prefill slot by one chunk: up to
        ``prefill_batch`` slots per dispatch, rounds repeating until each
        slot advanced once.  In paged mode rows are rounded up to a power
        of two (padding rows ride on a null table), and growing a slot's
        blocks may preempt another slot of the same round, which then drops
        out of it (JAX :1599 and :1693).  Slot mode has no null block to
        pad with, and needs none: a dispatch takes exactly its slots.

        With ``data > 1`` a dispatch takes up to ``prefill_batch`` slots of
        EACH data shard (JAX :1695-1760): shard d owns rows [d·g, (d+1)·g),
        g the widest shard's count (paged: rounded up to a power of two),
        short shards padded with ``None``.  Greedy and seeded rows give the
        single-device tokens; an unseeded temperature row's first token
        draws its noise at its row of the shard-grouped dispatch rather
        than of a dp = 1 one, so it is equal in distribution but not bit
        for bit (JAX's caveat, :1703-1707)."""
        C = self.prefill_chunk
        progressed: set = set()
        while True:
            per_shard: List[List[int]] = [[] for _ in range(self.dp)]
            for slot in sorted(self.slot_prefill):
                d = self._shard_of(slot)
                if (slot not in progressed
                        and len(per_shard[d]) < self.prefill_batch):
                    per_shard[d].append(slot)
            g = max(len(x) for x in per_shard)
            if g == 0:
                break
            if self.paged:
                g = min(1 << max(0, g - 1).bit_length(), self.prefill_batch)
            rows: List[Optional[int]] = []
            for x in per_shard:
                rows.extend(x + [None] * (g - len(x)))
            progressed.update(s for s in rows if s is not None)
            for i, slot in enumerate(rows):
                if slot is None or slot not in self.slot_prefill:
                    rows[i] = None  # empty, or preempted by an earlier row
                    continue
                if self.slot_req[slot].cancelled:
                    del self.slot_prefill[slot]
                    self._release_if_cancelled(slot)
                    rows[i] = None
                    continue
                part = self.slot_prefill[slot][:C]
                if self.paged and not self._ensure_blocks(
                        slot, int(self.slot_len[slot]) + len(part)):
                    self._finish_out_of_room(slot)
                    rows[i] = None
            # a later row's growth may have preempted an earlier row
            rows = [s if s in self.slot_prefill else None for s in rows]
            if not self.paged and self.dp == 1:
                # slot mode takes exactly its slots; shard-grouped rows
                # (dp > 1) keep their places, shard d at [d·g, (d+1)·g)
                rows = [s for s in rows if s is not None]
            if any(s is not None for s in rows):
                self._prefill_chunk(rows)

    def _grow_for_decode(self) -> None:
        """Grow every decoding slot's table to cover this tick's writes up
        front (JAX :1949-1965): ``steps_per_tick`` of them, or with
        speculation 1 + ``spec_k`` if more, whichever tick runs; a
        preemption frees some other slot, which then drops out of the
        tick."""
        need = self.steps_per_tick
        if self.spec_ngram:
            need = max(1 + self.spec_k, need)
        for slot, r in enumerate(self.slot_req):
            if r is not None and slot not in self.slot_prefill:
                if not self._ensure_blocks(
                        slot, min(int(self.slot_len[slot]) + need,
                                  self.max_len)):
                    self._finish_out_of_room(slot)

    # -- paged block management (host side) --------------------------------

    def _shard_of(self, slot: int) -> int:
        """The data shard that owns ``slot`` (JAX :1302): slots partition
        contiguously over the data axis; each shard has its own pool
        slice, allocator and prefix maps."""
        return slot // self.spb

    def _release_blocks(self, slot: int) -> None:
        """Drop the slot's blocks (JAX :1308): a registered block loses one
        owner and, at none, joins the eviction LRU; the rest return to the
        allocator."""
        d = self._shard_of(slot)
        for blk in self.slot_blocks[slot]:
            if blk in self._bh_blk2key[d]:
                self._bh_ref[d][blk] -= 1
                if self._bh_ref[d][blk] == 0:
                    self._bh_lru[d][blk] = None
            else:
                self.allocators[d].free([blk])
        self.slot_blocks[slot] = []
        self.tables[slot, :] = 0
        self._tables_dirty = True
        self.slot_reg[slot] = 0

    def _evict_cached_blocks(self, d: int, need: int) -> None:
        """Free shard ``d``'s unreferenced prefix-cache blocks, oldest
        first, until ``need`` blocks are available there (JAX :1326)."""
        alloc, lru = self.allocators[d], self._bh_lru[d]
        while alloc.available < need and lru:
            blk, _ = lru.popitem(last=False)
            del self._bh_key2blk[d][self._bh_blk2key[d].pop(blk)]
            del self._bh_ref[d][blk]
            alloc.free([blk])

    def _register_blocks(self, slot: int) -> None:
        """Register the slot's newly completed blocks in the prefix map
        (JAX :1335) under the tuple of every token up to their end: KV
        depends on (token, position) alone, so equal keys hold equal KV.
        Full blocks are never written again (writes land at slot_len and
        beyond), so sharing them needs no copy-on-write.  A block whose key
        is already registered stays the slot's own."""
        if not (self.paged and self.prefix_cache):
            return
        req = self.slot_req[slot]
        if req is None:
            return
        d = self._shard_of(slot)
        bs = self.block_size
        n_full = int(self.slot_len[slot]) // bs
        if n_full <= self.slot_reg[slot]:
            return
        stream = (req._resume or req.prompt_tokens) + req.output_tokens
        for i in range(self.slot_reg[slot], n_full):
            blk = self.slot_blocks[slot][i]
            if blk not in self._bh_blk2key[d]:
                key = tuple(stream[:(i + 1) * bs])
                if key not in self._bh_key2blk[d]:
                    self._bh_key2blk[d][key] = blk
                    self._bh_blk2key[d][blk] = key
                    self._bh_ref[d][blk] = 1
        self.slot_reg[slot] = n_full

    def _adopt_prefix(self, slot: int, stream: List[int]) -> int:
        """Adopt, read-only, the cached blocks of ``stream``'s longest
        registered prefix of whole blocks into ``slot``'s table (JAX
        :1365); returns the tokens reused, capped so that at least one
        token still prefills.  Reuse needs no chunk alignment: the padded
        tail of a chunk past the allocated blocks lands in the null
        block."""
        d = self._shard_of(slot)
        bs = self.block_size
        limit = min(len(stream) - 1, self._nbmax * bs)
        matched = 0
        while ((matched + 1) * bs <= limit
               and tuple(stream[:(matched + 1) * bs]) in self._bh_key2blk[d]):
            matched += 1
        for i in range(matched):
            blk = self._bh_key2blk[d][tuple(stream[:(i + 1) * bs])]
            if self._bh_ref[d][blk] == 0:
                self._bh_lru[d].pop(blk, None)
            self._bh_ref[d][blk] += 1
            self.slot_blocks[slot].append(blk)
            self.tables[slot, i] = blk
            self._tables_dirty = True
        self.slot_reg[slot] = matched
        return matched * bs

    def _preempt(self, protect: int) -> bool:
        """Free the latest-admitted request of ``protect``'s data shard
        other than ``protect`` and requeue it at the front with its resume
        stream (prompt + generated): the oldest requests keep their
        blocks, and greedy streams are unchanged, since re-prefill rebuilds
        the same KV.  Its completed blocks are registered first, so that
        its re-admission adopts them back."""
        cands = [i for i, r in enumerate(self.slot_req)
                 if r is not None and i != protect
                 and self._shard_of(i) == self._shard_of(protect)]
        if not cands:
            return False
        victim = max(cands, key=lambda i: self.slot_seq[i])
        req = self.slot_req[victim]
        self.slot_prefill.pop(victim, None)
        req._resume = list(req.prompt_tokens) + list(req.output_tokens)
        self._pending.insert(0, req)
        self._register_blocks(victim)
        self._release_blocks(victim)
        self.slot_req[victim] = None
        self.slot_len[victim] = 0
        self.stats["preemptions"] += 1
        return True

    def _ensure_blocks(self, slot: int, upto: int) -> bool:
        """Grow ``slot``'s table to cover positions [0, upto), evicting
        unreferenced cached blocks and then preempting other requests while
        the pool is dry (a victim's registered blocks join the LRU, so it
        is drained again after each preemption; JAX :1420).  False when
        even that cannot make room; the caller then finishes the request
        with "length"."""
        have = len(self.slot_blocks[slot])
        need = min(-(-upto // self.block_size), self._nbmax) - have
        if need <= 0:
            return True
        d = self._shard_of(slot)
        alloc = self.allocators[d]
        self._evict_cached_blocks(d, need)
        while alloc.available < need:
            if not self._preempt(protect=slot):
                return False
            self._evict_cached_blocks(d, need)
        got = alloc.alloc(need)
        self.slot_blocks[slot].extend(got)
        self.tables[slot, have:have + need] = got
        self._tables_dirty = True
        return True

    def _finish_out_of_room(self, slot: int) -> None:
        """Close ``slot``'s request when the pool cannot grow its KV any
        further: reason "length", keeping the output generated so far."""
        req = self.slot_req[slot]
        self.slot_prefill.pop(slot, None)
        req.done, req.finish_reason = True, "length"
        self._free_slot(slot)
        self._emit(req)

    def _emit(self, req: Request) -> None:
        """Deliver the tokens that survived :meth:`_maybe_finish` (an EOS
        or stop token it popped is never delivered): count each, stamp the
        first one's time (a resumed request keeps its own) and pass it to
        ``on_token``.  If the hook cancels the request, the tokens past the
        one it last saw are dropped (JAX: _emit)."""
        while req._emitted < len(req.output_tokens):
            tok = req.output_tokens[req._emitted]
            req._emitted += 1
            self.stats["generated_tokens"] += 1
            if req.t_first_token is None:
                req.t_first_token = time.monotonic()
            if self.on_token is not None:
                self.on_token(req, tok)
            if req.cancelled:
                del req.output_tokens[req._emitted:]
                del req.token_logprobs[req._emitted:]
                del req.top_logprobs[req._emitted:]
                return

    def _free_slot(self, slot: int) -> None:
        req = self.slot_req[slot]
        req.t_done = time.monotonic()
        if req.t_first_token is None and req.output_tokens:
            # finished on its first token (max_new_tokens=1): the _emit that
            # would stamp it runs after this
            req.t_first_token = req.t_done
        if req.ttft is not None:
            self._latency.append((req.ttft, req.tpot))
            del self._latency[:-1000]
        if self.paged:
            # registered full blocks stay in the prefix map, the rest return
            # to the pool; the zeroed table sends masked writes to the null
            # block
            self._register_blocks(slot)
            self.slot_len[slot] = 0
            self._release_blocks(slot)
        elif self.prefix_cache:
            # keep the KV of (prompt + output)[:slot_len] (the last output
            # token's KV is never written), clamped so that a masked row's
            # writes of a tick (_free_margin of them) stay past it and
            # inside the cache (JAX :2106-2137)
            seq = req.prompt_tokens + req.output_tokens
            keep = max(0, min(int(self.slot_len[slot]), len(seq),
                              self.max_len - self._free_margin))
            self.slot_tokens[slot] = seq[:keep]
            self.slot_len[slot] = keep
        else:
            self.slot_len[slot] = 0
        self.slot_req[slot] = None

    def _release_if_cancelled(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is not None and req.cancelled:
            req.done, req.finish_reason = True, "stop"
            self._free_slot(slot)

    def _maybe_finish(self, slot: int) -> None:
        """Finish ``slot``'s request on an EOS or stop token (popped, with
        its logprobs), a completed guided choice that no candidate extends
        (kept: it is part of the answer), its token budget or the cache's
        end."""
        req = self.slot_req[slot]
        sp = req.sampling
        out = req.output_tokens
        last = out[-1]
        hit_stop = ((sp.eos_token_id is not None and last == sp.eos_token_id)
                    or last in sp.stop_token_ids)
        guided_done = False
        if sp.guided_choice and not hit_stop:
            m = len(out)
            guided_done = (any(list(c) == out for c in sp.guided_choice)
                           and not any(len(c) > m and list(c[:m]) == out
                                       for c in sp.guided_choice))
        out_of_room = self.slot_len[slot] + 1 >= self.max_len
        if hit_stop or guided_done or out_of_room \
                or len(out) >= sp.max_new_tokens:
            if hit_stop:
                out.pop()  # don't emit the EOS/stop token
                req.token_logprobs.pop()
                if req.top_logprobs:
                    req.top_logprobs.pop()
            req.done = True
            req.finish_reason = ("stop" if hit_stop or guided_done
                                 else "length")
            self._free_slot(slot)


def generate(
    params: Dict[str, Any],
    config: ModelConfig,
    prompts: List[List[int]],
    sampling: Optional[SamplingParams] = None,
    **engine_kw,
) -> List[List[int]]:
    """One-shot batch generation."""
    sampling = sampling or SamplingParams()
    eng = Engine(params, config, **engine_kw)
    reqs = [Request(prompt_tokens=p, sampling=sampling) for p in prompts]
    eng.run(reqs)
    return [r.output_tokens for r in reqs]
