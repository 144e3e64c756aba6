"""A step of the model captured as one CUDA graph: the port's counterpart of
the JAX engine's one jitted program a decode tick (qqq_tpu/serve/engine.py:
_decode_one_packed, and _decode_multi_packed for ``steps_per_tick > 1``),
and of its jitted whole-bucket prefill.

The engine captures its decode ticks and speculative verifies, each in a
memory pool of its own, and its whole-bucket prefills (slot mode, one
graph per (rows, bucket)), all in one pool that they share: their replays
are serialised on one stream and each output is read back before the next
replay, so the pool grows with the largest of them, not with their sum.
Prefill stays eager on the CPU, under a mesh, where ``_eager_tick`` is
set, and for chunked prefill and ``score_prompt``.

A replay launches every kernel of the step with no host work between
them.  What a graph freezes at capture, it reads at replay:

* every pointer a kernel was given, the TMA descriptors that the W4A8
  weight stream encodes on the host (csrc/w4a8_stream.cuh:map2d) among
  them: the weights, the KV caches, the engine's static inputs (the tick's
  packed rows, block tables, penalty counts and masks and padded bias and
  guided planes; a prefill's packed tokens, lengths and destination
  slots), and the activations, workspaces and a prefill's scratch cache
  that the capture took from the graph's memory pool keep their addresses
  across replays, so the engine writes each dispatch's inputs into the
  same tensors;
* every host decision: the sampler's branch, the GEMM routes and the
  sampling extras present (the engine keys its graphs by them), and the
  grids, which depend on shapes only (the kernels read ``cache_len`` and
  the tables on the device);
* first-call host work (shared-memory opt-ins, occupancy queries, the
  TMA encoder's lookup, sizing caches) must have run: the engine runs
  each tick and each prefill once eagerly, on the capture stream, before
  it captures it.

The engine's ``torch.Generator`` is registered with a tick's graph, so
each replay draws new noise.  Replays make no wrapper calls, so the kernel
wrappers' ``launches`` counts are kept here: the capture's increase is
taken back and added again on every replay.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from qqq_tpu_torch.kernels import counted_wrappers


class TickGraph:
    """``run()`` (returning one output tensor) captured on ``stream``, in
    the memory pool ``pool`` (a ``torch.cuda.graph_pool_handle()``; None: a
    pool of its own); on a CUDA device only.  ``generator``, when given, is
    registered with the graph.  A failed capture raises; there is no eager
    fallback."""

    def __init__(self, run: Callable[[], torch.Tensor],
                 generator: Optional[torch.Generator],
                 stream: torch.cuda.Stream, pool=None):
        counters = counted_wrappers()
        before = {name: f.launches for name, f in counters.items()}
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.out = run()
        #: replays so far
        self.replays = 0
        #: wrapper → its launches in one replay
        self.launches: Dict[Callable, int] = {}
        for name, f in counters.items():
            if f.launches != before[name]:
                self.launches[f] = f.launches - before[name]
                f.launches = before[name]  # the capture launched nothing

    def replay(self) -> torch.Tensor:
        """Launch the captured step on the current stream; returns the
        (static) output tensor that it writes."""
        self.graph.replay()
        self.replays += 1
        for f, n in self.launches.items():
            f.launches += n
        return self.out
