"""Tensor, sequence and data parallelism over ``torch.distributed`` (port
of qqq_tpu/parallel)."""
from qqq_tpu_torch.parallel.shard import (
    make_mesh,
    make_hybrid_mesh,
    initialize_distributed,
    param_pspecs,
    cache_pspec,
    paged_cache_pspec,
    shard_params,
    tp_decode_overlapped_fn,
    tp_forward_fn,
)
