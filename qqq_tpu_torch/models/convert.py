"""JAX params → port params.

:func:`params_from_numpy` takes the JAX package's params pytree after the
caller has turned every leaf into a numpy array (for example
``jax.tree.map(np.asarray, params)``) and returns the same tree of torch
tensors on ``device``.  Layouts and dtypes are kept as they are, so both
packages compute from identical bits; bf16 leaves (numpy's ``ml_dtypes``
bfloat16, which ``torch.from_numpy`` rejects) travel as their uint16 bits.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from qqq_tpu_torch.utils.device import resolve_device


def _leaf(x: Any, device: torch.device) -> torch.Tensor:
    arr = np.array(x)  # a writable contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _convert(tree: Any, device: torch.device) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return _leaf(tree, device)


def params_from_numpy(tree: Any, config, device=None) -> Any:
    """Convert a numpy params tree (the JAX package's layout) to torch."""
    if len(tree["layers"]) != config.num_hidden_layers:
        raise ValueError(
            f"params hold {len(tree['layers'])} layers, config "
            f"{config.num_hidden_layers}"
        )
    if tuple(np.shape(tree["embed"])) != (config.vocab_size,
                                          config.hidden_size):
        raise ValueError(f"embed shape {np.shape(tree['embed'])} does not "
                         "match the config")
    return _convert(tree, resolve_device(device))
