"""Checkpoint loading for the command-line entry points (port of
``load_any``, qqq_tpu/cli/eval.py:45).

The evaluation CLI itself (WikiText2 perplexity, the zero-shot suite) is a
later slice of the port; ``cli/serve`` and ``cli/generate`` load their
model through :func:`load_any`.
"""

from __future__ import annotations

import json
import logging
import os

import torch

logger = logging.getLogger("qqq_tpu_torch")


def load_any(model_path: str, dtype: torch.dtype = torch.bfloat16,
             device=None):
    """(params, config) from our quantized checkpoints (``…w_packed``
    tensors), the reference QQQ's Marlin-packed HF checkpoints (``….B`` /
    ``.s_channel`` buffers) or plain HF checkpoints, told apart by
    config.json and the tensor names, loaded onto ``device``."""
    from qqq_tpu_torch.models.loader import (
        _st_keys, load_hf_model, load_quantized,
    )

    with open(os.path.join(model_path, "config.json")) as f:
        cfg_raw = json.load(f)
    if "quantization_config" in cfg_raw:
        st_files = sorted(f for f in os.listdir(model_path)
                          if f.endswith(".safetensors"))
        keys = _st_keys(os.path.join(model_path, st_files[0]))
        if any(k.endswith("w_packed") for k in keys):
            params, config, qc = load_quantized(model_path, dtype=dtype,
                                                device=device)
            logger.info("loaded our quantized checkpoint: %s", qc)
            return params, config
        from qqq_tpu_torch.models.marlin_compat import load_qqq_hf_checkpoint

        params, config = load_qqq_hf_checkpoint(model_path, dtype=dtype,
                                                device=device)
        logger.info("loaded a reference (Marlin-format) QQQ checkpoint")
        return params, config
    return load_hf_model(model_path, dtype=dtype, device=device)
