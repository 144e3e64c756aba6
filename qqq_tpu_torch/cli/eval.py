"""Evaluation CLI (port of qqq_tpu/cli/eval.py, the reference's
examples/eval_model.py analogue), and the checkpoint loading that every
command-line entry point shares (:func:`load_any`).

WikiText2 perplexity (the same slicing and normalization, eval_model.py:
49-98) and the five-task zero-shot suite (piqa, arc_easy, arc_challenge,
hellaswag, winogrande) through the port's own log-likelihood harness
(cli/zeroshot.py; the reference runs lm_eval==0.4.2).  The model runs its
cache-free forward on the card (``--device cuda``, the default) through the
W4A8 prefill kernels, or on the CPU through their plain versions
(``--device cpu``).

Usage:
  python -m qqq_tpu_torch.cli.eval --model_path <quantized_or_hf_dir> \\
      --eval_ppl --tasks piqa,arc_easy
  python -m qqq_tpu_torch.cli.eval --model_path <dir> --eval_ppl \\
      --ppl_dataset synthetic --max_windows 4 --device cpu

Besides JAX's ``<dataset>_ppl`` the printed results hold the mean NLL per
scored token, the windows scored and, for each window, the seconds and
tokens per second (host clock; each window ends in a device-to-host copy of
its NLL).
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import time

import torch

logger = logging.getLogger("qqq_tpu_torch")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--eval_ppl", action="store_true")
    p.add_argument("--ppl_dataset", default="wikitext2")
    p.add_argument("--allow_synthetic", action="store_true",
                   help="permit the random-token fallback when the dataset "
                        "can't be fetched (smoke runs only)")
    p.add_argument("--tasks", default="")
    p.add_argument("--max_length", type=int, default=2048)
    p.add_argument("--max_windows", type=int, default=0)
    p.add_argument("--num_fewshot", type=int, default=0)
    p.add_argument("--limit", type=int, default=0,
                   help="cap examples per zero-shot task (0 = all)")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default="cuda",
                   help="the CUDA card by default; 'cpu' runs the plain "
                        "PyTorch versions of the kernels")
    return p.parse_args(argv)


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


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    args.tokenizer_path = args.tokenizer_path or args.model_path
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    from qqq_tpu_torch.utils.data import get_loaders
    from qqq_tpu_torch.utils.device import resolve_device
    from qqq_tpu_torch.utils.eval import perplexity

    device = resolve_device(args.device)
    params, config = load_any(args.model_path, dtype, device=device)
    results = {}

    if args.eval_ppl:
        _, testenc = get_loaders(
            args.ppl_dataset,
            tokenizer_path=args.tokenizer_path,
            seed=0,
            seqlen=args.max_length,
            vocab_size=config.vocab_size,
            allow_synthetic=args.allow_synthetic,
        )
        n_windows = testenc.shape[0] // args.max_length
        if args.max_windows:
            n_windows = min(n_windows, args.max_windows)
        t0 = time.perf_counter()
        ppl = perplexity(
            params, config, testenc,
            seqlen=args.max_length, max_windows=args.max_windows,
        )
        secs = time.perf_counter() - t0
        name = args.ppl_dataset
        results[f"{name}_ppl"] = round(ppl, 4)
        results[f"{name}_nll_per_token"] = math.log(ppl)
        results[f"{name}_windows"] = n_windows
        results[f"{name}_seconds_per_window"] = secs / n_windows
        results[f"{name}_tokens_per_s"] = n_windows * args.max_length / secs
        logger.info("%s ppl = %.4f (%d windows of %d tokens, %.3f s each)",
                    name, ppl, n_windows, args.max_length, secs / n_windows)

    if args.tasks:
        from qqq_tpu_torch.cli.zeroshot import run_tasks

        task_results = run_tasks(
            params, config, args.tokenizer_path,
            args.tasks.split(","), limit=args.limit,
            num_fewshot=args.num_fewshot,
        )
        results.update(task_results)

    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
