"""Quantization pipeline CLI (port of qqq_tpu/cli/quantize.py).

[rotation] → [smoothing] → GPTQ → pack → save, with the JAX CLI's flags:
  --w_group_size -1 → per channel; 128 → groups of 128
  --smooth_method ∈ {os+, awq, sq, none}; --rotate ∈ {hadamard, random, none}
and ``--device`` (the CUDA card by default; 'cpu' runs the same code on
the CPU).  It never falls back to the CPU when the card is missing.

Usage:
  python -m qqq_tpu_torch.cli.quantize --model_path <hf_dir> \\
      --save_path <out> --rotate hadamard --w_group_size 128 --gptq_mse true
  python -m qqq_tpu_torch.cli.quantize --model_path <hf_dir> \\
      --save_path <out> --smooth_method os+ --w_group_size -1
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

logger = logging.getLogger("qqq_tpu_torch")


def str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def _canon_a_quantizer(name: str) -> str:
    from qqq_tpu_torch.calib.smooth import (
        A_QUANTIZER_REFERENCE_NAMES, A_QUANTIZERS,
    )

    canon = A_QUANTIZER_REFERENCE_NAMES.get(name, name)
    if canon not in A_QUANTIZERS:
        raise SystemExit(f"unknown a_quantizer {name!r}; choose from "
                         f"{A_QUANTIZERS} (or reference class names)")
    return canon


def _canon_observer(name: str) -> str:
    """Our registry keys or the reference's class names."""
    from qqq_tpu_torch.calib.observers import OBSERVERS, REFERENCE_NAMES

    canon = REFERENCE_NAMES.get(name, name)
    if canon not in OBSERVERS:
        raise SystemExit(f"unknown observer {name!r}; choose from "
                         f"{sorted(OBSERVERS)} (or reference class names)")
    return canon


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--save_path", required=True)
    p.add_argument("--dtype", default="bfloat16")
    # weight quantization
    p.add_argument("--wbits", type=int, default=4)
    p.add_argument("--w_group_size", type=int, default=-1)
    # calibration data
    p.add_argument("--calib_dataset", default="wikitext2")
    p.add_argument("--custom_dataset", default=None,
                   help="local text/jsonl[.zst] calibration file")
    p.add_argument("--allow_synthetic", action="store_true",
                   help="permit the random-token fallback when the dataset "
                        "can't be fetched (smoke runs only)")
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_length", type=int, default=2048)
    p.add_argument("--sample_batch", type=int, default=4)
    # rotation
    p.add_argument("--rotate", default="none",
                   choices=["hadamard", "random", "none"])
    # smoothing
    p.add_argument("--smooth_method", default="none",
                   choices=["os+", "awq", "sq", "none"])
    p.add_argument("--a_quantizer", default="token",
                   help="activation fake-quantizer during smoothing: "
                        "token|tensor|group|token_group (reference class "
                        "names accepted)")
    p.add_argument("--a_group_size", type=int, default=128,
                   help="channel-group size for group/token_group")
    p.add_argument("--a_observer", default="minmax",
                   help="activation range estimator during smoothing: "
                        "minmax|quantile|lsq_plus|mse (reference class "
                        "names accepted)")
    p.add_argument("--a_percentile", type=float, default=0.999,
                   help="clip quantile when --a_observer quantile")
    p.add_argument("--w_observer", default="minmax",
                   help="weight range estimator during smoothing: "
                        "minmax|lsq_plus|mse")
    # GPTQ
    p.add_argument("--gptq_mse", type=str2bool, default=False)
    p.add_argument("--gptq_groupsize", type=int, default=None)
    p.add_argument("--gptq_act_order", type=str2bool, default=True)
    p.add_argument("--gptq_percdamp", type=float, default=0.01)
    p.add_argument("--gptq_blocksize", type=int, default=128)
    p.add_argument("--offload", type=str2bool, default=False,
                   help="keep the dense layers in pinned host memory and "
                        "move one layer at a time onto the device")
    p.add_argument("--quantize_lm_head", type=str2bool, default=False,
                   help="also W4A8-quantize the LM head (the reference "
                        "keeps it FP)")
    # the GPTQ intermediate (codes and scales), for a pack-only resume
    p.add_argument("--save_quantizers", type=str2bool, default=True,
                   help="save <save_path>_quantizers.npz (per-linear codes "
                        "and scales) for a pack-only resume")
    p.add_argument("--quantizers_path", default=None)
    p.add_argument("--pack_only", action="store_true",
                   help="skip calibration and GPTQ; rebuild the packed "
                        "checkpoint from --quantizers_path")
    p.add_argument("--save_format", default="native",
                   choices=["native", "marlin"],
                   help="'marlin' writes a checkpoint the reference (and "
                        "vLLM) loads")
    p.add_argument("--device", default="cuda",
                   help="the CUDA card by default; 'cpu' runs the same "
                        "code on the CPU")
    return p.parse_args(argv)


def _save(args, params, config) -> None:
    if args.save_format == "marlin":
        from qqq_tpu_torch.models.marlin_compat import save_marlin_checkpoint

        save_marlin_checkpoint(args.save_path, params, config,
                               group_size=args.w_group_size)
    else:
        from qqq_tpu_torch.models.loader import save_quantized

        save_quantized(args.save_path, params, config, {
            "quant_method": "qqq",
            "wbits": args.wbits,
            "group_size": args.w_group_size,
            "rotation": args.rotate,
            "smooth_method": args.smooth_method,
        })


def _pin(params):
    """Every tensor of the params tree in pinned host memory."""
    def visit(x):
        if isinstance(x, dict):
            return {k: visit(v) for k, v in x.items()}
        if isinstance(x, list):
            return [visit(v) for v in x]
        return None if x is None else x.pin_memory()
    return visit(params)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    args.tokenizer_path = args.tokenizer_path or args.model_path
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    # Hessians, folds and GPTQ in full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from qqq_tpu_torch.calib.pipeline import apply_gptq, pack_from_quantizers
    from qqq_tpu_torch.calib.rotation import fuse_layer_norms, rotate_model
    from qqq_tpu_torch.calib.smooth import export_smoothed_model, smooth_model
    from qqq_tpu_torch.core.quant import QuantSpec
    from qqq_tpu_torch.models.loader import load_hf_model
    from qqq_tpu_torch.utils.data import get_loaders
    from qqq_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    if args.offload and (args.rotate != "none"
                         or args.smooth_method != "none"):
        raise SystemExit("--offload supports the GPTQ-only recipe; rotate "
                         "or smooth the model without it")
    t0 = time.time()
    if args.offload:
        params, config = load_hf_model(args.model_path, dtype=dtype,
                                       device="cpu")
        if dev.type == "cuda":
            params = _pin(params)
    else:
        params, config = load_hf_model(args.model_path, dtype=dtype,
                                       device=dev)
    logger.info("loaded %s in %.1fs", args.model_path, time.time() - t0)

    spec = QuantSpec(bits=args.wbits, group_size=args.w_group_size,
                     mse=args.gptq_mse)
    quantizers_path = (args.quantizers_path
                       or args.save_path + "_quantizers.npz")
    sl_path = f"{args.save_path}_scale_list.npz"

    if args.pack_only:
        # re-apply the deterministic transforms (the rotation is seeded, the
        # smoothing scales were saved), then pack the saved codes
        if args.rotate != "none":
            params = fuse_layer_norms(params, config)
            params, _ = rotate_model(params, config, mode=args.rotate,
                                     seed=args.seed)
        if args.smooth_method != "none":
            z = np.load(sl_path)
            params = export_smoothed_model(
                params, config,
                [torch.from_numpy(z[k]).to(dev) for k in z.files])
        params = pack_from_quantizers(params, config, spec, quantizers_path)
        _save(args, params, config)
        logger.info("re-packed from %s in %.1fs", quantizers_path,
                    time.time() - t0)
        return

    calib, _ = get_loaders(
        args.calib_dataset, tokenizer_path=args.tokenizer_path,
        nsamples=args.nsamples, seed=args.seed, seqlen=args.max_length,
        vocab_size=config.vocab_size, allow_synthetic=args.allow_synthetic,
        custom_data_path=args.custom_dataset,
    )

    if args.rotate != "none":
        params = fuse_layer_norms(params, config)
        params, _ = rotate_model(params, config, mode=args.rotate,
                                 seed=args.seed)
        logger.info("rotated model (mode=%s)", args.rotate)

    if args.smooth_method != "none":
        # the search runs on ONE batch, then the scales are folded
        scale_list = smooth_model(
            params, config, torch.from_numpy(calib[:1]).long().to(dev),
            method=args.smooth_method, w_spec=spec,
            a_percentile=(args.a_percentile
                          if "uantile" in args.a_observer else None),
            a_observer=_canon_observer(args.a_observer),
            w_observer=_canon_observer(args.w_observer),
            a_quantizer=_canon_a_quantizer(args.a_quantizer),
            a_group_size=args.a_group_size,
        )
        np.savez(sl_path, *[s.cpu().numpy() for s in scale_list])
        params = export_smoothed_model(params, config, scale_list)
        logger.info("smoothed model (method=%s)", args.smooth_method)

    params, _ = apply_gptq(
        params, config, calib, spec,
        percdamp=args.gptq_percdamp, actorder=args.gptq_act_order,
        blocksize=args.gptq_blocksize, sample_batch=args.sample_batch,
        pack=True, dtype=dtype, stream_from_host=args.offload,
        quantize_lm_head=args.quantize_lm_head,
        quantizers_path=quantizers_path if args.save_quantizers else None,
        device=dev,
    )
    _save(args, params, config)
    logger.info("saved quantized checkpoint (%s format) to %s (total "
                "%.1fs)", args.save_format, args.save_path, time.time() - t0)


if __name__ == "__main__":
    main()
