"""Text-generation smoke CLI (port of qqq_tpu/cli/generate.py).

Usage:
  python -m qqq_tpu_torch.cli.generate --model_path <dir> \
      --prompt "The capital of France is" --max_new_tokens 64
  python -m qqq_tpu_torch.cli.generate --model_path <dir> \
      --prompt_tokens 1,450,7483 --prompt_tokens 1,306 --device cpu

``--prompt`` needs a tokenizer (``transformers`` and one at the model or
tokenizer path); ``--prompt_tokens`` (comma-separated ids, repeatable)
needs none, and then the output is printed as token ids.
"""

from __future__ import annotations

import argparse
import logging

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--prompt", nargs="+", default=None)
    p.add_argument("--prompt_tokens", action="append", default=None,
                   help="a prompt as comma-separated token ids; repeat the "
                        "flag for more prompts")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--max_length", type=int, default=2048)
    p.add_argument("--kv_int8", action="store_true", default=True)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help=">0 enables chunked prefill: prompts prefill this "
                        "many tokens per tick interleaved with decode")
    p.add_argument("--prefix_cache", action="store_true",
                   help="with --prefill_chunk: prompts sharing a prefix "
                        "with a finished one skip re-prefilling it")
    p.add_argument("--spec_ngram", type=int, default=0,
                   help=">0: prompt-lookup speculative decoding (exact "
                        "for greedy; faster on repetitive continuations)")
    p.add_argument("--spec_k", type=int, default=4,
                   help="max draft tokens verified per speculative tick")
    p.add_argument("--device", default="cuda",
                   help="the CUDA card by default; 'cpu' runs the plain "
                        "PyTorch versions of the kernels")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    from qqq_tpu_torch.cli.eval import load_any
    from qqq_tpu_torch.cli.serve import load_tokenizer
    from qqq_tpu_torch.serve.engine import generate
    from qqq_tpu_torch.serve.sampling import SamplingParams

    params, config = load_any(args.model_path, dtype, device=args.device)
    tok = None
    if args.prompt_tokens:
        labels = args.prompt_tokens
        prompts = [[int(t) for t in s.split(",")] for s in labels]
    else:
        tok = load_tokenizer(args.tokenizer_path or args.model_path)
        if tok is None:
            raise SystemExit("no tokenizer: pass --prompt_tokens")
        labels = args.prompt or ["The capital of France is"]
        prompts = [tok(p).input_ids for p in labels]
    sampling = SamplingParams(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        max_new_tokens=args.max_new_tokens,
        eos_token_id=tok.eos_token_id if tok is not None else None,
    )
    outs = generate(
        params, config, prompts, sampling, max_batch=max(len(prompts), 1),
        max_len=args.max_length, kv_quantized=args.kv_int8, dtype=dtype,
        prefill_chunk=args.prefill_chunk, prefix_cache=args.prefix_cache,
        spec_ngram=args.spec_ngram, spec_k=args.spec_k, device=args.device,
    )
    for label, out in zip(labels, outs):
        print(f"=== {label!r}")
        print(tok.decode(out) if tok is not None else out)
    return outs


if __name__ == "__main__":
    main()
