#!/usr/bin/env python3
"""Does a row's decode depend on the rows beside it?  On the card.

    python3 scripts/check_batch_invariance.py [--one-pass]

First the primitive: at hidden widths 896 (Qwen2-0.5B), 4096, 5120 and
8192, each of 64 random rows' mean square alone against the same row
among the first n rows, n = 1 .. 64; it prints the row counts that part
(none: invariant).  Then the model: full-width, full-depth Llama-2-7B
(random g128 weights from a seed): the engine prefills chip_smoke.py's
four prompts (100, 300, 600, 900 tokens), then the model decodes 64 greedy
steps over copies of the same caches: all four rows in one forward, rows
0-1 and 2-3 in forwards of their own (the two shards of a data axis of
2), and each row alone (a data axis of 4).  It prints, per split and row,
the first step whose final hidden state differs from the four-row
forward's (none: the decode is batch-invariant).  ``--one-pass`` takes
the RMSNorm's mean square as one ``torch.mean`` over the hidden dim, whose
thread layout on the card depends on how many rows share the call, in
place of ``models/llama.py:_mean_square``.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--one-pass", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("check_batch_invariance: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from qqq_tpu_torch.kernels import build
    from qqq_tpu_torch.models import ModelConfig
    from qqq_tpu_torch.models import llama as M
    from qqq_tpu_torch.serve.engine import Engine, Request
    from qqq_tpu_torch.serve.sampling import SamplingParams

    if args.one_pass:
        M._mean_square = lambda x: torch.mean(x * x, dim=-1, keepdim=True)
    label = "one-pass torch.mean" if args.one_pass else "_mean_square"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for width in (896, 4096, 5120, 8192):
        x = torch.randn(64, width, generator=gen, device=dev)
        alone = torch.cat([M._mean_square(x[i:i + 1]) for i in range(64)])
        parted = [n for n in range(1, 65)
                  if not torch.equal(M._mean_square(x[:n]), alone[:n])]
        print(f"{label}, H {width}: row counts whose rows part from each "
              f"row alone: {parted or 'none'}", flush=True)

    build.build_all()
    config = ModelConfig(vocab_size=cs.V, hidden_size=cs.H,
                         intermediate_size=cs.I, num_hidden_layers=cs.L,
                         num_attention_heads=cs.NH,
                         num_key_value_heads=cs.NKV)
    params = cs.random_packed_params(dev, config, 128)
    eng = Engine(params, config, fuse=False, max_batch=4, max_len=2048,
                 prefill_buckets=cs.BUCKETS)
    rng = np.random.default_rng(0)
    eng._pending.extend(
        Request(prompt_tokens=[int(t) for t in rng.integers(0, cs.V, n)],
                sampling=SamplingParams(max_new_tokens=64))
        for n in cs.PROMPT_LENS)
    eng._admit_whole()  # the prefills alone
    splits = {"2 + 2": (slice(0, 2), slice(2, 4)),
              "1 + 1 + 1 + 1": tuple(slice(r, r + 1) for r in range(4))}
    copies = {name: [[{k: v[sl].clone() for k, v in c.items()}
                      for c in eng.caches] for sl in sls]
              for name, sls in splits.items()}
    tok = torch.tensor(eng.slot_last_tok, device=dev, dtype=torch.int64)
    clen = torch.tensor(eng.slot_len, device=dev, dtype=torch.int32)
    first = {name: {} for name in splits}
    for step in range(64):
        whole, _ = M.forward(eng.params, config, tok[:, None],
                             caches=eng.caches, cache_len=clen,
                             return_hidden=True)
        for name, sls in splits.items():
            parts = torch.cat([M.forward(
                eng.params, config, tok[sl][:, None], caches=copies[name][i],
                cache_len=clen[sl].contiguous(), return_hidden=True)[0]
                for i, sl in enumerate(sls)])
            for r in range(4):
                if r not in first[name] and not torch.equal(whole[r],
                                                            parts[r]):
                    first[name][r] = step
        tok = M.lm_head(eng.params, whole)[:, -1].argmax(-1)
        clen = clen + 1
    for name in splits:
        print(f"{label}, rows {name} against all four: first step whose "
              "hidden state differs, by row: "
              + ", ".join(f"row {r}: {first[name].get(r, 'none')}"
                          for r in range(4)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
