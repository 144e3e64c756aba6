"""Quality evaluation: WikiText2-style perplexity and log-likelihood
scoring (port of qqq_tpu/utils/eval.py).

Perplexity follows the reference's examples/eval_model.py:49-98: the test
encoding is cut into non-overlapping ``seqlen`` windows, each window goes
through the model's cache-free forward, and the shifted cross-entropy is
summed; the result is ``exp(Σ nll / (n_windows · (seqlen − 1)))``, the
count of positions that are actually scored, as the JAX package divides.

:func:`loglikelihood` is the scoring primitive of the zero-shot tasks
(cli/zeroshot.py).  :func:`loglikelihood_batch` pads every request into a
length bucket and always runs ``batch_size`` rows, padding rows included,
as JAX does: the W4A8 linears choose their kernel by the row count M = B·T
(the requant route from 512 rows, ``models/llama.py:_requant_policy``), so a
batch shrunk to its real rows would take another kernel and other numerics
than JAX's.

Everything runs on the device the params live on.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from qqq_tpu_torch.models import llama as M
from qqq_tpu_torch.models.config import ModelConfig


def _device(params: Dict[str, Any]) -> torch.device:
    return params["embed"].device


def _window_nll(params, config: ModelConfig, tokens: torch.Tensor
                ) -> torch.Tensor:
    """Σ shifted cross-entropy over one (B, T) window (eval_model.py:85-95),
    a 0-d f32 tensor on the device."""
    logits, _ = M.forward(params, config, tokens)
    logp = torch.log_softmax(logits[:, :-1, :], dim=-1)
    tgt = tokens[:, 1:].to(torch.int64)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    return nll.sum()


@torch.no_grad()
def perplexity(
    params: Dict[str, Any],
    config: ModelConfig,
    test_tokens: np.ndarray,  # (N,) int32 flat encoding
    *,
    seqlen: int = 2048,
    max_windows: int = 0,
    batch: int = 1,
) -> float:
    n_windows = test_tokens.shape[0] // seqlen
    if max_windows:
        n_windows = min(n_windows, max_windows)
    dev = _device(params)
    total = 0.0
    for b0 in range(0, n_windows, batch):
        rows = [test_tokens[i * seqlen:(i + 1) * seqlen]
                for i in range(b0, min(b0 + batch, n_windows))]
        tok = torch.from_numpy(np.stack(rows).astype(np.int32)).to(dev)
        total += float(_window_nll(params, config, tok))
    # eval_model.py:97's normalization, over the shifted positions
    return float(np.exp(total / (n_windows * (seqlen - 1))))


def loglikelihood(
    params: Dict[str, Any],
    config: ModelConfig,
    context: Sequence[int],
    continuation: Sequence[int],
) -> Tuple[float, bool]:
    """(logprob of continuation given context, is_greedy): the lm_eval
    scoring contract for multiple-choice zero-shot tasks."""
    ll, greedy = loglikelihood_batch(
        params, config, [(list(context), list(continuation))]
    )[0]
    return ll, greedy


def _score_batch(params, config: ModelConfig, tokens: torch.Tensor,
                 ctx_len: torch.Tensor, total_len: torch.Tensor):
    """Σ log p(continuation) per row: positions [ctx_len − 1, total_len − 1)
    predicting tokens[pos + 1], by masking (a padded batch); and whether
    every one of those tokens is the argmax."""
    logits, _ = M.forward(params, config, tokens)
    logp = torch.log_softmax(logits[:, :-1, :].to(torch.float32), dim=-1)
    tgt = tokens[:, 1:].to(torch.int64)
    tok_lp = torch.gather(logp, -1, tgt[..., None])[..., 0]
    pos = torch.arange(tokens.shape[1] - 1, dtype=torch.int32,
                       device=tokens.device)[None, :]
    mask = (pos >= ctx_len[:, None] - 1) & (pos < total_len[:, None] - 1)
    ll = torch.where(mask, tok_lp, torch.zeros_like(tok_lp)).sum(dim=1)
    greedy_tok = torch.argmax(logp, dim=-1)
    all_greedy = torch.where(mask, greedy_tok == tgt,
                             torch.ones_like(mask)).all(dim=1)
    return ll, all_greedy


@torch.no_grad()
def loglikelihood_batch(
    params: Dict[str, Any],
    config: ModelConfig,
    pairs: Sequence[Tuple[Sequence[int], Sequence[int]]],
    *,
    batch_size: int = 8,
    buckets: Sequence[int] = (64, 128, 256, 512, 1024, 2048),
) -> list:
    """Batched scoring: requests are grouped into padded length buckets of
    ``batch_size`` rows each (padding rows score ``ctx_len = total_len =
    2``, nothing); a request longer than the last bucket keeps its last
    tokens, as lm_eval truncates.  Returns [(ll, is_greedy)] in input
    order."""
    items = []
    for idx, (ctx, cont) in enumerate(pairs):
        toks = list(ctx) + list(cont)
        bucket = next((b for b in buckets if len(toks) <= b), None)
        if bucket is None:
            toks = toks[-buckets[-1]:]  # left-truncate like lm_eval
            bucket = buckets[-1]
        items.append((bucket, idx, toks, len(ctx), len(toks)))

    dev = _device(params)
    results: list = [None] * len(pairs)
    by_bucket: Dict[int, list] = {}
    for it in items:
        by_bucket.setdefault(it[0], []).append(it)
    for bucket, group in by_bucket.items():
        for i0 in range(0, len(group), batch_size):
            chunk = group[i0:i0 + batch_size]
            B = batch_size  # JAX's fixed batch shape (see the docstring)
            toks = np.zeros((B, bucket), np.int32)
            ctx_len = np.full((B,), 2, np.int32)
            total_len = np.full((B,), 2, np.int32)
            for r, (_, _, t, cl, tl) in enumerate(chunk):
                toks[r, :len(t)] = t
                ctx_len[r] = cl
                total_len[r] = tl
            ll, greedy = _score_batch(
                params, config, torch.from_numpy(toks).to(dev),
                torch.from_numpy(ctx_len).to(dev),
                torch.from_numpy(total_len).to(dev),
            )
            ll, greedy = ll.cpu().numpy(), greedy.cpu().numpy()
            for r, (_, idx, _, _, _) in enumerate(chunk):
                results[idx] = (float(ll[r]), bool(greedy[r]))
    return results
