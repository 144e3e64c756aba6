"""Token sampling: greedy / temperature / top-k / top-p / min-p (port of
qqq_tpu/serve/sampling.py).

:func:`sample_batched` takes per-row parameter tensors, so one batch mixes
greedy and sampled rows; which of its branches runs is decided on the host
from the rows' parameters (:func:`sampling_branch`, the counterpart of the
JAX engine's static arguments), so that the sampler reads nothing back from
the device and a decode tick can be captured in a CUDA graph, one graph a
branch.  Sampling is explicit Gumbel-max
(``argmax(logits / t + gumbel)``) with noise drawn from a caller-owned
``torch.Generator``; it gives other numbers than ``jax.random`` for the same
seed, with the same distribution.  Penalties, logit bias, guided masks,
per-request seeds and top-N logprobs arrive in a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

#: the sampler's branches: every row greedy (no noise drawn, nothing
#: sorted); some row sampled from its whole distribution; some row's
#: top-k, top-p or min-p filter set as well
GREEDY, SAMPLED, FILTERED = "greedy", "sampled", "filtered"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 → greedy
    top_k: int = 0            # 0 → disabled
    top_p: float = 1.0        # 1 → disabled
    min_p: float = 0.0        # 0 → disabled (vLLM min-p filtering)
    seed: Optional[int] = None
    max_new_tokens: int = 128
    eos_token_id: Optional[int] = None
    #: extra token ids that end generation exactly like EOS
    stop_token_ids: tuple = ()
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    logit_bias: tuple = ()
    top_logprobs: int = 0
    guided_choice: tuple = ()

    @property
    def has_penalties(self) -> bool:
        return (self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0
                or self.repetition_penalty != 1.0)

    def later_slice_features(self) -> list:
        """Names of the set fields whose sampling this slice does not port."""
        names = []
        if self.has_penalties:
            names.append("penalties")
        if self.logit_bias:
            names.append("logit_bias")
        if self.guided_choice:
            names.append("guided_choice")
        if self.top_logprobs:
            names.append("top_logprobs")
        if self.seed is not None:
            names.append("seed")
        return names


def _topk_topp_filter(
    scaled: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor,
    min_p: torch.Tensor,
) -> torch.Tensor:
    """Mask logits below the per-row min-p / top-k / top-p cutoffs to -inf."""
    V = scaled.shape[-1]
    neg_inf = -torch.inf
    # min-p: threshold at max_logit + log(min_p) (vLLM semantics)
    cut = scaled.amax(dim=-1, keepdim=True) + torch.log(
        torch.clamp_min(min_p, 1e-30))[:, None]
    scaled = torch.where((min_p[:, None] > 0.0) & (scaled < cut), neg_inf,
                         scaled)
    # top-k: kth-largest per row as threshold (k = 0 keeps everything)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = torch.clamp(top_k.to(torch.int64) - 1, 0, V - 1)
    kth = torch.gather(sorted_desc, -1, k_idx[:, None])
    scaled = torch.where((top_k[:, None] > 0) & (scaled < kth), neg_inf,
                         scaled)
    # top-p: smallest prefix (by prob) with cumulative mass >= top_p
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    cutoff_idx = torch.sum(cum < top_p[:, None], dim=-1)
    cutoff = torch.gather(sorted_desc, -1,
                          torch.clamp(cutoff_idx, 0, V - 1)[:, None])
    return torch.where((top_p[:, None] < 1.0) & (scaled < cutoff), neg_inf,
                       scaled)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))`` from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sampling_branch(temperature, top_k, top_p, min_p) -> str:
    """The branch of :func:`sample_batched` for rows with these parameters
    (host arrays, one entry a row; a row left out is greedy)."""
    if not (np.asarray(temperature) > 0.0).any():
        return GREEDY
    if ((np.asarray(top_k) > 0).any() or (np.asarray(top_p) < 1.0).any()
            or (np.asarray(min_p) > 0.0).any()):
        return FILTERED
    return SAMPLED


def sample_batched(
    logits: torch.Tensor,        # (B, V) f32
    generator: torch.Generator,
    temperature: torch.Tensor,   # (B,) f32; <= 0 → greedy for that row
    top_k: torch.Tensor,         # (B,) int; 0 → disabled
    top_p: torch.Tensor,         # (B,) f32; >= 1 → disabled
    min_p: Optional[torch.Tensor] = None,  # (B,) f32; 0 → disabled
    *,
    branch: str,                 # sampling_branch() of the same rows
) -> torch.Tensor:
    """Returns (B,) int32 next tokens; every row honours its own params.
    The greedy branch draws no noise and sorts nothing; only the filtered
    one sorts."""
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if branch == GREEDY:
        return greedy
    if branch not in (SAMPLED, FILTERED):
        raise ValueError(f"sampling branch {branch!r}")
    if min_p is None:
        min_p = torch.zeros((B,), dtype=torch.float32, device=logits.device)
    scaled = logits / torch.clamp_min(temperature, 1e-6)[:, None]
    if branch == FILTERED:
        scaled = _topk_topp_filter(scaled, top_k, top_p, min_p)
    g = gumbel((B, V), generator, logits.device)
    sampled = torch.argmax(scaled + g, dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, sampled)


def chosen_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Raw-model log-probability of each row's chosen token (B,) f32."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(lp, -1, tok.to(torch.int64)[:, None])[:, 0]
