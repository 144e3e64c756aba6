"""Token sampling: greedy / temperature / top-k / top-p / min-p, and the
per-request extras: penalties, logit bias, guided-choice masks, seeded rows
and top-N logprobs (port of qqq_tpu/serve/sampling.py).

:func:`sample_batched` takes per-row parameter tensors, so one batch mixes
greedy and sampled rows; which of its branches runs is decided on the host
from the rows' parameters (:func:`sampling_branch`, the counterpart of the
JAX engine's static arguments), so that the sampler reads nothing back from
the device and a decode tick can be captured in a CUDA graph, one graph a
branch.  Sampling is explicit Gumbel-max
(``argmax(logits / t + gumbel)``) with noise drawn from a caller-owned
``torch.Generator``; it gives other numbers than ``jax.random`` for the same
seed, with the same distribution.

A seeded row's noise is instead a function of (seed, generation index,
token id) alone (:func:`seeded_gumbel`, a counter-based integer hash in
torch ops): the seed travels as tensor data, so a captured graph replays
it, and the row draws the same tokens in any batch position, slot, KV
layout or number of steps a tick.  The hash is the port's own: seeded
tokens are not JAX's (``fold_in(PRNGKey(seed), n)``).
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
    #: reproducible sampling (OpenAI ``seed``; rows with temperature > 0)
    seed: Optional[int] = None
    max_new_tokens: int = 128
    eos_token_id: Optional[int] = None
    #: extra token ids that end generation exactly like EOS
    stop_token_ids: tuple = ()
    #: OpenAI presence / frequency penalties over generated-token counts (0
    #: → off) and the HF/vLLM multiplicative repetition penalty over prompt
    #: ∪ generated tokens (1 → off)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    #: OpenAI ``logit_bias``: ((token_id, bias), ...) added before sampling
    logit_bias: tuple = ()
    #: report the N highest raw-model logprobs per generated token (0 → off)
    top_logprobs: int = 0
    #: candidate token sequences; every generated token is masked to the
    #: candidates' continuations, and a completed candidate ends the row
    guided_choice: tuple = ()

    @property
    def has_penalties(self) -> bool:
        return (self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0
                or self.repetition_penalty != 1.0)


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


def apply_penalties(
    logits: torch.Tensor,       # (B, V) f32
    counts: torch.Tensor,       # (B, V) int32 generated-token counts
    prompt_mask: torch.Tensor,  # (B, V) bool: tokens of the prompt
    presence: torch.Tensor,     # (B,) f32; 0 → off
    frequency: torch.Tensor,    # (B,) f32; 0 → off
    repetition: torch.Tensor,   # (B,) f32; 1 → off
) -> torch.Tensor:
    """vLLM's order: the repetition penalty first, on the raw logits of
    prompt ∪ generated tokens; then presence and frequency, subtracted over
    the generated counts.  A row with every penalty off is unchanged."""
    c = counts.to(torch.float32)
    gen = c > 0
    rep = repetition[:, None]
    penal = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(prompt_mask | gen, penal, logits)
    return logits - presence[:, None] * gen - frequency[:, None] * c


def apply_allowed_mask(logits: torch.Tensor, ids: torch.Tensor
                       ) -> torch.Tensor:
    """Guided decoding's mask: a row with at least one valid id in ``ids``
    (B, K) keeps only those ids' logits (the rest → -1e30); a row of pads
    (id == V) is left as it is."""
    B, V = logits.shape
    ids = ids.to(torch.int64)
    # pads land in an extra column V, dropped after the scatter
    wide = torch.nn.functional.pad(logits, (0, 1), value=-1e30)
    masked = torch.full_like(wide, -1e30).scatter_(
        1, ids, torch.gather(wide, 1, ids))[:, :V]
    has = (ids < V).any(dim=1, keepdim=True)
    return torch.where(has, masked, logits)


def apply_logit_bias(logits: torch.Tensor, ids: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """OpenAI ``logit_bias``: add ``vals`` (B, K) f32 at ``ids`` (B, K);
    pad entries are (0, 0.0), which add nothing."""
    return logits.scatter_add(1, ids.to(torch.int64), vals)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))`` from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xorshift-multiply rounds) on int64
    values in [0, 2^32); every product stays below 2^59."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _MASK32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _MASK32
    return (x >> 16) ^ x


def seeded_gumbel(seeds: torch.Tensor, ngen: torch.Tensor, V: int
                  ) -> torch.Tensor:
    """(B, V) Gumbel noise of each row a function of (its seed, its
    generation index ``ngen``, the token id) only."""
    row = _mix32(seeds.to(torch.int64) & _MASK32)
    row = _mix32(((row ^ (ngen.to(torch.int64) & _MASK32)) + 0x9E3779B9)
                 & _MASK32)
    tok = torch.arange(V, dtype=torch.int64, device=seeds.device)
    h = _mix32((row[:, None] ^ _mix32(tok)[None, :]) & _MASK32)
    # the top 23 bits, centred in their cell: u in (0, 1), exact in f32
    u = ((h >> 9).to(torch.float32) + 0.5) * (1.0 / (1 << 23))
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
    seeded: Optional[torch.Tensor] = None,  # (B,) bool: rows with a seed
    seeds: Optional[torch.Tensor] = None,   # (B,) int32
    ngen: Optional[torch.Tensor] = None,    # (B,) int32 tokens so far
    *,
    branch: str,                 # sampling_branch() of the same rows
) -> torch.Tensor:
    """Returns (B,) int32 next tokens; every row honours its own params.
    Penalties, bias and guided masks are applied by the caller before this,
    so greedy rows honour them too.  The greedy branch draws no noise and
    sorts nothing; only the filtered one sorts.  With ``seeded`` (which the
    caller passes only when some row has a seed), those rows take
    :func:`seeded_gumbel` in place of the generator's noise."""
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
    if seeded is not None:
        g = torch.where(seeded[:, None], seeded_gumbel(seeds, ngen, V), g)
    sampled = torch.argmax(scaled + g, dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, sampled)


def top_logprobs(logits: torch.Tensor, n: int):
    """(values, ids) of the ``n`` highest raw-model logprobs of each row:
    (B, n) f32 and int64, highest first."""
    lsm = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.topk(lsm, n, dim=-1)


def chosen_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Raw-model log-probability of each row's chosen token (B,) f32."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(lp, -1, tok.to(torch.int64)[:, None])[:, 0]


def penalty_arrays(params_list, n: Optional[int] = None):
    """(presence, frequency, repetition) host f32 arrays, one entry a
    SamplingParams (None → off)."""
    if n is None:
        n = len(params_list)
    pres = np.zeros((n,), np.float32)
    freq = np.zeros((n,), np.float32)
    rep = np.ones((n,), np.float32)
    for i, sp in enumerate(params_list[:n]):
        if sp is None:
            continue
        pres[i] = sp.presence_penalty
        freq[i] = sp.frequency_penalty
        rep[i] = sp.repetition_penalty
    return pres, freq, rep


def bias_arrays(params_list, n: Optional[int] = None):
    """The ``logit_bias`` pairs as (ids int32, vals f32) host arrays of
    (n, K), K the most pairs of a row rounded up to a power of two (pads
    (0, 0.0)); (None, None) when no row has a bias."""
    if n is None:
        n = len(params_list)
    kmax = max((len(sp.logit_bias) for sp in params_list[:n]
                if sp is not None), default=0)
    if kmax == 0:
        return None, None
    K = 1 << (kmax - 1).bit_length()
    ids = np.zeros((n, K), np.int32)
    vals = np.zeros((n, K), np.float32)
    for i, sp in enumerate(params_list[:n]):
        if sp is None:
            continue
        for j, (tok, b) in enumerate(sp.logit_bias):
            ids[i, j] = tok
            vals[i, j] = b
    return ids, vals
