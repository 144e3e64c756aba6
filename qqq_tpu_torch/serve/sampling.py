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

A seeded row's noise is instead JAX's own stream: the i-th generated
token's noise is ``gumbel(fold_in(PRNGKey(seed), i), (V,))``
(:func:`seeded_gumbel`), with JAX's threefry2x32, its partitionable random
bits, its uniform in [tiny, 1) and its Gumbel transform written in int64
torch ops that hold uint32 values.  The generator is counter-based and
takes seed and index as tensor data, so a captured graph replays it and
the row draws the same tokens in any batch position, slot, KV layout or
number of steps a tick; the tokens are JAX's wherever the logits are.
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

    @property
    def alters_logits(self) -> bool:
        """The row samples from other than the raw model distribution
        (penalties, a logit bias or a guided choice): speculative decoding
        gives it no drafts, since only a verify's position 0 takes that
        stack."""
        return (self.has_penalties or bool(self.logit_bias)
                or bool(self.guided_choice))


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
#: threefry2x32's rotations, alternating by group of four rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl32(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK32


def threefry2x32(k0, k1, x0, x1):
    """JAX's threefry2x32 (jax/_src/prng.py:_threefry2x32_lowering): 20
    rounds with a key injection after every four, on int64 tensors that
    hold uint32 values (broadcast against each other)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _MASK32, (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def seeded_bits(seeds: torch.Tensor, ngen: torch.Tensor, V: int
                ) -> torch.Tensor:
    """(B, V) int64 holding uint32: ``jax.random.bits(fold_in(PRNGKey(s),
    n), (V,))`` for each row's seed s (int32, ≥ 0) and generation index n.
    ``PRNGKey(s)`` is the key (0, s); ``fold_in`` hashes the counter (0, n)
    under it into the row's key; the partitionable bits hash the counters
    (0, j) of the V positions and xor the two words."""
    s = (seeds.to(torch.int64) & _MASK32)[:, None]
    n = (ngen.to(torch.int64) & _MASK32)[:, None]
    zero = torch.zeros_like(s)
    k0, k1 = threefry2x32(zero, s, zero, n)
    j = torch.arange(V, dtype=torch.int64, device=seeds.device)[None, :]
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(j), j)
    return b0 ^ b1


def seeded_uniform(seeds: torch.Tensor, ngen: torch.Tensor, V: int
                   ) -> torch.Tensor:
    """(B, V) f32: ``jax.random.uniform(key, (V,), minval=tiny,
    maxval=1)`` of :func:`seeded_bits`' keys: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, times (1 − tiny) = 1 in f32,
    plus tiny, at least tiny (jax/_src/random.py:_uniform)."""
    bits = seeded_bits(seeds, ngen, V)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f + _F32_TINY, _F32_TINY)


def seeded_gumbel(seeds: torch.Tensor, ngen: torch.Tensor, V: int
                  ) -> torch.Tensor:
    """(B, V) f32 Gumbel noise ``jax.random.gumbel(fold_in(PRNGKey(seed),
    ngen), (V,))`` (mode "low": ``-log(-log(u))``) of each row."""
    return -torch.log(-torch.log(seeded_uniform(seeds, ngen, V)))


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


def sample_batched_sharded(
    local_logits: torch.Tensor,  # (B, V_local) f32: this rank's vocab slice
    generator: torch.Generator,
    temperature: torch.Tensor,   # (B,) f32; <= 0 → greedy
    tp,                          # the model axis (parallel.collectives.Axis)
    vocab_size: int,
    data_axis=None,              # the data axis, when the batch is sharded
    *,
    branch: str,                 # sampling_branch() of the GLOBAL rows
) -> torch.Tensor:
    """Greedy / temperature sampling on vocab-sharded logits without
    gathering them: a Gumbel-max on each rank's slice, then a distributed
    argmax in two collectives (``pmax`` of the winning value, ``pmin`` of
    the winners' global indices), so ties go to the lowest global index as
    ``torch.argmax`` gives them.  Two (B,) vectors cross the axis instead of
    the (B, V) logits.

    The noise is :func:`gumbel` of the GLOBAL shape (B · dp, V), drawn on
    every rank from generators in equal states and sliced at (this data
    shard's first row, this rank's first vocab index), so a row's noise
    depends only on its global (row, vocab) position and the tokens equal
    :func:`sample_batched`'s (top-k, top-p and min-p off) on the gathered
    logits bit for bit; the generator advances as there (no draw in the
    greedy branch).  With replicated logits (``V_local == vocab_size``,
    tied embeddings) each rank samples its rows locally."""
    from qqq_tpu_torch.parallel.collectives import pmax, pmin

    B, Vl = local_logits.shape
    dp = 1 if data_axis is None else data_axis.size
    row0 = 0 if data_axis is None else data_axis.index * B
    if branch not in (GREEDY, SAMPLED):
        raise ValueError(f"sharded sampling takes the greedy and sampled "
                         f"branches, not {branch!r}")
    g = None
    if branch == SAMPLED:
        g = gumbel((B * dp, vocab_size), generator, local_logits.device)
    if Vl == vocab_size:  # replicated logits
        greedy = torch.argmax(local_logits, dim=-1).to(torch.int32)
        if g is None:
            return greedy
        t = torch.clamp_min(temperature, 1e-6)[:, None]
        sampled = torch.argmax(local_logits / t + g[row0:row0 + B],
                               dim=-1).to(torch.int32)
        return torch.where(temperature <= 0.0, greedy, sampled)
    v_start = tp.index * Vl
    z = local_logits
    if g is not None:
        t = torch.clamp_min(temperature, 1e-6)[:, None]
        z = torch.where(temperature[:, None] > 0.0,
                        local_logits / t + g[row0:row0 + B,
                                             v_start:v_start + Vl],
                        local_logits)
    local_arg = torch.argmax(z, dim=-1)  # the first of equal maxima
    local_best = torch.gather(z, -1, local_arg[:, None])[:, 0]
    best = pmax(local_best.clone(), tp)
    cand = torch.where(local_best == best,
                       local_arg.to(torch.int32) + v_start,
                       torch.full_like(local_arg, vocab_size,
                                       dtype=torch.int32))
    return pmin(cand.contiguous(), tp)


def chosen_logprob_sharded(
    local_logits: torch.Tensor,  # (B, V_local) f32: this rank's vocab slice
    tok: torch.Tensor,           # (B,) GLOBAL token ids
    tp,
    vocab_size: int,
) -> torch.Tensor:
    """:func:`chosen_logprob` over vocab-sharded logits without gathering
    them: a distributed logsumexp (``pmax`` of the row maxima, ``psum`` of
    the shifted exp-sums) and a ``pmax`` that fetches the chosen token's
    logit from the rank that holds it; three (B,) collectives.  The
    result is taken as (logit − max) − log(sum), as ``log_softmax`` takes
    it (JAX adds the max back first, which costs an ulp of the max when
    the logits are large)."""
    from qqq_tpu_torch.parallel.collectives import pmax, psum

    B, Vl = local_logits.shape
    if Vl == vocab_size:  # replicated logits (tied embeddings)
        return chosen_logprob(local_logits, tok)
    z = local_logits.to(torch.float32)
    m = pmax(z.amax(dim=-1).contiguous(), tp)
    log_sum = torch.log(psum(torch.exp(z - m[:, None]).sum(dim=-1)
                             .contiguous(), tp))
    v_start = tp.index * Vl
    tok = tok.to(torch.int64)
    idx = torch.clamp(tok - v_start, 0, Vl - 1)
    mine = (tok >= v_start) & (tok < v_start + Vl)
    local_val = torch.gather(z, -1, idx[:, None])[:, 0]
    logit_tok = pmax(torch.where(mine, local_val, -torch.inf).contiguous(),
                     tp)
    return (logit_tok - m) - log_sum


def top_logprobs(logits: torch.Tensor, n: int):
    """(values, ids) of the ``n`` highest raw-model logprobs of each row:
    (B, n) f32 and int64, highest first."""
    lsm = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.topk(lsm, n, dim=-1)


def chosen_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Raw-model log-probability of each row's chosen token (B,) f32."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(lp, -1, tok.to(torch.int64)[:, None])[:, 0]


def sampling_arrays(params_list, n: Optional[int] = None):
    """(temperature, top_k, top_p, min_p) host arrays (f32, int32, f32,
    f32), one entry a SamplingParams; ``None`` entries (inactive slots) are
    greedy, and ``n`` pads or truncates to a fixed batch size."""
    if n is None:
        n = len(params_list)
    temp = np.zeros((n,), np.float32)
    topk = np.zeros((n,), np.int32)
    topp = np.ones((n,), np.float32)
    minp = np.zeros((n,), np.float32)
    for i, sp in enumerate(params_list[:n]):
        if sp is None:
            continue
        temp[i] = sp.temperature
        topk[i] = sp.top_k
        topp[i] = sp.top_p
        minp[i] = sp.min_p
    return temp, topk, topp, minp


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


def sample(
    logits: torch.Tensor,  # (B, V) f32
    generator: torch.Generator,
    params: SamplingParams,
) -> torch.Tensor:
    """Single-config convenience wrapper; returns (B,) int32 next tokens."""
    B, dev = logits.shape[0], logits.device
    return sample_batched(
        logits,
        generator,
        torch.full((B,), params.temperature, dtype=torch.float32, device=dev),
        torch.full((B,), params.top_k, dtype=torch.int32, device=dev),
        torch.full((B,), params.top_p, dtype=torch.float32, device=dev),
        torch.full((B,), params.min_p, dtype=torch.float32, device=dev),
        branch=sampling_branch(params.temperature, params.top_k,
                               params.top_p, params.min_p),
    )
