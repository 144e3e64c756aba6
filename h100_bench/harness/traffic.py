"""The one traffic generator: it reads a mix's parameters (``traffic/*.json``)
and makes its requests and arrivals from ``--seed``.

Sizes are drawn by blocked stratification: each block of ``block``
consecutive requests holds the same set of prompt and output lengths (the
distribution's quantiles at (i + 0.5) / block), shuffled by the seed, and
each block of ``block`` arrival gaps the same set of exponential gaps.  So
every seed offers the same work in another order, and a window that holds
a few blocks holds nearly the same work whatever the seed; the token ids
(uniform over the vocabulary) are the seed's own.

A mix file holds::

    {"loop": "closed", "clients": 64, "block": 64,
     "prompt": {"dist": "lognormal", "median": 256, "sigma": 0.8,
                "min": 32, "max": 1024},
     "output": {"dist": "uniform", "min": 128, "max": 512}}

or, for an open loop, ``"loop": "open", "arrivals": "poisson"``; the rate
of an open loop (requests per second) is the cell's (``rate_rps`` in its
file), since it follows the configuration's capacity.
"""

from __future__ import annotations

import math
import statistics
import zlib
from typing import Dict, List, Tuple

import numpy as np

_NORMAL = statistics.NormalDist()


def rng(seed: int, *tags) -> np.random.Generator:
    """A generator for one purpose of one seed: any whole number, negative
    or past 64 bits included, with string or integer tags."""
    words = [seed % (1 << 64)]
    for t in tags:
        words.append(zlib.crc32(t.encode()) if isinstance(t, str) else int(t))
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(words)))


def _quantile(dist: Dict, u: float) -> int:
    kind = dist["dist"]
    if kind == "lognormal":
        x = math.exp(math.log(dist["median"])
                     + dist["sigma"] * _NORMAL.inv_cdf(u))
    elif kind == "uniform":
        x = dist["min"] + math.floor(u * (dist["max"] - dist["min"] + 1))
    elif kind == "fixed":
        x = dist["value"]
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return int(min(max(round(x), dist.get("min", 1)),
                   dist.get("max", 1 << 30)))


def stratified(dist: Dict, block: int, seed: int, tag: str, b: int
               ) -> List[int]:
    """Block ``b`` of a length sequence: the distribution's ``block``
    quantiles, shuffled by the seed."""
    vals = [_quantile(dist, (i + 0.5) / block) for i in range(block)]
    order = rng(seed, tag, b).permutation(block)
    return [vals[j] for j in order]


class Traffic:
    """Requests ``(prompt token ids, max new tokens)`` by index, and the
    arrival offsets of an open loop, for one mix, seed and vocabulary."""

    def __init__(self, mix: Dict, seed: int, vocab: int,
                 rate_rps: float = 0.0):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        self.block = int(mix.get("block", 64))
        self.rate = float(rate_rps)
        self._blocks: Dict[int, Tuple[List[int], List[int]]] = {}

    def _block(self, b: int) -> Tuple[List[int], List[int]]:
        if b not in self._blocks:
            self._blocks[b] = (
                stratified(self.mix["prompt"], self.block, self.seed,
                           "prompt", b),
                stratified(self.mix["output"], self.block, self.seed,
                           "output", b))
        return self._blocks[b]

    def sizes(self, i: int) -> Tuple[int, int]:
        """(prompt length, output length) of request ``i``."""
        p, o = self._block(i // self.block)
        return p[i % self.block], o[i % self.block]

    def request(self, i: int) -> Tuple[List[int], int]:
        n, out = self.sizes(i)
        toks = rng(self.seed, "tokens", i).integers(0, self.vocab, size=n)
        return toks.tolist(), out

    def arrivals(self, seconds: float) -> List[float]:
        """Offsets in [0, seconds) of an open loop's arrivals at
        ``rate_rps``: exponential gaps, stratified in blocks."""
        if self.rate <= 0:
            raise ValueError("an open loop needs the cell's rate_rps > 0")
        out: List[float] = []
        t, b = 0.0, 0
        while True:
            us = [(i + 0.5) / self.block for i in range(self.block)]
            order = rng(self.seed, "gaps", b).permutation(self.block)
            for j in order:
                t += -math.log(1.0 - us[j]) / self.rate
                if t >= seconds:
                    return out
                out.append(t)
            b += 1
