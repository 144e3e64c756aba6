"""Quantization range observers (port of qqq_tpu/calib/observers.py): the
reference's thirteen estimators as stateful dataclasses over torch tensors.

Registry (reference QQQ/smooth/quantization/observer.py):

* minmax             MinMaxObserver           last-batch min/max
* quantile           QuantileObserver         minmax + token pruning
* lsq_plus           LSQPlusObserver          mean ± 3·std (ddof=1)
* avg_minmax         AvgMinMaxObserver        running mean of ranges
* ema_minmax         EMAMinMaxObserver        EMA of ranges
* avg_token_quantile AvgTokenQuantileObserver pruned-token average
* ema_quantile       EMAQuantileObserver      |x|-histogram clip, EMA
* avg_quantile       AvgQuantileObserver      |x|-histogram clip, average
* mse                MSEObserver              1D/2D grid, expanding
* avg_mse            AvgMSEObserver           grid, running mean
* mse_fast           MSEFastObserver          bounded scalar search
* avg_mse_fast       AvgMSEFastObserver
* ema_mse_fast       EMAMSEFastObserver

The symmetric range is ±(2^(b-1) − 1), so the 8-bit symmetric scale is
absmax / 127, as the deployed kernel's.  Every observer runs on the device
of the tensors it is given; the MSEFast family's bounded search
(``scipy.optimize.minimize_scalar``) drives its loss from the host, one
device reduction per evaluation, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from qqq_tpu_torch.core.quant import true_div

_EPS = 1.1920929e-07  # torch.finfo(float32).eps, the reference's eps buffer


def _flatten_ch(x: torch.Tensor, ch_axis: int) -> torch.Tensor:
    """(…, C, …) → (C, rest)."""
    x = torch.movedim(x, ch_axis, 0)
    return x.reshape(x.shape[0], -1)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def quantile(a: torch.Tensor, q, dim: Optional[int] = None,
             keepdim: bool = False) -> torch.Tensor:
    """Linear-interpolation quantile with ``jnp.quantile``'s arithmetic:
    ``q · (n − 1)`` in f32, ``low · (1 − w) + high · w``.  Any size (no
    ``torch.quantile`` element limit)."""
    if dim is None:
        a, dim = a.reshape(-1), 0
    a = torch.sort(a, dim=dim).values
    n = a.shape[dim]
    qf = _f32(q, a) * (n - 1)
    low, high = torch.floor(qf), torch.ceil(qf)
    hw = qf - low
    lw = 1 - hw
    lo = int(torch.clamp(low, 0, n - 1).item())
    hi = int(torch.clamp(high, 0, n - 1).item())
    out = (a.narrow(dim, lo, 1) * lw + a.narrow(dim, hi, 1) * hw)
    return out if keepdim else out.squeeze(dim)


def quant_range(bit: int, symmetric: bool) -> Tuple[int, int]:
    """The symmetric range is ±(2^(b-1) − 1): quant_min = −2^(b-1) + 1."""
    if symmetric:
        return -(2 ** (bit - 1)) + 1, 2 ** (bit - 1) - 1
    return 0, 2**bit - 1


def calculate_qparams(
    min_val: torch.Tensor, max_val: torch.Tensor, bit: int, symmetric: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    quant_min, quant_max = quant_range(bit, symmetric)
    min_neg = torch.clamp_max(min_val, 0.0)
    max_pos = torch.clamp_min(max_val, 0.0)
    if symmetric:
        max_pos = torch.maximum(-min_neg, max_pos)
        scale = torch.clamp_min(
            true_div(max_pos, (quant_max - quant_min) / 2.0), _EPS)
        zero = torch.zeros_like(scale)
    else:
        scale = torch.clamp_min(
            true_div(max_pos - min_neg, float(quant_max - quant_min)), _EPS)
        zero = torch.clamp(quant_min - torch.round(min_neg / scale),
                           quant_min, quant_max)
    return scale, zero


def fake_quant(x: torch.Tensor, scale, zero, bit: int,
               symmetric: bool) -> torch.Tensor:
    """Fake quantization with the observer ranges; ``scale`` (a tensor) and
    ``zero`` broadcast against ``x``."""
    qmin, qmax = quant_range(bit, symmetric)
    q = torch.clamp(torch.round(x / scale) + zero, qmin, qmax)
    return (q - zero) * scale


# ---------------------------------------------------------------------------
# base + minmax family


@dataclasses.dataclass
class RangeObserver:
    """MinMaxObserver: the last batch wins."""

    bit: int = 8
    symmetric: bool = True
    ch_axis: int = -1  # -1 = per-tensor
    min_val: Optional[torch.Tensor] = None
    max_val: Optional[torch.Tensor] = None
    _count: int = 0

    def _batch_range(self, x: torch.Tensor):
        if self.ch_axis == -1:
            return torch.amin(x), torch.amax(x)
        y = _flatten_ch(x, self.ch_axis)
        return torch.amin(y, dim=1), torch.amax(y, dim=1)

    def _combine(self, cur_min, cur_max):
        return cur_min, cur_max

    def _mask(self, x: torch.Tensor, mask) -> torch.Tensor:
        """Drop masked-out tokens: ``mask`` (B, T) selects tokens of x
        (B, T, C), or elements when x is itself (B, T)."""
        if mask is None:
            return x
        if self.ch_axis != -1:
            raise ValueError("a mask only for per-tensor observers")
        m = np.asarray(mask)
        keep = torch.as_tensor(np.nonzero(m.reshape(-1).astype(bool))[0],
                               device=x.device)
        if x.ndim == m.ndim:
            return x.reshape(-1)[keep]
        return x.reshape(-1, x.shape[-1])[keep]

    def update(self, x: torch.Tensor, mask=None):
        x = self._mask(x.to(torch.float32), mask)
        cur_min, cur_max = self._batch_range(x)
        self.min_val, self.max_val = self._combine(cur_min, cur_max)
        self._count += 1
        return self.min_val, self.max_val

    def qparams(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.min_val is None:
            raise ValueError("observer saw no data")
        return calculate_qparams(self.min_val, self.max_val, self.bit,
                                 self.symmetric)


class MinMaxObserver(RangeObserver):
    pass


def _running_mean(old, cur, c: int):
    return true_div(old * c + cur, float(c + 1))


def _ema(old, cur, r: float):
    return old * r + cur * (1 - r)


def prune_token(y: torch.Tensor, percentile: float) -> torch.Tensor:
    """Clip ``y`` (tokens, C) into the range of the tokens whose max (min)
    lies within the ``percentile`` quantile of the per-token |max| (|min|)."""
    t_max = torch.amax(y, dim=1)
    t_min = torch.amin(y, dim=1)
    upper = quantile(t_max.abs(), percentile)
    lower = -quantile(t_min.abs(), percentile)
    inf = torch.tensor(float("inf"), device=y.device)
    sel_upper = torch.amax(torch.where(t_max <= upper, t_max, -inf))
    sel_lower = torch.amin(torch.where(t_min >= lower, t_min, inf))
    return torch.clamp(y, sel_lower, sel_upper)


@dataclasses.dataclass
class QuantileObserver(RangeObserver):
    """Per-tensor: plain minmax; per-channel (tokens on ch_axis): outlier
    tokens pruned first (:func:`prune_token`)."""

    percentile: float = 1.0

    def _batch_range(self, x):
        if self.ch_axis == -1:
            return torch.amin(x), torch.amax(x)
        y = prune_token(_flatten_ch(x, self.ch_axis), self.percentile)
        return torch.amin(y, dim=1), torch.amax(y, dim=1)


@dataclasses.dataclass
class LSQPlusObserver(RangeObserver):
    """Range = mean ± 3·std (ddof = 1)."""

    def _batch_range(self, x):
        if self.ch_axis == -1:
            m, s = torch.mean(x), torch.std(x, correction=1)
        else:
            y = _flatten_ch(x, self.ch_axis)
            m, s = torch.mean(y, dim=1), torch.std(y, dim=1, correction=1)
        return m - 3 * s, m + 3 * s


@dataclasses.dataclass
class AvgMinMaxObserver(RangeObserver):
    """Running mean of batch ranges."""

    def _combine(self, cur_min, cur_max):
        if self.min_val is None:
            return cur_min, cur_max
        c = self._count
        return (_running_mean(self.min_val, cur_min, c),
                _running_mean(self.max_val, cur_max, c))


@dataclasses.dataclass
class EMAMinMaxObserver(RangeObserver):
    """EMA of batch ranges."""

    ema_ratio: float = 0.9

    def _combine(self, cur_min, cur_max):
        if self.min_val is None:
            return cur_min, cur_max
        r = self.ema_ratio
        return _ema(self.min_val, cur_min, r), _ema(self.max_val, cur_max, r)


@dataclasses.dataclass
class AvgTokenQuantileObserver(AvgMinMaxObserver):
    """Running mean of ranges; with a mask the batch is token-pruned first
    (the reference prunes only when given one)."""

    percentile: float = 1.0

    def update(self, x: torch.Tensor, mask=None):
        x = x.to(torch.float32)
        y = (prune_token(self._mask(x, mask), self.percentile)
             if mask is not None else x)
        cur_min, cur_max = torch.amin(y), torch.amax(y)
        self.min_val, self.max_val = self._combine(cur_min, cur_max)
        self._count += 1
        return self.min_val, self.max_val


# ---------------------------------------------------------------------------
# |x|-histogram quantile family (per-tensor only)


def _histogram(a: torch.Tensor, bins: int, hi: torch.Tensor) -> torch.Tensor:
    """``jnp.histogram(a, bins, range=(0, hi))`` counts: edges ``hi ·
    (k / bins)`` and ``hi`` itself, a value in the bin whose left edge is
    the last ≤ it, the right edge counted in the last bin."""
    lo = torch.zeros_like(hi)
    degenerate = hi == lo
    lo = torch.where(degenerate, lo - 0.5, lo)
    hi = torch.where(degenerate, hi + 0.5, hi)
    step = (torch.arange(bins, dtype=torch.float32, device=a.device)
            / torch.tensor(float(bins), device=a.device))
    edges = torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])
    idx = torch.searchsorted(edges, a, right=True)
    idx = torch.where(a == edges[-1], bins, idx)
    return torch.bincount(idx, minlength=bins + 1)[1:bins + 1]


def _hist_clip(x: torch.Tensor, threshold: float, bins: int):
    """Histogram |x| over [0, max|range|]; clip at the centre of the first
    bin where the cumulative count reaches ``threshold · numel``."""
    mn, mx = torch.amin(x), torch.amax(x)
    hist_max = torch.maximum(-mn, mx)
    absx = torch.abs(x.reshape(-1))
    cum = torch.cumsum(_histogram(absx, bins, hist_max), 0)
    crossed = cum >= threshold * absx.numel()
    idx = torch.argmax(crossed.to(torch.int32))
    clip = torch.where(torch.any(crossed),
                       (idx.to(torch.float32) + 0.5)
                       * true_div(hist_max, float(bins)),
                       hist_max)
    return torch.maximum(mn, -clip), torch.minimum(mx, clip)


@dataclasses.dataclass
class EMAQuantileObserver(RangeObserver):
    ema_ratio: float = 0.9
    threshold: float = 0.9999
    bins: int = 2048

    def _batch_range(self, x):
        if self.ch_axis != -1:
            raise ValueError("ema_quantile is per-tensor")
        return _hist_clip(x, self.threshold, self.bins)

    def _combine(self, cur_min, cur_max):
        if self.min_val is None:
            return cur_min, cur_max
        r = self.ema_ratio
        return _ema(self.min_val, cur_min, r), _ema(self.max_val, cur_max, r)


@dataclasses.dataclass
class AvgQuantileObserver(RangeObserver):
    threshold: float = 0.999
    bins: int = 2048

    def _batch_range(self, x):
        if self.ch_axis != -1:
            raise ValueError("avg_quantile is per-tensor")
        return _hist_clip(x, self.threshold, self.bins)

    def _combine(self, cur_min, cur_max):
        if self.min_val is None:
            return cur_min, cur_max
        c = self._count
        return (_running_mean(self.min_val, cur_min, c),
                _running_mean(self.max_val, cur_max, c))


# ---------------------------------------------------------------------------
# MSE grid-search family


@dataclasses.dataclass
class MSEObserver(RangeObserver):
    """Candidate ranges grow from xrange/num to the full range (1D for
    symmetric or one-sided data, 2D range × zero point otherwise); batches
    combine by expanding (min of mins, max of maxes)."""

    num: int = 100
    norm_p: float = 2.0
    one_side_dist: Optional[str] = None  # 'pos' | 'neg' | 'no'

    def _lp_loss(self, xq, x):
        d = torch.pow(torch.abs(xq - x), self.norm_p)
        if self.ch_axis == -1:
            return torch.mean(d)
        return torch.mean(_flatten_ch(d, self.ch_axis), dim=1)

    def _loss_for(self, x, new_min, new_max):
        scale, zero = calculate_qparams(new_min, new_max, self.bit,
                                        self.symmetric)
        if self.ch_axis != -1:
            shape = [1] * x.ndim
            shape[self.ch_axis] = -1
            scale, zero = scale.reshape(shape), zero.reshape(shape)
        xq = fake_quant(x, scale, zero, self.bit, self.symmetric)
        return self._lp_loss(xq, x)

    def _ranges(self, x, clamp_zero: bool):
        if self.ch_axis == -1:
            x_min, x_max = torch.amin(x), torch.amax(x)
        else:
            y = _flatten_ch(x, self.ch_axis)
            x_min, x_max = torch.amin(y, dim=1), torch.amax(y, dim=1)
            if clamp_zero:
                x_min = torch.clamp_max(x_min, 0.0)
                x_max = torch.clamp_min(x_max, 0.0)
        return x_min, x_max

    def _search_1d(self, x, pos=None, neg=None):
        """``pos``/``neg``: one-sided data (whole tensor) as bool tensors."""
        if pos is None:
            pos = torch.tensor(self.one_side_dist == "pos", device=x.device)
            neg = torch.tensor(self.one_side_dist == "neg", device=x.device)
        x_min, x_max = self._ranges(x, clamp_zero=False)
        xrange = torch.maximum(torch.abs(x_min), x_max)
        best_score = torch.zeros_like(x_min) + 1e10
        best_min, best_max = x_min, x_max
        zeros = torch.zeros_like(x_min)
        for i in range(1, self.num + 1):
            thres = true_div(xrange, float(self.num)) * i
            new_min = torch.where(pos, zeros, -thres)
            new_max = torch.where(neg, zeros, thres)
            score = self._loss_for(x, new_min, new_max)
            better = score < best_score
            best_min = torch.where(better, new_min, best_min)
            best_max = torch.where(better, new_max, best_max)
            best_score = torch.minimum(score, best_score)
        return best_min, best_max

    def _search_2d(self, x):
        qmin, qmax = quant_range(self.bit, self.symmetric)
        x_min, x_max = self._ranges(x, clamp_zero=True)
        xrange = x_max - x_min
        best_score = torch.zeros_like(x_min) + 1e10
        best_min, best_max = x_min, x_max
        for i in range(1, self.num + 1):
            tmp_max = true_div(xrange, float(self.num)) * i
            tmp_delta = true_div(tmp_max, float(qmax - qmin))
            for zp in range(qmin, qmax + 1):
                new_min = torch.maximum(-zp * tmp_delta, x_min)
                new_max = torch.minimum(tmp_max - zp * tmp_delta, x_max)
                score = self._loss_for(x, new_min, new_max)
                better = score < best_score
                best_min = torch.where(better, new_min, best_min)
                best_max = torch.where(better, new_max, best_max)
                best_score = torch.minimum(best_score, score)
        return best_min, best_max

    def _batch_range(self, x):
        if self.symmetric:
            return self._search_1d(x, torch.amin(x) >= 0.0,
                                   torch.amax(x) <= 0.0)
        if self.one_side_dist is None:
            self.one_side_dist = (
                "pos" if float(torch.amin(x)) >= 0.0
                else "neg" if float(torch.amax(x)) <= 0.0 else "no")
        if self.one_side_dist != "no":
            return self._search_1d(x)
        return self._search_2d(x)

    def _combine(self, cur_min, cur_max):
        if self.min_val is None:
            return cur_min, cur_max
        return (torch.minimum(self.min_val, cur_min),
                torch.maximum(self.max_val, cur_max))


@dataclasses.dataclass
class AvgMSEObserver(MSEObserver):
    """Grid search, running-mean combine (per-tensor)."""

    def _combine(self, cur_min, cur_max):
        if self.min_val is None:
            return cur_min, cur_max
        c = self._count
        return (_running_mean(self.min_val, cur_min, c),
                _running_mean(self.max_val, cur_max, c))


# ---------------------------------------------------------------------------
# MSEFast family: bounded scalar minimization (scipy), per-tensor


@dataclasses.dataclass
class MSEFastObserver(RangeObserver):
    """Bounded search of the range (and, asymmetric two-sided, the shift);
    batches combine by expanding min/max."""

    norm_p: float = 2.0
    one_side_dist: Optional[str] = None

    def _loss(self, x, new_min: float, new_max: float) -> float:
        scale, zero = calculate_qparams(_f32(np.float32(new_min), x),
                                        _f32(np.float32(new_max), x),
                                        self.bit, self.symmetric)
        xq = fake_quant(x, scale, zero, self.bit, self.symmetric)
        return float(torch.mean(torch.pow(torch.abs(xq - x), self.norm_p)))

    def _search_1d(self, x, x_min: float, x_max: float):
        from scipy.optimize import minimize_scalar

        xrange = max(abs(x_min), x_max)

        def ends(r):
            return (0.0 if self.one_side_dist == "pos" else -r,
                    0.0 if self.one_side_dist == "neg" else r)

        res = minimize_scalar(lambda r: self._loss(x, *ends(r)),
                              bounds=(min(0.1, 0.01 * xrange), xrange),
                              method="Bounded")
        lo, hi = ends(res.x)
        return _f32(np.float32(lo), x), _f32(np.float32(hi), x)

    def _search_2d(self, x, x_min: float, x_max: float):
        from scipy.optimize import minimize_scalar

        qmin, qmax = quant_range(self.bit, self.symmetric)
        xrange = x_max - x_min

        def shift_loss(shift, r):
            return self._loss(x, max(0.0 - shift, x_min),
                              min(r - shift, x_max))

        def best_shift(r):
            d = r / float(qmax - qmin)
            return minimize_scalar(shift_loss, args=(r,),
                                   bounds=(d * qmin, d * qmax),
                                   method="Bounded")

        res = minimize_scalar(lambda r: best_shift(r).fun,
                              bounds=(min(0.1, 0.01 * xrange), xrange),
                              method="Bounded")
        final_range = res.x
        shift = best_shift(final_range).x
        return (_f32(np.float32(max(0.0 - shift, x_min)), x),
                _f32(np.float32(min(final_range - shift, x_max)), x))

    def _batch_range(self, x):
        if self.ch_axis != -1:
            raise ValueError("the fast search is per-tensor")
        x_min, x_max = float(torch.amin(x)), float(torch.amax(x))
        if self.one_side_dist is None:
            self.one_side_dist = (
                "pos" if x_min >= 0.0 else "neg" if x_max <= 0.0 else "no")
        if self.one_side_dist != "no" or self.symmetric:
            return self._search_1d(x, x_min, x_max)
        return self._search_2d(x, x_min, x_max)

    def _combine(self, cur_min, cur_max):
        if self.min_val is None:
            return cur_min, cur_max
        return (torch.minimum(self.min_val, cur_min),
                torch.maximum(self.max_val, cur_max))


@dataclasses.dataclass
class AvgMSEFastObserver(MSEFastObserver):
    def _combine(self, cur_min, cur_max):
        if self.min_val is None:
            return cur_min, cur_max
        c = self._count
        return (_running_mean(self.min_val, cur_min, c),
                _running_mean(self.max_val, cur_max, c))


@dataclasses.dataclass
class EMAMSEFastObserver(MSEFastObserver):
    ema_ratio: float = 0.9

    def _combine(self, cur_min, cur_max):
        if self.min_val is None:
            return cur_min, cur_max
        r = self.ema_ratio
        return _ema(self.min_val, cur_min, r), _ema(self.max_val, cur_max, r)


OBSERVERS = {
    "minmax": MinMaxObserver,
    "quantile": QuantileObserver,
    "lsq_plus": LSQPlusObserver,
    "avg_minmax": AvgMinMaxObserver,
    "ema_minmax": EMAMinMaxObserver,
    "avg_token_quantile": AvgTokenQuantileObserver,
    "ema_quantile": EMAQuantileObserver,
    "avg_quantile": AvgQuantileObserver,
    "mse": MSEObserver,
    "avg_mse": AvgMSEObserver,
    "mse_fast": MSEFastObserver,
    "avg_mse_fast": AvgMSEFastObserver,
    "ema_mse_fast": EMAMSEFastObserver,
}

#: reference class name ↔ registry key (the CLI accepts either spelling)
REFERENCE_NAMES = {
    "MinMaxObserver": "minmax",
    "QuantileObserver": "quantile",
    "LSQPlusObserver": "lsq_plus",
    "AvgMinMaxObserver": "avg_minmax",
    "EMAMinMaxObserver": "ema_minmax",
    "AvgTokenQuantileObserver": "avg_token_quantile",
    "EMAQuantileObserver": "ema_quantile",
    "AvgQuantileObserver": "avg_quantile",
    "MSEObserver": "mse",
    "AvgMSEObserver": "avg_mse",
    "MSEFastObserver": "mse_fast",
    "AvgMSEFastObserver": "avg_mse_fast",
    "EMAMSEFastObserver": "ema_mse_fast",
}


def make_observer(name: str, **kw) -> RangeObserver:
    name = REFERENCE_NAMES.get(name, name)
    return OBSERVERS[name](**kw)
