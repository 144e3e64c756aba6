"""Adaptive smoothing: activation-outlier migration into weights (port of
qqq_tpu/calib/smooth.py).

The model is walked layer by layer on one calibration batch; each
sub-block's migration scale is searched, applied, and the walk continues
with the smoothed, fake-quantized values (the reference runs its model with
calibration quantization on).  Three searchers:

* ``os+``: Outlier Suppression+ 1-D range search: symmetric clip
  thresholds walked down from the activation bound, each turned into the
  per-channel scale ``max(cmx/t, cmn/−t, 1)``; the least L2 error of the
  quantized sub-block output against the FP one wins (the first of equal
  losses).
* ``awq``: the ratio grid ``s = mean|x|^r`` normalized, r ∈ {0 .. 0.95}.
* ``sq``: SmoothQuant's closed form ``act^α / w^(1−α)``.

Sub-blocks replayed under quantization: ``qkv`` (full attention: RoPE,
softmax, PV), ``o_proj`` / ``down_proj`` (a product) and ``up_and_gate``
(SwiGLU).  The candidates run one after another (a full-width ``qkv`` replay
holds a (B, nh, T, T) score tensor).

Folding: ``ln /= s``; ``qkv *= s``; for MHA (not GQA) ``o *= s``,
``v /= s``; ``gate, up *= s``; ``down *= s``, ``up /= s``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from qqq_tpu_torch.core.quant import (
    QuantSpec, fake_quantize_weight, quantize_activations_per_token, true_div,
)
from qqq_tpu_torch.models import llama as M
from qqq_tpu_torch.models.config import ModelConfig

#: observers usable as per-token activation range estimators
TOKEN_OBSERVERS = ("minmax", "quantile", "lsq_plus", "mse")

#: the reference's activation fake-quantizers:
#:   token       TokenFixedFakeQuantize       dynamic per token (default)
#:   tensor      FixedFakeQuantize            one scale for the tensor
#:   group       GroupFixedFakeQuantize       per (token, channel group)
#:   token_group TokenGroupFixedFakeQuantize  per channel group, shared
#:                                            across tokens
A_QUANTIZERS = ("token", "tensor", "group", "token_group")

A_QUANTIZER_REFERENCE_NAMES = {
    "TokenFixedFakeQuantize": "token",
    "FixedFakeQuantize": "tensor",
    "GroupFixedFakeQuantize": "group",
    "TokenGroupFixedFakeQuantize": "token_group",
}

#: observers usable as per-(out channel | group row) weight estimators
WEIGHT_OBSERVERS = ("minmax", "lsq_plus", "mse")

_EPS = 1.1920929e-07


def _fake_quant_act_grouped(x: torch.Tensor, quantizer: str,
                            group_size: int) -> torch.Tensor:
    """Per-tensor, per-(token, group) or per-group-across-tokens symmetric
    ±127 fake quant."""
    from qqq_tpu_torch.calib.observers import fake_quant

    C = x.shape[-1]
    xf = x.reshape(-1, C).to(torch.float32)
    if quantizer == "tensor":
        s = torch.clamp_min(true_div(xf.abs().amax(), 127.0), _EPS)
        return fake_quant(xf, s, 0.0, 8, True).reshape(x.shape).to(x.dtype)
    if C % group_size:
        raise ValueError(f"{C} channels do not split into groups of "
                         f"{group_size}")
    if quantizer == "group":
        y = xf.reshape(-1, group_size)
    else:  # token_group
        y = xf.T.reshape(C // group_size, -1)
    s = torch.clamp_min(true_div(y.abs().amax(dim=1, keepdim=True), 127.0),
                        _EPS)
    deq = fake_quant(y, s, 0.0, 8, True)
    out = deq.reshape(-1, C) if quantizer == "group" else deq.reshape(C, -1).T
    return out.reshape(x.shape).to(x.dtype)


def _fake_quant_act_observed(x: torch.Tensor, observer: str,
                             percentile: Optional[float]) -> torch.Tensor:
    """Per-token fake quant with a selectable range estimator (tokens on
    the observer's channel axis)."""
    from qqq_tpu_torch.calib.observers import fake_quant, make_observer

    if observer not in TOKEN_OBSERVERS:
        raise ValueError(
            f"a_observer {observer!r} is per-tensor only; per-token "
            f"activation quant supports {TOKEN_OBSERVERS}")
    kw = {}
    if observer == "quantile" and percentile is not None:
        kw["percentile"] = percentile
    obs = make_observer(observer, bit=8, symmetric=True, ch_axis=0, **kw)
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    obs.update(xf)
    scale, zero = obs.qparams()
    out = fake_quant(xf, scale[:, None], zero[:, None], 8, True)
    return out.reshape(x.shape).to(x.dtype)


def _fake_quant_act(x: torch.Tensor, percentile: Optional[float] = None,
                    convention: str = "observer",
                    observer: str = "minmax") -> torch.Tensor:
    """Dynamic per-token symmetric INT8 fake quant.  ``convention=
    "observer"``: range ±127, scale absmax/127 clamped at float eps (the
    reference's calibration quantizer); ``"kernel"``: the deployed kernel's
    dynamic quant.  ``percentile`` clips each token at that quantile of its
    |x|; ``observer`` picks another range estimator."""
    if observer != "minmax":
        return _fake_quant_act_observed(x, observer, percentile)
    if percentile is not None:
        from qqq_tpu_torch.calib.clipping import fake_quant_act_percentile

        return fake_quant_act_percentile(x, percentile)
    if convention == "kernel":
        q, s = quantize_activations_per_token(x.reshape(-1, x.shape[-1]))
        return (q.to(torch.float32) * s).reshape(x.shape).to(x.dtype)
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    s = torch.clamp_min(true_div(xf.abs().amax(dim=-1, keepdim=True), 127.0),
                        _EPS)
    q = torch.clamp(torch.round(xf / s), -127, 127)
    return (q * s).reshape(x.shape).to(x.dtype)


def _fake_quant_weight_observer(w: torch.Tensor, w_spec: QuantSpec,
                                observer: str = "minmax") -> torch.Tensor:
    """Weight fake quant in the observer convention: symmetric ±(2^(b-1) −
    1), per output channel, or per (output channel, K-group) row."""
    K, N = w.shape
    maxq = 2 ** (w_spec.bits - 1) - 1
    if w_spec.per_channel:
        y = w.to(torch.float32).T  # (N, K): a row per output channel
    else:
        y = w.to(torch.float32).T.reshape(-1, w_spec.group_size)
    if observer == "minmax":
        s = torch.clamp_min(
            true_div(y.abs().amax(dim=1, keepdim=True), float(maxq)), _EPS)
        deq = torch.clamp(torch.round(y / s), -maxq, maxq) * s
    else:
        from qqq_tpu_torch.calib.observers import fake_quant, make_observer

        if observer not in WEIGHT_OBSERVERS:
            raise ValueError(f"w_observer {observer!r} unsupported; pick one "
                             f"of {WEIGHT_OBSERVERS}")
        obs = make_observer(observer, bit=w_spec.bits, symmetric=True,
                            ch_axis=0)
        obs.update(y)
        scale, zero = obs.qparams()
        deq = fake_quant(y, scale[:, None], zero[:, None], w_spec.bits, True)
    if w_spec.per_channel:
        return deq.T.to(w.dtype)
    return deq.reshape(N, K).T.to(w.dtype)


def _sub_block_output(module_type: str, x: torch.Tensor, w: torch.Tensor,
                      extra: Dict[str, Any]) -> torch.Tensor:
    """FP sub-block replay; ``x`` (B, T, C), ``w`` (C, N) concatenated."""
    if module_type in ("o_proj", "down_proj"):
        return x @ w
    if module_type == "up_and_gate":
        gate, up = torch.chunk(x @ w, 2, dim=-1)
        return F.silu(gate) * up
    if module_type == "qkv":
        cfg: ModelConfig = extra["config"]
        B, T, _ = x.shape
        nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        qkv = x @ w
        q = qkv[..., :nh * hd].reshape(B, T, nh, hd)
        k = qkv[..., nh * hd:(nh + nkv) * hd].reshape(B, T, nkv, hd)
        v = qkv[..., (nh + nkv) * hd:].reshape(B, T, nkv, hd)
        if extra.get("qkv_bias") is not None:
            bq, bk, bv = extra["qkv_bias"]
            q = q + bq.reshape(1, 1, nh, hd)
            k = k + bk.reshape(1, 1, nkv, hd)
            v = v + bv.reshape(1, 1, nkv, hd)
        positions = extra["positions"]
        q, k = M.apply_rope(q, k, positions, extra["inv_freq"])
        kf = M.repeat_kv(k, cfg.num_kv_groups)
        vf = M.repeat_kv(v, cfg.num_kv_groups)
        mask = positions[:, None, :] <= positions[:, :, None]
        return M._attention_scores(q, kf, vf, mask).reshape(B, T, nh * hd)
    raise ValueError(module_type)


def _quantized_output(module_type: str, x: torch.Tensor, w: torch.Tensor,
                      w_spec: QuantSpec, extra: Dict[str, Any]
                      ) -> torch.Tensor:
    convention = extra.get("convention", "observer")
    a_quantizer = extra.get("a_quantizer", "token")
    if a_quantizer != "token":
        xq = _fake_quant_act_grouped(x, a_quantizer,
                                     extra.get("a_group_size", 128))
    else:
        xq = _fake_quant_act(x, extra.get("a_percentile"), convention,
                             extra.get("a_observer", "minmax"))
    if convention == "observer":
        wq = _fake_quant_weight_observer(w, w_spec,
                                         extra.get("w_observer", "minmax"))
    else:
        wq = fake_quantize_weight(w, w_spec).to(w.dtype)
    return _sub_block_output(module_type, xq, wq, extra)


def _loss(pred: torch.Tensor, tgt: torch.Tensor, p: float = 2.0
          ) -> torch.Tensor:
    return torch.mean(torch.sum(
        torch.pow(torch.abs(pred.to(torch.float32) - tgt), p), dim=-1))


def _cac_scale(cmx, cmn, threshold) -> torch.Tensor:
    """Per-channel scale from a symmetric clip threshold."""
    one = torch.ones_like(cmx)
    mx = torch.where(cmx > threshold, cmx / threshold, one)
    mn = torch.where(cmn < -threshold, cmn / -threshold, one)
    return torch.maximum(mx, mn)


def _first_argmin(losses: List[torch.Tensor]) -> int:
    """Index of the least loss, the first of equal ones."""
    return int(torch.argmin(torch.stack(losses)))


def migrate(
    module_type: str,
    x: torch.Tensor,
    w: torch.Tensor,
    extra: Dict[str, Any],
    *,
    method: str = "os+",
    w_spec: QuantSpec = QuantSpec(bits=4, group_size=-1),
    n_grid: Optional[int] = None,
    smooth_alpha: float = 0.5,
) -> torch.Tensor:
    """Search the per-channel migration scale of one sub-block: returns
    s (C,) f32, with x/s and w·s the smoothed pair."""
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    cmx = torch.amax(x, dim=(0, 1))
    cmn = torch.amin(x, dim=(0, 1))

    if method == "sq":
        act_scales = torch.maximum(cmx.abs(), cmn.abs())
        w_scales = torch.clamp_min(w.abs().amax(dim=1), 1e-5)
        return torch.clamp_min(
            torch.pow(act_scales, smooth_alpha)
            / torch.pow(w_scales, 1 - smooth_alpha), 1e-5)

    fp_out = _sub_block_output(module_type, x, w, extra).to(torch.float32)

    if method == "awq":
        n = n_grid or 20
        x_max = torch.mean(x.reshape(-1, x.shape[-1]).abs(), dim=0)

        def awq_scale(r):
            s = torch.clamp_min(torch.pow(x_max, r), 1e-4)
            return s / torch.sqrt(s.max() * s.min())

        ratios = (torch.arange(n, dtype=torch.float32, device=x.device)
                  / torch.tensor(float(n), device=x.device))
        losses = []
        for r in ratios:
            s = awq_scale(r)
            out = _quantized_output(module_type, x / s, w * s[:, None],
                                    w_spec, extra)
            losses.append(_loss(out, fp_out))
        return awq_scale(ratios[_first_argmin(losses)])

    if method == "os+":
        amx = float(torch.clamp_min(torch.amax(x), 0.0))
        amn = float(torch.clamp_max(torch.amin(x), 0.0))
        bound = max(-amn, amx)
        # the reference's candidate walk: from the bound down by step while
        # st >= 0.1, num = max(100, int(amx / 0.5))
        lo = 0.1
        num = n_grid or max(100, int(amx / 0.5))
        step = (bound - lo) / num
        ts = []
        st = bound
        while st >= lo:
            ts.append(st)
            st -= step
        if not ts:  # degenerate tiny activations: bound <= 0.1
            ts = [max(bound, lo)]
        thresholds = torch.tensor(ts, dtype=torch.float32, device=x.device)
        losses = []
        for t in thresholds:
            s = _cac_scale(cmx, cmn, t)
            out = _quantized_output(module_type, x / s, w * s[:, None],
                                    w_spec, extra)
            losses.append(_loss(out, fp_out))
        return _cac_scale(cmx, cmn, thresholds[_first_argmin(losses)])

    raise ValueError(f"unknown smooth method {method!r}")


# ---------------------------------------------------------------------------
# whole-model smoothing pass


def smooth_model(
    params: Dict[str, Any],
    config: ModelConfig,
    calib_tokens: torch.Tensor,  # (B, T) one calibration batch
    *,
    method: str = "os+",
    w_spec: QuantSpec = QuantSpec(bits=4, group_size=-1),
    n_grid: Optional[int] = None,
    a_percentile: Optional[float] = None,
    a_observer: str = "minmax",
    w_observer: str = "minmax",
    a_quantizer: str = "token",
    a_group_size: int = 128,
) -> List[torch.Tensor]:
    """The migration searches through the model; returns the scale list in
    the reference's order, [qkv, o, gate_up, down] per layer.  ``o`` is
    searched for GQA too (the replay divides by it), but only MHA folds it
    (:func:`export_smoothed_model`)."""
    B, T = calib_tokens.shape
    dev = calib_tokens.device
    inv_freq = M.rope_inv_freq(config, dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    x = params["embed"][calib_tokens].to(torch.float32)
    scale_list: List[torch.Tensor] = []

    def f32(lin):
        return lin["w"].to(torch.float32)

    with torch.no_grad():
        for layer in params["layers"]:
            extra = {
                "config": config, "positions": positions,
                "inv_freq": inv_freq, "a_percentile": a_percentile,
                "a_observer": a_observer, "w_observer": w_observer,
                "a_quantizer": a_quantizer, "a_group_size": a_group_size,
            }
            search = dict(extra=extra, method=method, w_spec=w_spec,
                          n_grid=n_grid)
            # attention: the qkv migration on the post-norm input
            h = M.rms_norm(x, layer["input_layernorm"], config.rms_norm_eps)
            w_qkv = torch.cat([f32(layer["q_proj"]), f32(layer["k_proj"]),
                               f32(layer["v_proj"])], dim=1)
            if "b" in layer["q_proj"]:
                extra["qkv_bias"] = (layer["q_proj"]["b"],
                                     layer["k_proj"]["b"],
                                     layer["v_proj"]["b"])
            s_qkv = migrate("qkv", h, w_qkv, **search)
            scale_list.append(s_qkv)
            h = h / s_qkv
            # the o_proj input through the fake-quantized, smoothed qkv
            attn = _quantized_output("qkv", h, w_qkv * s_qkv[:, None], w_spec,
                                     extra)
            w_o = f32(layer["o_proj"])
            s_o = migrate("o_proj", attn, w_o, **search)
            scale_list.append(s_o)
            x = x + _quantized_output("o_proj", attn / s_o, w_o * s_o[:, None],
                                      w_spec, extra)
            # MLP: the gate/up migration, then down_proj's
            h2 = M.rms_norm(x, layer["post_attention_layernorm"],
                            config.rms_norm_eps)
            w_gu = torch.cat([f32(layer["gate_proj"]), f32(layer["up_proj"])],
                             dim=1)
            s_gu = migrate("up_and_gate", h2, w_gu, **search)
            scale_list.append(s_gu)
            h2 = h2 / s_gu
            swiglu = _quantized_output("up_and_gate", h2,
                                       w_gu * s_gu[:, None], w_spec, extra)
            w_d = f32(layer["down_proj"])
            s_d = migrate("down_proj", swiglu, w_d, **search)
            scale_list.append(s_d)
            x = x + _quantized_output("down_proj", swiglu / s_d,
                                      w_d * s_d[:, None], w_spec, extra)
    return scale_list


def export_smoothed_model(params: Dict[str, Any], config: ModelConfig,
                          scale_list: List[torch.Tensor]) -> Dict[str, Any]:
    """Fold the scale list into the norms and linears."""
    mha = config.num_attention_heads == config.num_key_value_heads
    params = dict(params)
    it = iter(scale_list)

    def scale_in(lin, s):  # the input dim multiplied
        return {**lin, "w": (lin["w"].to(torch.float32) * s[:, None]).to(
            lin["w"].dtype)}

    def scale_out(lin, s):  # the output dim divided, the bias too
        nl = {**lin, "w": (lin["w"].to(torch.float32) / s[None, :]).to(
            lin["w"].dtype)}
        if "b" in lin:
            nl["b"] = (lin["b"].to(torch.float32) / s).to(lin["b"].dtype)
        return nl

    def ln_div(ln, s):
        return (ln.to(torch.float32) / s).to(ln.dtype)

    new_layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        dev = layer["input_layernorm"].device
        s_qkv, s_o, s_gu, s_d = (next(it).to(dev) for _ in range(4))
        layer["input_layernorm"] = ln_div(layer["input_layernorm"], s_qkv)
        for name in ("q_proj", "k_proj", "v_proj"):
            layer[name] = scale_in(layer[name], s_qkv)
        if mha:
            layer["o_proj"] = scale_in(layer["o_proj"], s_o)
            layer["v_proj"] = scale_out(layer["v_proj"], s_o)
        layer["post_attention_layernorm"] = ln_div(
            layer["post_attention_layernorm"], s_gu)
        layer["gate_proj"] = scale_in(layer["gate_proj"], s_gu)
        layer["up_proj"] = scale_in(layer["up_proj"], s_gu)
        layer["down_proj"] = scale_in(layer["down_proj"], s_d)
        layer["up_proj"] = scale_out(layer["up_proj"], s_d)
        new_layers.append(layer)
    params["layers"] = new_layers
    return params
