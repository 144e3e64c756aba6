"""Layer-sequential GPTQ quantization pipeline (port of
qqq_tpu/calib/pipeline.py).

Per decoder layer:

1. replay the calibration samples through the still-dense layer, one
   Hessian per linear-input group accumulated from the layer's own capture
   forward (q/k/v share the post-input-norm input, gate/up the
   post-attention-norm input);
2. GPTQ-quantize the seven linears: q/k/v as one call on their weights
   concatenated along N, gate/up as one, o and down alone (GPTQ is
   independent across output columns, so each linear's codes are those of
   a call of its own);
3. replay the samples through the layer with the fake-quantized dense
   weights to make the next layer's inputs.

Calibration runs dense (plain products, and attention without a cache is
``models/llama.py:_attention_scores``); no CUDA kernel lies on it.
Embeddings and the lm_head stay FP unless ``quantize_lm_head``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qqq_tpu_torch.calib.gptq import (
    GPTQResult, gptq_quantize_matrix, hessian_init, hessian_update,
)
from qqq_tpu_torch.core.quant import QuantSpec
from qqq_tpu_torch.models import llama as M
from qqq_tpu_torch.models.config import ModelConfig
from qqq_tpu_torch.models.quantize import quantize_result_to_linear

logger = logging.getLogger("qqq_tpu_torch")

_QKV = ("q_proj", "k_proj", "v_proj")
_GUP = ("gate_proj", "up_proj")
#: linears quantized together (one Hessian, one GPTQ call) and their key
GPTQ_GROUPS = ((_QKV, "qkv"), (("o_proj",), "o"), (_GUP, "gup"),
               (("down_proj",), "down"))
LINEARS = (*_QKV, "o_proj", *_GUP, "down_proj")


def layer_capture_forward(
    layer: Dict[str, Any],
    x: torch.Tensor,  # (B, T, H)
    positions: torch.Tensor,
    inv_freq: torch.Tensor,
    config: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decoder-layer forward that also returns each linear group's input."""
    B, T, _ = x.shape
    nh, nkv, hd = (config.num_attention_heads, config.num_key_value_heads,
                   config.head_dim)
    h = M.rms_norm(x, layer["input_layernorm"], config.rms_norm_eps)
    q = M.linear_apply(layer["q_proj"], h).reshape(B, T, nh, hd)
    k = M.linear_apply(layer["k_proj"], h).reshape(B, T, nkv, hd)
    v = M.linear_apply(layer["v_proj"], h).reshape(B, T, nkv, hd)
    q, k = M.apply_rope(q, k, positions, inv_freq)
    mask = positions[:, None, :] <= positions[:, :, None]
    kf = M.repeat_kv(k, config.num_kv_groups)
    vf = M.repeat_kv(v, config.num_kv_groups)
    attn = M._attention_scores(q, kf, vf, mask).reshape(B, T, nh * hd)
    x = x + M.linear_apply(layer["o_proj"], attn)
    h2 = M.rms_norm(x, layer["post_attention_layernorm"], config.rms_norm_eps)
    swiglu = F.silu(M.linear_apply(layer["gate_proj"], h2)) * M.linear_apply(
        layer["up_proj"], h2)
    x = x + M.linear_apply(layer["down_proj"], swiglu)
    return x, {"qkv": h, "o": attn, "gup": h2, "down": swiglu}


def save_quantizers(path: str, records: Dict[str, Any]) -> None:
    """Persist the per-linear GPTQ results (codes, scales, zeros, loss):
    packing can resume from this file alone."""
    np.savez(path, **records)
    logger.info("saved GPTQ intermediate to %s", path)


def pack_from_quantizers(
    params: Dict[str, Any],
    config: ModelConfig,
    spec: QuantSpec,
    quantizers_path: str,
) -> Dict[str, Any]:
    """Rebuild the packed checkpoint from a saved quantizers.npz (ours or
    the JAX package's) without re-running GPTQ, on the params' device."""
    del config
    dev = params["embed"].device
    z = np.load(quantizers_path)

    def linear(pre: str, lin: Dict[str, Any]) -> Dict[str, Any]:
        q4 = torch.from_numpy(np.asarray(z[f"{pre}.q4"])).to(dev)
        scale = torch.from_numpy(np.asarray(z[f"{pre}.scale"])).to(dev)
        b = lin.get("b")
        return quantize_result_to_linear(
            q4, scale, spec, None if b is None else b.to(dev))

    out = dict(params)
    out["layers"] = [
        {**layer, **{name: linear(f"layers.{li}.{name}", layer[name])
                     for name in LINEARS}}
        for li, layer in enumerate(params["layers"])]
    if "lm_head.q4" in z.files and params.get("lm_head") is not None:
        out["lm_head"] = linear("lm_head", params["lm_head"])
    return out


def _to(tree: Dict[str, Any], dev: torch.device) -> Dict[str, Any]:
    return {k: ({kk: vv.to(dev, non_blocking=True) for kk, vv in v.items()}
                if isinstance(v, dict) else v.to(dev, non_blocking=True))
            for k, v in tree.items()}


def _gptq_group(names, layer, H, spec, **kw) -> Dict[str, GPTQResult]:
    """GPTQ of the linears ``names`` (one Hessian) as one call on their
    weights concatenated along N; the result split back per linear."""
    widths = [layer[n]["w"].shape[1] for n in names]
    W = torch.cat([layer[n]["w"].to(torch.float32) for n in names], dim=1)
    res = gptq_quantize_matrix(W, H, spec, **kw)
    del W
    out, c0 = {}, 0
    for n, w in zip(names, widths):
        cols = slice(c0, c0 + w)
        c0 += w
        out[n] = GPTQResult(
            w_deq=res.w_deq[:, cols], q4=res.q4[:, cols].contiguous(),
            scale=res.scale[:, cols].contiguous(),
            zero=res.zero[:, cols].contiguous(),
            loss=res.column_loss[cols].sum(),
            column_loss=res.column_loss[cols])
    return out


def apply_gptq(
    params: Dict[str, Any],
    config: ModelConfig,
    calib_tokens,  # (nsamples, seqlen) integer
    spec: QuantSpec,
    *,
    percdamp: float = 0.01,
    actorder: bool = True,
    blocksize: int = 128,
    sample_batch: int = 4,
    pack: bool = True,
    dtype: torch.dtype = torch.bfloat16,
    stream_from_host: bool = False,
    quantize_lm_head: bool = False,
    quantizers_path: Optional[str] = None,
    scale_store_dtype: Optional[torch.dtype] = torch.bfloat16,
    device=None,
    timings: Optional[Dict[str, list]] = None,
    layer_hook: Optional[Callable[..., None]] = None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Quantize every decoder-layer linear of ``params``.  Returns
    (new_params, stats); stats["layer_losses"] holds each layer's
    {linear: GPTQ loss}.  With ``pack`` the linears become packed W4A8
    params, otherwise dense fake-quantized weights.

    The work runs on ``device`` (the params' own by default).  With
    ``stream_from_host`` the params live on the host (pinned memory, say)
    and each decoder layer is copied to the device for its turn and
    dropped after it; only the packed result and the hidden states stay
    there.  ``timings``, when given, collects seconds per layer under
    "hessian", "gptq" and "replay" (each step synchronized).
    ``layer_hook(li, dense_layer, hessians, results)``, when given, sees
    each dense layer, its Hessians (keys qkv, o, gup, down) and its
    linears' GPTQ results after GPTQ (diagnostics: the Hessian-weighted
    error of another quantizer on the same parameters, say)."""
    dev = torch.device(device) if device is not None else params[
        "embed"].device
    tokens = torch.as_tensor(calib_tokens).to("cpu", torch.int64)
    n, T = tokens.shape
    inv_freq = M.rope_inv_freq(config, dev)
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None]

    def clock(key: str, t0: float) -> float:
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings.setdefault(key, []).append(time.perf_counter() - t0)
        return time.perf_counter()

    gptq_kw = dict(blocksize=blocksize, percdamp=percdamp, actorder=actorder,
                   scale_store_dtype=scale_store_dtype)
    stats: Dict[str, Any] = {"layer_losses": []}
    records: Dict[str, Any] = {}

    def record(pre: str, res: GPTQResult) -> None:
        if quantizers_path:
            records[f"{pre}.q4"] = res.q4.cpu().numpy()
            records[f"{pre}.scale"] = res.scale.cpu().numpy()
            records[f"{pre}.zero"] = res.zero.cpu().numpy()
            records[f"{pre}.loss"] = np.float32(float(res.loss))

    def dense_of(res: GPTQResult, lin: Dict[str, Any]) -> Dict[str, Any]:
        dense = {"w": res.w_deq.to(dtype)}
        if "b" in lin:
            dense["b"] = lin["b"]
        return dense

    def output(res: GPTQResult, lin: Dict[str, Any]) -> Dict[str, Any]:
        if pack:
            return quantize_result_to_linear(res.q4, res.scale, spec,
                                             lin.get("b"))
        return dense_of(res, lin)

    with torch.no_grad():
        embed = params["embed"]
        hidden = [embed[tokens[s0:s0 + sample_batch].to(embed.device)]
                  .to(dev).to(dtype) for s0 in range(0, n, sample_batch)]
        new_layers = []
        for li, layer in enumerate(params["layers"]):
            t_layer = t0 = time.perf_counter()
            if stream_from_host:
                layer = _to(layer, dev)
            Hs, ns = {}, {}
            for key, dim in (("qkv", config.hidden_size),
                             ("o", config.q_dim),
                             ("gup", config.hidden_size),
                             ("down", config.intermediate_size)):
                Hs[key], ns[key] = hessian_init(dim, dev)
            for xb in hidden:
                _, caps = layer_capture_forward(
                    layer, xb, positions.expand(xb.shape[0], T), inv_freq,
                    config)
                for key in Hs:
                    Hs[key], ns[key] = hessian_update(Hs[key], ns[key],
                                                      caps[key])
                del caps
            t0 = clock("hessian", t0)

            new_layer = dict(layer)     # packed (or dense) output
            replay_layer = dict(layer)  # dense fake-quant, for the replay
            losses, results = {}, {}
            for names, hkey in GPTQ_GROUPS:
                results.update(_gptq_group(names, layer, Hs[hkey], spec,
                                           **gptq_kw))
                for name in names:
                    res = results[name]
                    losses[name] = float(res.loss)
                    record(f"layers.{li}.{name}", res)
                    replay_layer[name] = dense_of(res, layer[name])
                    new_layer[name] = output(res, layer[name])
            t0 = clock("gptq", t0)
            if layer_hook is not None:
                layer_hook(li, layer, Hs, results)
                t0 = time.perf_counter()
            del Hs, results

            # the next layer's inputs come from the quantized layer, with FP
            # activations: the dense fake-quantized weights, not the kernels
            hidden = [
                M.decoder_layer(replay_layer, xb,
                                positions.expand(xb.shape[0], T), inv_freq,
                                config)[0]
                for xb in hidden]
            clock("replay", t0)
            del replay_layer, layer
            stats["layer_losses"].append(losses)
            logger.info("layer %d quantized in %.1fs, loss=%s", li,
                        time.perf_counter() - t_layer, losses)
            new_layers.append(new_layer)

        out = dict(params)
        out["layers"] = new_layers
        if quantize_lm_head and params.get("lm_head") is not None:
            head = params["lm_head"]
            if stream_from_host:
                head = _to(head, dev)
            Hh, nh_ = hessian_init(config.hidden_size, dev)
            norm_w = params["norm"].to(dev)
            for xb in hidden:
                Hh, nh_ = hessian_update(
                    Hh, nh_, M.rms_norm(xb, norm_w, config.rms_norm_eps))
            res = gptq_quantize_matrix(head["w"], Hh, spec, **gptq_kw)
            stats["lm_head_loss"] = float(res.loss)
            record("lm_head", res)
            out["lm_head"] = output(res, head)
    if quantizers_path:
        save_quantizers(quantizers_path, records)
    return out, stats
