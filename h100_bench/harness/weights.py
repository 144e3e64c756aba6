"""Seeded weights, made on the device: the INT4 codes and the scales that the
program's packer and the plain reference are both handed.

Each layer has a generator of its own, seeded from (``--seed``, layer), so
the reference can draw layer ``i`` again, alone, after the window, and get
the very values the program was built from.  A layer is drawn in a few
large calls: one normal draw for the codes of all seven linears, one for
their scales, one for the q/k/v biases, one for the two norms.  Values are
made in the types they are served in: codes int8 in [-8, 7], g128 scales
bf16, per-channel scales f32, biases, norms, embedding and head bf16.

The distribution is the configuration file's ``assumed`` block: codes
``clip(round(N(0, code_std)), -8, 7)`` (RTN codes of Gaussian weights
spread about so), scales ``weight_std / code_std · exp(scale_jitter ·
N(0, 1))``, so that a weight ``scale · code`` has about ``weight_std``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj",
           "gate_proj", "up_proj", "down_proj")
BIASED = ("q_proj", "k_proj", "v_proj")


def head_dim(cfg: Dict[str, Any]) -> int:
    return (cfg.get("head_dim")
            or cfg["hidden_size"] // cfg["num_attention_heads"])


def shapes(cfg: Dict[str, Any]) -> Dict[str, Tuple[int, int]]:
    """(K, N) of each decoder linear, weights stored (in, out)."""
    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    hd = head_dim(cfg)
    qd, kvd = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    return {"q_proj": (H, qd), "k_proj": (H, kvd), "v_proj": (H, kvd),
            "o_proj": (qd, H), "gate_proj": (H, I), "up_proj": (H, I),
            "down_proj": (I, H)}


def group_size(cfg: Dict[str, Any], K: int) -> int:
    g = cfg["quant"]["group_size"]
    return K if g == -1 else g


def _generator(seed: int, tag: str, i: int, device) -> torch.Generator:
    words = [seed % (1 << 64), sum(map(ord, tag)) * 1000003 + i]
    s = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s & ((1 << 63) - 1))


def _normal(n: int, gen: torch.Generator, device) -> torch.Tensor:
    return torch.empty(n, dtype=torch.float32, device=device).normal_(
        generator=gen)


def draw_layer(cfg: Dict[str, Any], seed: int, i: int, device
               ) -> Dict[str, Any]:
    """Layer ``i``: ``{"input_layernorm", "post_attention_layernorm": (H,)
    bf16, <linear>: {"codes": (K, N) int8, "scale": (K / group, N) bf16
    (g128) or f32 (per channel), "bias": (N,) bf16 or None}}``."""
    a = cfg["assumed"]
    shp = shapes(cfg)
    gen = _generator(seed, "layer", i, device)
    sizes = [K * N for K, N in shp.values()]
    z = _normal(sum(sizes), gen, device)
    codes = torch.clamp(torch.round(z * a["code_std"]), -8, 7).to(torch.int8)
    del z
    nscale = [(K // group_size(cfg, K)) * N for K, N in shp.values()]
    s = torch.exp(_normal(sum(nscale), gen, device) * a["scale_jitter"])
    s = s * (a["weight_std"] / a["code_std"])
    per_channel = cfg["quant"]["group_size"] == -1
    s = s if per_channel else s.to(torch.bfloat16)
    nb = [shp[n][1] for n in BIASED]
    bias = (_normal(sum(nb), gen, device) * a["bias_std"]).to(torch.bfloat16)
    H = cfg["hidden_size"]
    norms = (1.0 + _normal(2 * H, gen, device) * a["norm_jitter"]).to(
        torch.bfloat16)
    out: Dict[str, Any] = {"input_layernorm": norms[:H],
                           "post_attention_layernorm": norms[H:]}
    co = so = bo = 0
    for name, (K, N) in shp.items():
        g = group_size(cfg, K)
        out[name] = {
            "codes": codes[co:co + K * N].view(K, N),
            "scale": s[so:so + (K // g) * N].view(K // g, N),
            "bias": None,
        }
        co += K * N
        so += (K // g) * N
        if name in BIASED:
            out[name]["bias"] = bias[bo:bo + N]
            bo += N
    return out


def draw_embed(cfg: Dict[str, Any], seed: int, device) -> torch.Tensor:
    """(V, H) bf16."""
    V, H = cfg["vocab_size"], cfg["hidden_size"]
    gen = _generator(seed, "embed", 0, device)
    return (_normal(V * H, gen, device) * cfg["assumed"]["embed_std"]).to(
        torch.bfloat16).view(V, H)


def draw_head(cfg: Dict[str, Any], seed: int, device) -> torch.Tensor:
    """(H, V) bf16, the untied lm_head (weights stored (in, out))."""
    V, H = cfg["vocab_size"], cfg["hidden_size"]
    gen = _generator(seed, "head", 0, device)
    return (_normal(V * H, gen, device) * cfg["assumed"]["head_std"]).to(
        torch.bfloat16).view(H, V)


def draw_final_norm(cfg: Dict[str, Any], seed: int, device) -> torch.Tensor:
    H = cfg["hidden_size"]
    gen = _generator(seed, "norm", 0, device)
    return (1.0 + _normal(H, gen, device) * cfg["assumed"]["norm_jitter"]).to(
        torch.bfloat16)
