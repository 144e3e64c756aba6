"""Plain reference of a W4A8 Qwen2 (and Llama) decoder, in float32 PyTorch
with TF32 off: no kernel, no cache, no batching, and nothing of the program.

It follows the published Qwen2 layer (RMSNorm, q/k/v with bias, RoPE in the
HF rotate-half convention, grouped-query causal attention, SiLU-gated MLP,
final norm, untied or tied head) with the QQQ W4A8 recipe's arithmetic at
the points the recipe defines:

* every decoder linear takes its input quantized per token to ``act_bits``
  (symmetric, scale = absmax / (2^(bits-1) - 1), round half to even,
  clipped), multiplies by the INT4 codes times their scales (per channel,
  or per group of 128 input rows), rescales by the token's scale and adds
  its bias;
* keys (after RoPE) and values are stored quantized per (token, kv head)
  to ``kv_bits`` the same way, and attention reads them back dequantized,
  the new tokens' own included.

Everything else is float32.  Departures from a served bf16 model: none of
its bf16 roundings (residual stream, GEMM outputs, attention) are made
here.  The weights come from the benchmark's seeded draw
(``harness/weights.py``), layer by layer, so the reference holds one layer
at a time.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from harness import weights as W


def _quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """x quantized per row (last dim) to ``bits`` and dequantized."""
    qmax = float((1 << (bits - 1)) - 1)
    s = x.abs().amax(dim=-1, keepdim=True) / qmax
    s = torch.clamp_min(s, torch.finfo(torch.float32).tiny)
    return torch.clamp(torch.round(x / s), -qmax - 1, qmax) * s


def _dequant(lin: Dict[str, Any], group: int) -> torch.Tensor:
    codes = lin["codes"].to(torch.float32)
    scale = lin["scale"].to(torch.float32)
    K, N = codes.shape
    return (codes.view(K // group, group, N) * scale[:, None, :]).view(K, N)


def _linear(x: torch.Tensor, w: torch.Tensor, bias, act_bits: int
            ) -> torch.Tensor:
    y = _quant(x, act_bits) @ w
    return y if bias is None else y + bias.to(torch.float32)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * w.to(torch.float32)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (L, heads, hd) at positions 0 .. L-1, rotate-half convention."""
    L, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = torch.arange(L, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cat([ang.cos()] * 2, -1).to(torch.float32)[:, None, :]
    sin = torch.cat([ang.sin()] * 2, -1).to(torch.float32)[:, None, :]
    half = hd // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def _attention(q, k, v, groups: int) -> torch.Tensor:
    """Causal GQA attention of one sequence: q (L, nh, hd), k/v (L, nkv, hd)
    → (L, nh·hd)."""
    L, nh, hd = q.shape
    k = torch.repeat_interleave(k, groups, dim=1).transpose(0, 1)
    v = torch.repeat_interleave(v, groups, dim=1).transpose(0, 1)
    s = q.transpose(0, 1) @ k.transpose(1, 2) / math.sqrt(hd)
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return (p @ v).transpose(0, 1).reshape(L, nh * hd)


@torch.no_grad()
def logits_at(cfg: Dict[str, Any], seed: int, seqs: List[List[int]],
              starts: List[int], device, act_bits: int = 8,
              kv_bits: int = 8) -> List[torch.Tensor]:
    """For each token sequence, float32 logits (len - start, V) at positions
    ``start`` .. len - 1 (each predicting the token after it)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(cfg, seed, seqs, starts, device, act_bits, kv_bits)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _logits_at(cfg, seed, seqs, starts, device, act_bits, kv_bits):
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = W.head_dim(cfg)
    lens = [len(s) for s in seqs]
    toks = torch.tensor([t for s in seqs for t in s], dtype=torch.int64,
                        device=device)
    embed = W.draw_embed(cfg, seed, device)
    x = embed[toks].to(torch.float32)  # (total tokens, H)
    del embed
    for i in range(cfg["num_hidden_layers"]):
        lay = W.draw_layer(cfg, seed, i, device)
        w = {n: _dequant(lay[n], W.group_size(cfg, lay[n]["codes"].shape[0]))
             for n in W.LINEARS}
        h = _rms(x, lay["input_layernorm"], eps)
        q = _linear(h, w["q_proj"], lay["q_proj"]["bias"], act_bits)
        k = _linear(h, w["k_proj"], lay["k_proj"]["bias"], act_bits)
        v = _linear(h, w["v_proj"], lay["v_proj"]["bias"], act_bits)
        outs, o = [], 0
        for n in lens:
            qs = _rope(q[o:o + n].view(n, nh, hd), theta)
            ks = _quant(_rope(k[o:o + n].view(n, nkv, hd), theta), kv_bits)
            vs = _quant(v[o:o + n].view(n, nkv, hd), kv_bits)
            outs.append(_attention(qs, ks, vs, nh // nkv))
            o += n
        x = x + _linear(torch.cat(outs), w["o_proj"], None, act_bits)
        del q, k, v, outs
        h = _rms(x, lay["post_attention_layernorm"], eps)
        g = _linear(h, w["gate_proj"], None, act_bits)
        u = _linear(h, w["up_proj"], None, act_bits)
        x = x + _linear(torch.nn.functional.silu(g) * u, w["down_proj"], None,
                        act_bits)
        del g, u, h, w, lay
    rows, o = [], 0
    for n, st in zip(lens, starts):
        rows.append(torch.arange(o + st, o + n, device=device))
        o += n
    idx = torch.cat(rows)
    h = _rms(x[idx], W.draw_final_norm(cfg, seed, device), eps)
    del x
    if cfg.get("tie_word_embeddings"):
        head = W.draw_embed(cfg, seed, device).to(torch.float32).T
    else:
        head = W.draw_head(cfg, seed, device).to(torch.float32)
    logits = h @ head
    return list(torch.split(logits, [n - st for n, st in zip(lens, starts)]))
