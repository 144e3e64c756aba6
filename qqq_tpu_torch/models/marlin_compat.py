"""Interop with the reference QQQ's checkpoints, Marlin-packed (port of
qqq_tpu/models/marlin_compat.py).

The reference quantizes once and writes an HF checkpoint whose QuantLinear
buffers are in Marlin's CUDA fragment layout:

* ``B`` int32 (K/16, N·16/8): weights in 16×16 tiles, an intra-tile
  permutation for ``ldmatrix``, 8 nibbles a word;
* ``s_channel`` fp32 (1, N): per-channel scales (a per-channel checkpoint
  stores ``scale/16``, a per-group one ``s_extra``);
* ``s_group`` fp16 (K/128, N): per-group double scales ``scale/s_extra``,
  both scale tensors in Marlin's scale permutations.

This module inverts that and repacks the codes into the nibble-plane
layout of core/packing.py, with torch ops on the tensors' device, so a
reference-quantized model loads straight onto the card; and it writes the
params tree back out in that layout.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from qqq_tpu_torch.core.packing import pack_int4, unpack_int4
from qqq_tpu_torch.models.config import ModelConfig
from qqq_tpu_torch.models.loader import _read_state_dict, _st_write
from qqq_tpu_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=None)
def _marlin_perms(per_channel: bool):
    """The Marlin packing permutations: (perm (1024,), scale_perm (64,),
    scale_perm_single (32,)), numpy int64."""
    perm = []
    for i in range(32):
        perm1 = []
        col = i // 4
        for block in (0, 1):
            for row in (4 * (i % 4), 4 * (i % 4) + 1, 4 * (i % 4) + 2,
                        4 * (i % 4) + 3):
                perm1.append(16 * row + col + 8 * block)
        for j in range(4):
            perm.extend(p + 256 * j for p in perm1)
    perm = np.array(perm)
    interleave = (np.array([4, 0, 5, 1, 6, 2, 7, 3]) if per_channel
                  else np.array([0, 2, 4, 6, 1, 3, 5, 7]))
    perm = perm.reshape(-1, 8)[:, interleave].ravel()
    scale_perm = np.array([i + 8 * j for i in range(8) for j in range(8)])
    scale_perm_single = np.array(
        [2 * i + j for i in range(4) for j in (0, 1, 8, 9, 16, 17, 24, 25)])
    return perm, scale_perm, scale_perm_single


def _index(perm: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(perm)).to(device)


def unpack_marlin(
    B: torch.Tensor,                  # (K/16, N·16/8) int32
    s_channel: torch.Tensor,          # (1, N) fp32
    s_group: Optional[torch.Tensor],  # (K/128, N) fp16, or None / empty
    *, infeatures: int, outfeatures: int,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Invert QuantLinear.pack → (signed codes (K, N) int8, s_channel (N,)
    fp32, full group scales ``s_group · s_extra`` (K/128, N) fp32 or
    None), on ``B``'s device."""
    K, N = infeatures, outfeatures
    dev = B.device
    per_channel = s_group is None or s_group.numel() == 0
    perm, scale_perm, scale_perm_single = _marlin_perms(per_channel)

    # nibbles out of the words: res[:, i::8] held nibble i
    Bu = B.to(torch.int64) & 0xFFFFFFFF
    res = torch.empty((K // 16, N * 16), dtype=torch.int64, device=dev)
    for i in range(8):
        res[:, i::8] = (Bu >> (4 * i)) & 0xF
    # the fragment permutation (pack: res[:, perm]), then the 16×16 tiling
    inv = _index(np.argsort(perm), dev)
    res = res.reshape(-1, perm.size)[:, inv].reshape(K // 16, N * 16)
    w = res.reshape(K // 16, N // 16, 16, 16).permute(0, 2, 1, 3)
    w = w.reshape(K, N)

    inv_single = _index(np.argsort(scale_perm_single), dev)
    s = s_channel.to(torch.float32).reshape(-1, scale_perm_single.size)
    s = s[:, inv_single].reshape(N)
    if per_channel:
        # (w & 0xF) of signed codes: sign-extend; the scale was stored /16
        q4 = torch.where(w >= 8, w - 16, w)
        return q4.to(torch.int8), s * 16.0, None
    q4 = w - 8  # stored as q + 8
    sg = s_group.to(torch.float32).reshape(-1, scale_perm.size)
    sg = sg[:, _index(np.argsort(scale_perm), dev)].reshape(K // 128, N)
    return q4.to(torch.int8), s, sg * s[None, :]


def pack_marlin(q4: torch.Tensor, scale: torch.Tensor, *, group_size: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward Marlin packing of signed codes (K, N) and fp32 scales (G, N)
    → (B int32, s_channel fp32 (1, N), s_group fp16 (K/group, N); empty
    (0, N) per channel)."""
    K, N = q4.shape
    dev = q4.device
    per_channel = group_size == -1
    perm, scale_perm, scale_perm_single = _marlin_perms(per_channel)
    single = _index(scale_perm_single, dev)
    scale = scale.to(torch.float32)
    if per_channel:
        w = q4.to(torch.int64) & 0xF
        s_channel = (scale.reshape(N) / 16.0).reshape(-1, single.numel())
        s_channel = s_channel[:, single].reshape(1, N)
        s_group = torch.zeros((0, N), dtype=torch.float16, device=dev)
    else:
        w = (q4.to(torch.int64) + 8) & 0xF
        w_deq = scale.repeat_interleave(group_size, 0) * q4.to(torch.float32)
        absmax = w_deq.abs().amax(0)
        absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
        s_extra = absmax / torch.full_like(absmax, 127.0)
        sg = (scale / s_extra[None, :]).to(torch.float16)
        s_channel = s_extra.reshape(-1, single.numel())[:, single]
        s_channel = s_channel.reshape(1, N)
        s_group = sg.reshape(-1, scale_perm.size)[:, _index(scale_perm, dev)]
        s_group = s_group.reshape(K // group_size, N)
    w = w.reshape(K // 16, 16, N // 16, 16).permute(0, 2, 1, 3)
    w = w.reshape(K // 16, N * 16)
    res = w.reshape(-1, perm.size)[:, _index(perm, dev)]
    res = res.reshape(K // 16, N * 16)
    Bw = torch.zeros((K // 16, N * 16 // 8), dtype=torch.int64, device=dev)
    for i in range(8):
        Bw |= res[:, i::8] << (4 * i)
    Bw = torch.where(Bw >= 2 ** 31, Bw - 2 ** 32, Bw)  # two's complement
    return Bw.to(torch.int32), s_channel, s_group


_MARLIN_LINEARS = (
    ("q_proj", "self_attn.q_proj"),
    ("k_proj", "self_attn.k_proj"),
    ("v_proj", "self_attn.v_proj"),
    ("o_proj", "self_attn.o_proj"),
    ("gate_proj", "mlp.gate_proj"),
    ("up_proj", "mlp.up_proj"),
    ("down_proj", "mlp.down_proj"),
)


def load_qqq_hf_checkpoint(model_path: str,
                           dtype: torch.dtype = torch.bfloat16, device=None
                           ) -> Tuple[Dict[str, Any], ModelConfig]:
    """Load a reference-quantized HF checkpoint (``quant_method: "qqq"``)
    into the params tree on ``device``, its weights repacked into the
    nibble-plane layout there; scales stay fp32, norms, embeddings, biases
    and the FP lm_head become ``dtype``."""
    device = resolve_device(device)
    with open(os.path.join(model_path, "config.json")) as f:
        raw = json.load(f)
    qc = raw.pop("quantization_config", None)
    if not qc or qc.get("quant_method") != "qqq":
        raise ValueError(f"{model_path} is not a QQQ checkpoint")
    config = ModelConfig.from_hf(raw)
    sd = _read_state_dict(model_path)

    def fp(key: str, transpose: bool = False) -> torch.Tensor:
        t = sd[key].to(torch.float32)
        if transpose:
            t = t.T.contiguous()
        return t.to(dtype).to(device)

    def linear(prefix: str, K: int, N: int) -> Dict[str, Any]:
        s_g = sd.get(f"{prefix}.s_group")
        if s_g is not None and s_g.numel() == 0:
            s_g = None
        q4, s_channel, s_full = unpack_marlin(
            sd[f"{prefix}.B"].to(device),
            sd[f"{prefix}.s_channel"].to(device),
            None if s_g is None else s_g.to(device),
            infeatures=K, outfeatures=N)
        p: Dict[str, Any] = {"w_packed": pack_int4(q4)}
        if s_full is None:
            p["s_channel"] = s_channel
        else:
            p["s_group"] = s_full
        if f"{prefix}.bias" in sd:
            p["b"] = fp(f"{prefix}.bias")
        return p

    H, I = config.hidden_size, config.intermediate_size
    dims = {"q_proj": (H, config.q_dim), "k_proj": (H, config.kv_dim),
            "v_proj": (H, config.kv_dim), "o_proj": (config.q_dim, H),
            "gate_proj": (H, I), "up_proj": (H, I), "down_proj": (I, H)}
    layers = []
    for i in range(config.num_hidden_layers):
        pre = f"model.layers.{i}"
        layer: Dict[str, Any] = {
            "input_layernorm": fp(f"{pre}.input_layernorm.weight"),
            "post_attention_layernorm": fp(
                f"{pre}.post_attention_layernorm.weight"),
        }
        for ours, theirs in _MARLIN_LINEARS:
            layer[ours] = linear(f"{pre}.{theirs}", *dims[ours])
        layers.append(layer)
    params: Dict[str, Any] = {
        "embed": fp("model.embed_tokens.weight"),
        "layers": layers,
        "norm": fp("model.norm.weight"),
    }
    if config.tie_word_embeddings or "lm_head.weight" not in sd:
        params["lm_head"] = None
    else:
        params["lm_head"] = {"w": fp("lm_head.weight", transpose=True)}
    return params, config


def save_marlin_checkpoint(out_path: str, params: Dict[str, Any],
                           config: ModelConfig, *, group_size: int) -> None:
    """Export packed params as a checkpoint the reference (and vLLM) loads:
    per linear ``B``/``s_channel``[/``s_group``] in Marlin layout, fp16 FP
    weights, and config.json's ``quantization_config``.  g128 scales are
    stored as the format's fp16 double scales, as the reference's own
    pack() rounds them."""
    flat: Dict[str, torch.Tensor] = {}

    def put_fp(key: str, t: torch.Tensor, transpose: bool = False) -> None:
        t = t.to(torch.float32)
        flat[key] = (t.T if transpose else t).contiguous().to(torch.float16)

    def put_linear(prefix: str, lin: Dict[str, Any]) -> None:
        if "w_packed" not in lin:
            raise ValueError(f"{prefix} is not packed W4A8")
        q4 = unpack_int4(lin["w_packed"])
        N = q4.shape[1]
        if group_size == -1:
            scale = lin["s_channel"].to(torch.float32).reshape(1, N)
        else:
            scale = lin["s_group"].to(torch.float32)
        B, s_channel, s_group = pack_marlin(q4, scale, group_size=group_size)
        flat[f"{prefix}.B"] = B
        flat[f"{prefix}.s_channel"] = s_channel
        if group_size != -1:
            flat[f"{prefix}.s_group"] = s_group
        if "b" in lin:
            put_fp(f"{prefix}.bias", lin["b"])

    for i, layer in enumerate(params["layers"]):
        pre = f"model.layers.{i}"
        put_fp(f"{pre}.input_layernorm.weight", layer["input_layernorm"])
        put_fp(f"{pre}.post_attention_layernorm.weight",
               layer["post_attention_layernorm"])
        for ours, theirs in _MARLIN_LINEARS:
            put_linear(f"{pre}.{theirs}", layer[ours])
    put_fp("model.embed_tokens.weight", params["embed"])
    put_fp("model.norm.weight", params["norm"])
    head = params.get("lm_head")
    if head is not None:
        if "w" not in head:
            raise ValueError("the Marlin format keeps the lm_head FP")
        put_fp("lm_head.weight", head["w"], transpose=True)

    os.makedirs(out_path, exist_ok=True)
    _st_write(os.path.join(out_path, "model.safetensors"), flat,
              metadata={"format": "pt"})
    cfg = dict(config.__dict__)
    cfg["model_type"] = "llama"
    cfg["architectures"] = ["LlamaForCausalLM"]
    cfg["quantization_config"] = {"group_size": group_size,
                                  "quant_method": "qqq", "wbits": 4}
    with open(os.path.join(out_path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
