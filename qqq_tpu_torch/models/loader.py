"""HF checkpoint interop: import FP models, save and load quantized
checkpoints (port of qqq_tpu/models/loader.py).

HF linear weights are stored (out, in) and transposed to the (in, out)
convention of the params tree.  Quantized checkpoints are one
``model.safetensors`` plus a ``config.json`` that embeds a
``quantization_config`` with ``quant_method: "qqq"``, the file layout and
tensor names of the JAX package, so a checkpoint written by either package
loads in the other bit for bit.

The safetensors format is read and written here, without the
``safetensors`` package: an 8-byte little-endian header length, a JSON
header ``{name: {"dtype", "shape", "data_offsets"}}`` (plus an optional
``"__metadata__"``) padded with spaces to a multiple of 8 bytes, then the
tensors' raw little-endian bytes, back to back.  Tensors are read through
``np.memmap`` and placed straight onto the requested device.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from qqq_tpu_torch.models.config import ModelConfig
from qqq_tpu_torch.utils.device import resolve_device

_LAYER_LINEARS = (
    ("q_proj", "self_attn.q_proj"),
    ("k_proj", "self_attn.k_proj"),
    ("v_proj", "self_attn.v_proj"),
    ("o_proj", "self_attn.o_proj"),
    ("gate_proj", "mlp.gate_proj"),
    ("up_proj", "mlp.up_proj"),
    ("down_proj", "mlp.down_proj"),
)

# ---------------------------------------------------------------------------
# safetensors, read and written without the safetensors package

#: safetensors dtype name → (numpy carrier, torch dtype); bf16 travels as
#: its uint16 bits and is viewed as torch.bfloat16
_ST_DTYPES = {
    "BF16": (np.uint16, torch.bfloat16),
    "F16": (np.float16, torch.float16),
    "F32": (np.float32, torch.float32),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "I32": (np.int32, torch.int32),
    "I64": (np.int64, torch.int64),
}
_ST_NAMES = {t: name for name, (_, t) in _ST_DTYPES.items()}


def _st_header(path: str) -> Tuple[Dict[str, Any], int]:
    """(header without ``__metadata__``, byte offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def _st_keys(path: str) -> List[str]:
    """Tensor names of a safetensors file (its header only is read)."""
    return list(_st_header(path)[0])


def _st_read(path: str, device=torch.device("cpu")) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on ``device``."""
    header, start = _st_header(path)
    mm = np.memmap(path, dtype=np.uint8, mode="c")  # copy-on-write: writable
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype "
                             f"{meta['dtype']}")
        carrier, tdtype = _ST_DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        arr = mm[start + begin:start + end].view(carrier)
        if arr.ctypes.data % arr.itemsize:  # a writer that did not align
            arr = arr.copy()
        t = torch.from_numpy(arr).view(tdtype).reshape(meta["shape"])
        # an owned copy on the CPU; a device copy reads the mapped pages
        out[name] = t.clone() if device.type == "cpu" else t.to(device)
    del mm
    return out


def _st_write(path: str, tensors: Dict[str, torch.Tensor],
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; row-major bytes) as one file."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    host: Dict[str, torch.Tensor] = {}
    offset = 0
    # widest elements first, as the safetensors package orders them: every
    # tensor then starts at a multiple of its element size
    order = sorted(tensors, key=lambda n: -tensors[n].element_size())
    for name in order:
        t = tensors[name]
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} cannot be saved")
        t = t.detach().to("cpu").contiguous()
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        host[name] = t
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in host.values():
            if t.numel():
                f.write(t.view(torch.uint8).reshape(-1).numpy().data)


# ---------------------------------------------------------------------------
# HF checkpoints


def _read_state_dict(model_path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the safetensors shards (or, without any, of the
    ``pytorch_model*.bin`` shards) on the CPU.  A ``.bin`` shard's floating
    tensors are read as float32, as the JAX package reads them; its
    integer tensors are kept as they are."""
    st_files = sorted(f for f in os.listdir(model_path)
                      if f.endswith(".safetensors"))
    tensors: Dict[str, torch.Tensor] = {}
    if st_files:
        for fname in st_files:
            tensors.update(_st_read(os.path.join(model_path, fname)))
        return tensors
    bin_files = sorted(f for f in os.listdir(model_path)
                       if f.startswith("pytorch_model") and f.endswith(".bin"))
    if not bin_files:
        raise FileNotFoundError(f"no weights found in {model_path}")
    for fname in bin_files:
        sd = torch.load(os.path.join(model_path, fname), map_location="cpu",
                        weights_only=True)
        for key, val in sd.items():
            tensors[key] = val.float() if val.is_floating_point() else val
    return tensors


def load_hf_config(model_path: str) -> ModelConfig:
    with open(os.path.join(model_path, "config.json")) as f:
        raw = json.load(f)
    raw.pop("quantization_config", None)
    return ModelConfig.from_hf(raw)


def load_hf_model(model_path: str, dtype: torch.dtype = torch.bfloat16,
                  device=None) -> Tuple[Dict[str, Any], ModelConfig]:
    """Import an HF Llama/Qwen2 checkpoint into the params tree on
    ``device``: every weight through float32 to ``dtype``, linears
    transposed to (in, out)."""
    device = resolve_device(device)
    config = load_hf_config(model_path)
    sd = _read_state_dict(model_path)

    def arr(key: str, transpose: bool = False) -> torch.Tensor:
        t = sd[key].to(torch.float32)
        if transpose:
            t = t.T.contiguous()
        return t.to(dtype).to(device)

    def linear(prefix: str) -> Dict[str, torch.Tensor]:
        p = {"w": arr(f"{prefix}.weight", transpose=True)}
        if f"{prefix}.bias" in sd:
            p["b"] = arr(f"{prefix}.bias")
        return p

    layers = []
    for i in range(config.num_hidden_layers):
        pre = f"model.layers.{i}"
        layer: Dict[str, Any] = {
            "input_layernorm": arr(f"{pre}.input_layernorm.weight"),
            "post_attention_layernorm": arr(
                f"{pre}.post_attention_layernorm.weight"),
        }
        for ours, theirs in _LAYER_LINEARS:
            layer[ours] = linear(f"{pre}.{theirs}")
        layers.append(layer)
    params: Dict[str, Any] = {
        "embed": arr("model.embed_tokens.weight"),
        "layers": layers,
        "norm": arr("model.norm.weight"),
    }
    if config.tie_word_embeddings or "lm_head.weight" not in sd:
        params["lm_head"] = None
    else:
        params["lm_head"] = linear("lm_head")
    return params, config


def save_hf_model(out_path: str, params: Dict[str, Any],
                  config: ModelConfig) -> None:
    """Write dense params as an HF Llama/Qwen2 directory (one
    ``model.safetensors`` and ``config.json``) that :func:`load_hf_model`
    reads back bit for bit: linears transposed to (out, in), every tensor
    in its own dtype."""
    sd: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["norm"],
    }

    def linear(prefix: str, lin: Dict[str, torch.Tensor]) -> None:
        sd[f"{prefix}.weight"] = lin["w"].T.contiguous()
        if "b" in lin:
            sd[f"{prefix}.bias"] = lin["b"]

    for i, layer in enumerate(params["layers"]):
        pre = f"model.layers.{i}"
        sd[f"{pre}.input_layernorm.weight"] = layer["input_layernorm"]
        sd[f"{pre}.post_attention_layernorm.weight"] = layer[
            "post_attention_layernorm"]
        for ours, theirs in _LAYER_LINEARS:
            linear(f"{pre}.{theirs}", layer[ours])
    if params.get("lm_head") is not None:
        linear("lm_head", params["lm_head"])
    os.makedirs(out_path, exist_ok=True)
    _st_write(os.path.join(out_path, "model.safetensors"), sd,
              metadata={"format": "pt"})
    cfg = {k: v for k, v in config.__dict__.items() if v is not None}
    if config.rope_scaling is not None:
        cfg["rope_scaling"] = config.rope_scaling_dict
    with open(os.path.join(out_path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)


# ---------------------------------------------------------------------------
# quantized checkpoints (the JAX package's native format)


def _flatten(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Dotted names (``layers.3.q_proj.w_packed``) → tensors; None leaves
    (an untied ``lm_head`` absent) are dropped."""
    flat: Dict[str, torch.Tensor] = {}

    def visit(prefix: str, obj: Any) -> None:
        if isinstance(obj, dict):
            for k, v in obj.items():
                visit(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(obj, list):
            for i, v in enumerate(obj):
                visit(f"{prefix}.{i}", v)
        elif obj is not None:
            flat[prefix] = obj

    visit("", params)
    return flat


def save_quantized(out_path: str, params: Dict[str, Any], config: ModelConfig,
                   quant_config: Optional[Dict[str, Any]] = None) -> None:
    """Save packed params and a config.json with ``quantization_config``."""
    os.makedirs(out_path, exist_ok=True)
    _st_write(os.path.join(out_path, "model.safetensors"), _flatten(params),
              metadata={"format": "pt"})
    cfg = dict(config.__dict__)
    cfg["quantization_config"] = quant_config or {
        "quant_method": "qqq", "wbits": 4, "group_size": -1,
    }
    with open(os.path.join(out_path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)


def load_quantized(model_path: str, dtype: torch.dtype = torch.bfloat16,
                   device=None
                   ) -> Tuple[Dict[str, Any], ModelConfig, Dict[str, Any]]:
    """Load a checkpoint saved by :func:`save_quantized` (of either
    package) onto ``device``: float32 tensors (scales, norms saved in f32)
    stay float32, other floating tensors become ``dtype``."""
    device = resolve_device(device)
    with open(os.path.join(model_path, "config.json")) as f:
        raw = json.load(f)
    quant_config = raw.pop("quantization_config", {})
    config = ModelConfig(**{k: v for k, v in raw.items()
                            if k in ModelConfig.__dataclass_fields__})
    flat = _st_read(os.path.join(model_path, "model.safetensors"), device)
    params: Dict[str, Any] = {
        "layers": [{} for _ in range(config.num_hidden_layers)]}
    for key, t in flat.items():
        if t.is_floating_point() and t.dtype != torch.float32:
            t = t.to(dtype)
        parts = key.split(".")
        node: Any = params
        for p in parts[:-1]:
            node = node[int(p)] if p.isdigit() else node.setdefault(p, {})
        node[parts[-1]] = t
    params.setdefault("lm_head", None)
    return params, config, quant_config
