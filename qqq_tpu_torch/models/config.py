"""Model configuration (port of qqq_tpu/models/config.py): Llama-1/2/3 and
Qwen2 geometry."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model_type: str = "llama"  # "llama" | "qwen2"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    attention_bias: bool = False  # qwen2: True for qkv (not o_proj)
    tie_word_embeddings: bool = False
    # HF rope_scaling, stored as a sorted item-tuple so the config hashes (a
    # list of pairs, as json gives the tuple back, is taken too)
    rope_scaling: Optional[Any] = None

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(
                self, "head_dim", self.hidden_size // self.num_attention_heads
            )
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(
                self, "rope_scaling", tuple(sorted(self.rope_scaling.items()))
            )
        elif isinstance(self.rope_scaling, list):  # round-tripped through json
            object.__setattr__(
                self, "rope_scaling",
                tuple((k, v) for k, v in self.rope_scaling),
            )

    @property
    def rope_scaling_dict(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @classmethod
    def from_hf(cls, hf_config: Any) -> "ModelConfig":
        """Build from a transformers config object or a plain dict (a
        config.json), e.g. Llama-3.1's GQA geometry and llama3
        ``rope_scaling``."""
        get = (
            hf_config.get
            if isinstance(hf_config, dict)
            else lambda k, d=None: getattr(hf_config, k, d)
        )
        model_type = get("model_type", "llama")
        if model_type not in ("llama", "qwen2"):
            raise ValueError(f"unsupported model_type {model_type!r}")
        rope_scaling = get("rope_scaling", None)
        if rope_scaling is not None and not isinstance(rope_scaling, dict):
            rope_scaling = dict(rope_scaling)
        return cls(
            model_type=model_type,
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            intermediate_size=get("intermediate_size"),
            num_hidden_layers=get("num_hidden_layers"),
            num_attention_heads=get("num_attention_heads"),
            num_key_value_heads=get(
                "num_key_value_heads", get("num_attention_heads")
            ),
            head_dim=get("head_dim", None),
            rms_norm_eps=get("rms_norm_eps", 1e-5),
            rope_theta=get("rope_theta", 10000.0),
            max_position_embeddings=get("max_position_embeddings", 4096),
            attention_bias=(
                model_type == "qwen2" or bool(get("attention_bias", False))
            ),
            tie_word_embeddings=bool(get("tie_word_embeddings", False)),
            rope_scaling=rope_scaling,
        )

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim
