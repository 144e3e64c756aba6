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
    # HF rope_scaling, stored as a sorted item-tuple so the config hashes
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

    @property
    def rope_scaling_dict(self) -> Optional[dict]:
        return dict(self.rope_scaling) if self.rope_scaling else None

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def q_dim(self) -> int:
        return self.num_attention_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_key_value_heads * self.head_dim
