"""Model configuration + registry. One ``configs/<arch>.py`` per assigned arch."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int = 0                # 0 for attention-free (ssm)
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0               # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"        # swiglu | gelu
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    window: int = 0                 # sliding-window attention if > 0
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    n_local_experts: int = 0        # experts held here, from 0 up; 0 -> all
    dropless: bool = False          # route every choice (no capacity)
    shared_d_ff: int = 0            # the shared expert's width; 0 -> d_ff
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_conv_bias: bool = False
    # --- hybrid (jamba, granite): one attention layer per `attn_period`
    # layers, MoE on every `moe_period`-th layer ---
    attn_period: int = 0
    attn_offset: int = 4
    moe_period: int = 0
    # --- positions and muP multipliers (granite); defaults change nothing ---
    nope: bool = False              # no positional encoding in attention
    embedding_multiplier: float = 0.0   # 0 -> sqrt(d_model)
    residual_multiplier: float = 1.0    # on every sublayer's output
    attention_multiplier: float = 0.0   # softmax scale; 0 -> head_dim**-0.5
    logits_scaling: float = 1.0         # logits are divided by it
    # --- enc-dec / frontends ---
    n_encoder_layers: int = 0
    frontend: str = "none"          # none | vision_stub | audio_stub
    n_prefix_tokens: int = 0        # vision patches fed as embeddings
    # --- numerics / compile ---
    dtype: str = "bfloat16"
    remat: str = "dots"             # none | dots | full
    attn_chunk: int = 1024          # KV block for memory-efficient attention
    # --- technique applicability (DESIGN.md §Arch-applicability) ---
    subquadratic: bool = False      # True -> long_500k decode supported

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def held_experts(self) -> int:
        """The experts whose weights this model holds: 0 .. n - 1."""
        return self.n_local_experts or self.n_experts

    def is_attention_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            return self.attn_period > 0 and i % self.attn_period == self.attn_offset
        return True

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        if self.family == "hybrid":
            return self.moe_period > 0 and i % self.moe_period == self.moe_period - 1
        return True

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        small = dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if self.family != "hybrid" else self.attn_period),
            d_model=128,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32 if self.n_heads else 0,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            n_local_experts=min(self.n_local_experts, 4),
            shared_d_ff=512 if self.shared_d_ff else 0,
            # no-drop capacity so decode (tiny T) matches full forward exactly
            capacity_factor=float(min(self.n_experts, 4) or 1),
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            n_prefix_tokens=min(self.n_prefix_tokens, 8),
            window=min(self.window, 64) if self.window else 0,
            attn_chunk=64,
            dtype="float32",
        )
        # a hybrid with MoE after every mixer (granite) keeps its own period
        # of ``attn_period`` layers and its attention offset
        if self.family == "hybrid" and self.moe_period != 1:
            small = dataclasses.replace(small, attn_period=4, attn_offset=2,
                                        moe_period=2, n_layers=4)
        return dataclasses.replace(small, **overrides)


# -- registry -----------------------------------------------------------------
_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        import repro_torch.configs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
