"""Mixtral-8x7B [arXiv:2401.04088; hf] — 8 experts top-2, sliding-window attn.

SWA (W=4096) bounds the KV cache -> runs the long_500k cell with a ring
buffer cache.
"""

from repro_torch.models.config import ModelConfig, register_arch


@register_arch("mixtral-8x7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=32000, mlp_type="swiglu",
        n_experts=8, experts_per_token=2, window=4096,
        rope_theta=1e6, remat="full", subquadratic=True,
    )
