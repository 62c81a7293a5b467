"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family; hf] — GQA with per-head qk RMSNorm.

Copied from the reference package's ``repro/configs/qwen3_0_6b.py``."""

from repro_torch.models.config import ModelConfig, register_arch


@register_arch("qwen3-0.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=3072, vocab_size=151936, mlp_type="swiglu", qk_norm=True,
        rope_theta=1e6, tie_embeddings=True,
        remat="full", subquadratic=False,
    )
