"""Yi-6B [arXiv:2403.04652; hf] — llama-architecture GQA, SwiGLU."""

from repro_torch.models.config import ModelConfig, register_arch


@register_arch("yi-6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=11008, vocab_size=64000, mlp_type="swiglu", rope_theta=5e6,
        remat="full", subquadratic=False,
    )
