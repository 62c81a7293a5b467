"""DeepSeek-Coder-33B [arXiv:2401.14196; hf] — llama-architecture GQA."""

from repro_torch.models.config import ModelConfig, register_arch


@register_arch("deepseek-coder-33b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b", family="dense",
        n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=19200, vocab_size=32256, mlp_type="swiglu", rope_theta=1e5,
        remat="full", subquadratic=False,
    )
