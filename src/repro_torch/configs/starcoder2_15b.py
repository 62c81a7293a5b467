"""StarCoder2-15B [arXiv:2402.19173; hf] — dense GQA, RoPE, GELU MLP."""

from repro_torch.models.config import ModelConfig, register_arch


@register_arch("starcoder2-15b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
        d_ff=24576, vocab_size=49152, mlp_type="gelu", rope_theta=1e5,
        remat="full", subquadratic=False,
    )
