"""Mamba2-780M [arXiv:2405.21060] — attention-free SSD (state-space duality).

O(1)-state recurrent decode -> runs the long_500k cell.
"""

from repro_torch.models.config import ModelConfig, register_arch


@register_arch("mamba2-780m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab_size=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
        ssm_chunk=256, tie_embeddings=True,
        remat="full", subquadratic=True,
    )
