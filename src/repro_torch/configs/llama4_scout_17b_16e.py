"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE top-1.

16 routed experts (top-1) + 1 shared expert per layer. The early-fusion
vision frontend is out of the assigned backbone scope (entry tagged [moe]);
text path only.
"""

from repro_torch.models.config import ModelConfig, register_arch


@register_arch("llama4-scout-17b-16e")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048, mlp_type="swiglu",
        n_experts=16, experts_per_token=1, n_shared_experts=1,
        rope_theta=5e5, remat="full", subquadratic=False,
    )
