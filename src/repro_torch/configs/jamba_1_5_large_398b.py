"""Jamba-1.5-Large (398B) [arXiv:2403.19887; hf] — hybrid Mamba+attention MoE.

1:7 attention:mamba interleave (one attention layer per 8, at offset 4), MoE
(16 experts, top-2) on every other layer. Adaptation note (DESIGN.md): mamba
sublayers use our Mamba2/SSD block (state=128) rather than Mamba-1 (state=16)
— the framework's SSM primitive — preserving the hybrid structure and
compute/memory character. SSM layers keep O(1) decode state -> long_500k runs
(attention layers hold the full 500k KV, sharded).
"""

from repro_torch.models.config import ModelConfig, register_arch


@register_arch("jamba-1.5-large-398b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab_size=65536, mlp_type="swiglu",
        n_experts=16, experts_per_token=2,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        attn_period=8, attn_offset=4, moe_period=2,
        remat="full", subquadratic=True,
    )
