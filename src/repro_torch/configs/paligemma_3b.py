"""PaliGemma-3B [arXiv:2407.07726; hf] — SigLIP + gemma decoder (MQA kv=1).

The SigLIP vision tower is a STUB per the assignment: ``input_specs`` feeds
256 precomputed patch embeddings (B, 256, d_model); the gemma-style decoder
backbone (18L, 8H MQA, head_dim 256) is real, with a prefix-LM mask over the
visual prefix.
"""

from repro_torch.models.config import ModelConfig, register_arch


@register_arch("paligemma-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab_size=257216, mlp_type="swiglu",
        frontend="vision_stub", n_prefix_tokens=256, tie_embeddings=True,
        remat="full", subquadratic=False,
    )
