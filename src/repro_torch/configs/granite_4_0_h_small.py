"""Granite-4.0-H-Small (32B total, 9B active) [hf: ibm-granite/
granite-4.0-h-small, config.json, ``granitemoehybrid``] — Mamba2 and
attention hybrid with fine-grained experts.

40 layers in periods of 10: Mamba2 everywhere but attention at offset 5
(layers 5, 15, 25, 35). Mamba2: 128 heads of 64, state 128, 1 group,
conv 4 with a bias, chunk 256. Attention: GQA, 32 query and 8 K/V heads
of 128, no positional encoding. After every mixer a dropless MoE of 72
experts of width 768, top-10 (softmax over the 10 largest logits), and an
always-on shared SwiGLU expert of width 1536. muP multipliers: the
embedding x 12, every sublayer's output x 0.22, softmax scale 1/128,
logits / 16. RMSNorm eps 1e-5, tied embeddings, vocab 100352.

Port only: the reference package has no such architecture.
"""

from repro_torch.models.config import ModelConfig, register_arch


@register_arch("granite-4.0-h-small")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-4.0-h-small", family="hybrid",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=768, vocab_size=100352, mlp_type="swiglu", norm_eps=1e-5,
        tie_embeddings=True,
        n_experts=72, experts_per_token=10, n_shared_experts=1,
        shared_d_ff=1536, dropless=True,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        ssm_conv_width=4, ssm_conv_bias=True,
        attn_period=10, attn_offset=5, moe_period=1,
        nope=True, embedding_multiplier=12.0, residual_multiplier=0.22,
        attention_multiplier=1.0 / 128, logits_scaling=16.0,
        remat="full", subquadratic=True,
    )
