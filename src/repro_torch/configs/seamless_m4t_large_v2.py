"""SeamlessM4T-large-v2 [arXiv:2308.11596; hf] — encoder-decoder, multimodal.

The speech frontend (w2v-BERT conformer feature extractor) is a STUB per the
assignment: ``input_specs`` feeds precomputed frame embeddings (B, S, d_model).
The transformer backbone (24L enc + 24L dec, MHA kv=16, GELU) is real.
"""

from repro_torch.models.config import ModelConfig, register_arch


@register_arch("seamless-m4t-large-v2")
def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2", family="audio",
        n_layers=24, n_encoder_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, head_dim=64, d_ff=8192, vocab_size=256206,
        mlp_type="gelu", frontend="audio_stub",
        remat="full", subquadratic=False,
    )
