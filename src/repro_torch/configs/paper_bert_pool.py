"""The paper's own evaluation subject: a BERT-base-like encoder LM (~110M).

MGit's G1/G2/G5 graphs are built from BERT/RoBERTa-family models; this config
is the trainable stand-in used by the end-to-end examples (finetune lineages,
update cascades) and the compression benchmarks at realistic scale.
"""

from repro_torch.models.config import ModelConfig, register_arch


@register_arch("paper-bert")
def config() -> ModelConfig:
    return ModelConfig(
        name="paper-bert", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab_size=30522, mlp_type="gelu",
        remat="dots", subquadratic=False,
    )


@register_arch("paper-bert-small")
def config_small() -> ModelConfig:
    """~14M variant for fast end-to-end examples on CPU."""
    return ModelConfig(
        name="paper-bert-small", family="dense",
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=1024, vocab_size=8192, mlp_type="gelu", dtype="float32",
        remat="none", subquadratic=False,
    )
