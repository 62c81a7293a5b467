"""Architecture configs, copied from the reference package's
``repro/configs`` with their imports rebased (see each module's source
note).

Importing this package populates the registry used by ``get_config``.
"""

from repro_torch.configs import (deepseek_coder_33b, jamba_1_5_large_398b,
                                 llama4_scout_17b_16e, mamba2_780m,
                                 mixtral_8x7b, paligemma_3b, paper_bert_pool,
                                 qwen3_0_6b, seamless_m4t_large_v2,
                                 starcoder2_15b, yi_6b)

__all__ = [
    "starcoder2_15b", "yi_6b", "qwen3_0_6b", "deepseek_coder_33b",
    "seamless_m4t_large_v2", "mamba2_780m", "llama4_scout_17b_16e",
    "mixtral_8x7b", "jamba_1_5_large_398b", "paligemma_3b", "paper_bert_pool",
]
