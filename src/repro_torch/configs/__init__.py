"""Architecture configs ported so far (see each module's source note).

Importing this package populates the registry used by ``get_config``. The
reference package's other architectures arrive with their model families.
"""

from repro_torch.configs import paper_bert_pool, qwen3_0_6b

__all__ = ["paper_bert_pool", "qwen3_0_6b"]
