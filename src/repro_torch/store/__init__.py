"""MGit storage: CAS dedup, codecs, delta compression, artifact manifests,
and continuous checkpointing of a train state."""

from repro_torch.store.artifact_store import ArtifactStore
from repro_torch.store.cas import CAS
from repro_torch.store.checkpoint import (CKPT_OVERHEAD, CKPT_STATS,
                                          CheckpointManager, flatten_state,
                                          unflatten_state)
from repro_torch.store.codecs import CODECS, get_codec
from repro_torch.store.delta import (CompressResult, ParamDelta,
                                     decompress_param, delta_compression,
                                     lcs_param_matching)

__all__ = [
    "ArtifactStore", "CAS", "CODECS", "get_codec", "CompressResult",
    "ParamDelta", "decompress_param", "delta_compression",
    "lcs_param_matching", "CheckpointManager", "CKPT_OVERHEAD", "CKPT_STATS",
    "flatten_state", "unflatten_state",
]
