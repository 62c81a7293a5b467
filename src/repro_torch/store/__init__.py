"""MGit storage: CAS dedup, codecs, delta compression, artifact manifests."""

from repro_torch.store.artifact_store import ArtifactStore
from repro_torch.store.cas import CAS
from repro_torch.store.codecs import CODECS, get_codec
from repro_torch.store.delta import (CompressResult, ParamDelta,
                                     decompress_param, delta_compression,
                                     lcs_param_matching)

__all__ = [
    "ArtifactStore", "CAS", "CODECS", "get_codec", "CompressResult",
    "ParamDelta", "decompress_param", "delta_compression",
    "lcs_param_matching",
]
