"""Carry model weights across into this package's artifacts.

:func:`to_artifact` turns a flat ``{path: array}`` parameter dict into a
:class:`ModelArtifact` with the chain layer graph of
``repro_torch.models.graph.state_graph``. The dict may hold numpy arrays
(as the reference package's ``flatten_state(init_params(cfg))`` gives) or
torch tensors (as ``repro_torch.models.init_params`` gives). The same
parameters, model type and metadata commit to the same manifest in both
packages.

The store keeps parameters as numpy arrays, and numpy has no bfloat16
here, so bf16 parameters raise ``NotImplementedError`` until the bf16
storage path arrives.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.artifact import ModelArtifact
from repro_torch.kernels.build import BF16_ITEM
from repro_torch.models.graph import state_graph


def to_numpy(value) -> np.ndarray:
    """A contiguous host numpy array of ``value`` (array or tensor)."""
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            raise NotImplementedError(
                f"bfloat16 parameters cannot be stored yet: ROADMAP item "
                f"'{BF16_ITEM}'")
        value = value.detach().cpu().numpy()
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        raise NotImplementedError(
            f"bfloat16 parameters cannot be stored yet: ROADMAP item "
            f"'{BF16_ITEM}'")
    return np.ascontiguousarray(arr)


def to_artifact(flat: Mapping[str, Any], model_type: str,
                metadata: Optional[Dict[str, Any]] = None) -> ModelArtifact:
    """A ModelArtifact of the flat parameter dict ``flat`` (order kept)."""
    params = {k: to_numpy(v) for k, v in flat.items()}
    return ModelArtifact(state_graph(params, model_type), params,
                         model_type=model_type, metadata=dict(metadata or {}))
