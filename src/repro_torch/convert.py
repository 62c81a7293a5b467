"""Carry model weights across into this package's artifacts.

:func:`to_artifact` turns a flat ``{path: array}`` parameter dict into a
:class:`ModelArtifact` with the chain layer graph of
``repro_torch.models.graph.state_graph``. The dict may hold numpy arrays
(as the reference package's ``flatten_state(init_params(cfg))`` gives) or
torch tensors (as ``repro_torch.models.init_params`` gives). The same
parameters, model type and metadata commit to the same manifest in both
packages.

The store keeps parameters as numpy arrays, and numpy has no bfloat16
here: a bf16 parameter (a ``torch.bfloat16`` tensor, or an ``ml_dtypes``
array from the reference package) becomes the bf16 carrier of
``common/bf16.py``, its bits in a uint16 array named ``bfloat16``.

:func:`to_params` turns a flat ``{path: array}`` dict (a serving view's
parameters, or the reference's ``flatten_state(init_params(cfg))``) into
the model's nested tensor tree on a device, as ``ServeEngine`` and
``forward`` take it; ``models.flat_paths`` is its inverse.

:func:`state_from_reference` turns a reference train state (nested dicts
of arrays, the reference's ``OptState``, 0-dim step counters) into this
package's, so both packages can be fed the same state.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.common import bf16
from repro_torch.common.tree import is_namedtuple
from repro_torch.core.artifact import ModelArtifact
from repro_torch.models.graph import state_graph
from repro_torch.models.model import _nested
from repro_torch.optim.adamw import OptState


def to_numpy(value) -> np.ndarray:
    """A contiguous host numpy array of ``value`` (array or tensor); bf16
    as the bf16 carrier."""
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            return bf16.from_torch(value)
        value = value.detach().cpu().numpy()
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":   # an ml_dtypes array
        arr = bf16.carry(arr.view(np.uint16))
    # np.ascontiguousarray would turn a 0-dim array into a 1-D one
    return arr if arr.flags.c_contiguous else np.ascontiguousarray(arr)


def to_artifact(flat: Mapping[str, Any], model_type: str,
                metadata: Optional[Dict[str, Any]] = None) -> ModelArtifact:
    """A ModelArtifact of the flat parameter dict ``flat`` (order kept)."""
    params = {k: to_numpy(v) for k, v in flat.items()}
    return ModelArtifact(state_graph(params, model_type), params,
                         model_type=model_type, metadata=dict(metadata or {}))


def to_tensor(value, device="cpu") -> torch.Tensor:
    """An array (or tensor) as a tensor of the same dtype and shape on
    ``device``; the bf16 carrier as ``torch.bfloat16``. Arrays are copied."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return bf16.to_torch(to_numpy(value), copy=True).to(device)


def to_params(flat: Mapping[str, Any], device="cpu") -> Dict[str, Any]:
    """The nested parameter tree of ``flat``: every array (or tensor) a
    tensor of the same dtype and shape on ``device``."""
    return _nested({k: to_tensor(v, device) for k, v in flat.items()})


def state_from_reference(state: Any, device="cpu") -> Any:
    """The reference package's train state as this package's: dicts stay
    dicts, an ``OptState`` (any NamedTuple with fields mu, nu, count)
    becomes :class:`repro_torch.optim.OptState`, other NamedTuples, lists
    and tuples keep their type, and every array becomes a tensor of the
    same dtype and shape (0-dim included) on ``device``."""
    if state is None:
        return None
    if isinstance(state, dict):
        return {k: state_from_reference(v, device) for k, v in state.items()}
    if is_namedtuple(state):
        values = [state_from_reference(getattr(state, f), device)
                  for f in state._fields]
        if tuple(state._fields) == OptState._fields:
            return OptState(*values)
        return type(state)(*values)
    if isinstance(state, (list, tuple)):
        return type(state)(state_from_reference(v, device) for v in state)
    return to_tensor(state, device)
