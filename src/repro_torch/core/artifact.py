"""ModelArtifact — the unit MGit versions: a LayerGraph plus its parameters.

Parameters are a flat mapping ``"layer/param" -> ndarray``. Artifacts are what
creation functions return, what ``diff``/``merge`` compare, and what the storage
layer persists (via the CAS + delta compression).

Artifacts loaded from storage are *lazy* (DESIGN.md §3.4): ``params`` is a
:class:`LazyParams` mapping whose values are :class:`ParamRef` handles that
materialize per-tensor through the store's chain resolver on first access.
Shape/dtype/content-hash metadata comes from the manifest, so ``nbytes``,
``param_hashes`` (and therefore contextual ``diff``) never touch tensor data.
"""

from __future__ import annotations

import dataclasses
from collections.abc import MutableMapping
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np

from repro_torch.common.bf16 import dtype_name, np_dtype
from repro_torch.common.hashing import tensor_hash
from repro_torch.core.graphir import LayerGraph


def param_key(layer: str, param: str) -> str:
    return f"{layer}/{param}"


def split_key(key: str):
    layer, _, param = key.rpartition("/")
    return layer, param


# ---------------------------------------------------------------------------
# Lazy parameter views
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamRef:
    """Handle to one stored parameter: metadata now, tensor on demand.

    ``store`` is any object with ``materialize_param(ref, key) -> ndarray``
    (duck-typed so ``core`` does not import ``store``)."""

    store: Any = dataclasses.field(repr=False)
    ref: str                      # manifest ref the parameter lives in
    key: str                      # flat "layer/param" key
    shape: Tuple[int, ...]
    dtype: str
    hash: Optional[str] = None    # content hash recorded at commit time

    @property
    def nbytes(self) -> int:
        item = np_dtype(self.dtype).itemsize
        return int(np.prod(self.shape, dtype=np.int64) * item) \
            if self.shape else item

    def materialize(self) -> np.ndarray:
        return self.store.materialize_param(self.ref, self.key)


class LazyParams(MutableMapping):
    """Flat param mapping that materializes tensors per-key on access.

    Backed by ``ParamRef`` handles; assigning a value (``p[k] = arr``) installs
    an eager override, which is how functional updates (``replace_params``,
    merge) stay lazy for every parameter they did not touch."""

    def __init__(self, refs: Dict[str, ParamRef],
                 overrides: Optional[Dict[str, np.ndarray]] = None) -> None:
        self._refs = dict(refs)
        self._overrides: Dict[str, np.ndarray] = dict(overrides or {})

    # -- mapping protocol -----------------------------------------------------
    def __getitem__(self, key: str) -> np.ndarray:
        if key in self._overrides:
            return self._overrides[key]
        return self._refs[key].materialize()

    def __setitem__(self, key: str, value) -> None:
        self._overrides[key] = value

    def __delitem__(self, key: str) -> None:
        found = key in self._overrides or key in self._refs
        self._overrides.pop(key, None)
        self._refs.pop(key, None)
        if not found:
            raise KeyError(key)

    def __contains__(self, key: object) -> bool:
        # MutableMapping's default __contains__ calls __getitem__, which
        # MATERIALIZES the tensor — membership must stay metadata-only
        return key in self._refs or key in self._overrides

    def __iter__(self) -> Iterator[str]:
        for k in self._refs:
            yield k
        for k in self._overrides:
            if k not in self._refs:
                yield k

    def __len__(self) -> int:
        return len(set(self._refs) | set(self._overrides))

    def __repr__(self) -> str:
        return (f"LazyParams({len(self)} params, "
                f"{len(self._overrides)} overridden)")

    # -- metadata without materialization --------------------------------------
    def ref_of(self, key: str) -> Optional[ParamRef]:
        if key in self._overrides:
            return None
        return self._refs.get(key)

    def spec_of(self, key: str) -> Tuple[Tuple[int, ...], str]:
        """(shape, dtype) without touching tensor data."""
        if key in self._overrides:
            v = self._overrides[key]
            return tuple(np.shape(v)), dtype_name(np.asarray(v))
        r = self._refs[key]
        return tuple(r.shape), r.dtype

    def hash_of(self, key: str) -> Optional[str]:
        """Commit-time content hash, or None for overridden/unhashed keys."""
        if key in self._overrides:
            return None
        r = self._refs.get(key)
        return r.hash if r is not None else None

    def nbytes_total(self) -> int:
        total = 0
        for k in self:
            if k in self._overrides:
                total += int(np.asarray(self._overrides[k]).nbytes)
            else:
                total += self._refs[k].nbytes
        return total

    def with_overrides(self, updates: Mapping[str, np.ndarray]) -> "LazyParams":
        merged = dict(self._overrides)
        merged.update(updates)
        return LazyParams(self._refs, merged)


@dataclasses.dataclass
class ModelArtifact:
    """A model = structure (LayerGraph) + content (flat param dict) + metadata."""

    graph: LayerGraph
    params: Dict[str, np.ndarray]
    model_type: str = "generic"
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _hashes: Optional[Dict[str, str]] = dataclasses.field(default=None, repr=False)

    def param_hashes(self, recompute: bool = False) -> Dict[str, str]:
        """Content hash per parameter; cached (params are treated as immutable).

        Lazy artifacts answer from manifest metadata: only parameters without
        a recorded hash (e.g. overridden ones) are materialized."""
        if self._hashes is None or recompute:
            if isinstance(self.params, LazyParams) and not recompute:
                self._hashes = {
                    k: self.params.hash_of(k) or tensor_hash(self.params[k])
                    for k in self.params
                }
            else:
                self._hashes = {k: tensor_hash(v)
                                for k, v in self.params.items()}
            # Attach to the LayerGraph so contextual diff sees them.
            per_layer: Dict[str, Dict[str, str]] = {}
            for key, h in self._hashes.items():
                layer, param = split_key(key)
                per_layer.setdefault(layer, {})[param] = h
            self.graph.set_param_hashes(per_layer)
        return self._hashes

    @property
    def is_lazy(self) -> bool:
        return isinstance(self.params, LazyParams)

    def nbytes(self) -> int:
        if isinstance(self.params, LazyParams):
            return self.params.nbytes_total()
        total = 0
        for v in self.params.values():
            # trust an integer ``nbytes`` attribute (ndarrays and chunk
            # sources both carry one) — np.asarray on a streaming chunk
            # source would try to materialize a multi-GB tensor
            n = getattr(v, "nbytes", None)
            total += (int(n) if isinstance(n, (int, np.integer))
                      else int(np.asarray(v).nbytes))
        return total

    def _clone_graph(self) -> LayerGraph:
        """Structure-preserving copy. Artifacts must not share LayerGraph objects:
        contextual hashes are attached to graph nodes, so a shared graph would let
        one artifact clobber another's content fingerprints."""
        g = LayerGraph.from_json(self.graph.to_json())
        for node in g.nodes.values():
            node.param_hashes = {}
        return g

    def replace_params(self, new_params: Mapping[str, np.ndarray],
                       **metadata: Any) -> "ModelArtifact":
        """Functional update: same structure (cloned), new parameter values.

        On a lazy artifact the untouched parameters stay lazy (the update
        installs overrides instead of materializing the whole model)."""
        if isinstance(self.params, LazyParams):
            merged: Any = self.params.with_overrides(new_params)
        else:
            merged = dict(self.params)
            merged.update(new_params)
        meta = dict(self.metadata)
        meta.update(metadata)
        return ModelArtifact(graph=self._clone_graph(), params=merged,
                             model_type=self.model_type, metadata=meta)

    def map_params(self, fn: Callable[[str, np.ndarray], np.ndarray]) -> "ModelArtifact":
        return ModelArtifact(
            graph=self._clone_graph(),
            params={k: fn(k, v) for k, v in self.params.items()},
            model_type=self.model_type,
            metadata=dict(self.metadata),
        )

    def __repr__(self) -> str:
        mb = self.nbytes() / 1e6
        return (f"ModelArtifact(type={self.model_type!r}, layers={len(self.graph)}, "
                f"params={len(self.params)}, {mb:.1f}MB)")
