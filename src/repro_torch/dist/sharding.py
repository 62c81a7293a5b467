"""Parameter placement rules, as pure functions, on one device.

:func:`param_spec` gives the per-dimension placement of a parameter and
:func:`shard_cuts` the axis-0 shard boundaries the chunk layer aligns its
grid to. A spec is a tuple with one entry per dimension: a mesh-axis name
(``"data"``, ``"model"``) or None (replicated). The port runs on one card
with no mesh, so :func:`shard`, the model code's placement constraint, is
the identity.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

Spec = Tuple[Optional[str], ...]
Entry = Union[None, str, Tuple[str, ...]]


def shard(x: Any, *entries: Entry) -> Any:
    """The reference's per-dimension sharding constraint; the identity on
    one device."""
    return x

_NORM_LEAVES = ("norm", "scale", "bias", "gamma", "beta")


def param_spec(path: str, ndim: int) -> Spec:
    """Placement of a parameter by its flat path + rank.

    Rules (megatron-style tensor parallelism + data-parallel ZeRO over the
    reduce dimension):
      * norm / scale / bias leaves: replicated;
      * embeddings: vocab over ``model``, feature over ``data``;
      * MoE expert weights (rank >= 3 under a moe/expert layer): experts over
        ``model``, the contracting dim over ``data``;
      * generic matmul weights: contracting dim over ``data``, output dim
        over ``model``; leading (stacked-layer) dims replicated.
    """
    leaf = path.rsplit("/", 1)[-1]
    if leaf.startswith("ln") or any(tag in leaf for tag in _NORM_LEAVES):
        return (None,) * ndim
    if ndim <= 1:
        return (None,) * ndim
    if "embed" in path:
        return ("model", "data") + (None,) * (ndim - 2)
    if ("moe" in path or "expert" in path) and ndim >= 3:
        return (None,) * (ndim - 3) + ("model", "data", None)
    return (None,) * (ndim - 2) + ("data", "model")


def shard_cuts(path: str, shape, itemsize: int,
               n_shards: int) -> Optional[list]:
    """Byte offsets where ``n_shards`` axis-0 shards of this param begin/end.

    The chunk layer (``store/chunks.py``, DESIGN.md §12) uses these as hard
    segment boundaries so no chunk straddles two shards — each host of a
    distributed consumer can then pull exactly the chunk set covering its
    own shard. Only axis-0 sharding produces *contiguous* byte ranges in a
    C-order tensor, so cuts exist only when :func:`param_spec` shards
    dimension 0 (2-D matmul weights shard dim 0 over ``data``, embeddings
    over ``model``); replicated or inner-dim-only placements return None.
    """
    shape = tuple(int(d) for d in shape)
    if n_shards <= 1 or len(shape) < 2:
        return None
    spec = param_spec(path, len(shape))
    if not spec or spec[0] is None:
        return None
    rows = shape[0]
    if rows < n_shards:
        return None
    row_bytes = itemsize
    for d in shape[1:]:
        row_bytes *= d
    # the same even-ceil split over axis 0 as the reference package
    cuts = []
    for s in range(1, n_shards):
        cuts.append((s * rows) // n_shards * row_bytes)
    return cuts
