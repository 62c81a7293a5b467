"""Nested containers of tensors, walked in the reference package's order.

The reference flattens its train state with ``jax.tree_util``: dict keys
sorted at every level, NamedTuple fields in declaration order, list and
tuple items by index, and ``None`` as an empty subtree. The checkpoint
manifest's key order and path strings follow that order, so every walk
here keeps it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[str, ...]


def is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any):
    """(key, child) pairs of a container in flatten order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def flatten_with_path(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path`` order."""
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    out: List[Tuple[Path, Any]] = []
    for key, child in children:
        out.extend(flatten_with_path(child, prefix + (key,)))
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(template: Any, values) -> Any:
    """``template``'s structure with its leaves replaced, in flatten order,
    by ``values``."""
    it = iter(values)
    out = _build(template, it)
    if next(it, _END) is not _END:
        raise ValueError("more values than the template has leaves")
    return out


_END = object()


def _build(tree: Any, it: Iterator) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _build(tree[k], it) for k in sorted(tree)}
    if is_namedtuple(tree):
        return type(tree)(*[_build(getattr(tree, f), it)
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_build(v, it) for v in tree)
    value = next(it, _END)
    if value is _END:
        raise ValueError("fewer values than the template has leaves")
    return value


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in ``tree``'s structure."""
    columns = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(columns[0]) for c in columns):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*columns)])
