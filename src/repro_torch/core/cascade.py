"""Automated model updating — ``run_update_cascade`` (paper Algorithm 2).

When a model ``m`` is updated to ``m'`` (a new version), every descendant of
``m`` with a registered creation function is rebuilt against the new upstream:

Phase 1 creates (empty) next-version nodes for all descendants, wiring
provenance edges to the *next versions* of their parents (falling back to the
current version when a parent is outside the cascade) and version edges to the
old nodes. Phase 2 walks the new nodes in all-parents-first order and invokes
each node's creation function (or the merged MTL-group creation function) to
materialize the new models. MGit never overwrites the old versions.

The cascade is exception-safe: a creation function that raises rolls back
every next-version node that was created but never materialized (edges
detached, node deleted, graph re-committed) before the exception propagates —
a failed cascade leaves no half-built empty nodes in the persisted lineage.
Nodes that *did* materialize before the failure are kept; re-running the
cascade is idempotent and picks up where it left off.

Passing ``gate=`` (a :class:`repro_torch.diag.gate.TestGate`, DESIGN.md
§9.4) runs registered tests on each newly materialized version through the
memoized diagnostics runner and *quarantines* regressing nodes: the version
edge stays recorded and the artifact is kept, but the node is marked
``metadata["quarantined"]`` so remote sync excludes it by default.

Copied from the reference package's ``repro/core/cascade.py``; only the
imports differ.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Set

from repro_torch.core.lineage import LineageGraph, LineageNode
from repro_torch.core.traversal import all_parents_first, bfs

SkipFn = Optional[Callable[[LineageNode], bool]]
TermFn = Optional[Callable[[LineageNode], bool]]


def next_version_name(name: str) -> str:
    base, sep, suffix = name.rpartition("@v")
    if sep and suffix.isdigit():
        return f"{base}@v{int(suffix) + 1}"
    return f"{name}@v2"


def _rollback_unmaterialized(graph: LineageGraph, new_names: List[str],
                             materialized: Set[str]) -> None:
    """Detach and delete cascade nodes that never got a model.

    Reverse creation order, so a child empty node disappears before its
    (possibly also empty) parent. Edges are removed explicitly rather than
    via ``remove_node`` — its subtree recursion would also take down
    already-materialized siblings reachable through shared children."""
    for name in reversed(new_names):
        node = graph.nodes.get(name)
        if node is None or name in materialized:
            continue
        for p in list(node.parents):
            graph.remove_edge(p, name, "provenance")
        for c in list(node.children):
            graph.remove_edge(name, c, "provenance")
        for p in list(node.version_parents):
            graph.remove_edge(p, name, "versioning")
        for c in list(node.version_children):
            graph.remove_edge(name, c, "versioning")
        del graph.nodes[name]
    graph._commit()


def run_update_cascade(graph: LineageGraph, m: str, m_prime: str,
                       skip_fn: SkipFn = None, terminate_fn: TermFn = None,
                       gate: Optional[Any] = None) -> List[str]:
    """Trigger the update cascade for the model update ``m -> m_prime``.

    Returns the names of the newly created model versions (excluding
    m_prime). ``gate`` (anything with ``apply(node) -> decision``) is invoked
    on every newly materialized version; see module docstring.
    """
    if m_prime not in graph.nodes:
        raise KeyError(f"updated model {m_prime!r} must already be a node")
    if m_prime not in graph.nodes[m].version_children:
        graph.add_version_edge(m, m_prime)

    new_names: List[str] = []
    materialized: Set[str] = set()
    try:
        # ---- Phase 1: create (empty) next versions of all descendants. ----
        skip2 = (lambda x: (skip_fn(x) if skip_fn else False) or x.name == m)
        next_of = {m: m_prime}
        for x in bfs(graph, start=m, skip_fn=skip2, terminate_fn=terminate_fn):
            if x.creation_fn is None:
                continue  # nothing to rebuild this node with — leave it untouched
            x_new_name = next_version_name(x.name)
            if x_new_name in graph.nodes:
                # idempotence: cascade already created it — but descendants
                # created THIS run must still rewire to it, so the next_of
                # mapping is recorded before skipping (a resumed cascade
                # otherwise derives children from the stale parent version)
                next_of[x.name] = x_new_name
                continue
            parents_new = [next_of.get(p, p) for p in x.parents]
            node_new = graph.add_node(None, x_new_name, model_type=x.model_type)
            init = x.creation_fn.initialize([graph.nodes[p] for p in parents_new])
            if init is not None:
                node_new.artifact = init
            for p_new in parents_new:
                graph.add_edge(p_new, x_new_name)
            graph.add_version_edge(x.name, x_new_name)
            node_new.creation_fn = x.creation_fn
            next_of[x.name] = x_new_name
            new_names.append(x_new_name)

        # ---- Phase 2: materialize, all parents first (MTL groups together). ----
        skip3 = (lambda x: (skip_fn(x) if skip_fn else False) or x.name == m_prime)
        for xs in all_parents_first(graph, start=m_prime, skip_fn=skip3,
                                    terminate_fn=terminate_fn, group_mtl=True):
            group = xs if isinstance(xs, list) else [xs]
            group = [x for x in group if x.name in new_names]
            if not group:
                continue
            if len(group) > 1:
                # merged MTL creation function: one call produces all group members
                artifacts = group[0].creation_fn.run_group(group)
                for node, artifact in zip(group, artifacts):
                    graph._attach_artifact(node, artifact)
                    materialized.add(node.name)
            else:
                node = group[0]
                artifact = node.creation_fn(node.get_parents())
                graph._attach_artifact(node, artifact)
                materialized.add(node.name)
            if gate is not None:
                for node in group:
                    gate.apply(node)
    except Exception:
        _rollback_unmaterialized(graph, new_names, materialized)
        raise
    graph._commit()
    return new_names
