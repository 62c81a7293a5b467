"""Diff-adapted test transfer (DESIGN.md §9.3).

Two reuse decisions, both made from *metadata only* (manifest graph JSON and
commit-time parameter hashes — no tensor ever materializes here):

1. **Scoped re-run skipping** — a test that declares a ``scope`` (param-key
   prefix) depends only on that submodule. Its memoization key is the hash
   of the scoped parameters' content hashes (:func:`scoped_content_key`), so
   two versions whose tested submodule is bit-identical (e.g. a finetune
   that froze the head a head-probe tests) resolve to the SAME ledger entry:
   the second version is never re-tested.

2. **Structural transfer** — a test registered for model type A may run
   against a node of type B when B's layer graph structurally matches A's
   (``core/diff.py`` contextual-matching machinery in structural mode, with
   a divergence budget). This is how a derivative that kept its parent's
   architecture inherits the parent type's behavioral checks.

Copied from the reference package's ``repro/diag/transfer.py``; only the imports
differ.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.common.hashing import bytes_hash
from repro_torch.core.diff import module_diff
from repro_torch.core.graphir import LayerGraph
from repro_torch.core.lineage import LineageGraph, LineageNode, RegisteredTest


def _in_scope(key: str, scope: str) -> bool:
    """Path-boundary prefix match over flat "layer/param" keys: scope
    "head" covers "head/w" but NOT "header/w"; an exact key is its own
    scope."""
    return key == scope or key.startswith(scope.rstrip("/") + "/")


def scoped_param_hashes(node: LineageNode,
                        scope: str) -> Optional[Dict[str, str]]:
    """Content hashes of the parameters under ``scope``, metadata-only.

    Store-backed nodes answer from the manifest; in-memory nodes from
    ``param_hashes()`` (cheap at test-model scale, cached after). Returns
    None when the scope matches nothing — callers fall back to whole-model
    keying rather than memoizing on an empty selection."""
    graph = node._graph
    store = graph.store if graph is not None else None
    if node.artifact_ref is not None and store is not None:
        manifest = store.get_manifest(node.artifact_ref)
        items = {k: e.get("hash") or e.get("tensor")
                 for k, e in manifest["params"].items() if _in_scope(k, scope)}
    else:
        hashes = node.get_model().param_hashes()
        items = {k: h for k, h in hashes.items() if _in_scope(k, scope)}
    return items or None


def scoped_content_key(node: LineageNode, scope: str) -> Optional[str]:
    """Ledger manifest-key for a scoped test: ``s_`` + hash of the scoped
    parameter-hash set. Identical submodule content => identical key,
    across versions AND across nodes (DESIGN.md §9.3)."""
    items = scoped_param_hashes(node, scope)
    if items is None:
        return None
    payload = json.dumps(sorted(items.items())).encode()
    return "s_" + bytes_hash(payload)


def structure_of(node: LineageNode) -> LayerGraph:
    """The node's LayerGraph without materializing any tensor."""
    if node.artifact is not None:
        return node.artifact.graph
    graph = node._graph
    store = graph.store if graph is not None else None
    if node.artifact_ref is not None and store is not None:
        return LayerGraph.from_json(
            store.get_manifest(node.artifact_ref)["graph"])
    return node.get_model().graph  # raises if no artifact anywhere


def structurally_transferable(a: LayerGraph, b: LayerGraph,
                              max_divergence: float = 0.0) -> bool:
    """True when structural diff divergence (paper §3.2) is within budget."""
    return module_diff(a, b, mode="structural").divergence <= max_divergence


def transferable_tests(graph: LineageGraph, node: LineageNode,
                       max_divergence: float = 0.0) -> List[RegisteredTest]:
    """Type-bound tests that transfer to ``node`` via structural matching.

    For each test registered on a *different* model type, pick that type's
    exemplar (first node by name with an available structure) and admit the
    test when the exemplar's layer graph matches the node's. Node-bound
    tests never transfer — binding to a name is an explicit pin."""
    out: List[RegisteredTest] = []
    node_structure: Optional[LayerGraph] = None
    exemplars: Dict[str, Optional[LayerGraph]] = {}
    for t in graph.tests:
        if t.model_type is None or t.applies_to(node):
            continue
        if t.model_type not in exemplars:
            exemplar = None
            for name in sorted(graph.nodes):
                cand = graph.nodes[name]
                if cand.name == node.name or cand.model_type != t.model_type:
                    continue
                try:
                    exemplar = structure_of(cand)
                    break
                except Exception:
                    continue
            exemplars[t.model_type] = exemplar
        exemplar = exemplars[t.model_type]
        if exemplar is None:
            continue
        if node_structure is None:
            try:
                node_structure = structure_of(node)
            except Exception:
                return out
        if structurally_transferable(exemplar, node_structure, max_divergence):
            out.append(t)
    return out
