"""The ``merge`` primitive (paper §5, Figure 2).

Given two models independently derived from a common ancestor, classify the
concurrent changes as:

* ``conflict``          — both users changed at least one common layer -> manual merge;
* ``possible_conflict`` — the changed layer sets are disjoint but *dependent*
                          (one eventually consumes the other's output, or a
                          downstream layer consumes both) -> run tests to verify;
* ``no_conflict``       — disjoint and independent -> auto-merge.

Change detection is powered by ``diff``: structural matching maps layers
between ancestor and each derivative; a matched layer counts as changed when
its parameter content hash differs; unmatched layers are structural edits.

Copied from the reference package's ``repro/core/merge.py``; only the imports
differ.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.artifact import ModelArtifact
from repro_torch.core.diff import module_diff
from repro_torch.core.lineage import LineageGraph

CONFLICT = "conflict"
POSSIBLE_CONFLICT = "possible_conflict"
NO_CONFLICT = "no_conflict"


@dataclasses.dataclass
class ChangeSet:
    """Changes of one derivative relative to the ancestor, in ancestor namespace."""

    changed: Set[str]          # matched layers whose parameters differ
    removed: Set[str]          # ancestor layers with no structural match
    added: Set[str]            # new layer names (derivative namespace)
    match_map: Dict[str, str]  # ancestor layer -> derivative layer

    @property
    def touched(self) -> Set[str]:
        return self.changed | self.removed


def compute_changeset(ancestor: ModelArtifact, derived: ModelArtifact) -> ChangeSet:
    ancestor.param_hashes()
    derived.param_hashes()
    d = module_diff(ancestor, derived, mode="structural")
    mm = d.match_map()
    changed: Set[str] = set()
    for a_name, b_name in mm.items():
        ah = ancestor.graph.nodes[a_name].contextual_hash()
        bh = derived.graph.nodes[b_name].contextual_hash()
        if ah != bh:
            changed.add(a_name)
    return ChangeSet(changed=changed, removed=set(d.del_nodes),
                     added=set(d.add_nodes), match_map=mm)


def _dependent(graph, c1: Set[str], c2: Set[str]) -> bool:
    """True if any changed layer pair is dependent (paper's DFS check):
    one reaches the other, or some layer is reachable from both."""
    if not c1 or not c2:
        return False
    r1 = graph.reachable_from(c1) | c1
    r2 = graph.reachable_from(c2) | c2
    # one consumes the other's output (directly or eventually)
    if (graph.reachable_from(c1) & c2) or (graph.reachable_from(c2) & c1):
        return True
    # a downstream layer consumes outputs of both
    return bool((r1 & r2) - (c1 | c2) - ((c1 & r2) | (c2 & r1)))


@dataclasses.dataclass
class MergeResult:
    status: str
    merged: Optional[ModelArtifact]
    conflicting_layers: List[str]
    test_results: Dict[str, float]
    detail: str = ""


def merge_artifacts(ancestor: ModelArtifact, m1: ModelArtifact, m2: ModelArtifact,
                    tests: Optional[list] = None,
                    test_threshold: float = 0.0) -> MergeResult:
    """Three-way merge of artifacts per the Figure 2 decision tree."""
    cs1 = compute_changeset(ancestor, m1)
    cs2 = compute_changeset(ancestor, m2)

    overlap = sorted(cs1.touched & cs2.touched)
    if cs1.added and cs2.added and (cs1.added & cs2.added):
        overlap = sorted(set(overlap) | (cs1.added & cs2.added))
    if overlap:
        return MergeResult(CONFLICT, None, overlap, {},
                           detail="common layer(s) updated by both changes")

    merged = _apply_changes(ancestor, m1, cs1)
    merged = _apply_changes(merged, m2, cs2)

    if _dependent(ancestor.graph, cs1.touched, cs2.touched):
        results: Dict[str, float] = {}
        if tests:
            for t in tests:
                results[t.name] = float(t.fn(merged))
            ok = all(v >= test_threshold for v in results.values())
            status = NO_CONFLICT if ok else CONFLICT
            detail = ("dependent changes; tests "
                      + ("passed" if ok else "FAILED"))
            return MergeResult(status, merged if ok else None,
                               [] if ok else sorted(cs1.touched | cs2.touched),
                               results, detail)
        return MergeResult(POSSIBLE_CONFLICT, merged, [], {},
                           detail="dependent changes; no tests registered — verify manually")

    return MergeResult(NO_CONFLICT, merged, [], {}, detail="independent changes")


def _apply_changes(base: ModelArtifact, derived: ModelArtifact,
                   cs: ChangeSet) -> ModelArtifact:
    """Apply one derivative's parameter changes onto ``base`` (ancestor-shaped).

    Structural edits (add/remove layers) are applied only when they do not
    collide with the other side — callers guarantee disjointness by this point.
    """
    new_params = {}
    for a_layer in cs.changed:
        b_layer = cs.match_map[a_layer]
        for pname in derived.graph.nodes[b_layer].params:
            key_b = f"{b_layer}/{pname}"
            key_a = f"{a_layer}/{pname}"
            if key_b in derived.params:
                new_params[key_a] = derived.params[key_b]
    out = base.replace_params(new_params)
    # Structural adds/removes: rebuild graph if needed.
    if cs.added or cs.removed:
        from repro_torch.core.graphir import LayerGraph
        g = LayerGraph()
        keep = [n for n in base.graph.nodes if n not in cs.removed]
        for n in keep:
            g.add_node(base.graph.nodes[n])
        inv = {v: k for k, v in cs.match_map.items()}
        for n in cs.added:
            g.add_node(derived.graph.nodes[n])
            for key in list(derived.params):
                if key.startswith(n + "/"):
                    out.params[key] = derived.params[key]
        for (s, d) in base.graph.edges:
            if s in g.nodes and d in g.nodes:
                g.add_edge(s, d)
        for (s, d) in derived.graph.edges:
            s2, d2 = inv.get(s, s), inv.get(d, d)
            if (s in cs.added or d in cs.added) and s2 in g.nodes and d2 in g.nodes:
                g.add_edge(s2, d2)
        out = ModelArtifact(graph=g, params=out.params,
                            model_type=out.model_type, metadata=out.metadata)
    return out


def _common_ancestor(graph: LineageGraph, x1: str, x2: str) -> Optional[str]:
    """Closest common ancestor over provenance+versioning edges (min total hops)."""

    def ancestors(name: str) -> Dict[str, int]:
        dist = {name: 0}
        frontier = [name]
        while frontier:
            nxt = []
            for n in frontier:
                node = graph.nodes[n]
                for p in node.parents + node.version_parents:
                    if p not in dist:
                        dist[p] = dist[n] + 1
                        nxt.append(p)
            frontier = nxt
        return dist

    a1, a2 = ancestors(x1), ancestors(x2)
    common = set(a1) & set(a2) - {x1, x2}
    if not common:
        return None
    return min(common, key=lambda n: (a1[n] + a2[n], n))


def merge(graph: LineageGraph, x1: str, x2: str,
          ancestor: Optional[str] = None, test_threshold: float = 0.0) -> MergeResult:
    """Graph-level merge: resolve the common ancestor, merge artifacts, and on
    success insert the merged model as a new node with provenance edges."""
    anc = ancestor or _common_ancestor(graph, x1, x2)
    if anc is None:
        return MergeResult(CONFLICT, None, [], {},
                           detail="no common ancestor in lineage graph")
    n1, n2 = graph.nodes[x1], graph.nodes[x2]
    tests = [t for t in graph.tests if t.applies_to(n1) or t.applies_to(n2)]
    result = merge_artifacts(graph.get_model(anc), n1.get_model(), n2.get_model(),
                             tests=tests, test_threshold=test_threshold)
    if result.merged is not None and result.status != CONFLICT:
        merged_name = f"merge({x1},{x2})"
        graph.add_node(result.merged, merged_name,
                       model_type=graph.nodes[x1].model_type)
        graph.add_edge(x1, merged_name)
        graph.add_edge(x2, merged_name)
    return result
