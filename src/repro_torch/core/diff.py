"""MGit's ``diff`` primitive (paper Algorithm 3).

Hash-table based graph matching between two LayerGraphs. Produces the node/edge
add/delete sets needed to turn model A into model B, plus the matched pairs.
Runs in either *structural* mode (hashes ignore parameter values) or
*contextual* mode (hashes include parameter content). The divergence scores

    d = |edges_diff| / (|edges_A| + |edges_B|)

computed from the diff output drive automated lineage-graph construction (§3.2).

Copied from the reference package's ``repro/core/diff.py``; only the imports
differ.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.artifact import ModelArtifact
from repro_torch.core.graphir import LayerGraph


Edge = Tuple[str, str]
Match = Tuple[str, str]


@dataclasses.dataclass
class DiffResult:
    """Output of ``module_diff``: edit script A -> B plus the match maps."""

    mode: str
    matched_nodes: List[Match]     # (name_in_A, name_in_B)
    matched_edges: List[Tuple[Edge, Edge]]
    add_nodes: List[str]           # names in B to add
    del_nodes: List[str]           # names in A to delete
    add_edges: List[Edge]          # edges in B to add
    del_edges: List[Edge]          # edges in A to delete
    n_edges_a: int
    n_edges_b: int
    n_nodes_a: int
    n_nodes_b: int

    @property
    def divergence(self) -> float:
        """Paper's divergence score: |edges_diff| / (|E_A| + |E_B|)."""
        denom = self.n_edges_a + self.n_edges_b
        if denom == 0:
            # Degenerate single-layer graphs: fall back to node-level score.
            denom = self.n_nodes_a + self.n_nodes_b
            return (len(self.add_nodes) + len(self.del_nodes)) / max(denom, 1)
        return (len(self.add_edges) + len(self.del_edges)) / denom

    @property
    def identical(self) -> bool:
        return not (self.add_nodes or self.del_nodes or self.add_edges or self.del_edges)

    def match_map(self) -> Dict[str, str]:
        """name_in_A -> name_in_B for matched layers."""
        return dict(self.matched_nodes)


def _node_hash(graph: LayerGraph, name: str, mode: str) -> str:
    node = graph.nodes[name]
    return node.contextual_hash() if mode == "contextual" else node.structural_hash()


def _build_tables(graph: LayerGraph, mode: str):
    """Hash tables of nodes and edges; values are lists in topological order."""
    topo = graph.topo_order()
    topo_idx = {n: i for i, n in enumerate(topo)}
    nh = {n: _node_hash(graph, n, mode) for n in graph.nodes}
    node_table: Dict[str, List[str]] = {}
    for n in topo:
        node_table.setdefault(nh[n], []).append(n)
    edge_table: Dict[Tuple[str, str], List[Edge]] = {}
    for (src, dst) in sorted(graph.edges, key=lambda e: (topo_idx[e[0]], topo_idx[e[1]])):
        edge_table.setdefault((nh[src], nh[dst]), []).append((src, dst))
    return node_table, edge_table, topo_idx


def module_diff(a, b, mode: str = "contextual") -> DiffResult:
    """Algorithm 3: diff between two models (LayerGraphs or ModelArtifacts)."""
    if isinstance(a, ModelArtifact):
        if mode == "contextual":
            a.param_hashes()  # ensure hashes are attached to the graph
        a = a.graph
    if isinstance(b, ModelArtifact):
        if mode == "contextual":
            b.param_hashes()
        b = b.graph

    n1_table, e1_table, topo1 = _build_tables(a, mode)
    n2_table, e2_table, topo2 = _build_tables(b, mode)

    match1: Dict[str, str] = {}  # node in A -> node in B
    match2: Dict[str, str] = {}  # node in B -> node in A
    matched_edges: List[Tuple[Edge, Edge]] = []

    def _consistent(x: str, y: str) -> bool:
        """x (in A) may be matched to y (in B) without violating 1-1 matching."""
        if x in match1:
            return match1[x] == y
        return y not in match2

    def _commit(x: str, y: str) -> None:
        match1[x] = y
        match2[y] = x

    # Pass 1: greedily match edges whose (src-hash, dst-hash) agree, committing a
    # matching only when both endpoint pairs are consistent with matches so far.
    for ehash, es1 in e1_table.items():
        es2 = list(e2_table.get(ehash, []))
        for e1 in es1:
            for e2 in es2:
                if _consistent(e1[0], e2[0]) and _consistent(e1[1], e2[1]):
                    # A self-consistency corner: matching (x->y) for both
                    # endpoints of the same edge must not collide.
                    if e1[0] == e1[1] and e2[0] != e2[1]:
                        continue
                    _commit(e1[0], e2[0])
                    _commit(e1[1], e2[1])
                    matched_edges.append((e1, e2))
                    es2.remove(e2)
                    break

    # Pass 2: match remaining nodes that share a hash but sit on no common edge.
    for nhash, ns1 in n1_table.items():
        ns1u = [n for n in ns1 if n not in match1]
        ns2u = [n for n in n2_table.get(nhash, []) if n not in match2]
        for x, y in zip(ns1u, ns2u):
            _commit(x, y)

    # Pass 3: drop inverse (order-crossing) matches. Sort node matches by topo
    # order in A and require strictly increasing topo order in B.
    node_matches = sorted(match1.items(), key=lambda kv: topo1[kv[0]])
    kept: List[Match] = []
    max_b = -1
    for x, y in node_matches:
        if topo2[y] > max_b:
            kept.append((x, y))
            max_b = topo2[y]
    kept_1 = {x: y for x, y in kept}
    kept_2 = {y: x for x, y in kept}
    matched_edges = [
        (e1, e2)
        for (e1, e2) in matched_edges
        if kept_1.get(e1[0]) == e2[0] and kept_1.get(e1[1]) == e2[1]
    ]
    matched_edge_set_a = {e1 for e1, _ in matched_edges}
    matched_edge_set_b = {e2 for _, e2 in matched_edges}

    # Also: an edge present in both graphs between *matched* endpoints counts as
    # matched even if pass 1 missed it (endpoints matched in pass 2).
    b_edges = set(b.edges)
    for (src, dst) in a.edges:
        if (src, dst) in matched_edge_set_a:
            continue
        mapped = (kept_1.get(src), kept_1.get(dst))
        if mapped[0] is not None and mapped[1] is not None and mapped in b_edges:
            if mapped not in matched_edge_set_b:
                matched_edges.append(((src, dst), mapped))
                matched_edge_set_a.add((src, dst))
                matched_edge_set_b.add(mapped)

    add_nodes = [n for n in b.nodes if n not in kept_2]
    del_nodes = [n for n in a.nodes if n not in kept_1]
    add_edges = [e for e in b.edges if e not in matched_edge_set_b]
    del_edges = [e for e in a.edges if e not in matched_edge_set_a]

    return DiffResult(
        mode=mode,
        matched_nodes=kept,
        matched_edges=matched_edges,
        add_nodes=add_nodes,
        del_nodes=del_nodes,
        add_edges=add_edges,
        del_edges=del_edges,
        n_edges_a=len(a.edges),
        n_edges_b=len(b.edges),
        n_nodes_a=len(a.nodes),
        n_nodes_b=len(b.nodes),
    )


def divergence_scores(a, b) -> Tuple[float, float]:
    """(d_structural, d_contextual) between two models (paper §3.2)."""
    ds = module_diff(a, b, mode="structural").divergence
    dc = module_diff(a, b, mode="contextual").divergence
    return ds, dc
