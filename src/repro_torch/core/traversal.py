"""Traversals over the lineage graph (paper §3.1.4).

Traversals are iterators over nodes. They can follow provenance edges,
versioning edges, or both, support skip/terminate predicates, and include the
all-parents-first order used by the update cascade and a binary-search
(bisection) generator for finding the first failing model in a version chain.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterator, List, Optional, Sequence

from repro_torch.core.lineage import LineageGraph, LineageNode

SkipFn = Optional[Callable[[LineageNode], bool]]
TermFn = Optional[Callable[[LineageNode], bool]]


def _children(graph: LineageGraph, node: LineageNode,
              edge_types: Sequence[str]) -> List[LineageNode]:
    out: List[LineageNode] = []
    if "provenance" in edge_types:
        out.extend(graph.nodes[c] for c in node.children)
    if "versioning" in edge_types:
        out.extend(graph.nodes[c] for c in node.version_children)
    return out


def bfs(graph: LineageGraph, start: Optional[str] = None,
        edge_types: Sequence[str] = ("provenance",),
        skip_fn: SkipFn = None, terminate_fn: TermFn = None) -> Iterator[LineageNode]:
    queue = deque(graph.roots() if start is None else [graph.nodes[start]])
    seen = {n.name for n in queue}
    while queue:
        node = queue.popleft()
        if terminate_fn is not None and terminate_fn(node):
            return
        if skip_fn is None or not skip_fn(node):
            yield node
        for child in _children(graph, node, edge_types):
            if child.name not in seen:
                seen.add(child.name)
                queue.append(child)


def dfs(graph: LineageGraph, start: Optional[str] = None,
        edge_types: Sequence[str] = ("provenance",),
        skip_fn: SkipFn = None, terminate_fn: TermFn = None) -> Iterator[LineageNode]:
    stack = list(reversed(graph.roots() if start is None else [graph.nodes[start]]))
    seen = {n.name for n in stack}
    while stack:
        node = stack.pop()
        if terminate_fn is not None and terminate_fn(node):
            return
        if skip_fn is None or not skip_fn(node):
            yield node
        for child in reversed(_children(graph, node, edge_types)):
            if child.name not in seen:
                seen.add(child.name)
                stack.append(child)


def version_chain(graph: LineageGraph, start: str) -> Iterator[LineageNode]:
    """All versions of a model, oldest -> newest, following version edges only."""
    node: Optional[LineageNode] = graph.nodes[start]
    # rewind to the first version
    while node.version_parents:
        node = graph.nodes[node.version_parents[0]]
    while node is not None:
        yield node
        node = graph.nodes[node.version_children[0]] if node.version_children else None


def all_parents_first(graph: LineageGraph, start: Optional[str] = None,
                      skip_fn: SkipFn = None, terminate_fn: TermFn = None,
                      group_mtl: bool = False) -> Iterator[object]:
    """Kahn-style order: a node is yielded only once ALL its provenance parents
    (within the traversed region) have been yielded. Used by Algorithm 2.

    With ``group_mtl=True``, nodes whose creation functions share an
    ``mtl_group`` are yielded together as a list once the whole group is ready.
    """
    if start is None:
        region = {n.name for n in graph.nodes.values()}
        frontier = deque(graph.roots())
    else:
        root = graph.nodes[start]
        region = {root.name}
        q = deque([root])
        while q:
            n = q.popleft()
            for c in n.children:
                if c not in region:
                    region.add(c)
                    q.append(graph.nodes[c])
        frontier = deque([root])

    visited: set = set()
    emitted: set = set()
    queue = frontier
    pending: List[LineageNode] = []

    def ready(node: LineageNode) -> bool:
        return all(p not in region or p in visited for p in node.parents)

    while queue or pending:
        made_progress = False
        requeue: List[LineageNode] = []
        for node in list(queue) + pending:
            if node.name in visited:
                continue
            if not ready(node):
                requeue.append(node)
                continue
            visited.add(node.name)
            made_progress = True
            if terminate_fn is not None and terminate_fn(node):
                return
            if skip_fn is None or not skip_fn(node):
                if group_mtl and node.creation_fn is not None and node.creation_fn.mtl_group:
                    grp = node.creation_fn.mtl_group
                    members = [
                        graph.nodes[n] for n in region
                        if graph.nodes[n].creation_fn is not None
                        and graph.nodes[n].creation_fn.mtl_group == grp
                    ]
                    if all(m.name in visited or ready(m) for m in members):
                        group = [m for m in members if m.name not in emitted]
                        for m in group:
                            visited.add(m.name)
                            emitted.add(m.name)
                        if group:
                            yield group
                    else:
                        visited.discard(node.name)
                        requeue.append(node)
                        continue
                else:
                    emitted.add(node.name)
                    yield node
            for c in node.children:
                if c in region and c not in visited:
                    requeue.append(graph.nodes[c])
        queue = deque()
        pending = [n for n in requeue if n.name not in visited]
        if not made_progress and pending:
            # cycle or unreachable parents — bail out rather than spin
            return


def bisect(graph: LineageGraph, start: str,
           failing: Callable[[LineageNode], bool],
           skip_fn: SkipFn = None) -> Optional[LineageNode]:
    """Binary search over a version chain for the FIRST failing version.

    Assumes monotonicity (once a version fails, later versions fail) — the
    standard git-bisect contract. Returns None if no version fails.
    ``skip_fn`` marks versions that cannot be probed (git-bisect-skip):
    they are excluded from the search entirely, so the result is the first
    failing *probe-able* version. DAG-wide attribution (classifying a
    failure as introduced / inherited / merge-emergent rather than finding
    one chain position) lives in ``repro_torch.diag.blame`` (DESIGN.md §9.2).
    """
    chain = [n for n in version_chain(graph, start)
             if skip_fn is None or not skip_fn(n)]
    lo, hi = 0, len(chain) - 1
    if not chain or not failing(chain[hi]):
        return None
    if failing(chain[0]):
        return chain[0]
    # invariant: chain[lo] passes, chain[hi] fails
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if failing(chain[mid]):
            hi = mid
        else:
            lo = mid
    return chain[hi]


def traverse(graph: LineageGraph, order: str = "bfs", **kwargs) -> Iterator[object]:
    if order == "bfs":
        return bfs(graph, **kwargs)
    if order == "dfs":
        return dfs(graph, **kwargs)
    if order == "versions":
        return version_chain(graph, kwargs["start"])
    if order == "all_parents_first":
        kwargs.pop("edge_types", None)
        return all_parents_first(graph, **kwargs)
    raise ValueError(f"unknown traversal order {order!r}")
