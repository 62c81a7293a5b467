"""Regression attribution over the provenance DAG (DESIGN.md §9.2).

``bisect`` answers "which version of THIS model first failed"; ``blame``
answers the paper's harder question (§4): *is this bug inherited from an
upstream model?* Given a failing (node, test) it walks BOTH edge kinds —
version edges and provenance edges — up to the roots, evaluates the test on
every ancestor through the memoized runner (so repeated blames and
overlapping closures are nearly free), and classifies each failure:

* ``introduced`` — the node fails but every evaluated upstream passes (or
  nothing upstream runs the test): the regression originates here;
* ``inherited`` — at least one direct upstream (version parent or
  provenance parent) fails the same test: the bug flowed downstream;
* ``emergent`` — a merge-style node (>= 2 provenance parents) fails while
  all of its parents pass: the combination, not an input, is at fault.

The **frontier** is the earliest-ancestor set where the test first fails
(every failing node none of whose evaluated upstreams fails) — the DAG
generalization of bisect's single first-bad version.

Copied from the reference package's ``repro/diag/blame.py``; only the imports
differ.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.lineage import LineageGraph, LineageNode, RegisteredTest
from repro_torch.diag.runner import DiagnosticsRunner, TestResult

PASS = "pass"
INTRODUCED = "introduced"
INHERITED = "inherited"
EMERGENT = "emergent"
NOT_RUN = "not_run"


@dataclasses.dataclass
class BlameEntry:
    node: str
    status: str
    value: Optional[float] = None
    passed: Optional[bool] = None
    cached: bool = False
    inherited_from: List[str] = dataclasses.field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class BlameReport:
    node: str
    test: str
    entries: Dict[str, BlameEntry]
    frontier: List[str]            # earliest failing ancestor set

    @property
    def status(self) -> str:
        """Classification of the queried node itself."""
        return self.entries[self.node].status

    def to_json(self) -> Dict[str, Any]:
        return {
            "node": self.node,
            "test": self.test,
            "status": self.status,
            "frontier": self.frontier,
            "entries": {k: v.to_json() for k, v in sorted(self.entries.items())},
        }


def _ancestor_closure(graph: LineageGraph, start: str) -> List[LineageNode]:
    """``start`` plus every ancestor reachable over version OR provenance
    edges, in deterministic BFS-from-start order."""
    order = [start]
    seen = {start}
    i = 0
    while i < len(order):
        node = graph.nodes[order[i]]
        i += 1
        for p in node.version_parents + node.parents:
            if p not in seen and p in graph.nodes:
                seen.add(p)
                order.append(p)
    return [graph.nodes[n] for n in order]


def _find_test(graph: LineageGraph, test_name: str) -> RegisteredTest:
    for t in graph.tests:
        if t.name == test_name:
            return t
    raise KeyError(f"no registered test named {test_name!r}")


def blame(graph: LineageGraph, node_name: str, test_name: str,
          runner: Optional[DiagnosticsRunner] = None,
          failing: Optional[Callable[[TestResult], bool]] = None
          ) -> BlameReport:
    """Attribute a test failure at ``node_name`` across the provenance DAG.

    ``failing`` overrides the pass/fail convention (default: the result's
    recorded ``passed`` flag — exceptions and non-finite metrics fail).
    Evaluation is parallel and memoized; a blame immediately after a
    ``DiagnosticsRunner.run`` sweep executes zero new tests."""
    if node_name not in graph.nodes:
        raise KeyError(f"unknown node {node_name!r}")
    runner = runner or DiagnosticsRunner(graph)
    test = _find_test(graph, test_name)
    failing = failing or (lambda r: not r.passed)

    closure = _ancestor_closure(graph, node_name)
    report = runner.run(nodes=closure, tests=[test])

    results: Dict[str, TestResult] = {}
    for name, res in report.results.items():
        if test.name in res:
            results[name] = res[test.name]

    failing_set = {n for n, r in results.items() if failing(r)}
    entries: Dict[str, BlameEntry] = {}
    for node in closure:
        r = results.get(node.name)
        if r is None:
            entries[node.name] = BlameEntry(node=node.name, status=NOT_RUN)
            continue
        if node.name not in failing_set:
            entries[node.name] = BlameEntry(
                node=node.name, status=PASS, value=r.value, passed=r.passed,
                cached=r.cached)
            continue
        upstream = [p for p in node.version_parents + node.parents
                    if p in results]
        failed_upstream = [p for p in upstream if p in failing_set]
        if failed_upstream:
            status = INHERITED
        elif len([p for p in node.parents if p in results]) >= 2:
            status = EMERGENT
        else:
            status = INTRODUCED
        entries[node.name] = BlameEntry(
            node=node.name, status=status, value=r.value, passed=r.passed,
            cached=r.cached, inherited_from=failed_upstream)

    frontier = sorted(n for n, e in entries.items()
                      if e.status in (INTRODUCED, EMERGENT))
    return BlameReport(node=node_name, test=test.name, entries=entries,
                       frontier=frontier)
