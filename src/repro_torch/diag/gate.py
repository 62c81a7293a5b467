"""Test-gated cascades + quarantine (DESIGN.md §9.4).

Git-Theta-style behavioral gating: an update cascade
(``run_update_cascade(..., gate=TestGate(...))``) runs every registered test
on each newly materialized version through the memoized runner, compares
against the version parent's recorded results, and **quarantines** a
regressing node instead of silently committing it:

* the version edge stays recorded and the artifact is kept (nothing is
  destroyed — the regression is inspectable and blame-able);
* ``metadata["quarantined"] = True`` plus a ``metadata["quarantine"]``
  record (tests, values, baselines) mark the node;
* remote sync excludes quarantined nodes from push selection by default
  (the reference's ``repro.remote.sync.push(include_quarantined=...)``; the
  port's remote slice reads the same flag), so a regression never
  propagates to collaborators unnoticed.

Regression semantics (metrics are higher-is-better, like the paper's test
accuracies): a node regresses when a test *newly fails* (the baseline
passed, or there is no baseline) or when its metric drops more than ``tol``
below the baseline value. A failure the version parent already had is
inherited, not a regression — the gate does not punish a node for upstream
history (that is ``blame``'s job).

Copied from the reference package's ``repro/diag/gate.py``; only the
imports differ.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

from repro_torch.core.lineage import LineageGraph, LineageNode, RegisteredTest
# Flag names + predicate live in the dependency-light core module so the
# push/hub/serving seams can read them without importing the diag runner;
# re-exported here for compatibility with existing imports.
from repro_torch.core.quarantine import (QUARANTINE_FLAG, QUARANTINE_RECORD,
                                   is_quarantined)
from repro_torch.diag.runner import DiagnosticsRunner, TestResult


@dataclasses.dataclass
class Regression:
    test: str
    kind: str                      # "new_failure" | "metric_drop"
    value: Optional[float]
    baseline: Optional[float] = None
    baseline_node: Optional[str] = None
    error: Optional[str] = None

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class GateDecision:
    node: str
    passed: bool
    regressions: List[Regression]
    results: Dict[str, TestResult]
    quarantined: bool = False

    def to_json(self) -> Dict[str, Any]:
        return {
            "node": self.node,
            "passed": self.passed,
            "quarantined": self.quarantined,
            "regressions": [r.to_json() for r in self.regressions],
            "results": {t: r.to_json() for t, r in self.results.items()},
        }


class TestGate:
    """The ``gate=`` hook for update cascades (and standalone checks)."""

    __test__ = False    # "Test" prefix, but not a pytest class

    def __init__(self, graph: Optional[LineageGraph] = None,
                 runner: Optional[DiagnosticsRunner] = None,
                 tol: float = 0.0, quarantine: bool = True,
                 pattern: Optional[str] = None, match: str = "regex") -> None:
        if runner is None:
            if graph is None:
                raise ValueError("TestGate needs a graph or a runner")
            runner = DiagnosticsRunner(graph)
        self.runner = runner
        self.graph = graph or runner.graph
        self.tol = tol
        self.quarantine = quarantine
        self.pattern = pattern
        self.match = match
        self.decisions: List[GateDecision] = []

    # -- evaluation ------------------------------------------------------------
    def _baseline(self, node: LineageNode,
                  test: RegisteredTest) -> Optional[TestResult]:
        """The version parent's (memoized) result for ``test``, if any."""
        for pname in node.version_parents:
            parent = self.graph.nodes.get(pname)
            if parent is None:
                continue
            if any(t.name == test.name
                   for t in self.runner.tests_for(parent)):
                return self.runner.run_one(parent, test)
        return None

    def check(self, node: Union[str, LineageNode]) -> GateDecision:
        """Evaluate the gate for one node, without side effects."""
        if isinstance(node, str):
            node = self.graph.nodes[node]
        from repro_torch.core.lineage import compile_test_pattern
        matcher = compile_test_pattern(self.pattern, self.match)
        regressions: List[Regression] = []
        results: Dict[str, TestResult] = {}
        for test in self.runner.tests_for(node):
            if not matcher(test.name):
                continue
            res = self.runner.run_one(node, test)
            results[test.name] = res
            base = self._baseline(node, test)
            if not res.passed:
                if base is None or base.passed:
                    regressions.append(Regression(
                        test=test.name, kind="new_failure", value=res.value,
                        baseline=base.value if base else None,
                        baseline_node=base.node if base else None,
                        error=res.error))
                # else: baseline failed too — inherited, not a regression
            elif (base is not None and base.passed
                  and base.value is not None and res.value is not None
                  and res.value < base.value - self.tol):
                regressions.append(Regression(
                    test=test.name, kind="metric_drop", value=res.value,
                    baseline=base.value, baseline_node=base.node))
        self.runner.ledger.flush()   # batch the check's ledger writes
        return GateDecision(node=node.name, passed=not regressions,
                            regressions=regressions, results=results)

    def apply(self, node: Union[str, LineageNode]) -> GateDecision:
        """Check + quarantine on failure; the cascade hook entry point."""
        decision = self.check(node)
        if not decision.passed and self.quarantine:
            name = node if isinstance(node, str) else node.name
            quarantine_node(self.graph, name, decision)
            decision.quarantined = True
        self.decisions.append(decision)
        return decision

    def report(self) -> List[Dict[str, Any]]:
        return [d.to_json() for d in self.decisions]


# ---------------------------------------------------------------------------
# Quarantine state (lives in node metadata => persists + syncs as metadata)
# ---------------------------------------------------------------------------


def quarantine_node(graph: LineageGraph, name: str,
                    decision: Optional[GateDecision] = None,
                    reason: Optional[str] = None) -> None:
    node = graph.nodes[name]
    node.metadata[QUARANTINE_FLAG] = True
    record: Dict[str, Any] = {"reason": reason or "gate regression"}
    if decision is not None:
        record["regressions"] = [r.to_json() for r in decision.regressions]
    node.metadata[QUARANTINE_RECORD] = record
    graph._commit()


def release_node(graph: LineageGraph, name: str) -> None:
    """Lift a quarantine (after a fix-forward or a human override)."""
    node = graph.nodes[name]
    node.metadata.pop(QUARANTINE_FLAG, None)
    node.metadata.pop(QUARANTINE_RECORD, None)
    graph._commit()


def gate_report(graph: LineageGraph) -> List[Dict[str, Any]]:
    """All currently quarantined nodes with their recorded regressions."""
    out = []
    for name in sorted(graph.nodes):
        node = graph.nodes[name]
        if is_quarantined(node):
            out.append({"node": name,
                        **node.metadata.get(QUARANTINE_RECORD,
                                            {"reason": "unknown"})})
    return out
