"""Diagnostics engine over the lineage graph (paper §4; DESIGN.md §9).

Four layers:

* :mod:`repro_torch.diag.runner` — memoized parallel test execution backed
  by a content-addressed result ledger in the store (§9.1);
* :mod:`repro_torch.diag.blame` — DAG-wide regression attribution:
  introduced / inherited / merge-emergent, plus the earliest failing
  frontier (§9.2);
* :mod:`repro_torch.diag.transfer` — diff-adapted test transfer and scoped
  re-run skipping from manifest metadata only (§9.3);
* :mod:`repro_torch.diag.gate` — test-gated update cascades with quarantine,
  honored by remote sync (§9.4).

Copied from the reference package's ``repro/diag``; only the imports
differ. Nothing here touches a tensor's device: tests receive the models
the store checks out, and the store runs the kernels.
"""

from repro_torch.diag.blame import (EMERGENT, INHERITED, INTRODUCED,
                                    NOT_RUN, PASS, BlameEntry, BlameReport,
                                    blame)
from repro_torch.diag.gate import (GateDecision, Regression, TestGate,
                                   gate_report, is_quarantined,
                                   quarantine_node, release_node)
from repro_torch.diag.runner import (DiagnosticsRunner, ResultLedger,
                                     RunReport, TestResult, manifest_key_for,
                                     test_identity_hash)
from repro_torch.diag.transfer import (scoped_content_key,
                                       scoped_param_hashes,
                                       structurally_transferable,
                                       structure_of, transferable_tests)

__all__ = [
    "blame", "BlameEntry", "BlameReport",
    "PASS", "INTRODUCED", "INHERITED", "EMERGENT", "NOT_RUN",
    "TestGate", "GateDecision", "Regression", "gate_report",
    "is_quarantined", "quarantine_node", "release_node",
    "DiagnosticsRunner", "ResultLedger", "RunReport", "TestResult",
    "manifest_key_for", "test_identity_hash",
    "scoped_content_key", "scoped_param_hashes", "structure_of",
    "structurally_transferable", "transferable_tests",
]
