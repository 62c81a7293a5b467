"""MGit core: lineage graph, diff, merge, update cascade, auto-construction."""

from repro_torch.core.artifact import ModelArtifact, param_key, split_key
from repro_torch.core.auto import auto_construct, auto_insert, choose_parent
from repro_torch.core.cascade import next_version_name, run_update_cascade
from repro_torch.core.diff import DiffResult, divergence_scores, module_diff
from repro_torch.core.graphir import LayerGraph, LayerNode
from repro_torch.core.lineage import (CreationFunction, LineageGraph,
                                      LineageNode, RegisteredTest,
                                      register_creation_type)
from repro_torch.core.merge import (CONFLICT, NO_CONFLICT, POSSIBLE_CONFLICT,
                                    MergeResult, merge, merge_artifacts)
from repro_torch.core.quarantine import (QUARANTINE_FLAG, QUARANTINE_RECORD,
                                         is_quarantined)
from repro_torch.core.traversal import (all_parents_first, bfs, bisect, dfs,
                                        version_chain)

__all__ = [
    "ModelArtifact", "param_key", "split_key",
    "auto_construct", "auto_insert", "choose_parent",
    "next_version_name", "run_update_cascade",
    "DiffResult", "divergence_scores", "module_diff",
    "LayerGraph", "LayerNode",
    "CreationFunction", "LineageGraph", "LineageNode", "RegisteredTest",
    "register_creation_type",
    "CONFLICT", "NO_CONFLICT", "POSSIBLE_CONFLICT", "MergeResult", "merge",
    "merge_artifacts",
    "QUARANTINE_FLAG", "QUARANTINE_RECORD", "is_quarantined",
    "all_parents_first", "bfs", "bisect", "dfs", "version_chain",
]
