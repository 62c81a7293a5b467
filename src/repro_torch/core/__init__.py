"""MGit core: lineage graph, layer-graph IR, artifacts, traversal.

``diff``, ``merge``, ``cascade`` and ``auto`` are not part
of this package yet; ``LineageGraph.merge`` and
``LineageGraph.run_update_cascade`` import them lazily and raise
``ImportError`` until they arrive.
"""

from repro_torch.core.artifact import ModelArtifact, param_key, split_key
from repro_torch.core.graphir import LayerGraph, LayerNode
from repro_torch.core.lineage import (CreationFunction, LineageGraph,
                                      LineageNode, RegisteredTest,
                                      register_creation_type)
from repro_torch.core.traversal import (all_parents_first, bfs, bisect, dfs,
                                        version_chain)

__all__ = [
    "ModelArtifact", "param_key", "split_key",
    "LayerGraph", "LayerNode",
    "CreationFunction", "LineageGraph", "LineageNode", "RegisteredTest",
    "register_creation_type",
    "all_parents_first", "bfs", "bisect", "dfs", "version_chain",
]
