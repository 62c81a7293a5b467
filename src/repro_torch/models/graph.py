"""The layer graph of a flat parameter dict.

The reference package builds it in ``repro/store/checkpoint.py``
(``spec_graph`` / ``state_graph``); the same chain graph here makes the
two packages commit byte-identical manifests for the same parameters.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.common.bf16 import dtype_name
from repro_torch.core.graphir import LayerGraph, LayerNode


def spec_graph(specs: Dict[str, Tuple[Tuple[int, ...], str]],
               model_type: str) -> LayerGraph:
    """Chain LayerGraph over (shape, dtype) specs keyed by state path."""
    g = LayerGraph()
    prev = None
    for key, (shape, dtype) in specs.items():
        layer, _, param = key.rpartition("/")
        layer, param = layer or key, param or "value"
        if layer not in g.nodes:
            g.add_node(LayerNode(layer, "state"))
            if prev is not None:
                g.add_edge(prev, layer)
            prev = layer
        g.nodes[layer].params[param] = (tuple(shape), str(dtype))
    return g


def state_graph(flat: Dict[str, np.ndarray], model_type: str) -> LayerGraph:
    """Chain LayerGraph over state entries (checkpoints are sequenced by path)."""
    return spec_graph(
        {k: (tuple(np.shape(v)), dtype_name(np.asarray(v)))
         for k, v in flat.items()}, model_type)
