"""Automated lineage-graph construction (paper §3.2).

Inserting a model ``x`` runs a pairwise ``diff`` against every model already in
the graph and picks as parent the node with the smallest *contextual* then
*structural* divergence score. If nothing is sufficiently similar, ``x``
becomes a root. Only provenance edges are inferred — versioning edges require
user annotation, exactly as in the paper.

Copied from the reference package's ``repro/core/auto.py``; only the imports
differ.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.artifact import ModelArtifact
from repro_torch.core.diff import divergence_scores, module_diff
from repro_torch.core.lineage import LineageGraph

# A divergence of 1.0 means "no overlap at all"; anything >= the threshold is
# treated as unrelated and the model becomes a root.
DEFAULT_ROOT_THRESHOLD = 0.999

_SAMPLE = 4096  # elements sampled per tensor for value divergence


def value_divergence(a: ModelArtifact, b: ModelArtifact) -> float:
    """Beyond-paper refinement: CONTINUOUS divergence over structurally
    matched parameters (mean relative |delta| on a sample).

    The paper's contextual score is exact-hash based, so once every tensor
    changed even slightly (finetune version chains) all candidates tie at
    1.0 and parent choice degrades to name order. A magnitude-aware score
    recovers the ordering (a model is closest to the version it was
    finetuned FROM). Used only as a tiebreak below ``root_threshold``.
    """
    d = module_diff(a, b, mode="structural")
    if not d.matched_nodes:
        return float("inf")
    num = den = 0.0
    for a_name, b_name in d.matched_nodes:
        for pname in a.graph.nodes[a_name].params:
            ka, kb = f"{a_name}/{pname}", f"{b_name}/{pname}"
            if ka not in a.params or kb not in b.params:
                continue
            pa = np.asarray(a.params[ka]).ravel()[:_SAMPLE]
            pb = np.asarray(b.params[kb]).ravel()[:_SAMPLE]
            if pa.shape != pb.shape:
                continue
            num += float(np.mean(np.abs(pa - pb)))
            den += float(np.mean(np.abs(pa))) + 1e-12
    return num / max(den, 1e-12)


def choose_parent(graph: LineageGraph, artifact: ModelArtifact,
                  root_threshold: float = DEFAULT_ROOT_THRESHOLD,
                  use_value_similarity: bool = True,
                  ) -> Tuple[Optional[str], Dict[str, Tuple[float, float]]]:
    """Return (best_parent_name or None, all pairwise scores).

    Paper order: smallest contextual, then structural divergence.
    ``use_value_similarity`` adds the continuous value divergence as a final
    tiebreak (set False for the paper-faithful algorithm)."""
    scores: Dict[str, Tuple] = {}
    for name, node in graph.nodes.items():
        try:
            other = node.get_model()
        except ValueError:
            continue
        ds, dc = divergence_scores(other, artifact)
        scores[name] = (ds, dc)
    if not scores:
        return None, scores
    if use_value_similarity:
        # only pay the value-divergence cost for the tied leaders
        leader = min((scores[n][1], scores[n][0]) for n in scores)
        tied = [n for n in scores
                if (scores[n][1], scores[n][0]) == leader]
        dv = {n: (value_divergence(graph.nodes[n].get_model(), artifact)
                  if len(tied) > 1 else 0.0)
              for n in tied}
        best = min(tied, key=lambda n: (dv[n], n))
    else:
        best = min(scores, key=lambda n: (scores[n][1], scores[n][0], n))
    ds, dc = scores[best]
    if dc >= root_threshold and ds >= root_threshold:
        return None, scores
    return best, scores


def auto_insert(graph: LineageGraph, artifact: ModelArtifact, name: str,
                root_threshold: float = DEFAULT_ROOT_THRESHOLD,
                use_value_similarity: bool = True) -> Optional[str]:
    """Insert ``artifact`` with automatically inferred provenance.

    Returns the chosen parent name (None if inserted as a root).
    """
    parent, _ = choose_parent(graph, artifact, root_threshold,
                              use_value_similarity=use_value_similarity)
    graph.add_node(artifact, name)
    if parent is not None:
        graph.add_edge(parent, name)
    return parent


def auto_construct(graph: LineageGraph, pool: List[Tuple[str, ModelArtifact]],
                   root_threshold: float = DEFAULT_ROOT_THRESHOLD,
                   use_value_similarity: bool = True,
                   ) -> Dict[str, Optional[str]]:
    """Build a lineage graph from a pool of (name, artifact) pairs.

    Models are inserted in pool order (the paper bootstraps from an unordered
    pool; insertion order only affects which of two equally-similar models is
    the parent). Returns {model: inferred parent}.
    """
    chosen: Dict[str, Optional[str]] = {}
    for name, artifact in pool:
        chosen[name] = auto_insert(graph, artifact, name, root_threshold,
                                   use_value_similarity=use_value_similarity)
    return chosen


def insertion_benchmark(graph: LineageGraph, pool: List[Tuple[str, ModelArtifact]],
                        ) -> List[float]:
    """Per-model auto-insertion wall times (paper Figure 3)."""
    times: List[float] = []
    for name, artifact in pool:
        t0 = time.perf_counter()
        auto_insert(graph, artifact, name)
        times.append(time.perf_counter() - t0)
    return times
