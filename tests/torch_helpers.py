"""Toy models for the port's parity tests, built alike in both packages.

``tests/helpers.py`` builds its models with the reference's core types.
The functions here take the core module (``repro.core`` or
``repro_torch.core``), so the same seeded numpy values go through either
package; ``finetune_like``, ``reinit_head`` and ``l2_test`` of
``helpers.py`` only call methods of the artifact they are given and serve
both packages as they are.
"""

from __future__ import annotations

import numpy as np


def make_chain_model(core, seed=0, n_layers=4, d=16, head_dim=4, prefix="L",
                     model_type="toy"):
    """``helpers.make_chain_model`` with ``core``'s types."""
    rng = np.random.default_rng(seed)
    layers, params = [], {}
    for i in range(n_layers):
        layers.append(core.LayerNode(f"{prefix}{i}", "linear",
                                     params={"w": ((d, d), "float32"),
                                             "b": ((d,), "float32")}))
        params[f"{prefix}{i}/w"] = rng.normal(size=(d, d)).astype(np.float32)
        params[f"{prefix}{i}/b"] = rng.normal(size=(d,)).astype(np.float32)
    layers.append(core.LayerNode("head", "linear",
                                 params={"w": ((d, head_dim), "float32")}))
    params["head/w"] = rng.normal(size=(d, head_dim)).astype(np.float32)
    return core.ModelArtifact(core.LayerGraph.chain(layers), params,
                              model_type=model_type)


def graph_model(core, names, edges, seed=0, d=8, model_type="toy"):
    """A model of (d, d) linear layers ``names`` joined by ``edges``, with
    weights drawn in ``names`` order from a seeded numpy generator."""
    g = core.LayerGraph()
    for name in names:
        g.add_node(core.LayerNode(name, "linear",
                                  params={"w": ((d, d), "float32")}))
    for src, dst in edges:
        g.add_edge(src, dst)
    rng = np.random.default_rng(seed)
    params = {f"{n}/w": rng.normal(size=(d, d)).astype(np.float32)
              for n in names}
    return core.ModelArtifact(g, params, model_type=model_type)


def branch_model(core, seed=0, d=8):
    """``test_core_merge._branch_model``: stem -> (b1, b2) -> head."""
    return graph_model(core, ("stem", "b1", "b2", "head"),
                       [("stem", "b1"), ("stem", "b2"), ("b1", "head"),
                        ("b2", "head")], seed=seed, d=d)


def two_heads_model(core, seed=0):
    """stem -> head_a and stem -> head_b: no layer consumes both heads."""
    return graph_model(core, ("stem", "head_a", "head_b"),
                       [("stem", "head_a"), ("stem", "head_b")], seed=seed)


def edit(m, layer, delta=0.1):
    """``m`` with ``delta`` added to ``layer``'s weight."""
    return m.replace_params({f"{layer}/w": m.params[f"{layer}/w"] + delta})


def diff_summary(d):
    """Everything a ``DiffResult`` says, as plain data."""
    return {"mode": d.mode, "matched_nodes": d.matched_nodes,
            "matched_edges": d.matched_edges, "add_nodes": d.add_nodes,
            "del_nodes": d.del_nodes, "add_edges": d.add_edges,
            "del_edges": d.del_edges, "divergence": d.divergence,
            "identical": d.identical}
