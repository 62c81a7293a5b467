"""Quickstart: build a lineage graph, store it compressed, diff/test/merge.

The PyTorch/CUDA port's run of ``examples/quickstart.py``: the same numpy
models and seeds, so it prints the same figures. The store commits and
checks out through the CUDA kernels on the card unless ``--device cpu``
asks for the plain versions on the host.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np

from repro_torch.core import (LayerGraph, LayerNode, LineageGraph,
                              ModelArtifact, bfs, divergence_scores, merge,
                              module_diff)
from repro_torch.diag import DiagnosticsRunner
from repro_torch.store import ArtifactStore


def make_model(seed, d=128, n_layers=6):
    rng = np.random.default_rng(seed)
    layers, params = [], {}
    for i in range(n_layers):
        layers.append(LayerNode(f"block{i}", "linear",
                                params={"w": ((d, d), "float32")}))
        params[f"block{i}/w"] = rng.normal(size=(d, d)).astype(np.float32)
    layers.append(LayerNode("head", "linear", params={"w": ((d, 10), "float32")}))
    params["head/w"] = rng.normal(size=(d, 10)).astype(np.float32)
    return ModelArtifact(LayerGraph.chain(layers), params, model_type="demo")


def finetune(m, seed, scale=1e-4):
    rng = np.random.default_rng(seed)
    return m.map_params(lambda k, v: (v + rng.normal(scale=scale, size=v.shape)
                                      * (rng.random(v.shape) < 0.2)).astype(v.dtype))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the store's kernels on the card (raises "
                         "without one); cpu: the plain versions on the host")
    args = ap.parse_args(argv)

    tmp = tempfile.mkdtemp(prefix="mgit-demo-")
    store = ArtifactStore(root=tmp, codec="lzma",
                          backend="ref" if args.device == "cpu" else None)
    g = LineageGraph(path=tmp, store=store)

    # 1. a pretrained root and two finetuned children
    base = make_model(seed=0)
    g.add_node(base, "base")
    for i in range(2):
        g.add_edge("base", f"task{i}")          # provenance first…
        g.add_node(finetune(base, seed=10 + i), f"task{i}")  # …then content

    # 2. storage: children are delta-compressed against the root
    s = store.stats()
    print(f"storage: logical={s['logical_bytes']/1e6:.1f}MB "
          f"physical={s['physical_bytes']/1e6:.1f}MB "
          f"ratio={s['compression_ratio']:.2f}x")

    # 3. diff / divergence (structural: same architecture; contextual: every
    #    finetuned tensor differs)
    d = module_diff(g.get_model("base"), g.get_model("task0"), mode="structural")
    dc = module_diff(g.get_model("base"), g.get_model("task0"), mode="contextual")
    print(f"diff(base, task0): structural matched={len(d.matched_nodes)} "
          f"(div={d.divergence:.3f}); contextual div={dc.divergence:.3f}")
    print("divergence(task0, task1):",
          tuple(round(x, 3) for x in divergence_scores(
              g.get_model("task0"), g.get_model("task1"))))

    # 4. register a test + run it over the graph. scope="head" tells the
    #    diagnostics runner the test only reads the head submodule, so
    #    versions sharing a bit-identical head share one memoized result.
    g.register_test_function(
        lambda m: float(np.linalg.norm(m.params["head/w"])), "head_norm",
        mt="demo", scope="head")
    print("tests:", g.run_tests(bfs(g), pattern="head", match="regex"))

    # 4b. the memoized parallel runner: the second sweep answers entirely
    #     from the content-addressed result ledger (zero materializations)
    runner = DiagnosticsRunner(g)
    cold = runner.run()
    warm = DiagnosticsRunner(g).run()   # fresh runner: hits come from the store
    print(f"diag: cold executed={cold.executed}, "
          f"warm cache-hit ratio={warm.cache_hit_ratio:.0%}")

    # 5. merge two concurrent edits
    u1 = g.get_model("task0").replace_params(
        {"block0/w": g.get_model("task0").params["block0/w"] + 0.01})
    u2 = g.get_model("task0").replace_params(
        {"head/w": g.get_model("task0").params["head/w"] * 1.01})
    g.add_edge("task0", "edit_a")
    g.add_node(u1, "edit_a")
    g.add_edge("task0", "edit_b")
    g.add_node(u2, "edit_b")
    result = merge(g, "edit_a", "edit_b")
    print(f"merge(edit_a, edit_b): {result.status} — {result.detail}")

    print("\nlineage graph:")
    print(g.log())
    print(f"\n(artifacts persisted under {tmp})")


if __name__ == "__main__":
    main()
