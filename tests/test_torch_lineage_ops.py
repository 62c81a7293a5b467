"""The port's lineage operations against the reference package, on the CPU.

Diff (Algorithm 3), three-way merge, the update cascade (Algorithm 2) and
auto-construction (§3.2) run on the same toy models, built from the same
numpy seeds, in both packages: each case of ``tests/test_core_diff.py``,
``tests/test_core_merge.py`` and ``tests/test_core_cascade.py`` is run in
each and must give equal diff matches and divergence scores, merge
outcomes and merged param hashes, cascade node names and edges, and
rollback survivors. Where a case has a store, both packages commit through
a ``backend="ref"`` store (the port's numpy twins) and must write equal
manifest refs.
"""

import json
import types

import numpy as np
import pytest

import repro.core as rcore
import repro.core.auto as rauto
import repro.diag as rdiag
from repro.store import ArtifactStore as RefStore

import repro_torch.core as tcore
import repro_torch.core.auto as tauto
import repro_torch.diag as tdiag
from repro_torch.common.hashing import tensor_hash
from repro_torch.store import ArtifactStore as PortStore

from helpers import finetune_like, l2_test, reinit_head
from torch_helpers import (branch_model, diff_summary, edit,
                           make_chain_model, two_heads_model)


def _creation_types(core):
    """The reference cascade tests' creation functions, registered under
    names of their own in ``core``'s registry."""

    @core.register_creation_type("torch-parity-finetune")
    class Finetune(core.CreationFunction):
        def __call__(self, parents):
            return finetune_like(parents[0].get_model(),
                                 seed=self.config["seed"], density=1.0,
                                 scale=self.config.get("scale", 1e-4))

    @core.register_creation_type("torch-parity-boom")
    class Boom(core.CreationFunction):
        def __call__(self, parents):
            if self.config.get("boom"):
                raise RuntimeError("creation failed")
            return finetune_like(parents[0].get_model(),
                                 seed=self.config["seed"])

    @core.register_creation_type("torch-parity-mtl")
    class MTL(core.CreationFunction):
        def __call__(self, parents):
            return finetune_like(parents[0].get_model(),
                                 seed=self.config["seed"])

        def run_group(self, nodes):
            out = []
            for node in nodes:
                parent = node.get_parents()[0].get_model()
                m = finetune_like(parent, seed=node.creation_fn.config["seed"])
                out.append(m.replace_params(
                    {k: v for k, v in parent.params.items()
                     if not k.startswith("head")}))
            return out

    @core.register_creation_type("torch-parity-regress")
    class Regress(core.CreationFunction):
        def __call__(self, parents):
            m = finetune_like(parents[0].get_model(), seed=self.config["seed"])
            if self.config.get("regress"):
                m.metadata["broken"] = True
            return m

    return types.SimpleNamespace(Finetune=Finetune, Boom=Boom, MTL=MTL,
                                 Regress=Regress)


REF = types.SimpleNamespace(name="ref", core=rcore, auto=rauto, diag=rdiag,
                            cr=_creation_types(rcore),
                            store=lambda root: RefStore(root=root))
PORT = types.SimpleNamespace(name="port", core=tcore, auto=tauto,
                             diag=tdiag,
                             cr=_creation_types(tcore),
                             store=lambda root: PortStore(root=root,
                                                          backend="ref"))


def both(case, tmp_path=None):
    """``case(pkg, root)`` run in each package (each in a directory of its
    own); returns the two results."""
    out = []
    for pkg in (REF, PORT):
        root = None if tmp_path is None else str(tmp_path / pkg.name)
        out.append(case(pkg, root))
    return out


def graph_state(g):
    """Node names, edges, artifact refs and quarantine flags of a lineage."""
    return {name: {"parents": n.parents, "children": n.children,
                   "version_parents": n.version_parents,
                   "version_children": n.version_children,
                   "artifact_ref": n.artifact_ref,
                   "quarantined": bool(n.metadata.get("quarantined")),
                   "model_type": n.model_type}
            for name, n in sorted(g.nodes.items())}


def hashes_of(m):
    return None if m is None else (m.model_type, sorted(
        m.param_hashes().items()), json.dumps(m.graph.to_json(),
                                              sort_keys=True))


# ---------------------------------------------------------------------------
# diff (tests/test_core_diff.py)
# ---------------------------------------------------------------------------


def _adapter_model(core, a):
    """``test_structural_addition``'s b: a with an adapter before the head."""
    b_graph = core.LayerGraph()
    for name in a.graph.topo_order():
        b_graph.add_node(core.LayerNode.from_json(
            a.graph.nodes[name].to_json()))
    adapter = core.LayerNode("adapter", "adapter",
                             params={"w": ((16, 16), "float32")})
    params = dict(a.params)
    params["adapter/w"] = np.zeros((16, 16), np.float32)
    b_graph.nodes.pop("head")
    nodes = [b_graph.nodes[n] for n in list(b_graph.nodes)]
    g = core.LayerGraph.chain(nodes + [adapter, core.LayerNode.from_json(
        a.graph.nodes["head"].to_json())])
    return core.ModelArtifact(g, params, model_type="toy")


def _moe_pair(core):
    layers = [core.LayerNode("router", "router",
                             params={"w": ((8, 4), "float32")}),
              *[core.LayerNode(f"expert{i}", "mlp",
                               params={"w": ((8, 8), "float32")})
                for i in range(4)]]
    g = core.LayerGraph()
    for layer in layers:
        g.add_node(layer)
    for i in range(4):
        g.add_edge("router", f"expert{i}")
    rng = np.random.default_rng(0)
    params = {f"{l.name}/w": rng.normal(size=l.params["w"][0])
              .astype(np.float32) for l in layers}
    a = core.ModelArtifact(g, params, model_type="moe")
    return a, a.replace_params({"expert2/w": params["expert2/w"] + 1.0})


DIFF_CASES = {
    "identical": lambda c: (make_chain_model(c, seed=0),
                            make_chain_model(c, seed=0)),
    "structural_vs_contextual": lambda c: (
        make_chain_model(c, seed=0),
        finetune_like(make_chain_model(c, seed=0), seed=1, scale=0.5,
                      density=1.0)),
    "head_change_localized": lambda c: (
        make_chain_model(c, seed=0), reinit_head(make_chain_model(c, seed=0))),
    "structural_addition": lambda c: (
        make_chain_model(c, seed=0, n_layers=3),
        _adapter_model(c, make_chain_model(c, seed=0, n_layers=3))),
    "unrelated_models": lambda c: (
        make_chain_model(c, seed=0, d=16),
        make_chain_model(c, seed=1, d=32, n_layers=3, prefix="M")),
    "moe_routing": _moe_pair,
}


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_diff_and_divergence_match_reference(case):
    def run(pkg, _root):
        a, b = DIFF_CASES[case](pkg.core)
        return {mode: diff_summary(pkg.core.module_diff(a, b, mode=mode))
                for mode in ("structural", "contextual")}, \
            pkg.core.divergence_scores(a, b)
    ref, port = both(run)
    assert port == ref
    summaries, (ds, dc) = port
    if case == "identical":
        assert summaries["contextual"]["identical"] and dc == 0.0
    elif case == "structural_vs_contextual":
        assert ds == 0.0 and dc > 0.5
    elif case == "head_change_localized":
        assert summaries["contextual"]["add_nodes"] == ["head"]
        assert {m[0] for m in summaries["contextual"]["matched_nodes"]} == \
            {f"L{i}" for i in range(4)}
    elif case == "structural_addition":
        assert summaries["structural"]["add_nodes"] == ["adapter"]
        assert 0 < summaries["structural"]["divergence"] < 0.5
    elif case == "unrelated_models":
        assert (ds, dc) == (1.0, 1.0)
    else:
        assert summaries["contextual"]["del_nodes"] == ["expert2"]


@pytest.mark.parametrize("dtype", ["float32", "float16", "int8", "int32"])
def test_param_hashes_equal_reference_and_store_hash(dtype):
    """Contextual diff hashes a layer from its params' content hashes: the
    port's artifact hashes must be the reference's, and the store's."""
    a_ref = make_chain_model(rcore, seed=3)
    a_port = make_chain_model(tcore, seed=3)
    cast = {k: v.astype(dtype) for k, v in a_ref.params.items()}
    ref_m = a_ref.replace_params(cast)
    port_m = a_port.replace_params(cast)
    assert port_m.param_hashes() == ref_m.param_hashes()
    for k, v in cast.items():
        assert port_m.param_hashes()[k] == tensor_hash(v)
    for name in port_m.graph.nodes:
        assert port_m.graph.nodes[name].contextual_hash() == \
            ref_m.graph.nodes[name].contextual_hash()


def test_auto_construct_chooses_reference_parents(tmp_path):
    """``test_auto_construct_recovers_gold_graph``'s pool, store-backed."""
    def run(pkg, root):
        c = pkg.core
        root_a = make_chain_model(c, seed=0, d=16)
        root_b = make_chain_model(c, seed=7, d=24, n_layers=5, prefix="M")
        pool = [("root_a", root_a), ("root_b", root_b)]
        pool += [(f"ft_a{i}", finetune_like(root_a, seed=20 + i, density=0.1))
                 for i in range(3)]
        pool.append(("head_b", reinit_head(root_b)))
        g = c.LineageGraph(path=root, store=pkg.store(root))
        chosen = c.auto_construct(g, pool)
        extra = finetune_like(g.get_model("ft_a1"), seed=77, scale=1e-6)
        parent, scores = c.choose_parent(g, extra)
        return chosen, parent, scores, graph_state(g)
    ref, port = both(run, tmp_path)
    assert port == ref
    chosen = port[0]
    assert chosen["root_a"] is None and chosen["root_b"] is None
    assert chosen["head_b"] == "root_b"
    assert all(chosen[f"ft_a{i}"] in ("root_a", "ft_a0", "ft_a1")
               for i in range(3))


def test_insertion_benchmark_inserts_like_auto_insert():
    def run(pkg, _root):
        c = pkg.core
        a = make_chain_model(c, seed=0)
        pool = [("a", a), ("b", finetune_like(a, seed=1)),
                ("c", make_chain_model(c, seed=4, d=32, n_layers=2,
                                     prefix="Q"))]
        g = c.LineageGraph()
        times = pkg.auto.insertion_benchmark(g, pool)
        assert len(times) == 3 and all(t >= 0 for t in times)
        return graph_state(g)
    ref, port = both(run)
    assert port == ref
    assert port["b"]["parents"] == ["a"] and port["c"]["parents"] == []


# ---------------------------------------------------------------------------
# merge (tests/test_core_merge.py)
# ---------------------------------------------------------------------------


def _with_extra(core, model, seed):
    g = core.LayerGraph()
    for n in model.graph.nodes.values():
        g.add_node(core.LayerNode(n.name, n.op_type, params=dict(n.params)))
    for s, d in model.graph.edges:
        g.add_edge(s, d)
    g.add_node(core.LayerNode("extra", "linear",
                              params={"w": ((4, 4), "float32")}))
    g.add_edge("head", "extra")
    rng = np.random.default_rng(seed)
    params = dict(model.params)
    params["extra/w"] = rng.normal(size=(4, 4)).astype(np.float32)
    return type(model)(g, params, model_type=model.model_type)


def _without(core, model, layer):
    g = core.LayerGraph()
    for n in model.graph.nodes.values():
        if n.name != layer:
            g.add_node(core.LayerNode(n.name, n.op_type, params=dict(n.params)))
    for s, d in model.graph.edges:
        if layer not in (s, d) and s in g.nodes and d in g.nodes:
            g.add_edge(s, d)
    params = {k: v for k, v in model.params.items()
              if not k.startswith(layer + "/")}
    return type(model)(g, params, model_type=model.model_type)


def _with_adapter(core, m):
    rng = np.random.default_rng(0)
    for _ in m.graph.nodes:     # the reference test draws m's weights first
        rng.normal(size=(8, 8))
    g2 = core.LayerGraph()
    for n in m.graph.nodes.values():
        g2.add_node(core.LayerNode(n.name, n.op_type, params=dict(n.params)))
    for s, d in m.graph.edges:
        g2.add_edge(s, d)
    g2.add_node(core.LayerNode("adapter", "linear",
                               params={"w": ((8, 8), "float32")}))
    g2.add_edge("head_a", "adapter")
    params = dict(m.params)
    params["adapter/w"] = rng.normal(size=(8, 8)).astype(np.float32)
    return core.ModelArtifact(g2, params, model_type="toy")


def _l2(core, name="l2"):
    return [core.RegisteredTest(name=name, fn=l2_test, model_type="toy")]


# case -> (ancestor, m1, m2, merge_artifacts keywords), and the expected
# status and conflicting layers of the reference test
MERGE_CASES = {
    "conflict_same_layer": (
        lambda c: (lambda m: (m, edit(m, "b1", 0.1), edit(m, "b1", -0.1),
                              {}))(branch_model(c)),
        rcore.CONFLICT, ["b1"]),
    "possible_conflict_dependent_layers": (
        lambda c: (lambda m: (m, edit(m, "L0"), edit(m, "L2"), {}))(
            make_chain_model(c, seed=0)),
        rcore.POSSIBLE_CONFLICT, []),
    "parallel_branches_share_a_consumer": (
        lambda c: (lambda m: (m, edit(m, "b1"), edit(m, "b2"), {}))(
            branch_model(c)),
        rcore.POSSIBLE_CONFLICT, []),
    "truly_independent": (
        lambda c: (lambda m: (m, edit(m, "head_a"), edit(m, "head_b"), {}))(
            two_heads_model(c)),
        rcore.NO_CONFLICT, []),
    "dependent_resolved_by_tests": (
        lambda c: (lambda m: (m, edit(m, "L0", 1e-6), edit(m, "L2", 1e-6),
                              dict(tests=_l2(c), test_threshold=-1e9)))(
            make_chain_model(c, seed=0)),
        rcore.NO_CONFLICT, []),
    "dependent_failing_tests": (
        lambda c: (lambda m: (m, edit(m, "L0", 1e-6), edit(m, "L2", 1e-6),
                              dict(tests=_l2(c), test_threshold=1e9)))(
            make_chain_model(c, seed=0)),
        rcore.CONFLICT, ["L0", "L2"]),
    "both_add_same_layer": (
        lambda c: (lambda m: (m, _with_extra(c, m, 1), _with_extra(c, m, 2),
                              {}))(branch_model(c)),
        rcore.CONFLICT, ["extra"]),
    "removed_vs_changed_layer": (
        lambda c: (lambda m: (m, _without(c, m, "b1"), edit(m, "b1"), {}))(
            branch_model(c)),
        rcore.CONFLICT, ["b1"]),
    "structural_add_merges_cleanly": (
        lambda c: (lambda m: (m, _with_adapter(c, m), edit(m, "head_b"),
                              {}))(two_heads_model(c)),
        rcore.NO_CONFLICT, []),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_artifacts_matches_reference(case, tmp_path):
    make, status, conflicting = MERGE_CASES[case]

    def run(pkg, root):
        ancestor, m1, m2, kw = make(pkg.core)
        r = pkg.core.merge_artifacts(ancestor, m1, m2, **kw)
        ref = None
        if r.merged is not None:
            ref = pkg.store(root).commit_artifact("merged", r.merged)
        return (r.status, r.conflicting_layers, r.test_results, r.detail,
                hashes_of(r.merged), ref)
    ref, port = both(run, tmp_path)
    assert port == ref
    assert port[0] == status
    assert sorted(port[1]) == sorted(conflicting) or \
        set(conflicting) <= set(port[1])
    assert (port[4] is None) == (status == rcore.CONFLICT)


def _merge_graph(pkg, root, names_layers, base=None):
    c = pkg.core
    g = c.LineageGraph(path=root, store=pkg.store(root))
    base = base if base is not None else branch_model(c)
    g.add_node(base, "base")
    for name, layer in names_layers:
        g.add_node(edit(base, layer), name)
        g.add_edge("base", name)
    return g


def test_graph_level_merges_match_reference(tmp_path):
    """No common ancestor, an explicit ancestor, and a merge that inserts
    its node: outcomes, the inserted node's edges and every artifact ref."""
    def run(pkg, root):
        c = pkg.core
        islands = c.LineageGraph(path=root + "-islands",
                                 store=pkg.store(root + "-islands"))
        islands.add_node(branch_model(c, seed=0), "island1")
        islands.add_node(branch_model(c, seed=1), "island2")
        r0 = c.merge(islands, "island1", "island2")
        g = _merge_graph(pkg, root, [("u1", "b1"), ("u2", "b2"),
                                     ("user1", "b1"), ("user2", "b2")])
        r1 = g.merge("u1", "u2", ancestor="base")
        r2 = c.merge(g, "user1", "user2")
        return ([(r.status, r.detail, hashes_of(r.merged))
                 for r in (r0, r1, r2)],
                graph_state(islands), graph_state(g))
    ref, port = both(run, tmp_path)
    assert port == ref
    (s0, s1, s2), _, state = port
    assert s0[0] == rcore.CONFLICT and "no common ancestor" in s0[1]
    assert s1[0] in (rcore.NO_CONFLICT, rcore.POSSIBLE_CONFLICT)
    assert set(state["merge(user1,user2)"]["parents"]) == {"user1", "user2"}
    assert state["merge(u1,u2)"]["artifact_ref"] is not None


# ---------------------------------------------------------------------------
# update cascade (tests/test_core_cascade.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["m", "m@v2", "m@v9", "exp@vfinal", "m@v",
                                  "a@v1@v7", "m@v99", "m@v007", "v2",
                                  "user@host", "m@v-1"])
def test_next_version_name_matches_reference(name):
    assert tcore.next_version_name(name) == rcore.next_version_name(name)


def _cascade_graph(pkg, root, n_children=3, cr="Finetune", configs=None):
    """mlm with children task0..; each built by its creation function."""
    c = pkg.core
    g = c.LineageGraph(path=root, store=pkg.store(root))
    base = make_chain_model(c, seed=0)
    g.add_node(base, "mlm")
    for i in range(n_children):
        config = (configs or [{}] * n_children)[i]
        fn = getattr(pkg.cr, cr)(seed=100 + i, **config)
        g.add_node(finetune_like(base, seed=50 + i), f"task{i}", cr=fn)
        g.add_edge("mlm", f"task{i}")
    return g


def _update_root(g, seed=999, scale=1e-3):
    g.add_node(finetune_like(g.get_model("mlm"), seed=seed, scale=scale),
               "mlm@v2")


CASCADE_CASES = {}


def cascade_case(fn):
    CASCADE_CASES[fn.__name__] = fn
    return fn


@cascade_case
def creates_new_versions(pkg, root):
    g = _cascade_graph(pkg, root)
    _update_root(g)
    created = pkg.core.run_update_cascade(g, "mlm", "mlm@v2")
    assert sorted(created) == ["task0@v2", "task1@v2", "task2@v2"]
    return created, g


@cascade_case
def never_overwrites(pkg, root):
    g = _cascade_graph(pkg, root)
    before = g.nodes["task0"].artifact_ref
    _update_root(g, seed=5, scale=5e-5)
    created = pkg.core.run_update_cascade(g, "mlm", "mlm@v2")
    assert g.nodes["task0"].artifact_ref == before
    return created, g


@cascade_case
def skip_fn(pkg, root):
    g = _cascade_graph(pkg, root)
    _update_root(g, seed=5, scale=5e-5)
    created = pkg.core.run_update_cascade(
        g, "mlm", "mlm@v2", skip_fn=lambda n: n.name == "task1")
    assert "task1@v2" not in created and "task0@v2" in created
    return created, g


@cascade_case
def multi_level(pkg, root):
    g = _cascade_graph(pkg, root, n_children=1)
    fn = pkg.cr.Finetune(seed=500)
    g.add_node(fn([g.nodes["task0"]]), "distilled", cr=fn)
    g.add_edge("task0", "distilled")
    _update_root(g, seed=5, scale=5e-5)
    created = pkg.core.run_update_cascade(g, "mlm", "mlm@v2")
    assert g.nodes["distilled@v2"].parents == ["task0@v2"]
    return created, g


@cascade_case
def rolls_back_unmaterialized_nodes(pkg, root):
    g = _cascade_graph(pkg, root, cr="Boom",
                       configs=[{"boom": False}, {"boom": True},
                                {"boom": False}])
    _update_root(g)
    with pytest.raises(RuntimeError, match="creation failed"):
        pkg.core.run_update_cascade(g, "mlm", "mlm@v2")
    assert "task1@v2" not in g.nodes
    for node in g.nodes.values():
        for ref in node.children + node.version_children + node.parents:
            assert ref in g.nodes
    survivors = graph_state(pkg.core.LineageGraph(path=root,
                                                  store=pkg.store(root)))
    assert survivors == graph_state(g)
    g.nodes["task1"].creation_fn = pkg.cr.Boom(seed=101, boom=False)
    created = pkg.core.run_update_cascade(g, "mlm", "mlm@v2")
    assert "task1@v2" in g.nodes
    return (survivors, created), g


@cascade_case
def resume_rewires_to_new_parent_versions(pkg, root):
    c = pkg.core
    g = c.LineageGraph(path=root, store=pkg.store(root))
    base = make_chain_model(c, seed=0)
    g.add_node(base, "mlm")
    a_cr = pkg.cr.Boom(seed=1, boom=False)
    g.add_node(a_cr([g.nodes["mlm"]]), "a", cr=a_cr)
    g.add_edge("mlm", "a")
    g.add_node(finetune_like(g.get_model("a"), seed=3), "b",
               cr=pkg.cr.Boom(seed=2, boom=True))
    g.add_edge("a", "b")
    g.add_node(finetune_like(base, seed=999), "mlm@v2")
    with pytest.raises(RuntimeError):
        c.run_update_cascade(g, "mlm", "mlm@v2")
    survivors = sorted(g.nodes)
    assert "a@v2" in g.nodes and "b@v2" not in g.nodes
    g.nodes["b"].creation_fn = pkg.cr.Boom(seed=2, boom=False)
    created = c.run_update_cascade(g, "mlm", "mlm@v2")
    assert g.nodes["b@v2"].parents == ["a@v2"]
    return (survivors, created), g


@cascade_case
def rollback_with_store_keeps_store_consistent(pkg, root):
    c = pkg.core
    g = c.LineageGraph(path=root, store=pkg.store(root))
    base = make_chain_model(c, seed=0)
    g.add_node(base, "mlm")
    g.add_node(finetune_like(base, seed=50), "task0",
               cr=pkg.cr.Boom(seed=1, boom=True))
    g.add_edge("mlm", "task0")
    g.add_node(finetune_like(base, seed=999), "mlm@v2")
    with pytest.raises(RuntimeError):
        c.run_update_cascade(g, "mlm", "mlm@v2")
    assert "task0@v2" not in g.nodes
    roots = [n.artifact_ref for n in g.nodes.values() if n.artifact_ref]
    assert g.store.fsck(roots)["ok"]
    return sorted(g.nodes), g


@cascade_case
def gate_quarantines_regressions(pkg, root):
    def flag_test(model):
        return float("nan") if model.metadata.get("broken") else 1.0

    g = _cascade_graph(pkg, root, n_children=2, cr="Regress",
                       configs=[{"regress": False}, {"regress": True}])
    g.register_test_function(flag_test, "probe/flag", mt="toy")
    _update_root(g)
    gate = pkg.diag.TestGate(graph=g)
    created = pkg.core.run_update_cascade(g, "mlm", "mlm@v2", gate=gate)
    assert pkg.diag.is_quarantined(g.nodes["task1@v2"])
    assert not pkg.diag.is_quarantined(g.nodes["task0@v2"])
    report = [{k: v for k, v in row.items() if k != "regressions"}
              for row in pkg.diag.gate_report(g)]
    decisions = [(d.node, d.passed, d.quarantined,
                  [(r.test, r.kind, r.baseline_node) for r in d.regressions])
                 for d in gate.decisions]
    return (created, report, decisions), g


@cascade_case
def mtl_group(pkg, root):
    c = pkg.core
    g = c.LineageGraph(path=root, store=pkg.store(root))
    base = make_chain_model(c, seed=0)
    g.add_node(base, "mlm")
    for i in range(2):
        fn = pkg.cr.MTL(seed=100 + i)
        fn.mtl_group = "glue"
        g.add_node(fn([g.nodes["mlm"]]), f"mtl{i}", cr=fn)
        g.add_edge("mlm", f"mtl{i}")
    g.add_node(finetune_like(base, seed=9), "mlm@v2")
    created = c.run_update_cascade(g, "mlm", "mlm@v2")
    m0, m1 = g.get_model("mtl0@v2"), g.get_model("mtl1@v2")
    for k in m0.params:
        if not k.startswith("head"):
            np.testing.assert_array_equal(np.asarray(m0.params[k]),
                                          np.asarray(m1.params[k]))
    return sorted(created), g


@pytest.mark.parametrize("case", sorted(CASCADE_CASES))
def test_cascade_matches_reference(case, tmp_path):
    """Each case's new names, edges, artifact refs and, for the rollbacks,
    the surviving nodes are equal in the two packages; a fresh store of
    each package checks every stored model out bit for bit alike."""
    def run(pkg, root):
        result, g = CASCADE_CASES[case](pkg, root)
        fresh = pkg.store(root)
        models = {n.name: {k: np.asarray(v).tobytes() for k, v in
                           fresh.materialize_artifact(n.artifact_ref)
                           .params.items()}
                  for n in g.nodes.values() if n.artifact_ref}
        return result, graph_state(g), models
    ref, port = both(run, tmp_path)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]


def test_top_level_keys_are_invisible_to_contextual_hashes_as_in_reference():
    """A reference behaviour the port keeps: ``state_graph`` names a key
    without a "/" (``lm_head``, ``final_norm``) as layer ``lm_head`` with
    param ``value``, while ``param_hashes`` attaches its hash by
    ``split_key`` to layer "" — so neither package's contextual diff or
    merge sees an edit of such a key."""
    from repro.store.checkpoint import state_graph as ref_state_graph

    from repro_torch.models.graph import state_graph

    rng = np.random.default_rng(9)
    flat = {"layers/w": rng.normal(size=(2, 4, 4)).astype(np.float32),
            "lm_head": rng.normal(size=(4, 8)).astype(np.float32)}
    edited = dict(flat, lm_head=flat["lm_head"] + 1.0)
    out = []
    for core, graph_of in ((rcore, ref_state_graph), (tcore, state_graph)):
        a = core.ModelArtifact(graph_of(flat, "m"), dict(flat), model_type="m")
        b = core.ModelArtifact(graph_of(edited, "m"), dict(edited),
                               model_type="m")
        d = core.module_diff(a, b, mode="contextual")
        merged = core.merge_artifacts(a, b, a)
        out.append((d.identical, merged.status,
                    np.asarray(merged.merged.params["lm_head"]).tobytes()))
    assert out[0] == out[1]
    identical, status, lm_head = out[1]
    assert identical and status == rcore.NO_CONFLICT
    assert lm_head == flat["lm_head"].tobytes()   # the edit is lost


def test_refused_recompress_keeps_refcounts_exact(tmp_path):
    """``add_node`` then ``add_edge`` re-commits the node against its new
    parent; when the delta is refused (here a registered test moves by
    more than ``t_thr``) the re-commit stores the same full manifest. The
    reference keeps the second reference it took, so its fsck reports
    refcount drift; the port gives it back. Refs and checkouts agree."""
    def sensitive(model):
        return float(np.abs(np.asarray(model.params["L0/w"],
                                       np.float64)).sum() * 1e6)

    def run(pkg, root):
        c = pkg.core
        g = c.LineageGraph(path=root, store=pkg.store(root))
        base = make_chain_model(c, seed=0)
        g.add_node(base, "base")
        g.register_test_function(sensitive, "probe/sensitive", mt="toy")
        g.add_node(finetune_like(base, seed=1, scale=1e-3, density=1.0),
                   "child")
        full = g.nodes["child"].artifact_ref
        g.add_edge("base", "child")
        refs = [n.artifact_ref for n in g.nodes.values()]
        return full, graph_state(g), g.store.fsck(refs)
    ref, port = both(run, tmp_path)
    assert port[:2] == ref[:2]
    assert port[1]["child"]["artifact_ref"] == port[0]   # stayed full
    assert not ref[2]["ok"] and len(ref[2]["refcount_drift"]) > 0
    assert port[2]["ok"], port[2]["refcount_drift"]
