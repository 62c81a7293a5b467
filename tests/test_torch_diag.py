"""The port's diagnostics engine against the reference package, on the CPU.

Each case of ``tests/test_diag.py`` runs in both packages on the same toy
lineages (built from the same numpy seeds, committed through a
``backend="ref"`` store in the port), with the same test functions. Test
identity hashes, ``t_`` ledger keys and records, memo hits, blame
verdicts, gate decisions and ``gate_report`` rows must be equal, and the
port's ``fsck`` must be clean with ledger entries in its CAS. The two
cases of ``tests/test_diag.py`` that push to a remote push through each
package's own remote sync (the port's directory transport and clone on a
``backend="ref"`` store) and must select, skip and publish the same nodes.
"""

import json
import types

import numpy as np
import pytest

import repro.core as rcore
import repro.diag as rdiag
import repro.remote as rremote
from repro.store import ArtifactStore as RefStore
from repro.store.cas import ledger_key as ref_ledger_key

import repro_torch.core as tcore
import repro_torch.diag as tdiag
import repro_torch.remote as tremote
from repro_torch.store import ArtifactStore as PortStore
from repro_torch.store.cas import ledger_key

from helpers import finetune_like, l2_test
from torch_helpers import make_chain_model

REF = types.SimpleNamespace(name="ref", core=rcore, diag=rdiag,
                            store=lambda root: RefStore(root=root),
                            remote=rremote, local=rremote.LocalTransport,
                            clone=rremote.clone)
PORT = types.SimpleNamespace(name="port", core=tcore, diag=tdiag,
                             store=lambda root: PortStore(root=root,
                                                          backend="ref"),
                             remote=tremote,
                             local=lambda url: tremote.LocalTransport(
                                 url, backend="ref"),
                             clone=lambda url, dest: tremote.clone(
                                 url, dest, backend="ref"))


def broken_flag_test(model) -> float:
    return float("nan") if model.metadata.get("broken") else 1.0


def both(case, tmp_path):
    return [case(pkg, str(tmp_path / pkg.name)) for pkg in (REF, PORT)]


def canon(x) -> str:
    """``x`` as sorted JSON, so that NaN metrics compare equal."""
    return json.dumps(x, sort_keys=True, default=repr)


def result_of(r):
    """A TestResult without its wall time."""
    return (r.test, r.node, r.value, r.passed, r.cached, r.error,
            r.transferred, r.key)


def report_of(report):
    return {"executed": report.executed, "memo_hits": report.memo_hits,
            "results": {n: {t: result_of(r) for t, r in sorted(res.items())}
                        for n, res in sorted(report.results.items())}}


def ledger_of(store):
    """{t_ key: record without its wall time} of every ledger entry."""
    out = {}
    for key in sorted(k for k in store.cas.keys() if k.startswith("t_")):
        record = json.loads(store.cas.get_bytes(key))
        record.pop("duration_s")
        out[key] = record
    return out


def chain_repo(pkg, root):
    """test_diag.py's fixture: base -> mid -> leaf, store-backed."""
    g = pkg.core.LineageGraph(path=root, store=pkg.store(root))
    base = make_chain_model(pkg.core, seed=0)
    g.add_node(base, "base")
    g.add_edge("base", "mid")
    g.add_node(finetune_like(base, seed=1), "mid")
    g.add_edge("mid", "leaf")
    g.add_node(finetune_like(g.get_model("mid"), seed=2), "leaf")
    g.register_test_function(l2_test, "probe/l2", mt="toy")
    return g


def poisoned_repo(pkg, root, poison_at):
    g = pkg.core.LineageGraph(path=root, store=pkg.store(root))
    base = make_chain_model(pkg.core, seed=0)
    if poison_at == "base":
        base.metadata["broken"] = True
    g.add_node(base, "base")
    mid = finetune_like(base, seed=1)
    mid.metadata.update(base.metadata)
    if poison_at == "mid":
        mid.metadata["broken"] = True
    g.add_edge("base", "mid")
    g.add_node(mid, "mid")
    leaf = finetune_like(mid, seed=2)
    leaf.metadata.update(mid.metadata)
    g.add_edge("mid", "leaf")
    g.add_node(leaf, "leaf")
    g.register_test_function(broken_flag_test, "probe/flag", mt="toy")
    return g


def blame_of(report):
    return {"status": report.status, "frontier": report.frontier,
            "entries": {n: (e.status, e.value, e.passed, e.inherited_from)
                        for n, e in sorted(report.entries.items())}}


# ---------------------------------------------------------------------------
# identity hashes and the ledger
# ---------------------------------------------------------------------------


def _probe_with_comprehension(m):
    return sum(v for v in [1.0, 2.0]) + (lambda x: x)(0.0)


@pytest.mark.parametrize("fn, scope", [(l2_test, None),
                                       (broken_flag_test, None),
                                       (_probe_with_comprehension, "head")],
                         ids=["l2", "flag", "scoped-comprehension"])
def test_identity_hash_and_ledger_key_equal_reference(fn, scope):
    ref_t = rcore.RegisteredTest(name="p", fn=fn, scope=scope)
    port_t = tcore.RegisteredTest(name="p", fn=fn, scope=scope)
    th = tdiag.test_identity_hash(port_t)
    assert th == rdiag.test_identity_hash(ref_t)
    assert ledger_key(th, "m_abc") == ref_ledger_key(th, "m_abc")
    assert ledger_key(th, "m_abc").startswith("t_")


def test_identity_hash_stable_across_recompilation():
    src = ("def probe(m):\n"
           "    return sum(v for v in [1.0, 2.0]) + (lambda x: x)(0.0)\n")
    ns1, ns2 = {}, {}
    exec(src, ns1)
    exec(src, ns2)
    h1 = tdiag.test_identity_hash(tcore.RegisteredTest(name="p",
                                                       fn=ns1["probe"]))
    h2 = tdiag.test_identity_hash(tcore.RegisteredTest(name="p",
                                                       fn=ns2["probe"]))
    assert h1 == h2 == rdiag.test_identity_hash(
        rcore.RegisteredTest(name="p", fn=ns1["probe"]))


def test_cold_then_warm_runs_and_ledger_match_reference(tmp_path):
    """Cold run, warm run from a fresh graph and store (no tensor
    materialized), the ledger's keys and records, and the port's fsck."""
    def run(pkg, root):
        g = chain_repo(pkg, root)
        cold = pkg.diag.DiagnosticsRunner(g).run()
        g2 = pkg.core.LineageGraph(path=root, store=pkg.store(root))
        g2.register_test_function(l2_test, "probe/l2", mt="toy")
        g2.store.reset_io_stats()
        g2.store.cache.clear()
        warm = pkg.diag.DiagnosticsRunner(g2).run()
        assert g2.store.io_stats["tensors_materialized"] == 0
        assert g2.store.io_stats["plans_resolved"] == 0
        roots = [n.artifact_ref for n in g.nodes.values() if n.artifact_ref]
        assert g.store.fsck(roots)["ok"]
        key = ledger_key(pkg.diag.test_identity_hash(g.tests[0]),
                         g.nodes["base"].artifact_ref)
        return (report_of(cold), report_of(warm), ledger_of(g.store),
                json.loads(g.store.cas.get_bytes(key))["node"])
    ref, port = both(run, tmp_path)
    assert canon(port) == canon(ref)
    cold, warm, ledger, node = port
    assert (cold["executed"], cold["memo_hits"]) == (3, 0)
    assert (warm["executed"], warm["memo_hits"]) == (0, 3)
    assert len(ledger) == 3 and node == "base"


def test_changed_test_and_forced_rerun_match_reference(tmp_path):
    def run(pkg, root):
        g = chain_repo(pkg, root)
        pkg.diag.DiagnosticsRunner(g).run()

        def l2_shifted(model):
            return l2_test(model) + 1.0

        g.tests[0].fn = l2_shifted
        rerun = pkg.diag.DiagnosticsRunner(g).run()
        state = {"v": 1.0}
        g.register_test_function(lambda m: state["v"], "probe/ambient",
                                 mt="toy")
        first = pkg.diag.DiagnosticsRunner(g).run(pattern="ambient")
        state["v"] = 2.0
        forced = pkg.diag.DiagnosticsRunner(g).run(pattern="ambient",
                                                   force=True)
        g2 = pkg.core.LineageGraph(path=root, store=pkg.store(root))
        g2.register_test_function(lambda m: state["v"], "probe/ambient",
                                  mt="toy")
        again = pkg.diag.DiagnosticsRunner(g2).run()
        roots = [n.artifact_ref for n in g2.nodes.values() if n.artifact_ref]
        assert g2.store.fsck(roots)["ok"]
        return [report_of(r) for r in (rerun, first, forced, again)]
    ref, port = both(run, tmp_path)
    assert canon(port) == canon(ref)
    rerun, _, forced, again = port
    assert (rerun["executed"], rerun["memo_hits"]) == (3, 0)
    assert again["executed"] == 0
    assert again["results"]["base"]["probe/ambient"][2] == 2.0
    assert forced["results"]["base"]["probe/ambient"][2] == 2.0


def test_raising_test_is_a_recorded_failure_as_in_reference(tmp_path):
    """The reference's ``_evaluate`` records a test that raised as a failed
    result with its error, memoizes it, and a gate reads it as a new
    failure: the port keeps that behaviour."""
    def run(pkg, root):
        g = chain_repo(pkg, root)
        g.add_node(finetune_like(g.get_model("leaf"), seed=3), "leaf@v2")
        g.add_version_edge("leaf", "leaf@v2")

        def boom(model):
            raise RuntimeError("bad probe")

        g.tests = []
        g.register_test_function(boom, "probe/boom", mt="toy")
        r1 = pkg.diag.DiagnosticsRunner(g).run(nodes=[
            g.nodes[n] for n in ("base", "mid", "leaf")])
        r2 = pkg.diag.DiagnosticsRunner(g).run()
        decision = pkg.diag.TestGate(graph=g).apply("leaf@v2")
        return (report_of(r1), report_of(r2), ledger_of(g.store),
                [(r.kind, r.error) for r in decision.regressions],
                decision.quarantined)
    ref, port = both(run, tmp_path)
    assert canon(port) == canon(ref)
    r1, r2, _, regressions, quarantined = port
    errors = [res["probe/boom"][5] for res in r1["results"].values()]
    assert len(errors) == 3 and all("bad probe" in e for e in errors)
    assert (r2["executed"], r2["memo_hits"]) == (1, 3)
    # the baseline failed as well, so the node's failure is inherited
    assert regressions == [] and not quarantined


def test_run_pattern_modes_match_reference(tmp_path):
    def run(pkg, root):
        g = chain_repo(pkg, root)
        g.register_test_function(lambda m: 1.0, "acc/top1", mt="toy")
        runner = pkg.diag.DiagnosticsRunner(g)
        return (report_of(runner.run(pattern="acc*", match="glob")),
                report_of(runner.run(pattern=r"probe/.*")))
    ref, port = both(run, tmp_path)
    assert canon(port) == canon(ref)
    glob_hits, rx_hits = port
    assert all(set(v) == {"acc/top1"} for v in glob_hits["results"].values())
    assert all(set(v) == {"probe/l2"} for v in rx_hits["results"].values())


def test_history_matches_reference(tmp_path):
    def run(pkg, root):
        g = chain_repo(pkg, root)
        g.add_node(finetune_like(g.get_model("leaf"), seed=4), "leaf@v2")
        g.add_version_edge("leaf", "leaf@v2")
        runner = pkg.diag.DiagnosticsRunner(g)
        runner.run()
        return [{k: v for k, v in rec.items() if k != "duration_s"}
                for rec in runner.history("leaf@v2", "probe/l2")]
    ref, port = both(run, tmp_path)
    assert canon(port) == canon(ref)
    assert [r["node"] for r in port] == ["leaf", "leaf@v2"]


# ---------------------------------------------------------------------------
# blame
# ---------------------------------------------------------------------------


def _blame_emergent(pkg, root):
    g = pkg.core.LineageGraph(path=root, store=pkg.store(root))
    p1 = make_chain_model(pkg.core, seed=3)
    g.add_node(p1, "p1")
    g.add_node(finetune_like(p1, seed=4), "p2")
    merged = finetune_like(p1, seed=5)
    merged.metadata["broken"] = True
    g.add_node(merged, "merged")
    g.add_edge("p1", "merged")
    g.add_edge("p2", "merged")
    g.register_test_function(broken_flag_test, "probe/flag", mt="toy")
    return [blame_of(pkg.diag.blame(g, "merged", "probe/flag"))]


def _blame_version_edges(pkg, root):
    g = poisoned_repo(pkg, root, "base")
    v2 = finetune_like(g.get_model("leaf"), seed=9)
    v2.metadata["broken"] = True
    g.add_node(v2, "leaf@v2")
    g.add_version_edge("leaf", "leaf@v2")
    return [blame_of(pkg.diag.blame(g, "leaf@v2", "probe/flag"))]


def _blame_memoized(pkg, root):
    g = chain_repo(pkg, root)
    runner = pkg.diag.DiagnosticsRunner(g)
    runner.run()
    before = runner.stats["executed"]
    report = pkg.diag.blame(g, "leaf", "probe/l2", runner=runner)
    assert runner.stats["executed"] == before
    return [blame_of(report)]


BLAME_CASES = {
    "upstream_inherited": lambda pkg, root: [
        blame_of(pkg.diag.blame(g, n, "probe/flag"))
        for g in [poisoned_repo(pkg, root, "base")] for n in ("leaf", "mid")],
    "mid_chain_introduction": lambda pkg, root: [
        blame_of(pkg.diag.blame(poisoned_repo(pkg, root, "mid"), "leaf",
                                "probe/flag"))],
    "emergent_from_merge": _blame_emergent,
    "walks_version_edges": _blame_version_edges,
    "memoized": _blame_memoized,
}
BLAME_EXPECTED = {
    "upstream_inherited": ("inherited", ["base"]),
    "mid_chain_introduction": ("inherited", ["mid"]),
    "emergent_from_merge": ("emergent", ["merged"]),
    "walks_version_edges": ("inherited", ["base"]),
    "memoized": ("pass", []),
}


@pytest.mark.parametrize("case", sorted(BLAME_CASES))
def test_blame_matches_reference(case, tmp_path):
    ref, port = both(BLAME_CASES[case], tmp_path)
    assert canon(port) == canon(ref)
    assert (port[0]["status"], port[0]["frontier"]) == BLAME_EXPECTED[case]


# ---------------------------------------------------------------------------
# transfer and scoped keys
# ---------------------------------------------------------------------------


def test_scoped_keys_skip_unchanged_submodule_as_reference(tmp_path):
    def run(pkg, root):
        g = pkg.core.LineageGraph(path=root, store=pkg.store(root))
        g.add_node(make_chain_model(pkg.core, seed=0), "m@v1")
        stored = g.store.load_artifact(g.nodes["m@v1"].artifact_ref,
                                       lazy=False)
        v2 = finetune_like(stored, seed=1).replace_params(
            {"head/w": stored.params["head/w"]})
        g.add_node(v2, "m@v2")
        g.add_version_edge("m@v1", "m@v2")
        keys = [pkg.diag.scoped_content_key(g.nodes[n], s)
                for n in ("m@v1", "m@v2") for s in ("head", "hea", "L0")]
        hashes = pkg.diag.scoped_param_hashes(g.nodes["m@v2"], "L1")
        g.register_test_function(
            lambda m: float(np.linalg.norm(np.asarray(m.params["head/w"]))),
            "probe/head", mt="toy", scope="head")
        return keys, hashes, report_of(pkg.diag.DiagnosticsRunner(g).run())
    ref, port = both(run, tmp_path)
    assert canon(port) == canon(ref)
    keys, _, report = port
    assert keys[0] == keys[3] and keys[1] is None and keys[2] != keys[5]
    assert (report["executed"], report["memo_hits"]) == (1, 1)


def test_structural_transfer_matches_reference(tmp_path):
    def run(pkg, root):
        g = pkg.core.LineageGraph(path=root, store=pkg.store(root))
        a = make_chain_model(pkg.core, seed=0, model_type="typeA")
        b = finetune_like(a, seed=1)
        b.model_type = "typeB"
        g.add_node(a, "a")
        g.add_node(b, "b", model_type="typeB")
        c = make_chain_model(pkg.core, seed=2, n_layers=2, model_type="typeC")
        g.add_node(c, "c", model_type="typeC")
        g.register_test_function(l2_test, "probe/l2", mt="typeA")
        names = {n: [t.name for t in pkg.diag.transferable_tests(
            g, g.nodes[n])] for n in ("b", "c")}
        structure = pkg.diag.structure_of(g.nodes["b"]).to_json()
        plain = pkg.diag.DiagnosticsRunner(g).run()
        xfer = pkg.diag.DiagnosticsRunner(g, transfer=True).run()
        return names, structure, report_of(plain), report_of(xfer)
    ref, port = both(run, tmp_path)
    assert canon(port) == canon(ref)
    names, _, plain, xfer = port
    assert names == {"b": ["probe/l2"], "c": []}
    assert set(plain["results"]) == {"a"}
    assert set(xfer["results"]) == {"a", "b"}
    assert xfer["results"]["b"]["probe/l2"][6]   # transferred


# ---------------------------------------------------------------------------
# gate and quarantine
# ---------------------------------------------------------------------------


def _versions(pkg, root, meta1, meta2, store=True):
    g = pkg.core.LineageGraph(path=root,
                              store=pkg.store(root) if store else None)
    m1 = make_chain_model(pkg.core, seed=0)
    m1.metadata.update(meta1)
    g.add_node(m1, "m@v1")
    m2 = finetune_like(m1, seed=1)
    m2.metadata.update(meta2)
    g.add_node(m2, "m@v2")
    g.add_version_edge("m@v1", "m@v2")
    return g


def decision_of(d):
    return {"node": d.node, "passed": d.passed, "quarantined": d.quarantined,
            "regressions": [r.to_json() for r in d.regressions],
            "results": {t: result_of(r) for t, r in sorted(d.results.items())}}


def test_gate_quarantine_and_release_match_reference(tmp_path):
    def run(pkg, root):
        g = _versions(pkg, root, {}, {"broken": True})
        g.register_test_function(broken_flag_test, "probe/flag", mt="toy")
        gate = pkg.diag.TestGate(graph=g)
        decision = gate.apply("m@v2")
        quarantined = pkg.diag.is_quarantined(g.nodes["m@v2"])
        report = pkg.diag.gate_report(g)
        reloaded = pkg.core.LineageGraph(path=root, store=pkg.store(root))
        persisted = pkg.diag.gate_report(reloaded)
        pkg.diag.release_node(g, "m@v2")
        again = gate.check("m@v2")
        pkg.diag.quarantine_node(g, "m@v1", reason="manual")
        return (decision_of(decision), quarantined, report, persisted,
                pkg.diag.gate_report(g), decision_of(again),
                [{k: v for k, v in d.items() if k != "results"}
                 for d in gate.report()], ledger_of(g.store))
    ref, port = both(run, tmp_path)
    assert canon(port) == canon(ref)
    decision, quarantined, report, persisted, after, *_ = port
    assert decision["regressions"][0]["kind"] == "new_failure"
    assert quarantined and [r["node"] for r in report] == ["m@v2"]
    assert canon(persisted) == canon(report)
    assert after == [{"node": "m@v1", "reason": "manual"}]


@pytest.mark.parametrize("tol, passed", [(0.0, False), (0.1, True)])
def test_gate_metric_drop_and_tolerance_match_reference(tmp_path, tol,
                                                        passed):
    def run(pkg, root):
        g = _versions(pkg, root, {"score": 0.9}, {"score": 0.85},
                      store=False)
        g.register_test_function(lambda m: float(m.metadata["score"]),
                                 "probe/score", mt="toy")
        gate = pkg.diag.TestGate(graph=g, tol=tol, quarantine=False)
        return decision_of(gate.check("m@v2"))
    ref, port = both(run, tmp_path)
    for d in (ref, port):           # in-memory keys hash the params only
        assert d["results"]["probe/score"][7].startswith("t_")
    assert canon(port) == canon(ref)
    assert port["passed"] == passed
    if not passed:
        assert port["regressions"][0]["kind"] == "metric_drop"


def test_gate_inherited_failure_matches_reference(tmp_path):
    def run(pkg, root):
        g = _versions(pkg, root, {"broken": True}, {"broken": True},
                      store=False)
        g.register_test_function(broken_flag_test, "probe/flag", mt="toy")
        return decision_of(pkg.diag.TestGate(graph=g).check("m@v2"))
    ref, port = both(run, tmp_path)
    assert canon(port) == canon(ref)
    assert port["passed"]


def test_push_excludes_quarantined_nodes(tmp_path):
    def run(pkg, root):
        src = f"{root}/src"
        g = pkg.core.LineageGraph(path=src, store=pkg.store(src))
        base = make_chain_model(pkg.core, seed=0)
        g.add_node(base, "good")
        bad = finetune_like(base, seed=1)
        g.add_edge("good", "bad")
        g.add_node(bad, "bad")
        pkg.diag.quarantine_node(g, "bad", reason="manual")

        remote_dir = f"{root}/remote"
        report = pkg.remote.push(g, pkg.local(remote_dir))
        assert report.quarantined_skipped == ["bad"]
        assert "bad" not in report.selected_nodes

        dest = f"{root}/clone"
        pkg.clone(remote_dir, dest)
        g2 = pkg.core.LineageGraph(path=dest, store=pkg.store(dest))
        assert "good" in g2.nodes and "bad" not in g2.nodes
        assert g2.store.fsck([n.artifact_ref for n in g2.nodes.values()
                              if n.artifact_ref])["ok"]

        report2 = pkg.remote.push(g, pkg.local(remote_dir),
                                  include_quarantined=True)
        assert report2.quarantined_skipped == []
        assert "bad" in report2.selected_nodes
        return (report.to_json(), report2.to_json(),
                {n: g2.nodes[n].artifact_ref for n in sorted(g2.nodes)})
    ref, port = both(run, tmp_path)
    assert canon(port) == canon(ref)


def test_quarantine_after_push_does_not_delete_from_remote(tmp_path):
    """A node pushed earlier then quarantined reads as out of scope on the
    next push, not as a local deletion of the remote's copy."""
    def run(pkg, root):
        src = f"{root}/src"
        g = pkg.core.LineageGraph(path=src, store=pkg.store(src))
        base = make_chain_model(pkg.core, seed=0)
        g.add_node(base, "good")
        g.add_edge("good", "bad")
        g.add_node(finetune_like(base, seed=1), "bad")

        remote_dir = f"{root}/remote"
        transport = pkg.local(remote_dir)
        state = pkg.remote.RemoteState(src, "origin")
        pkg.remote.remote_add(src, "origin", remote_dir)
        first = pkg.remote.push(g, transport, state=state)
        assert set(first.selected_nodes) == {"good", "bad"}

        pkg.diag.quarantine_node(g, "bad", reason="regression found post-push")
        second = pkg.remote.push(g, transport, state=state)
        assert second.quarantined_skipped == ["bad"]
        remote_nodes = {n["name"] for n in transport.fetch_lineage()["nodes"]}
        assert remote_nodes == {"good", "bad"}
        third = pkg.remote.push(g, transport, state=state)
        assert {n["name"] for n in transport.fetch_lineage()["nodes"]} \
            == {"good", "bad"}
        assert third.published
        return ([r.to_json() for r in (first, second, third)],
                transport.fetch_lineage())
    ref, port = both(run, tmp_path)
    assert canon(port) == canon(ref)
