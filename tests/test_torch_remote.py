"""The port's remote sync engine against the reference package, on the CPU.

Each case of ``tests/test_remote_sync.py`` (but the CLI one, whose CLI is
not ported yet) runs in both packages on the same toy lineages, built from
the same numpy seeds; the port's stores, clones and directory transports
open with ``backend="ref"``. Each case keeps the reference test's own
assertions, applied to both packages, and must give equal results in
both: sync reports (object counts and bytes, flattened refs, merge
statuses and details), lineage refs and edges, checkouts bit for bit,
``fsck`` reports and refcounts.

Beyond the mirror: ``fetch_param_shard`` of a chunked f32 and a chunked
bf16 leaf, a shallow push of a reduced bf16 qwen3-0.6b lineage (the
reference taught to read its own ``V2`` objects, in the test only, as in
``tests/test_torch_bf16.py``), the public names, and the port's one
behaviour of its own: a kernel error during a pull's auto-merge propagates
instead of reading as a merge conflict.
"""

import dataclasses
import hashlib
import json
import os

import ml_dtypes
import numpy as np
import pytest

import repro.store.cas as ref_cas_module
import repro.store.chunks as ref_chunks
from repro.models import get_config as ref_get_config
from repro.models.model import param_shapes as ref_param_shapes
from repro.store.checkpoint import state_graph

import repro_torch.convert as convert
from repro_torch.common import bf16
from repro_torch.common import faults as port_faults
from repro_torch.kernels import ops
from repro_torch.kernels.build import KernelError
from repro_torch.store import ArtifactStore as PortStore

from helpers import finetune_like
from torch_harness import PORT, REF
from torch_helpers import make_chain_model

BF16 = ml_dtypes.bfloat16


@pytest.fixture(autouse=True)
def _disarm_port_kill_points():
    yield
    port_faults.disarm_all()


def both(case, tmp_path):
    """``case(pkg, root)`` in each package, each in a directory of its own;
    returns the two results."""
    return [case(pkg, str(tmp_path / pkg.name)) for pkg in (REF, PORT)]


def _repo(pkg, path, **store_kw):
    path = str(path)
    return pkg.core.LineageGraph(path=path, store=pkg.store(path, **store_kw))


def _seed_repo(pkg, path):
    """base -> ft chain with a version edge (delta-compressed storage)."""
    g = _repo(pkg, path)
    base = make_chain_model(pkg.core, seed=0, d=32)
    g.add_node(base, "m@v1")
    g.add_edge("m@v1", "m@v2")
    g.add_node(finetune_like(base, seed=1), "m@v2")
    g.add_version_edge("m@v1", "m@v2")
    return g


def _stored(g, name):
    return g.store.load_artifact(g.nodes[name].artifact_ref)


def _roots(g):
    return [n.artifact_ref for n in g.nodes.values() if n.artifact_ref]


def _bits(g, names=None):
    """{node: {key: (dtype, shape, sha256 of the stored bytes)}}."""
    out = {}
    for name in sorted(names or g.nodes):
        art = _stored(g, name)
        out[name] = {}
        for k in sorted(art.params):
            v = np.ascontiguousarray(np.asarray(art.params[k]))
            out[name][k] = (bf16.dtype_name(v) if v.dtype.kind == "u"
                            else str(v.dtype), v.shape,
                            hashlib.sha256(v.view(np.uint8)).hexdigest())
    return out


def _assert_bit_identical(g1, g2, names=None):
    assert _bits(g1, names) == _bits(g2, names)


def _graph(g):
    """Node names, edges and artifact refs of a lineage."""
    return {name: (n.parents, n.children, n.version_parents,
                   n.version_children, n.artifact_ref)
            for name, n in sorted(g.nodes.items())}


def _report(rep):
    """A SyncReport as plain data, without its backoff seconds."""
    out = rep.to_json()
    out.pop("transport_backoff_s")
    return out


def _fsck(store, roots):
    r = store.fsck(roots)
    return {k: r[k] for k in ("ok", "corrupt", "missing_objects",
                              "refcount_drift", "dangling_refs")}


def _state(pkg, g, name="origin"):
    return pkg.remote.RemoteState(g.path, name)


# ---------------------------------------------------------------------------
# Round trip + negotiation dedup
# ---------------------------------------------------------------------------


def test_push_clone_roundtrip_bit_identical(tmp_path):
    def case(pkg, root):
        g = _seed_repo(pkg, f"{root}/src")
        rep = pkg.remote.push(g, pkg.local(f"{root}/remote"),
                              state=_state(pkg, g))
        assert rep.published and \
            rep.objects_transferred == rep.objects_total > 0
        cl = pkg.clone(f"{root}/remote", f"{root}/dst")
        g2 = _repo(pkg, f"{root}/dst")
        assert sorted(g2.nodes) == sorted(g.nodes)
        for name in g.nodes:
            assert g2.nodes[name].artifact_ref == g.nodes[name].artifact_ref
        assert g2.nodes["m@v2"].parents == ["m@v1"]
        assert g2.nodes["m@v1"].version_children == ["m@v2"]
        _assert_bit_identical(g, g2)
        assert g.store.fsck(_roots(g))["ok"]
        assert g2.store.fsck(_roots(g2))["ok"]
        return {"push": _report(rep), "clone": _report(cl),
                "graph": _graph(g2), "bits": _bits(g2),
                "fsck": _fsck(g2.store, _roots(g2)),
                "refcounts": dict(g2.store.cas.refcounts)}
    ref, port = both(case, tmp_path)
    assert port == ref


def test_second_push_transfers_zero_objects(tmp_path):
    def case(pkg, root):
        g = _seed_repo(pkg, f"{root}/src")
        remote = pkg.local(f"{root}/remote")
        first = pkg.remote.push(g, remote, state=_state(pkg, g))
        rep = pkg.remote.push(g, remote, state=_state(pkg, g))
        assert rep.objects_transferred == 0
        assert rep.bytes_transferred == 0
        assert rep.dedup_ratio == 1.0
        return _report(first), _report(rep)
    ref, port = both(case, tmp_path)
    assert port == ref


def test_incremental_push_transfers_only_new_objects(tmp_path):
    def case(pkg, root):
        g = _seed_repo(pkg, f"{root}/src")
        remote = pkg.local(f"{root}/remote")
        pkg.remote.push(g, remote, state=_state(pkg, g))
        g.add_edge("m@v2", "m@v3")
        g.add_node(finetune_like(_stored(g, "m@v2"), seed=3), "m@v3")
        rep = pkg.remote.push(g, remote, state=_state(pkg, g))
        assert 0 < rep.objects_transferred < rep.objects_total
        g2 = _repo(pkg, f"{root}/dst")
        pulled = pkg.remote.pull(g2, remote)
        _assert_bit_identical(g, g2)
        return _report(rep), _report(pulled), _graph(g2), _bits(g2)
    ref, port = both(case, tmp_path)
    assert port == ref


def test_pull_into_fresh_repo_equals_clone(tmp_path):
    def case(pkg, root):
        g = _seed_repo(pkg, f"{root}/src")
        remote = pkg.local(f"{root}/remote")
        pkg.remote.push(g, remote)
        g2 = _repo(pkg, f"{root}/dst")
        rep = pkg.remote.pull(g2, remote)
        assert rep.merge.status == pkg.core.NO_CONFLICT
        assert sorted(g2.nodes) == sorted(g.nodes)
        _assert_bit_identical(g, g2)
        return _report(rep), _graph(g2), _bits(g2)
    ref, port = both(case, tmp_path)
    assert port == ref


# ---------------------------------------------------------------------------
# Shallow (filtered) sync + delta-chain awareness
# ---------------------------------------------------------------------------


def test_shallow_clone_filters_nodes_but_completes_chains(tmp_path):
    def case(pkg, root):
        g = _seed_repo(pkg, f"{root}/src")
        pkg.remote.push(g, pkg.local(f"{root}/remote"))
        rep = pkg.clone(f"{root}/remote", f"{root}/dst", filter="m@v2")
        g2 = _repo(pkg, f"{root}/dst")
        assert sorted(g2.nodes) == ["m@v2"]
        assert g2.nodes["m@v2"].parents == []
        _assert_bit_identical(g, g2, names=["m@v2"])
        assert g2.store.fsck(_roots(g2))["ok"]
        return (_report(rep), _graph(g2), _bits(g2),
                sorted(g2.store.cas.keys()))
    ref, port = both(case, tmp_path)
    assert port == ref


def test_shallow_push_flattens_when_base_missing(tmp_path):
    def case(pkg, root):
        g = _seed_repo(pkg, f"{root}/src")
        assert g.store.get_manifest(g.nodes["m@v2"].artifact_ref)["depth"] >= 1
        before = g.store.cas.object_count()
        rep = pkg.remote.push(g, pkg.local(f"{root}/remote"), filter="m@v2")
        assert rep.flattened
        gr = _repo(pkg, f"{root}/remote")
        manifest = gr.store.get_manifest(gr.nodes["m@v2"].artifact_ref)
        assert manifest["depth"] == 0
        assert all(e["kind"] == "full" for e in manifest["params"].values())
        _assert_bit_identical(g, gr, names=["m@v2"])
        assert g.store.cas.object_count() == before
        assert g.store.fsck(_roots(g))["ok"]
        return (_report(rep), _graph(gr), sorted(gr.store.cas.keys()),
                _fsck(gr.store, _roots(gr)))
    ref, port = both(case, tmp_path)
    assert port == ref


def test_shallow_push_prefers_delta_when_base_present(tmp_path):
    def case(pkg, root):
        g = _seed_repo(pkg, f"{root}/src")
        remote = f"{root}/remote"
        pkg.remote.push(g, pkg.local(remote), filter="m@v1")
        rep = pkg.remote.push(g, pkg.local(remote), filter="m@v2")
        assert rep.flattened == {}
        gr = _repo(pkg, remote)
        assert gr.nodes["m@v2"].artifact_ref == g.nodes["m@v2"].artifact_ref
        assert gr.store.get_manifest(
            gr.nodes["m@v2"].artifact_ref)["depth"] >= 1
        return _report(rep), _graph(gr)
    ref, port = both(case, tmp_path)
    assert port == ref


# ---------------------------------------------------------------------------
# Concurrent growth: three-way lineage merge on pull
# ---------------------------------------------------------------------------


def test_pull_merges_concurrently_grown_graphs(tmp_path):
    def case(pkg, root):
        g = _seed_repo(pkg, f"{root}/src")
        remote = pkg.local(f"{root}/remote")
        pkg.remote.push(g, remote, state=_state(pkg, g))
        pkg.clone(f"{root}/remote", f"{root}/dst")
        g2 = _repo(pkg, f"{root}/dst")

        g.add_edge("m@v2", "m@v3")
        g.add_node(finetune_like(_stored(g, "m@v2"), seed=7), "m@v3")
        pkg.remote.push(g, remote, state=_state(pkg, g))

        g2.add_edge("m@v1", "side")
        g2.add_node(finetune_like(_stored(g2, "m@v1"), seed=8), "side")
        rep = pkg.remote.pull(g2, pkg.local(f"{root}/remote"),
                              state=_state(pkg, g2))
        assert rep.merge.status == pkg.core.NO_CONFLICT
        assert sorted(g2.nodes) == ["m@v1", "m@v2", "m@v3", "side"]
        assert "side" in g2.nodes["m@v1"].children
        assert "m@v3" in g2.nodes["m@v2"].children
        g3 = pkg.core.LineageGraph(path=g2.path)
        assert sorted(g3.nodes) == sorted(g2.nodes)
        return _report(rep), _graph(g2), _bits(g2)
    ref, port = both(case, tmp_path)
    assert port == ref


def _clone_and_diverge_v1(pkg, root):
    """The two conflict cases' setup: the source force-pushes m@v1 with
    L0/w zeroed; the clone re-commits m@v1 with L0/w ones."""
    g = _seed_repo(pkg, f"{root}/src")
    remote = pkg.local(f"{root}/remote")
    pkg.remote.push(g, remote, state=_state(pkg, g))
    pkg.clone(f"{root}/remote", f"{root}/dst")
    g2 = _repo(pkg, f"{root}/dst")
    d = np.asarray(_stored(g, "m@v1").params["L0/w"]).shape[0]
    g.add_node(_stored(g, "m@v1").replace_params(
        {"L0/w": np.zeros((d, d), np.float32)}), "m@v1")
    pkg.remote.push(g, remote, state=_state(pkg, g), force=True)
    g2.add_node(_stored(g2, "m@v1").replace_params(
        {"L0/w": np.ones((d, d), np.float32)}), "m@v1")
    return g, g2


def test_pull_divergent_same_layer_is_conflict_keeps_local(tmp_path):
    def case(pkg, root):
        g, g2 = _clone_and_diverge_v1(pkg, root)
        local_ref = g2.nodes["m@v1"].artifact_ref
        rep = pkg.remote.pull(g2, pkg.local(f"{root}/remote"),
                              state=_state(pkg, g2))
        assert rep.merge.status == pkg.core.CONFLICT
        assert rep.merge.conflicts == ["m@v1"]
        assert g2.nodes["m@v1"].artifact_ref == local_ref
        return _report(rep), _graph(g2)
    ref, port = both(case, tmp_path)
    assert port == ref


def test_conflict_does_not_advance_base_so_push_still_refuses(tmp_path):
    def case(pkg, root):
        g, g2 = _clone_and_diverge_v1(pkg, root)
        remote_ref = g.nodes["m@v1"].artifact_ref
        rep = pkg.remote.pull(g2, pkg.local(f"{root}/remote"),
                              state=_state(pkg, g2))
        assert rep.merge.status == pkg.core.CONFLICT
        pushed = pkg.remote.push(g2, pkg.local(f"{root}/remote"),
                                 state=_state(pkg, g2))
        assert not pushed.published
        gr = _repo(pkg, f"{root}/remote")
        assert gr.nodes["m@v1"].artifact_ref == remote_ref
        return _report(rep), _report(pushed), _graph(gr)
    ref, port = both(case, tmp_path)
    assert port == ref


def test_pull_auto_merges_independent_model_edits(tmp_path):
    def case(pkg, root):
        core = pkg.core
        gph = core.LayerGraph()
        for n in ("stem", "head_a", "head_b"):
            gph.add_node(core.LayerNode(n, "linear",
                                        params={"w": ((8, 8), "float32")}))
        gph.add_edge("stem", "head_a")
        gph.add_edge("stem", "head_b")
        rng = np.random.default_rng(0)
        art = core.ModelArtifact(gph, {f"{n}/w": rng.normal(size=(8, 8)).astype(
            np.float32) for n in gph.nodes}, model_type="toy")

        g = _repo(pkg, f"{root}/src", delta_enabled=False)
        g.add_node(art, "model")
        remote = pkg.local(f"{root}/remote")
        pkg.remote.push(g, remote, state=_state(pkg, g))
        pkg.clone(f"{root}/remote", f"{root}/dst")
        g2 = _repo(pkg, f"{root}/dst", delta_enabled=False)

        a = _stored(g, "model")
        g.add_node(a.replace_params(
            {"head_a/w": np.asarray(a.params["head_a/w"]) + 1}), "model")
        pkg.remote.push(g, remote, state=_state(pkg, g))
        b = _stored(g2, "model")
        g2.add_node(b.replace_params(
            {"head_b/w": np.asarray(b.params["head_b/w"]) + 2}), "model")

        rep = pkg.remote.pull(g2, pkg.local(f"{root}/remote"),
                              state=_state(pkg, g2))
        assert rep.merge.status == core.NO_CONFLICT
        merged = _stored(g2, "model")
        np.testing.assert_allclose(np.asarray(merged.params["head_a/w"]),
                                   np.asarray(a.params["head_a/w"]) + 1)
        np.testing.assert_allclose(np.asarray(merged.params["head_b/w"]),
                                   np.asarray(b.params["head_b/w"]) + 2)
        return _report(rep), _graph(g2), _bits(g2)
    ref, port = both(case, tmp_path)
    assert port == ref


def test_push_conflict_aborts_unless_forced(tmp_path):
    def case(pkg, root):
        g = _seed_repo(pkg, f"{root}/src")
        remote = pkg.local(f"{root}/remote")
        pkg.remote.push(g, remote, state=_state(pkg, g))

        other = _repo(pkg, f"{root}/other")
        pkg.remote.pull(other, remote, state=_state(pkg, other))
        other.add_node(finetune_like(_stored(other, "m@v1"), seed=42), "m@v1")
        pkg.remote.push(other, remote, state=_state(pkg, other))

        g.add_node(finetune_like(_stored(g, "m@v1"), seed=43), "m@v1")
        refused = pkg.remote.push(g, remote, state=_state(pkg, g))
        assert not refused.published and \
            refused.merge.status == pkg.core.CONFLICT
        forced = pkg.remote.push(g, remote, state=_state(pkg, g), force=True)
        assert forced.published
        gr = _repo(pkg, f"{root}/remote")
        assert gr.nodes["m@v1"].artifact_ref == g.nodes["m@v1"].artifact_ref
        return _report(refused), _report(forced), _graph(gr)
    ref, port = both(case, tmp_path)
    assert port == ref


def test_merge_lineage_edge_union_and_deletion():
    base = {"nodes": [
        {"name": "a", "parents": [], "children": ["b"], "artifact_ref": "r1"},
        {"name": "b", "parents": ["a"], "children": [], "artifact_ref": "r2"},
    ]}
    ours = {"nodes": [
        {"name": "a", "parents": [], "children": ["b", "c"],
         "artifact_ref": "r1"},
        {"name": "b", "parents": ["a"], "children": [], "artifact_ref": "r2"},
        {"name": "c", "parents": ["a"], "children": [], "artifact_ref": "r3"},
    ]}
    theirs = {"nodes": [
        {"name": "a", "parents": [], "children": ["d"], "artifact_ref": "r1"},
        {"name": "d", "parents": ["a"], "children": [], "artifact_ref": "r4"},
    ]}
    out = []
    for pkg in (REF, PORT):
        merged, report = pkg.remote.merge_lineage(
            json.loads(json.dumps(base)), json.loads(json.dumps(ours)),
            json.loads(json.dumps(theirs)))
        assert {n["name"] for n in merged["nodes"]} == {"a", "c", "d"}
        a = next(n for n in merged["nodes"] if n["name"] == "a")
        assert set(a["children"]) == {"c", "d"}
        assert report.status == pkg.core.NO_CONFLICT
        out.append((merged, report.to_json(),
                    [dataclasses.asdict(o) for o in report.outcomes]))
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# Interrupted transfer: journal + resume + consistency
# ---------------------------------------------------------------------------


def _flaky(pkg, url, fail_after=1):
    """``test_remote_sync.FlakyTransport`` over ``pkg``'s LocalTransport."""

    class FlakyTransport(type(pkg.local(url))):
        def __init__(self):
            super().__init__(url, **({} if pkg is REF else
                                     {"backend": "ref"}))
            self.writes = 0
            self.fail_after = fail_after

        def write_objects(self, objects):
            self.writes += 1
            if self.writes > self.fail_after:
                raise IOError("simulated network drop")
            super().write_objects(objects)
    return FlakyTransport()


def test_interrupted_push_leaves_remote_consistent_and_resumes(tmp_path):
    def case(pkg, root):
        g = _repo(pkg, f"{root}/src")
        g.add_node(make_chain_model(pkg.core, seed=0, d=48, n_layers=6),
                   "m@v1")
        remote_dir = f"{root}/remote"
        with pytest.raises(IOError):
            pkg.remote.push(g, _flaky(pkg, remote_dir, 1), chunk_size=3,
                            state=_state(pkg, g))
        assert not os.path.exists(os.path.join(remote_dir, "lineage.json"))
        journal_dir = os.path.join(remote_dir, "transfers")
        journals = sorted(os.listdir(journal_dir))
        assert len(journals) == 1
        rep = pkg.remote.push(g, pkg.local(remote_dir), chunk_size=3,
                              state=_state(pkg, g))
        assert rep.published
        assert rep.objects_transferred < rep.objects_total
        assert os.listdir(journal_dir) == []
        gr = _repo(pkg, remote_dir)
        assert gr.store.fsck(_roots(gr))["ok"]
        _assert_bit_identical(g, gr)
        return journals, rep.objects_total, rep.chunks_resumed, _graph(gr)
    ref, port = both(case, tmp_path)
    assert port == ref


def test_stale_journal_does_not_suppress_transfer(tmp_path):
    def case(pkg, root):
        g = _repo(pkg, f"{root}/src")
        g.add_node(make_chain_model(pkg.core, seed=1, d=32), "m@v1")
        remote_dir = f"{root}/remote"
        t = pkg.local(remote_dir)
        closure = pkg.negotiate.walk_manifests(
            pkg.sync._local_fetch(g.store), [g.nodes["m@v1"].artifact_ref])
        plan = pkg.negotiate.plan_transfer(closure, set())
        tid = pkg.remote.transfer_id(plan.order, "push")
        first = list(pkg.negotiate.chunked(plan.order, 3))[0]
        t.ensure_repo()
        t.journal_write(tid, {"done": [pkg.remote.chunk_id(first)],
                              "total": 0})
        rep = pkg.remote.push(g, t, chunk_size=3, state=_state(pkg, g))
        assert rep.chunks_resumed == 0
        assert rep.objects_transferred == rep.objects_total
        assert rep.published
        gr = _repo(pkg, remote_dir)
        assert gr.store.fsck(_roots(gr))["ok"]
        return tid, plan.order, _report(rep)
    ref, port = both(case, tmp_path)
    assert port == ref


def test_journal_resume_after_partial_transfer_matches_chunks(tmp_path):
    def case(pkg, root):
        g = _repo(pkg, f"{root}/src")
        g.add_node(make_chain_model(pkg.core, seed=0, d=48, n_layers=6),
                   "m@v1")
        remote_dir = f"{root}/remote"
        with pytest.raises(IOError):
            pkg.remote.push(g, _flaky(pkg, remote_dir, 2), chunk_size=3,
                            state=_state(pkg, g))
        t = pkg.local(remote_dir)
        tids = t.journal_list()
        assert len(tids) == 1
        done_before = set(t.journal_load(tids[0])["done"])
        assert done_before
        rep = pkg.remote.push(g, t, chunk_size=3, state=_state(pkg, g))
        assert rep.published
        assert rep.chunks_resumed == len(done_before)
        assert t.journal_list() == []
        return tids, rep.objects_total, len(done_before)
    ref, port = both(case, tmp_path)
    assert port == ref


# ---------------------------------------------------------------------------
# fsck
# ---------------------------------------------------------------------------


def test_fsck_detects_corruption_and_drift(tmp_path):
    def case(pkg, root):
        g = _seed_repo(pkg, f"{root}/src")
        roots = _roots(g)
        assert g.store.fsck(roots)["ok"]
        g.store.cas.pack_threshold = 16
        g.store.cas.put_bytes(np.random.default_rng(3).bytes(64))
        objdir = os.path.join(g.path, "objects")
        victim = sorted(os.listdir(objdir))[0]
        path = os.path.join(objdir, victim)
        blob = bytearray(open(path, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(blob))
        report = g.store.fsck(roots)
        assert not report["ok"] and victim in report["corrupt"]
        blob[len(blob) // 2] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(blob))
        assert g.store.fsck(roots)["ok"]

        key = next(iter(g.store.expected_refcounts(roots)))
        g.store.cas.refcounts[key] += 5
        drifted = g.store.fsck(roots)
        assert not drifted["ok"] and key in drifted["refcount_drift"]
        actual, expected = drifted["refcount_drift"][key]
        assert actual == expected + 5
        g.store.rebuild_refcounts(roots)
        assert g.store.fsck(roots)["ok"]
        return victim, report["corrupt"], drifted["refcount_drift"]
    ref, port = both(case, tmp_path)
    assert port == ref


def test_fsck_reports_dangling_refs(tmp_path):
    def case(pkg, root):
        g = _seed_repo(pkg, f"{root}/src")
        g.store.cas.refcounts["deadbeef" * 8] = 2
        report = g.store.cas.fsck()
        assert "deadbeef" * 8 in report["dangling_refs"]
        assert not report["ok"]
        return report["dangling_refs"]
    ref, port = both(case, tmp_path)
    assert port == ref


# ---------------------------------------------------------------------------
# Remote configuration + atomic lineage persistence
# ---------------------------------------------------------------------------


def test_remote_config_roundtrip(tmp_path):
    def case(pkg, root):
        remote = pkg.remote
        remote.remote_add(root, "origin", f"{root}/r1")
        remote.remote_add(root, "backup", f"{root}/r2")
        assert set(remote.remote_list(root)) == {"origin", "backup"}
        transport, name = remote.resolve_transport(root, "origin")
        assert name == "origin" and transport.url == f"{root}/r1"
        transport, name = remote.resolve_transport(root, f"{root}/elsewhere")
        assert name is None
        remote.remote_remove(root, "backup")
        assert set(remote.remote_list(root)) == {"origin"}
        return {k: os.path.relpath(v, root)
                for k, v in remote.remote_list(root).items()}
    ref, port = both(case, tmp_path)
    assert port == ref


def test_lineage_save_leaves_no_temp_and_survives_stale_tmp(tmp_path):
    def case(pkg, root):
        g = _seed_repo(pkg, root)
        meta = os.path.join(root, "lineage.json")
        assert os.path.exists(meta) and not os.path.exists(meta + ".tmp")
        with open(meta + ".tmp", "w") as f:
            f.write("{ torn json")
        g2 = pkg.core.LineageGraph(path=root)
        assert sorted(g2.nodes) == sorted(g.nodes)
        g2.save()
        assert not os.path.exists(meta + ".tmp")
        return json.load(open(meta))
    ref, port = both(case, tmp_path)
    assert port == ref


# ---------------------------------------------------------------------------
# Beyond the mirror
# ---------------------------------------------------------------------------


def test_public_names_match_reference():
    assert PORT.remote.__all__ == REF.remote.__all__
    assert PORT.hub.__all__ == REF.hub.__all__
    for name in REF.remote.__all__:
        assert hasattr(PORT.remote, name), name
    for name in ("CHUNK_OBJECTS", "needs_flatten", "walk_manifests",
                 "plan_transfer"):
        assert getattr(PORT.negotiate, name) is not None
    assert PORT.negotiate.CHUNK_OBJECTS == REF.negotiate.CHUNK_OBJECTS
    assert PORT.http.WIRE_REC_HEAD.format == REF.http.WIRE_REC_HEAD.format
    assert PORT.http.GZIP_FLOOR == REF.http.GZIP_FLOOR
    assert PORT.remote.ETAG_ABSENT == REF.remote.ETAG_ABSENT
    doc = {"nodes": [{"name": "x", "artifact_ref": "m_1"}]}
    assert PORT.remote.lineage_etag(doc) == REF.remote.lineage_etag(doc)


def test_unclassifiable_divergence_stays_a_conflict_as_in_reference(tmp_path):
    """Missing objects still read as a conflict, in both packages: only
    the kernel layer's errors leave the reference's classification."""
    def case(pkg, root):
        g = _seed_repo(pkg, root)
        refs = [g.nodes[n].artifact_ref for n in ("m@v1", "m@v2")]
        ref, status, detail = pkg.sync._classify_artifact_divergence(
            g.store, "m@v2", "m_" + "0" * 64, *refs)
        assert ref is None and status == pkg.core.CONFLICT
        return status, detail.split(":")[0]
    ref, port = both(case, tmp_path)
    assert port == ref


def _diverge_disjoint(pkg, root, node):
    """m@v1 -> m@v2 -> m@v3 pushed and cloned; then source and clone
    re-commit ``node`` on disjoint layers and the source pushes. A checkout
    of m@v2 applies one delta hop, of m@v3 folds two. Returns the clone's
    directory."""
    g = _repo(pkg, f"{root}/src")
    model = make_chain_model(pkg.core, seed=0, d=32)
    g.add_node(model, "m@v1")
    for i, (parent, child) in enumerate((("m@v1", "m@v2"),
                                         ("m@v2", "m@v3"))):
        model = finetune_like(model, seed=i + 1)
        g.add_edge(parent, child)
        g.add_node(model, child)
    remote = pkg.local(f"{root}/remote")
    pkg.remote.push(g, remote, state=_state(pkg, g))
    pkg.clone(f"{root}/remote", f"{root}/dst")
    g2 = _repo(pkg, f"{root}/dst")
    a = _stored(g, node)
    g.add_node(a.replace_params(
        {"L0/w": np.asarray(a.params["L0/w"]) + 1.0}), node)
    pkg.remote.push(g, remote, state=_state(pkg, g), force=True)
    b = _stored(g2, node)
    g2.add_node(b.replace_params(
        {"L1/w": np.asarray(b.params["L1/w"]) + 2.0}), node)
    return f"{root}/dst"


KERNELS = ("dequant_apply_flat", "chain_apply_flat", "snapshot_fused_flat")


@pytest.mark.parametrize("node, kernel", [
    ("m@v2", "dequant_apply_flat"),     # the checkouts the merge classifies
    ("m@v3", "chain_apply_flat"),
    ("m@v3", "snapshot_fused_flat"),    # the merged model's commit
])
def test_kernel_error_in_auto_merge_propagates_not_a_conflict(
        tmp_path, monkeypatch, node, kernel):
    """On the card's path (its device mapped to the CPU, as
    ``tests/test_torch_slice.py::device_path_on_cpu`` does), a pull that
    must auto-merge ``node`` runs the storage kernels: the healthy pull
    launches ``kernel`` and auto-merges; when ``kernel`` fails with the
    kernel layer's error, that error leaves ``pull`` and nothing is
    recorded. The reference reports any error of its checkouts there as a
    conflict; the port keeps that classification for missing objects and
    shape drift (the test above) only."""
    monkeypatch.setitem(ops._DEVICES, "cuda", "cpu")
    calls = {}
    for name in KERNELS:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)

    def on_card(path):
        return PORT.core.LineageGraph(path=path, store=PortStore(
            root=path, backend="cuda"))

    healthy = on_card(_diverge_disjoint(PORT, str(tmp_path / "healthy"),
                                        node))
    calls.clear()
    rep = PORT.remote.pull(healthy, PORT.local(str(tmp_path / "healthy"
                                                   / "remote")),
                           state=_state(PORT, healthy))
    assert rep.merge.status != PORT.core.CONFLICT
    assert any(o.detail.startswith("auto-merged models")
               for o in rep.merge.outcomes), rep.merge.to_json()
    assert calls.get(kernel, 0) > 0, calls

    failing = on_card(_diverge_disjoint(PORT, str(tmp_path / "failing"),
                                        node))
    local = failing.nodes[node].artifact_ref

    def broken(*a, **k):
        raise KernelError(f"mgit_{kernel}: CUDA error 700 (an illegal "
                          f"memory access was encountered)")
    monkeypatch.setattr(ops, kernel, broken)
    with pytest.raises(KernelError, match="CUDA error 700"):
        PORT.remote.pull(failing, PORT.local(str(tmp_path / "failing"
                                                 / "remote")),
                         state=_state(PORT, failing))
    assert on_card(failing.path).nodes[node].artifact_ref == local


# ---------------------------------------------------------------------------
# Shard-granular fetch and bf16 collaboration
# ---------------------------------------------------------------------------

# tests/test_chunks.py's small grid, so multi-chunk behaviour shows on
# test-sized tensors
CHUNK_KW = dict(chunk_threshold=64 * 1024, chunk_min=16 * 1024,
                chunk_avg=32 * 1024, chunk_max=64 * 1024)


@pytest.fixture
def ref_reads_bf16(monkeypatch):
    """The reference's CAS decodes a ``V2`` npy payload as ml_dtypes
    bfloat16 and its chunk source takes a bf16 array's bytes (in this test
    only; ``src/repro`` is not changed), as in ``tests/test_torch_bf16.py``."""
    stock = ref_cas_module._tensor_from_npy_view

    def shim(view):
        arr = stock(view)
        if arr is not None and arr.dtype.kind == "V" \
                and arr.dtype.itemsize == 2:
            arr = arr.view(BF16)
        return arr
    monkeypatch.setattr(ref_cas_module, "_tensor_from_npy_view", shim)
    stock_init = ref_chunks.ArraySource.__init__

    def byte_view(self, arr):
        arr = np.asarray(arr)
        stock_init(self, arr.view(np.uint8) if arr.dtype == BF16 else arr)
        self.shape, self.dtype = tuple(arr.shape), arr.dtype
    monkeypatch.setattr(ref_chunks.ArraySource, "__init__", byte_view)


def _big_artifact(pkg, dtype, seed=0, rows=256, cols=300):
    """``test_chunks.big_artifact`` in ``pkg``'s types: one (rows, cols)
    leaf ``big/w`` in float32 or bfloat16 (ml_dtypes in the reference,
    the carrier in the port)."""
    w = np.random.default_rng(seed).standard_normal((rows, cols)).astype(
        np.float32)
    if dtype == "bfloat16":
        w = w.astype(BF16)
        if pkg is PORT:
            w = convert.to_numpy(w)
    g = pkg.core.LayerGraph.chain([pkg.core.LayerNode(
        "big", "linear", params={"w": ((rows, cols), dtype)})])
    return pkg.core.ModelArtifact(g, {"big/w": w}), w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fetch_param_shard_matches_reference(tmp_path, ref_reads_bf16,
                                             dtype):
    """``test_chunks.test_fetch_param_shard_local`` in both packages, on a
    chunked f32 and a chunked bf16 leaf: each shard's bytes are the
    tensor's rows the placement rules give it, equal in both packages, and
    the consumer imports only the chunks that cover them."""
    def case(pkg, root):
        store = pkg.store(f"{root}/src", chunk_shards=4, **CHUNK_KW)
        g = pkg.core.LineageGraph(path=f"{root}/src", store=store)
        art, w = _big_artifact(pkg, dtype)
        g.add_node(art, "m")
        ref = g.nodes["m"].artifact_ref
        e = store.get_manifest(ref)["params"]["big/w"]
        assert e["kind"] == "chunked" and e["dtype"] == dtype
        t = pkg.local(str(store.cas.root))
        raw = np.ascontiguousarray(w).view(np.uint8).tobytes()
        row_bytes = w.shape[1] * w.dtype.itemsize
        shards, held = [], []
        for shard in range(4):
            consumer = pkg.store(f"{root}/host{shard}")
            got = pkg.sync.fetch_param_shard(consumer, t, ref, "big/w",
                                             shard, 4)
            rows = w.shape[0]
            start = (shard * rows) // 4 * row_bytes
            end = ((shard + 1) * rows) // 4 * row_bytes
            assert got == raw[start:end]
            chunks = json.loads(consumer.cas.get_bytes(ref))["params"][
                "big/w"]["chunks"]
            total_c = sum(1 for it in chunks if "c" in it)
            n = sum(1 for it in chunks
                    if "c" in it and consumer.cas.has(it["c"]))
            assert 0 < n < total_c
            shards.append(hashlib.sha256(got).hexdigest())
            held.append(n)
        with pytest.raises(ValueError):
            pkg.sync.fetch_param_shard(consumer, t, ref, "big/w", 4, 4)
        return ref, shards, held
    ref, port = both(case, tmp_path)
    assert port == ref


QWEN3_LAYERS = 2


def _qwen3_bf16_lineage():
    """{node: flat ml_dtypes bf16 params}: reduced qwen3-0.6b at
    ``QWEN3_LAYERS`` layers, base -> ft1 -> ft2, made with numpy from a
    seed as ``tests/test_torch_bf16.py::qwen3_bf16`` makes them."""
    cfg = dataclasses.replace(ref_get_config("qwen3-0.6b").reduced(),
                              dtype="bfloat16", n_layers=QWEN3_LAYERS)
    rng = np.random.default_rng(5)
    base = {}
    for k, shape in ref_param_shapes(cfg).items():
        if "norm" in k.split("/")[-1]:
            base[k] = rng.normal(scale=0.1, size=shape).astype(BF16)
        else:
            fan = shape[-2] if len(shape) >= 2 else shape[-1]
            base[k] = (rng.normal(size=shape) / np.sqrt(fan)).astype(BF16)

    def ft(params, scale):
        return {k: (v.astype(np.float32) + rng.normal(
            scale=scale, size=v.shape) * (rng.random(v.shape) < 0.3))
            .astype(BF16) for k, v in params.items()}
    ft1 = ft(base, 2e-2)
    return cfg.name, {"base": base, "ft1": ft1, "ft2": ft(ft1, 2e-2)}


def test_bf16_shallow_push_flattens_like_reference(tmp_path, ref_reads_bf16):
    """A reduced bf16 qwen3-0.6b lineage pushed shallow (``filter="ft2"``:
    its chain base stays behind) flattens ft2 to full bf16 tensors: the
    flattened manifest ref, the receiver's object keys and their bytes
    (npy ``'<V2'``) equal the reference's, and the flattened ft2 checks out
    bit for bit as the chained one."""
    arch, flats = _qwen3_bf16_lineage()

    def case(pkg, root):
        g = _repo(pkg, f"{root}/src", chunk_threshold=0)
        for parent, node in ((None, "base"), ("base", "ft1"),
                             ("ft1", "ft2")):
            p = flats[node]
            art = (REF.core.ModelArtifact(state_graph(p, arch), p,
                                          model_type=arch)
                   if pkg is REF else convert.to_artifact(
                       {k: convert.to_numpy(v) for k, v in p.items()}, arch))
            if parent is not None:
                g.add_node(None, node, model_type=arch)
                g.add_version_edge(parent, node)
            g.add_node(art, node)
        manifest = g.store.get_manifest(g.nodes["ft2"].artifact_ref)
        assert "delta" in {e["kind"] for e in manifest["params"].values()}
        rep = pkg.remote.push(g, pkg.local(f"{root}/remote"), filter="ft2")
        assert list(rep.flattened) == [g.nodes["ft2"].artifact_ref]
        gr = _repo(pkg, f"{root}/remote", chunk_threshold=0)
        flat = gr.store.get_manifest(gr.nodes["ft2"].artifact_ref)
        assert flat["depth"] == 0
        assert {(e["kind"], e["dtype"]) for e in flat["params"].values()} \
            == {("full", "bfloat16")}
        _assert_bit_identical(g, gr, names=["ft2"])
        report = gr.store.fsck(_roots(gr))
        tensors = sorted(e["tensor"] for e in flat["params"].values())
        if pkg is REF:
            # the reference's fsck re-hashes a bf16 npy as |V2 (ROADMAP
            # section 3): every flattened tensor reads as corrupt
            assert report["corrupt"] == tensors
        else:
            assert report["ok"]
        gr.store.cas.flush()
        objects = {k: hashlib.sha256(gr.store.cas.get_bytes(k)).hexdigest()
                   for k in gr.store.cas.keys()}
        assert any(b"'<V2'" in gr.store.cas.get_bytes(k)[:128]
                   for k in objects)
        return _report(rep), objects, _bits(gr), report["refcount_drift"]
    ref, port = both(case, tmp_path)
    assert port == ref
