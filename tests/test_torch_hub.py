"""The port's hub daemon and HTTP transport against the reference, on the
CPU.

Each case of ``tests/test_hub_http.py`` and ``tests/test_hub_scale.py``
runs in both packages: a hub of the package on a loopback ephemeral port
(the port's over ``backend="ref"`` stores), the package's own client, and
the fault harness of that package (``tests/torch_harness.py``: the port's
kill-point registry and fault transports). Each case keeps the reference
test's assertions for both and must give equal results in both: sync
reports, lineage etags, hub object keys, merge statuses, status codes,
checkouts bit for bit and ``fsck``/refcount invariants.

Then the wire between the packages: a port client against a reference hub
and a reference client against a port hub (push, clone, a pull that
auto-merges, a 409 retry, and a push interrupted and resumed from the
server journal), each ending ``fsck`` clean with the etag and object keys
of the same scenario run within the reference alone; and a repository a
port hub wrote, opened, checked and checked out by the reference.
"""

import collections
import contextlib
import dataclasses
import http.client
import json
import shutil
import tempfile
import threading
from urllib.parse import urlsplit

import numpy as np
import pytest

from repro.models import get_config as ref_get_config
from repro.models.model import param_shapes as ref_param_shapes
from repro.store.checkpoint import state_graph

import repro_torch.convert as convert
from repro_torch.common import faults as port_faults
from repro_torch.kernels import ops
from repro_torch.store import ArtifactStore as PortStore

from helpers import finetune_like
from hyp_compat import given, settings, st
from torch_harness import (PORT, REF, assert_bit_identical, check_service,
                           crash_at)
from torch_helpers import make_chain_model

PKGS = (REF, PORT)


@pytest.fixture(autouse=True)
def _disarm_port_kill_points():
    yield
    port_faults.disarm_all()


def both(case, tmp_path):
    return [case(pkg, str(tmp_path / pkg.name)) for pkg in PKGS]


def _repo(pkg, path, **store_kw):
    path = str(path)
    return pkg.core.LineageGraph(path=path, store=pkg.store(path, **store_kw))


def _seed_repo(pkg, path):
    g = _repo(pkg, path)
    base = make_chain_model(pkg.core, seed=0, d=32)
    g.add_node(base, "m@v1")
    g.add_edge("m@v1", "m@v2")
    g.add_node(finetune_like(base, seed=1), "m@v2")
    g.add_version_edge("m@v1", "m@v2")
    return g


def _seed(pkg, path, seed=0, name="m@v1", d=32):
    g = _repo(pkg, path)
    g.add_node(make_chain_model(pkg.core, seed=seed, d=d), name)
    return g


def _stored(g, name):
    return g.store.load_artifact(g.nodes[name].artifact_ref)


def _roots(g):
    return [n.artifact_ref for n in g.nodes.values() if n.artifact_ref]


def _graph(g):
    return {name: (n.parents, n.children, n.version_parents,
                   n.version_children, n.artifact_ref)
            for name, n in sorted(g.nodes.items())}


def _report(rep):
    out = rep.to_json()
    for key in ("transport_backoff_s", "transport_retries",
                "transport_retries_by_family"):
        out.pop(key)
    return out


def _state(pkg, g, name="origin"):
    return pkg.remote.RemoteState(g.path, name)


def _transport(pkg, url, **kw):
    kw.setdefault("retries", 1)
    kw.setdefault("backoff", 0.01)
    return pkg.http.HttpTransport(url, **kw)


@contextlib.contextmanager
def serving(pkg, app, **kw):
    """``app`` (a HubApp or HubService of ``pkg``) served on a loopback
    ephemeral port; yields the server."""
    server, _ = pkg.hub.start_in_thread(app, **kw)
    try:
        yield server
    finally:
        server.shutdown()
        server.server_close()


def _keys(store):
    return sorted(store.cas.keys())


def _etag(pkg, doc):
    return pkg.remote.lineage_etag(doc)


# ---------------------------------------------------------------------------
# tests/test_hub_http.py: wire parity with LocalTransport
# ---------------------------------------------------------------------------


def test_http_push_clone_matches_local_transport(tmp_path):
    def case(pkg, root):
        app = pkg.hub_app(f"{root}/hubrepo")
        with serving(pkg, app) as server:
            url = server.url
            g = _seed_repo(pkg, f"{root}/src")
            rep = pkg.remote.push(g, _transport(pkg, url),
                                  state=_state(pkg, g))
            assert rep.published and \
                rep.objects_transferred == rep.objects_total > 0
            local_dir = f"{root}/localremote"
            pkg.remote.push(g, pkg.local(local_dir), state=_state(pkg, g, "o2"))
            local_doc = json.load(open(f"{local_dir}/lineage.json"))
            hub_doc, _ = app.lineage()
            assert _etag(pkg, hub_doc) == _etag(pkg, local_doc)
            assert _keys(app.store) == _keys(pkg.store(local_dir))
            pkg.clone(url, f"{root}/dst")
            g2 = _repo(pkg, f"{root}/dst")
            assert sorted(g2.nodes) == sorted(g.nodes)
            for name in g.nodes:
                assert g2.nodes[name].artifact_ref == \
                    g.nodes[name].artifact_ref
            assert_bit_identical(g, g2)
            assert app.fsck()["ok"]
            assert g2.store.fsck(_roots(g2))["ok"]
            assert pkg.remote.remote_list(g2.path)["origin"] == url
            return (_report(rep), _etag(pkg, hub_doc), _keys(app.store),
                    _graph(g2))
    ref, port = both(case, tmp_path)
    assert port == ref


def test_second_http_push_transfers_zero_objects(tmp_path):
    def case(pkg, root):
        with serving(pkg, pkg.hub_app(f"{root}/hubrepo")) as server:
            g = _seed_repo(pkg, f"{root}/src")
            pkg.remote.push(g, _transport(pkg, server.url),
                            state=_state(pkg, g))
            rep = pkg.remote.push(g, _transport(pkg, server.url),
                                  state=_state(pkg, g))
            assert rep.objects_transferred == 0
            assert rep.bytes_transferred == 0
            assert rep.dedup_ratio == 1.0
            return _report(rep)
    ref, port = both(case, tmp_path)
    assert port == ref


def test_http_pull_merges_concurrent_growth(tmp_path):
    def case(pkg, root):
        with serving(pkg, pkg.hub_app(f"{root}/hubrepo")) as server:
            url = server.url
            g = _seed_repo(pkg, f"{root}/src")
            pkg.remote.push(g, _transport(pkg, url), state=_state(pkg, g))
            pkg.clone(url, f"{root}/dst")
            g2 = _repo(pkg, f"{root}/dst")
            g.add_edge("m@v2", "m@v3")
            g.add_node(finetune_like(_stored(g, "m@v2"), seed=7), "m@v3")
            pkg.remote.push(g, _transport(pkg, url), state=_state(pkg, g))
            g2.add_edge("m@v1", "side")
            g2.add_node(finetune_like(_stored(g2, "m@v1"), seed=8), "side")
            rep = pkg.remote.pull(g2, _transport(pkg, url),
                                  state=_state(pkg, g2))
            assert rep.merge.status == pkg.core.NO_CONFLICT
            assert sorted(g2.nodes) == ["m@v1", "m@v2", "m@v3", "side"]
            assert_bit_identical(g, g2, names=["m@v3"])
            return _report(rep), _graph(g2)
    ref, port = both(case, tmp_path)
    assert port == ref


def test_ranged_reads_and_transport_extras(tmp_path):
    def case(pkg, root):
        app = pkg.hub_app(f"{root}/hubrepo")
        with serving(pkg, app) as server:
            g = _seed_repo(pkg, f"{root}/src")
            t = _transport(pkg, server.url)
            pkg.remote.push(g, t, state=_state(pkg, g))
            key = max(app.store.cas.keys(), key=app.store.cas.size)
            whole = bytes(app.store.cas.get_bytes(key))
            assert t.read_objects([key])[key] == whole
            assert t.read_object_range(key, 0, 10) == whole[:10]
            assert t.read_object_range(key, 5, 7) == whole[5:12]
            assert t.read_object_range(key, len(whole) - 3) == whole[-3:]
            assert t.read_object_range(key, len(whole)) == b""
            with pytest.raises(KeyError):
                t.read_objects([key, "nope_" + "0" * 32])
            with pytest.raises(KeyError):
                t.read_object_range("nope_" + "0" * 32, 0, 4)
            stats = t.server_stats()
            assert stats["publishes"] >= 1 and stats["objects_received"] > 0
            par = t.read_object_parallel(key, len(whole), part_bytes=512)
            assert par == whole
            return key, whole
    ref, port = both(case, tmp_path)
    assert port == ref


def test_path_traversal_rejected(tmp_path):
    def case(pkg, root):
        app = pkg.hub_app(f"{root}/hubrepo")
        secret = tmp_path / f"secret-{pkg.name}.txt"
        secret.write_text("not yours")
        statuses = []
        with serving(pkg, app) as server:
            host = urlsplit(server.url)
            for quoted in ("..%2F..%2Fsecret.txt",
                           "..%2f..%2f..%2fetc%2fpasswd", "..", "."):
                for method, path in (("GET", f"/api/objects/{quoted}"),
                                     ("GET", f"/api/journal/{quoted}"),
                                     ("PUT", f"/api/journal/{quoted}"),
                                     ("DELETE", f"/api/journal/{quoted}")):
                    conn = http.client.HTTPConnection(host.hostname,
                                                      host.port)
                    conn.request(method, path,
                                 body=b"{}" if method == "PUT" else None)
                    resp = conn.getresponse()
                    body = resp.read()
                    conn.close()
                    assert resp.status == 404, (method, path, resp.status,
                                                body)
                    statuses.append((method, path, resp.status, body))
        assert secret.read_text() == "not yours"
        return statuses
    ref, port = both(case, tmp_path)
    assert port == ref


# ---------------------------------------------------------------------------
# Optimistic lineage swap: 409 absorbed by the push retry loop
# ---------------------------------------------------------------------------

RACER = {"nodes": [{"name": "racer@v1", "parents": [], "children": [],
                    "version_parents": [], "version_children": [],
                    "model_type": "toy", "creation_fn": None,
                    "artifact_ref": None, "metadata": {}}]}


def test_publish_conflict_409_retries_and_merges(tmp_path):
    def case(pkg, root):
        app = pkg.hub_app(f"{root}/hubrepo")
        with serving(pkg, app) as server:
            g = _seed_repo(pkg, f"{root}/src")
            t = pkg.transports.RacingTransport(
                server.url, app, json.loads(json.dumps(RACER)), retries=1,
                backoff=0.01)
            rep = pkg.remote.push(g, t, state=_state(pkg, g))
            assert rep.published
            assert rep.publish_retries == 1
            doc, etag = app.lineage()
            assert {n["name"] for n in doc["nodes"]} == \
                {"m@v1", "m@v2", "racer@v1"}
            assert app.stats["conflicts_409"] == 1
            assert app.fsck()["ok"]
            return _report(rep), etag
    ref, port = both(case, tmp_path)
    assert port == ref


def test_stale_etag_publish_raises_409(tmp_path):
    def case(pkg, root):
        with serving(pkg, pkg.hub_app(f"{root}/hubrepo")) as server:
            t = _transport(pkg, server.url)
            t.publish_lineage({"nodes": []}, expected=None)
            _, etag = t.fetch_lineage_versioned()
            t.publish_lineage({"nodes": []}, expected=etag)
            with pytest.raises(pkg.remote.PublishConflict) as err:
                t.publish_lineage({"nodes": []}, expected="bogus-etag")
            return etag, err.value.current_etag
    ref, port = both(case, tmp_path)
    assert port == ref


def test_concurrent_pushes_from_two_clients_both_land(tmp_path):
    def case(pkg, root):
        app = pkg.hub_app(f"{root}/hubrepo")
        with serving(pkg, app) as server:
            url = server.url
            ga = _repo(pkg, f"{root}/a")
            ga.add_node(make_chain_model(pkg.core, seed=0, d=32, prefix="A"),
                        "a@v1")
            gb = _repo(pkg, f"{root}/b")
            gb.add_node(make_chain_model(pkg.core, seed=5, d=32, prefix="B"),
                        "b@v1")
            reports, errors = {}, []

            def worker(name, g):
                try:
                    reports[name] = pkg.remote.push(
                        g, _transport(pkg, url, retries=2),
                        state=_state(pkg, g))
                except BaseException as exc:  # pragma: no cover
                    errors.append((name, exc))

            threads = [threading.Thread(target=worker, args=("a", ga)),
                       threading.Thread(target=worker, args=("b", gb))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            assert not errors
            assert reports["a"].published and reports["b"].published
            doc, etag = app.lineage()
            assert {n["name"] for n in doc["nodes"]} == {"a@v1", "b@v1"}
            report = app.fsck()
            assert report["ok"] and not report["refcount_drift"]
            pkg.remote.pull(ga, _transport(pkg, url), state=_state(pkg, ga))
            pkg.remote.pull(gb, _transport(pkg, url), state=_state(pkg, gb))
            assert_bit_identical(ga, gb)
            return (sorted(n["name"] for n in doc["nodes"]),
                    _keys(app.store), _graph(ga))
    ref, port = both(case, tmp_path)
    assert port == ref


def _converge(pkg, root, url, app):
    """``test_same_node_divergence_converges_via_pull_merge_retry``'s body:
    a conflicting push, a pull that auto-merges, a push that lands."""
    g = _seed_repo(pkg, f"{root}/src")
    pkg.remote.push(g, _transport(pkg, url), state=_state(pkg, g))
    pkg.clone(url, f"{root}/dst")
    g2 = _repo(pkg, f"{root}/dst")
    a = _stored(g, "m@v2")
    g.add_node(a.replace_params(
        {"L0/w": np.asarray(a.params["L0/w"]) + 1.0}), "m@v2")
    pkg.remote.push(g, _transport(pkg, url), state=_state(pkg, g),
                    force=True)
    b = _stored(g2, "m@v2")
    g2.add_node(b.replace_params(
        {"L1/w": np.asarray(b.params["L1/w"]) + 2.0}), "m@v2")
    refused = pkg.remote.push(g2, _transport(pkg, url), state=_state(pkg, g2))
    assert not refused.published and refused.merge.status == pkg.core.CONFLICT
    pulled = pkg.remote.pull(g2, _transport(pkg, url), state=_state(pkg, g2))
    assert pulled.merge.status != pkg.core.CONFLICT
    landed = pkg.remote.push(g2, _transport(pkg, url), state=_state(pkg, g2))
    assert landed.published
    return g2, refused, pulled, landed


def test_same_node_divergence_converges_via_pull_merge_retry(tmp_path):
    def case(pkg, root):
        app = pkg.hub_app(f"{root}/hubrepo")
        with serving(pkg, app) as server:
            g2, refused, pulled, landed = _converge(pkg, root, server.url,
                                                    app)
            doc, etag = app.lineage()
            ref = next(n["artifact_ref"] for n in doc["nodes"]
                       if n["name"] == "m@v2")
            assert ref == g2.nodes["m@v2"].artifact_ref
            assert app.fsck()["ok"]
            return (_report(refused), _report(pulled), _report(landed), etag,
                    _keys(app.store))
    ref, port = both(case, tmp_path)
    assert port == ref


# ---------------------------------------------------------------------------
# Interrupted HTTP push: journalled resume over the network
# ---------------------------------------------------------------------------


def _interrupted_push(pkg, root, url, app):
    """``test_interrupted_http_push_resumes_via_server_journal``'s body."""
    g = _repo(pkg, f"{root}/src")
    g.add_node(make_chain_model(pkg.core, seed=0, d=48, n_layers=6), "m@v1")
    flaky = pkg.transports.FlakyHttpTransport(url, fail_after=2, retries=0,
                                              backoff=0.0)
    with pytest.raises(ConnectionError):
        pkg.remote.push(g, flaky, chunk_size=3, state=_state(pkg, g))
    payload, _ = app.lineage()
    assert payload is None
    t = _transport(pkg, url)
    tids = list(t.journal_list())
    assert len(tids) == 1
    done_before = set(t.journal_load(tids[0])["done"])
    assert done_before
    rep = pkg.remote.push(g, t, chunk_size=3, state=_state(pkg, g))
    assert rep.published
    assert rep.chunks_resumed == len(done_before)
    assert rep.objects_transferred < rep.objects_total
    assert list(t.journal_list()) == []
    assert app.fsck()["ok"]
    g2 = _repo(pkg, f"{root}/dst")
    pkg.remote.pull(g2, _transport(pkg, url))
    assert_bit_identical(g, g2)
    return tids, rep.objects_total, rep.chunks_resumed


def test_interrupted_http_push_resumes_via_server_journal(tmp_path):
    def case(pkg, root):
        app = pkg.hub_app(f"{root}/hubrepo")
        with serving(pkg, app) as server:
            return _interrupted_push(pkg, root, server.url, app)
    ref, port = both(case, tmp_path)
    assert port == ref


# ---------------------------------------------------------------------------
# Server-side policy: quarantine filtering + auth stub
# ---------------------------------------------------------------------------


def _quarantine(pkg, g, name):
    g.nodes[name].metadata[pkg.quarantine_flag] = True
    g._commit()


def test_hub_rejects_pushed_quarantined_nodes(tmp_path):
    def case(pkg, root):
        app = pkg.hub_app(f"{root}/hubrepo")
        with serving(pkg, app) as server:
            g = _seed_repo(pkg, f"{root}/src")
            _quarantine(pkg, g, "m@v2")
            rep = pkg.remote.push(g, _transport(pkg, server.url),
                                  state=_state(pkg, g),
                                  include_quarantined=True)
            assert rep.published
            assert rep.quarantine_rejected_by_remote == ["m@v2"]
            doc, etag = app.lineage()
            assert {n["name"] for n in doc["nodes"]} == {"m@v1"}
            assert app.stats["quarantine_rejected"] == 1
            v1 = next(n for n in doc["nodes"] if n["name"] == "m@v1")
            assert v1["children"] == [] and v1["version_children"] == []
            assert app.fsck()["ok"]
            pkg.remote.pull(g, _transport(pkg, server.url),
                            state=_state(pkg, g))
            assert "m@v2" in g.nodes
            return _report(rep), etag
    ref, port = both(case, tmp_path)
    assert port == ref


def test_hub_allow_quarantined_opt_in(tmp_path):
    def case(pkg, root):
        app = pkg.hub_app(f"{root}/hubrepo", allow_quarantined=True)
        with serving(pkg, app) as server:
            g = _seed_repo(pkg, f"{root}/src")
            _quarantine(pkg, g, "m@v2")
            pkg.remote.push(g, _transport(pkg, server.url),
                            state=_state(pkg, g), include_quarantined=True)
            doc, etag = app.lineage()
            assert {n["name"] for n in doc["nodes"]} == {"m@v1", "m@v2"}
            return etag
    ref, port = both(case, tmp_path)
    assert port == ref


def test_auth_token_enforced(tmp_path):
    def case(pkg, root):
        app = pkg.hub_app(f"{root}/hubrepo", token="sekrit")
        with serving(pkg, app) as server:
            bad = pkg.http.HttpTransport(server.url, token=None, retries=0)
            bad.ensure_repo()
            with pytest.raises(PermissionError):
                bad.have(["k"])
            with pytest.raises(PermissionError):
                pkg.http.HttpTransport(server.url, token="wrong",
                                       retries=0).have(["k"])
            good = pkg.http.HttpTransport(server.url, token="sekrit",
                                          retries=0)
            assert good.have(["k"]) == set()
            assert app.stats["auth_failures"] == 2
            return app.stats["auth_failures"]
    ref, port = both(case, tmp_path)
    assert port == ref


# ---------------------------------------------------------------------------
# Plumbing: scheme dispatch, etag parity, local optimistic swap
# ---------------------------------------------------------------------------


def test_resolve_transport_scheme_dispatch(tmp_path):
    def case(pkg, root):
        repo = f"{root}/repo"
        pkg.remote.remote_add(repo, "hubby", "http://127.0.0.1:1/x")
        t, name = pkg.remote.resolve_transport(repo, "hubby")
        assert isinstance(t, pkg.http.HttpTransport) and name == "hubby"
        assert pkg.remote.remote_list(repo)["hubby"] == "http://127.0.0.1:1/x"
        t, name = pkg.remote.resolve_transport(repo, f"{root}/peer")
        assert isinstance(t, pkg.remote.LocalTransport) and name is None
        return type(t).__name__, name
    ref, port = both(case, tmp_path)
    assert port == ref


def test_local_transport_optimistic_swap(tmp_path):
    def case(pkg, root):
        t = pkg.local(f"{root}/remote")
        t.ensure_repo()
        t.publish_lineage({"nodes": []}, expected=None)
        payload, etag = t.fetch_lineage_versioned()
        assert payload == {"nodes": []} and etag == _etag(pkg, payload)
        with pytest.raises(pkg.remote.PublishConflict):
            t.publish_lineage({"nodes": []}, expected="stale")
        t.publish_lineage({"nodes": [{"name": "x"}]}, expected=etag)
        assert t.fetch_lineage() == {"nodes": [{"name": "x"}]}
        return etag, t.fetch_lineage_versioned()[1]
    ref, port = both(case, tmp_path)
    assert port == ref


# ---------------------------------------------------------------------------
# tests/test_hub_scale.py: multi-tenant routing over one shared CAS
# ---------------------------------------------------------------------------


def test_multi_tenant_routing_shared_cas_dedup(tmp_path):
    def case(pkg, root):
        service = pkg.service(f"{root}/hub")
        with serving(pkg, service) as server:
            url = server.url
            Http = pkg.http.HttpTransport
            ga = _seed(pkg, f"{root}/a", seed=0)
            rep_a = pkg.remote.push(ga, Http(url + "/r/alpha"),
                                    state=_state(pkg, ga))
            gb = _seed(pkg, f"{root}/b", seed=0)
            base = gb.store.load_artifact(gb.nodes["m@v1"].artifact_ref)
            gb.add_node(finetune_like(base, seed=7), "m@v2")
            rep_b = pkg.remote.push(gb, Http(url + "/r/beta"),
                                    state=_state(pkg, gb))
            assert rep_a.published and rep_b.published
            assert rep_b.objects_transferred < rep_b.objects_total
            names = {r["name"] for r in Http(url).list_repos()}
            assert {"alpha", "beta"} <= names
            doc_a = Http(url + "/r/alpha").fetch_lineage()
            assert {n["name"] for n in doc_a["nodes"]} == {"m@v1"}
            pkg.clone(url + "/r/alpha", f"{root}/ca")
            assert_bit_identical(ga, _repo(pkg, f"{root}/ca"))
            cb = _repo(pkg, f"{root}/cb")
            pkg.remote.pull(cb, Http(url + "/r/beta"))
            assert_bit_identical(gb, cb)
            check_service(service)
            return (_report(rep_a), _report(rep_b), sorted(names),
                    _keys(service.store))
    ref, port = both(case, tmp_path)
    assert port == ref


def test_token_hub_never_creates_repos_for_bad_tokens(tmp_path):
    def case(pkg, root):
        service = pkg.service(f"{root}/hub", token="sekrit")
        with serving(pkg, service) as server:
            bad = pkg.http.HttpTransport(server.url + "/r/newrepo",
                                         token="wrong")
            with pytest.raises(PermissionError):
                bad.fetch_lineage_versioned()
            assert "newrepo" not in service.repo_names()
            ok = pkg.http.HttpTransport(server.url + "/r/newrepo",
                                        token="sekrit")
            ok.fetch_lineage_versioned()
            assert "newrepo" in service.repo_names()
            return service.repo_names()
    ref, port = both(case, tmp_path)
    assert port == ref


def test_delete_repo_then_gc_reclaims_only_its_bytes(tmp_path):
    def case(pkg, root):
        App = pkg.transports.AppTransport
        service = pkg.service(f"{root}/hub")
        ga = _seed(pkg, f"{root}/a", seed=0)
        pkg.remote.push(ga, App(service.repo("alpha")),
                        state=_state(pkg, ga))
        gb = _seed(pkg, f"{root}/b", seed=99)
        pkg.remote.push(gb, App(service.repo("beta")), state=_state(pkg, gb))
        check_service(service)
        service.delete_repo("beta")
        assert "beta" not in service.repo_names()
        reports = [service.run_gc() for _ in range(3)]
        assert sum(r["reclaimed_bytes"] for r in reports) > 0
        assert any(r["confirmed_orphans"] > 0 for r in reports)
        g2 = _repo(pkg, f"{root}/chk")
        pkg.remote.pull(g2, App(service.repo("alpha")))
        assert_bit_identical(ga, g2)
        before = service.store.cas.pack_stats()["pack_dead_bytes"]
        report = service.compact()
        assert report["dead_bytes_after"] <= before
        check_service(service, converged=True)
        return ([(r["reclaimed_bytes"], r["confirmed_orphans"])
                 for r in reports], _keys(service.store))
    ref, port = both(case, tmp_path)
    assert port == ref


# ---------------------------------------------------------------------------
# Kill-point fault injection: publish, mget, GC, replica sync
# ---------------------------------------------------------------------------


def test_publish_crash_before_commit_point_loses_nothing(tmp_path):
    def case(pkg, root):
        service = pkg.service(f"{root}/hub")
        app = service.repo("alpha")
        g = _seed(pkg, f"{root}/src", seed=3)
        with crash_at("hub.publish.pre_replace", faults=pkg.faults):
            with pytest.raises(pkg.faults.KillPointError):
                pkg.remote.push(g, pkg.transports.AppTransport(app),
                                state=_state(pkg, g))
        payload, _ = app.lineage()
        assert payload is None
        rep = pkg.remote.push(g, pkg.transports.AppTransport(app),
                              state=_state(pkg, g))
        assert rep.published
        check_service(service)
        return _report(rep), app.lineage()[1]
    ref, port = both(case, tmp_path)
    assert port == ref


def test_publish_crash_after_commit_point_is_already_durable(tmp_path):
    def case(pkg, root):
        service = pkg.service(f"{root}/hub")
        app = service.repo("alpha")
        g = _seed(pkg, f"{root}/src", seed=4)
        with crash_at("hub.publish.post_replace", faults=pkg.faults):
            with pytest.raises(pkg.faults.KillPointError):
                pkg.remote.push(g, pkg.transports.AppTransport(app),
                                state=_state(pkg, g))
        payload, _ = app.lineage()
        assert payload is not None
        assert {n["name"] for n in payload["nodes"]} == {"m@v1"}
        rep = pkg.remote.push(g, pkg.transports.AppTransport(app),
                              state=_state(pkg, g))
        assert rep.published
        check_service(service)
        return _report(rep), app.lineage()[1]
    ref, port = both(case, tmp_path)
    assert port == ref


def test_mget_mid_stream_abort_retried_to_bit_identity(tmp_path):
    def case(pkg, root):
        service = pkg.service(f"{root}/hub")
        with serving(pkg, service) as server:
            url = server.url
            g = _repo(pkg, f"{root}/src")
            g.add_node(make_chain_model(pkg.core, seed=0, d=48, n_layers=6),
                       "m@v1")
            pkg.remote.push(g, pkg.http.HttpTransport(url + "/r/alpha"),
                            state=_state(pkg, g))
            g2 = _repo(pkg, f"{root}/dst")
            with crash_at("hub.mget.record", after=2, faults=pkg.faults):
                pkg.remote.pull(g2, pkg.http.HttpTransport(
                    url + "/r/alpha", retries=3, backoff=0.01))
            assert pkg.faults.fired("hub.mget.record") == 1
            assert_bit_identical(g, g2)
            check_service(service)
            return _graph(g2)
    ref, port = both(case, tmp_path)
    assert port == ref


def _two_tenants_then_delete_beta(pkg, root):
    service = pkg.service(f"{root}/hub")
    ga = _seed(pkg, f"{root}/a", seed=0)
    pkg.remote.push(ga, pkg.transports.AppTransport(service.repo("alpha")),
                    state=_state(pkg, ga))
    gb = _seed(pkg, f"{root}/b", seed=99)
    pkg.remote.push(gb, pkg.transports.AppTransport(service.repo("beta")),
                    state=_state(pkg, gb))
    return service, ga


def test_gc_crash_before_zeroing_never_loses_objects(tmp_path):
    def case(pkg, root):
        service, ga = _two_tenants_then_delete_beta(pkg, root)
        service.delete_repo("beta")
        with crash_at("hub.gc.pre_zero", faults=pkg.faults):
            with pytest.raises(pkg.faults.KillPointError):
                service.run_gc()
        check_service(service)
        total = sum(service.run_gc()["reclaimed_bytes"] for _ in range(4))
        assert total > 0
        g2 = _repo(pkg, f"{root}/chk")
        pkg.remote.pull(g2, pkg.transports.AppTransport(
            service.repo("alpha")))
        assert_bit_identical(ga, g2)
        check_service(service, converged=True)
        return total, _keys(service.store)
    ref, port = both(case, tmp_path)
    assert port == ref


def test_reader_lease_defers_physical_reclaim(tmp_path):
    def case(pkg, root):
        service, _ = _two_tenants_then_delete_beta(pkg, root)
        store = service.store
        beta_only = (set(store.expected_refcounts(
            service.repo("beta").roots()))
            - set(store.expected_refcounts(service.repo("alpha").roots())))
        assert beta_only
        service.delete_repo("beta")
        with store.cas.pin():
            for _ in range(3):
                service.run_gc()
            deferred = store.cas.deferred_dead_bytes()
            assert deferred > 0
            for k in beta_only:
                assert store.cas.get_bytes(k)
        assert store.cas.deferred_dead_bytes() == 0
        for k in beta_only:
            assert not store.cas.has(k)
        check_service(service, converged=True)
        return deferred, sorted(beta_only)
    ref, port = both(case, tmp_path)
    assert port == ref


def test_replica_crash_stays_stale_and_clients_fall_back(tmp_path):
    def case(pkg, root):
        Http = pkg.http.HttpTransport
        service = pkg.service(f"{root}/hub")
        with serving(pkg, service) as server:
            url = server.url
            g = _seed(pkg, f"{root}/src", seed=0)
            pkg.remote.push(g, Http(url + "/r/alpha"), state=_state(pkg, g))
            replica = pkg.replica_hub(f"{root}/rep", url)
            with crash_at("replica.sync.pre_publish", faults=pkg.faults):
                with pytest.raises(pkg.faults.KillPointError):
                    replica.sync_once()
            with serving(pkg, replica.service) as rserver:
                rs = pkg.ReplicaSetTransport(
                    Http(url + "/r/alpha"),
                    [Http(rserver.url + "/r/alpha")])
                g2 = _repo(pkg, f"{root}/d1")
                pkg.remote.pull(g2, rs)
                assert rs.fallbacks > 0 and rs.replica_reads == 0
                assert_bit_identical(g, g2)
                replica.sync_once()
                rs = pkg.ReplicaSetTransport(
                    Http(url + "/r/alpha"),
                    [Http(rserver.url + "/r/alpha")])
                g3 = _repo(pkg, f"{root}/d2")
                pkg.remote.pull(g3, rs)
                assert rs.replica_reads > 0
                assert_bit_identical(g, g3)
                check_service(replica.service)
                with pytest.raises(Exception):
                    Http(rserver.url + "/r/alpha").publish_lineage(
                        {"nodes": []})
            check_service(service)
            return _graph(g3), _keys(replica.service.store)
    ref, port = both(case, tmp_path)
    assert port == ref


# ---------------------------------------------------------------------------
# Worker pool: bounded concurrency + load shedding
# ---------------------------------------------------------------------------


def test_backpressure_sheds_503_with_retry_after(tmp_path, monkeypatch):
    """The reference test's assertions on the port's hub (the reference's
    own test covers its hub). Its twelve threads connect one by one, so on
    a loaded host a late one can land after an admitted request has freed
    its slot, as the reference test does now and then; here they connect
    together, behind a listen backlog deep enough for all twelve, so the
    acceptor sees them while the first three hold their slots."""
    monkeypatch.setattr(PORT.hub.HubServer, "request_queue_size", 64)
    service = PORT.service(str(tmp_path / "hub"))
    codes = collections.Counter()
    retry_after = []
    lock = threading.Lock()
    start = threading.Barrier(12)
    with serving(PORT, service, max_workers=2, queue_depth=1) as server:
        server.delay_s = 0.2
        host = urlsplit(server.url)

        def hit():
            conn = http.client.HTTPConnection(host.hostname, host.port)
            try:
                start.wait(timeout=30)
                conn.request("GET", "/api/ping")
                resp = conn.getresponse()
                resp.read()
                with lock:
                    codes[resp.status] += 1
                    if resp.status == 503:
                        retry_after.append(resp.getheader("Retry-After"))
            finally:
                conn.close()

        threads = [threading.Thread(target=hit) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    assert codes[200] == 3 and codes[503] == 9, codes
    assert set(retry_after) == {"1"}
    assert service.default.stats["sheds_503"] == 9
    assert service.default.stats["errors_500"] == 0


# ---------------------------------------------------------------------------
# Random op sequences preserve the invariants
# ---------------------------------------------------------------------------

TENANTS = ("alpha", "beta", "gamma")


def _run_op_sequence(pkg, ops):
    """``test_hub_scale._run_op_sequence`` in ``pkg``; returns each
    tenant's lineage etag and the service's object keys at the end."""
    root = tempfile.mkdtemp(prefix=f"mgit-hubprop-{pkg.name}-")
    try:
        service = pkg.service(root + "/hub")
        mirrors = {}
        version = 0
        for op, idx in ops:
            tenant = TENANTS[idx % len(TENANTS)]
            if op == "push":
                version += 1
                g = mirrors.get(tenant)
                if g is None:
                    g = _seed(pkg, f"{root}/{tenant}-{version}", seed=0,
                              name=f"{tenant}@v1")
                    mirrors[tenant] = g
                else:
                    head = sorted(g.nodes)[-1]
                    art = g.store.load_artifact(g.nodes[head].artifact_ref)
                    g.add_node(finetune_like(art, seed=version),
                               f"{tenant}@v{version}")
                pkg.remote.push(g, pkg.transports.AppTransport(
                    service.repo(tenant)), state=_state(pkg, g))
            elif op == "delete":
                if tenant in service.repo_names():
                    service.delete_repo(tenant)
                mirrors.pop(tenant, None)
            elif op == "gc":
                service.run_gc()
            elif op == "compact":
                service.compact()
        for _ in range(4):
            service.run_gc()
        check_service(service, converged=True)
        for tenant, g in mirrors.items():
            g2 = _repo(pkg, f"{root}/verify-{tenant}")
            pkg.remote.pull(g2, pkg.transports.AppTransport(
                service.repo(tenant)))
            assert_bit_identical(g, g2)
        return ({t: service.repo(t).lineage()[1] for t in mirrors},
                _keys(service.store))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def test_scripted_hub_op_sequence():
    ops = [("push", 0), ("push", 1), ("push", 0), ("gc", 0), ("delete", 1),
           ("gc", 0), ("compact", 0), ("gc", 0), ("gc", 0), ("push", 1),
           ("gc", 0), ("compact", 0), ("push", 2), ("delete", 0), ("gc", 0),
           ("gc", 0), ("gc", 0), ("compact", 0)]
    ref, port = (_run_op_sequence(pkg, ops) for pkg in PKGS)
    assert port == ref


@settings(max_examples=15, deadline=None)
@given(st.lists(st.tuples(
    st.sampled_from(["push", "delete", "gc", "compact"]),
    st.integers(min_value=0, max_value=len(TENANTS) - 1)),
    min_size=1, max_size=12))
def test_random_hub_op_sequences_hold_invariants(ops):
    ref, port = (_run_op_sequence(pkg, ops) for pkg in PKGS)
    assert port == ref


# ---------------------------------------------------------------------------
# Stress: 64 threads racing GC/compaction over HTTP (tier-2, -m slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_stress_64_threads_racing_gc(tmp_path):
    service = PORT.service(str(tmp_path / "hub"))
    server, _ = PORT.hub.start_in_thread(service, max_workers=16,
                                         queue_depth=64)
    stop = threading.Event()
    errors = []

    def maintenance():
        while not stop.is_set():
            try:
                service.run_gc()
                service.compact()
            except Exception as exc:  # pragma: no cover - diagnostic aid
                errors.append(("maintenance", exc))
            stop.wait(0.05)

    def worker(i):
        tenant = TENANTS[i % len(TENANTS)]
        try:
            g = _repo(PORT, tmp_path / f"w{i}")
            g.add_node(make_chain_model(PORT.core, seed=i, d=16, n_layers=2),
                       f"w{i}@v1")
            t = PORT.http.HttpTransport(f"{server.url}/r/{tenant}",
                                        retries=6, backoff=0.05)
            PORT.remote.push(g, t, state=_state(PORT, g))
            g2 = _repo(PORT, tmp_path / f"v{i}")
            PORT.remote.pull(g2, PORT.http.HttpTransport(
                f"{server.url}/r/{tenant}", retries=6, backoff=0.05))
            assert_bit_identical(g, g2, names=[f"w{i}@v1"])
        except Exception as exc:
            errors.append((i, exc))

    gc_thread = threading.Thread(target=maintenance, daemon=True)
    gc_thread.start()
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        stop.set()
        gc_thread.join(10)
        server.shutdown()
        server.server_close()
    assert not errors, errors[:3]
    assert service.default.stats["errors_500"] == 0
    for _ in range(4):
        service.run_gc()
    check_service(service, converged=True)


# ---------------------------------------------------------------------------
# The wire between the packages
# ---------------------------------------------------------------------------

DIRECTIONS = [pytest.param(PORT, REF, id="port-client-reference-hub"),
              pytest.param(REF, PORT, id="reference-client-port-hub")]


def _interop(client, server, root):
    """Push, clone, a 409 retry, a conflicting push that a pull auto-merges
    and a push that lands, from ``client``'s package against a hub of
    ``server``'s; then an interrupted push resumed from the hub's journal
    into a tenant of its own. Returns what the wire must agree on."""
    service = server.service(f"{root}/hub")
    with serving(server, service) as hub:
        url = hub.url
        g = _seed_repo(client, f"{root}/src")
        rep = client.remote.push(g, _transport(client, url),
                                 state=_state(client, g))
        assert rep.published and \
            rep.objects_transferred == rep.objects_total > 0
        app = service.default
        doc, etag = app.lineage()
        assert etag == _etag(client, g.to_payload()) == _etag(server, doc)
        client.clone(url, f"{root}/clone")
        gc = _repo(client, f"{root}/clone")
        assert _graph(gc) == _graph(g)
        assert_bit_identical(g, gc)
        assert gc.store.fsck(_roots(gc))["ok"]

        racer = client.transports.RacingTransport(
            url, app, json.loads(json.dumps(RACER)), retries=1, backoff=0.01)
        raced = client.remote.push(g, racer, state=_state(client, g))
        assert raced.published and raced.publish_retries == 1
        assert app.stats["conflicts_409"] == 1

        g2, refused, pulled, landed = _converge(client, f"{root}/merge", url,
                                                app)
        doc, etag = app.lineage()
        merged = next(n["artifact_ref"] for n in doc["nodes"]
                      if n["name"] == "m@v2")
        assert merged == g2.nodes["m@v2"].artifact_ref
        check_service(service)

        tenant = service.repo("resume")
        resumed = _interrupted_push(client, f"{root}/resume",
                                    url + "/r/resume", tenant)
        check_service(service)
        return {"push": _report(rep), "raced": _report(raced),
                "refused": _report(refused), "pulled": _report(pulled),
                "landed": _report(landed), "resumed": resumed,
                "etag": etag, "merged": merged, "graph": _graph(g2),
                "keys": _keys(service.store)}


@pytest.mark.parametrize("client, server", DIRECTIONS)
def test_wire_interop_push_clone_merge_and_resume(tmp_path, client, server):
    """Each direction gives the lineage etags, manifest refs, sync reports
    and hub object keys that the same scenario gives within the reference
    alone; every store ends fsck clean with exact refcounts."""
    want = _interop(REF, REF, str(tmp_path / "ref-ref"))
    got = _interop(client, server, str(tmp_path / "mixed"))
    assert got == want


def test_repository_of_a_port_hub_opens_in_the_reference(tmp_path):
    """Repositories that port hubs wrote through the wire from a port
    client (a chain with a pull-merged re-commit; on a second hub, whose
    CAS lacks the chain, a shallow tenant holding the flattened m@v2) are
    ones the reference opens: the same lineage, a clean ``fsck`` over
    every tenant's roots, and checkouts bit for bit with the port's."""
    service = PORT.service(str(tmp_path / "hub"))
    second = PORT.service(str(tmp_path / "hub2"))
    with serving(PORT, service) as hub, serving(PORT, second) as hub2:
        g2, *_ = _converge(PORT, str(tmp_path / "merge"), hub.url,
                           service.default)
        shallow = PORT.remote.push(
            g2, _transport(PORT, hub2.url + "/r/shallow"), filter="m@v2")
        assert shallow.published and len(shallow.flattened) == 1
        check_service(service)
        check_service(second)
        roots = {"hub": service.all_roots(), "hub2": second.all_roots()}
    root = str(tmp_path / "hub")
    theirs = REF.core.LineageGraph(path=root, store=REF.store(root))
    ours = _repo(PORT, root)
    assert _graph(theirs) == _graph(ours) == _graph(g2)
    report = theirs.store.fsck(roots["hub"])
    assert report["ok"] and not report["refcount_drift"], report
    assert_bit_identical(theirs, ours)
    assert_bit_identical(theirs, g2)
    root2 = str(tmp_path / "hub2")
    store2 = REF.store(root2)
    report = store2.fsck(roots["hub2"])
    assert report["ok"] and not report["refcount_drift"], report
    tenant = REF.core.LineageGraph(path=f"{root2}/repos/shallow",
                                   store=store2)
    (flat,) = shallow.flattened.values()
    assert sorted(tenant.nodes) == ["m@v2"]
    assert tenant.nodes["m@v2"].artifact_ref == flat
    assert store2.get_manifest(flat)["depth"] == 0
    assert_bit_identical(tenant, g2)


# ---------------------------------------------------------------------------
# The slice as a whole: collaboration on a paper-bert lineage
# ---------------------------------------------------------------------------

# remote/sync.py's outcome for a node whose two re-commits it auto-merged
# as dependent changes with no tests to run (Figure 2)
AUTO_MERGED = ("auto-merged models: dependent changes; no tests registered "
               "— verify manually")


def _paper_bert_lineage(keys_sorted=True):
    """(arch, {node: flat f32 params}): reduced paper-bert at 2 layers,
    base -> ft1 -> ft2 by sparse noise, made with numpy from a seed; keys
    sorted, or in ``param_shapes``' order."""
    cfg = dataclasses.replace(ref_get_config("paper-bert").reduced(),
                              dtype="float32", n_layers=2)
    rng = np.random.default_rng(19)
    # keys in sorted order, the order of a checkout: state_graph chains the
    # layers, and a re-commit matches each param to its parent's, in the
    # order of the dict it is given, so a clone's re-commit from a checkout
    # must see the lineage's own order (as chip_smoke.py's init_params
    # lineage does)
    shapes = ref_param_shapes(cfg)
    base = {k: (rng.normal(size=shapes[k]) * 0.05).astype(np.float32)
            for k in (sorted(shapes) if keys_sorted else shapes)}

    def ft(params, scale):
        return {k: (v + rng.normal(scale=scale, size=v.shape)
                    * (rng.random(v.shape) < 0.3)).astype(np.float32)
                for k, v in params.items()}
    ft1 = ft(base, 5e-5)
    return cfg.name, {"base": base, "ft1": ft1, "ft2": ft(ft1, 1e-4)}


def _artifact(pkg, arch, flat):
    if pkg is REF:
        return REF.core.ModelArtifact(state_graph(flat, arch), dict(flat),
                                      model_type=arch)
    return convert.to_artifact(dict(flat), arch)


def _slice(pkg, root, store_kw, on_card, keys_sorted=True):
    """Push a paper-bert lineage to a hub of ``pkg``, clone it twice, edit
    the tip's encoder trunk in clone A (pushed) and its token embedding in
    clone B, pull into B (the auto-merge), push B's merge. The port's
    clones run on the card's path when ``on_card``. With a lineage whose
    keys are not in a checkout's order, the pull's report is returned."""
    arch, flats = _paper_bert_lineage(keys_sorted)
    kw = dict(store_kw, backend="cuda") if on_card else store_kw
    g = _repo(pkg, f"{root}/src", **store_kw)
    g.add_node(_artifact(pkg, arch, flats["base"]), "base")
    for parent, child in (("base", "ft1"), ("ft1", "ft2")):
        g.add_node(None, child, model_type=arch)
        g.add_version_edge(parent, child)
        g.add_node(_artifact(pkg, arch, flats[child]), child)
    service = pkg.service(f"{root}/hub", token="tok")
    with serving(pkg, service) as hub:
        url = hub.url
        t = pkg.http.HttpTransport(url, token="tok")
        pushed = pkg.remote.push(g, t, state=_state(pkg, g))
        assert pushed.published
        clones = {}
        for side in ("a", "b"):
            dest = f"{root}/clone-{side}"
            pkg.remote.remote_add(dest, "origin", url)
            graph = pkg.core.LineageGraph(path=dest, store=(
                PortStore(root=dest, **kw) if on_card
                else pkg.store(dest, **kw)))
            pkg.remote.pull(graph, t, state=_state(pkg, graph))
            clones[side] = graph
        tip = {k: np.asarray(v) for k, v in _stored(clones["a"], "ft2")
               .params.items()}
        assert (list(tip) == list(flats["ft2"])) == keys_sorted
        rng = np.random.default_rng(23)
        edits = {"a": [k for k in tip if k.startswith("layers/")],
                 "b": ["embed/tok"]}
        for side, keys in edits.items():
            flat = dict(tip)
            for k in keys:
                flat[k] = (tip[k] + rng.normal(scale=1e-3, size=tip[k].shape)
                           * (rng.random(tip[k].shape) < 0.3)).astype(
                               np.float32)
            clones[side].add_node(_artifact(pkg, arch, flat), "ft2")
        assert pkg.remote.push(clones["a"], t,
                               state=_state(pkg, clones["a"])).published
        pulled = pkg.remote.pull(clones["b"], t,
                                 state=_state(pkg, clones["b"]))
        if not keys_sorted:
            return _report(pulled)
        assert pulled.merge.status == pkg.core.POSSIBLE_CONFLICT, \
            pulled.merge.to_json()
        (outcome,) = [o for o in pulled.merge.outcomes if o.name == "ft2"]
        assert outcome.detail == AUTO_MERGED
        merged = clones["b"].nodes["ft2"].artifact_ref
        landed = pkg.remote.push(clones["b"], t,
                                 state=_state(pkg, clones["b"]))
        assert landed.published
        check_service(service)
        doc, etag = service.default.lineage()
        assert {n["name"]: n["artifact_ref"] for n in doc["nodes"]}["ft2"] \
            == merged
        store = clones["b"].store
        assert store.fsck(_roots(clones["b"]))["ok"]
        return {"refs": {n: g.nodes[n].artifact_ref for n in g.nodes},
                "merged": merged, "etag": etag, "keys": _keys(service.store),
                "pulled": _report(pulled), "landed": _report(landed),
                "bits": {k: np.asarray(v).tobytes() for k, v in
                         store.load_artifact(merged).params.items()}}


@pytest.mark.parametrize("on_card", [False, True],
                         ids=["host", "card-path-on-cpu"])
def test_collaboration_slice_on_paper_bert_matches_reference(
        tmp_path, monkeypatch, on_card):
    """Phase 4e of ``chip_smoke.py`` at a reduced paper-bert: the port's
    push, clones, auto-merging pull and push of the merge over its hub
    write the reference's manifest refs, merged ref, lineage etag and hub
    object keys, and its merged model bit for bit; on the card's path (its
    device mapped to the CPU) the clones' checkouts and the merge's commit
    go through the storage kernels' wrappers and still agree."""
    want = _slice(REF, str(tmp_path / "ref"), {"chunk_threshold": 0}, False)
    calls = {}
    if on_card:
        monkeypatch.setitem(ops._DEVICES, "cuda", "cpu")
        for name in ("dequant_apply_flat", "chain_apply_flat",
                     "snapshot_fused_flat"):
            fn = getattr(ops, name)

            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **k)
            monkeypatch.setattr(ops, name, counted)
    got = _slice(PORT, str(tmp_path / "port"), {"chunk_threshold": 0},
                 on_card)
    assert got == want
    if on_card:
        assert set(calls) == {"dequant_apply_flat", "chain_apply_flat",
                              "snapshot_fused_flat"}, calls


def test_recommit_from_a_checkout_in_another_key_order_conflicts_as_in_reference(
        tmp_path):
    """Pinned reference behaviour: ``state_graph`` chains the layers, and a
    re-commit matches each param to its parent's, in the order of the dict
    it is given. A lineage committed from ``param_shapes``' order and
    re-committed from checkouts (sorted keys) gets another layer chain and
    params delta'd against the wrong parent keys, so B's untouched layers
    read as changed and the pull reports a conflict, in both packages
    alike."""
    want, got = (_slice(pkg, str(tmp_path / pkg.name),
                        {"chunk_threshold": 0}, False, keys_sorted=False)
                 for pkg in PKGS)
    assert got == want
    assert want["merge"]["status"] == REF.core.CONFLICT
    assert want["merge"]["outcomes"][0]["detail"] == (
        "parameter merge conflict: common layer(s) updated by both changes")
