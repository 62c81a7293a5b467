"""The port's mgit CLI (``repro_torch.cli``) against the reference's, on the
CPU.

Every case of ``tests/test_cli.py`` and ``tests/test_cli_docs.py``, the two
CLI cases of ``tests/test_obs.py`` and
``tests/test_remote_sync.py::test_cli_remote_push_pull_fsck`` runs in both
packages (``tests/torch_harness.py``'s namespaces), the port's CLI with
``--backend ref``. Beyond the mirror:

* on one reference-written repository, ``log``, ``show``, ``diff``,
  ``param``, ``checkout``, ``stats`` and ``fsck`` print the same output in
  both packages, but ``checkout``'s ``seconds`` (a clock reading);
* a repository the port's CLI wrote with ``train``, ``push``, ``clone``
  and ``pull`` is opened, checked out and ``fsck``ed clean by the
  reference's CLI;
* bf16: ``param`` prints ``bfloat16`` and the norm of the widened values,
  ``_param_rms`` equals an ``ml_dtypes`` computation, and the reference's
  own ``param`` on a bf16 lineage raises (pinned, not copied);
* with no card and no ``--backend ref``, every command that opens a store
  raises ``KernelError``; the global ``--backend`` and ``serve --backend``
  parse to one meaning;
* the builtin probe's ledger identity differs between the packages, so a
  ledger written by one is executed again, not answered, by the other;
* the daemons (``hub serve``, ``serve``) run as ``python -m
  repro_torch.cli`` subprocesses on a loopback port and print their URL.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.request

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.cli as ref_cli
import repro.diag as ref_diag
import repro.obs as ref_obs

import repro_torch.cli as port_cli
import repro_torch.diag as port_diag
import repro_torch.obs as port_obs
from repro_torch.common import bf16
from repro_torch.convert import to_artifact
from repro_torch.kernels.build import KernelError
from repro_torch.models import get_config, init_params

from helpers import finetune_like
from torch_harness import PORT, REF
from torch_helpers import make_chain_model

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO_ROOT, "src")
MODULES = {"ref": ref_cli, "port": port_cli}
OBS = {"ref": ref_obs, "port": port_obs}
DOCS = {"ref": "cli.md", "port": "cli_torch.md"}


def cli_of(pkg):
    """``main`` of ``pkg``'s CLI; the port's asks for the CPU."""
    if pkg is REF:
        return ref_cli.main
    return lambda argv: port_cli.main(["--backend", "ref", *argv])


@pytest.fixture(params=[REF, PORT], ids=lambda p: p.name)
def pkg(request):
    return request.param


def _seed_chain(pkg, path):
    """``tests/test_cli.py``'s repository: base -> ft."""
    g = pkg.core.LineageGraph(path=path, store=pkg.store(path))
    base = make_chain_model(pkg.core, seed=0, d=32)
    g.add_node(base, "base")
    g.add_edge("base", "ft")
    g.add_node(finetune_like(base, seed=1), "ft")
    return g


@pytest.fixture
def repo(pkg, tmp_path):
    path = str(tmp_path)
    _seed_chain(pkg, path)
    return path


# ---------------------------------------------------------------------------
# tests/test_cli.py, in both packages
# ---------------------------------------------------------------------------


def test_cli_log(pkg, repo, capsys):
    assert cli_of(pkg)(["-C", repo, "log"]) == 0
    out = capsys.readouterr().out
    assert "base" in out and "ft" in out


def test_cli_show(pkg, repo, capsys):
    cli_of(pkg)(["-C", repo, "show", "ft"])
    info = json.loads(capsys.readouterr().out)
    assert info["parents"] == ["base"]
    assert info["storage"]["depth"] >= 1  # delta-compressed against base


def test_cli_diff(pkg, repo, capsys):
    cli_of(pkg)(["-C", repo, "diff", "base", "ft", "--mode", "structural"])
    d = json.loads(capsys.readouterr().out)
    assert d["divergence"] == 0.0


def test_cli_stats_and_gc(pkg, repo, capsys):
    cli = cli_of(pkg)
    cli(["-C", repo, "stats"])
    stats = json.loads(capsys.readouterr().out)
    assert stats["compression_ratio"] > 1.0
    cli(["-C", repo, "remove-node", "ft"])
    cli(["-C", repo, "gc"])
    out = capsys.readouterr().out
    assert "reclaimed" in out


def test_cli_diag_run_memoizes_across_invocations(pkg, repo, capsys):
    cli = cli_of(pkg)
    assert cli(["-C", repo, "diag", "run", "--builtin"]) == 0
    cold = json.loads(capsys.readouterr().out)
    assert cold["executed"] > 0 and cold["memo_hits"] == 0
    assert cli(["-C", repo, "diag", "run", "--builtin"]) == 0
    warm = json.loads(capsys.readouterr().out)
    assert warm["executed"] == 0 and warm["cache_hit_ratio"] == 1.0


def test_cli_diag_history_and_gate_report(pkg, repo, capsys):
    cli = cli_of(pkg)
    cli(["-C", repo, "diag", "run", "--builtin"])
    capsys.readouterr()
    assert cli(["-C", repo, "diag", "history", "ft"]) == 0
    entries = json.loads(capsys.readouterr().out)
    assert entries and entries[0]["test"] == "builtin/param_rms"
    assert cli(["-C", repo, "diag", "gate-report"]) == 0
    assert json.loads(capsys.readouterr().out) == []


def test_cli_diag_blame(pkg, repo, capsys):
    assert cli_of(pkg)(["-C", repo, "diag", "blame", "ft",
                        "builtin/param_rms", "--builtin"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["status"] == "pass" and report["frontier"] == []


def test_cli_diag_run_without_tests_errors(pkg, repo, capsys):
    assert cli_of(pkg)(["-C", repo, "diag", "run"]) == 1
    assert "no registered tests" in capsys.readouterr().out


def test_cli_test_pattern_modes_are_exclusive(pkg, repo):
    with pytest.raises(SystemExit):
        cli_of(pkg)(["-C", repo, "test", "--re", "a", "--glob", "b"])


def test_cli_version_edge(pkg, repo, capsys):
    g = pkg.core.LineageGraph(path=repo, store=pkg.store(repo))
    base = g.get_model("base")
    g.add_node(finetune_like(base, seed=9), "base2", model_type="toy")
    cli_of(pkg)(["-C", repo, "add-version-edge", "base", "base2"])
    capsys.readouterr()
    # reload from disk to confirm the CLI persisted the edge
    g2 = pkg.core.LineageGraph(path=repo)
    assert g2.nodes["base"].version_children == ["base2"]


# ---------------------------------------------------------------------------
# tests/test_cli_docs.py, in both packages (the port's docs/cli_torch.md)
# ---------------------------------------------------------------------------


def test_cli_docs_match_argparse_tree(pkg):
    mod = MODULES[pkg.name]
    generated = mod.dump_docs(mod.build_parser()) + "\n"
    with open(os.path.join(REPO_ROOT, "docs", DOCS[pkg.name])) as f:
        committed = f.read()
    assert committed == generated, (
        f"docs/{DOCS[pkg.name]} has drifted from the argparse tree — "
        f"regenerate with:  PYTHONPATH=src python -m {mod.__name__} "
        f"--dump-docs > docs/{DOCS[pkg.name]}")


def test_dump_docs_flag_prints_reference(pkg):
    mod = MODULES[pkg.name]
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", mod.__name__, "--dump-docs"],
        capture_output=True, text=True, env=env, check=True, timeout=300)
    assert out.stdout.startswith("# mgit — CLI reference")
    # deterministic across invocations (no terminal-width dependence)
    assert out.stdout == mod.dump_docs(mod.build_parser()) + "\n"


def test_docs_reference_every_command(pkg):
    mod = MODULES[pkg.name]
    generated = mod.dump_docs(mod.build_parser())
    for command in ("log", "show", "diff", "test", "param", "checkout",
                    "stats", "gc", "remote", "push", "pull", "clone",
                    "fsck", "diag", "hub"):
        assert f"mgit {command}" in generated, f"{command} missing from docs"


def test_port_docs_name_the_port_module_and_its_backend():
    generated = port_cli.dump_docs(port_cli.build_parser())
    assert "python -m repro_torch.cli" in generated
    assert "docs/cli_torch.md" in generated
    assert "python -m repro.cli" not in generated
    assert "`--backend BACKEND`" in generated          # the global option
    assert "`--backend SERVE_BACKEND`" in generated    # serve's own


# ---------------------------------------------------------------------------
# the CLI cases of tests/test_obs.py and tests/test_remote_sync.py
# ---------------------------------------------------------------------------


def _parse_prometheus(text):
    """``tests/test_obs.py``'s exposition-format parser."""
    samples, types = {}, {}
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            types[name] = kind
            continue
        if line.startswith("#"):
            continue
        metric, _, value = line.rpartition(" ")
        assert metric and value, f"unparseable line {line!r}"
        float(value)  # must be a number
        samples[metric] = float(value)
    return samples, types


def _seed_versions(pkg, path):
    """``m@v1 -> m@v2`` (``tests/test_obs.py``'s ``_seed``)."""
    g = pkg.core.LineageGraph(path=path, store=pkg.store(path))
    base = make_chain_model(pkg.core, seed=0, d=32)
    g.add_node(base, "m@v1")
    g.add_edge("m@v1", "m@v2")
    g.add_node(finetune_like(base, seed=1), "m@v2")
    return g


def test_cli_obs_metrics(pkg, tmp_path, capsys):
    _seed_versions(pkg, str(tmp_path))
    assert cli_of(pkg)(["-C", str(tmp_path), "obs", "metrics"]) == 0
    samples, types = _parse_prometheus(capsys.readouterr().out)
    assert any(k.startswith("mgit_store_") for k in samples)


def test_cli_obs_trace_emits_perfetto_json(pkg, tmp_path, capsys):
    _seed_versions(pkg, str(tmp_path))
    out = str(tmp_path / "trace.json")
    assert cli_of(pkg)(["-C", str(tmp_path), "obs", "--out", out, "trace",
                        "checkout", "m@v2"]) == 0
    capsys.readouterr()
    doc = json.load(open(out))
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    names = {e["name"] for e in evs}
    assert {"store.checkout", "checkout.param"} <= names
    assert not OBS[pkg.name].is_enabled()  # tracing restored off after the run


def test_cli_obs_trace_recovers_out_after_the_action(tmp_path, capsys):
    """``--out`` after ``trace`` lands in REMAINDER; the port recovers it
    as the reference does, and its nested command keeps ``--backend``."""
    _seed_versions(PORT, str(tmp_path))
    out = str(tmp_path / "after.json")
    assert cli_of(PORT)(["-C", str(tmp_path), "obs", "trace", "--out", out,
                         "checkout", "m@v2"]) == 0
    assert json.loads(capsys.readouterr().out)["node"] == "m@v2"
    assert any(e.get("ph") == "X" for e in json.load(open(out))["traceEvents"])


def test_cli_remote_push_pull_fsck(pkg, tmp_path):
    cli = cli_of(pkg)
    src = str(tmp_path / "src")
    g = _seed_versions(pkg, src)
    g.add_version_edge("m@v1", "m@v2")
    remote = str(tmp_path / "remote")
    dst = str(tmp_path / "dst")
    assert cli(["-C", src, "remote", "add", "origin", remote]) == 0
    assert cli(["-C", src, "push", "origin"]) == 0
    assert cli(["clone", remote, dst]) == 0
    assert cli(["-C", dst, "log"]) == 0
    assert cli(["-C", dst, "fsck"]) == 0
    assert cli(["-C", dst, "pull", "origin"]) == 0
    g2 = pkg.core.LineageGraph(path=dst)
    assert sorted(g2.nodes) == ["m@v1", "m@v2"]


# ---------------------------------------------------------------------------
# the two packages on one repository
# ---------------------------------------------------------------------------


def _output(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("command", [
    ["log"], ["show", "ft"], ["diff", "base", "ft"],
    ["diff", "base", "ft", "--mode", "structural"], ["param", "ft", "L0/w"],
    ["param", "ft", "nope"], ["checkout", "ft"], ["stats"], ["fsck"]],
    ids=lambda c: "-".join(c))
def test_reference_written_repository_prints_the_same_in_both(
        tmp_path, capsys, command):
    path = str(tmp_path)
    _seed_chain(REF, path)
    argv = ["-C", path, *command]
    rc_ref, ref_out = _output(cli_of(REF), argv, capsys)
    rc_port, port_out = _output(cli_of(PORT), argv, capsys)
    assert rc_port == rc_ref
    if command[0] == "checkout":     # a clock reading, not a result
        ref_doc, port_doc = json.loads(ref_out), json.loads(port_out)
        assert port_doc.pop("seconds") >= 0 and ref_doc.pop("seconds") >= 0
        assert port_doc == ref_doc
    else:
        assert port_out == ref_out


def _checkout(store, ref):
    return store.materialize_artifact(ref).params


def test_port_cli_repository_opens_in_the_reference(tmp_path, capsys):
    """``train``, ``push``, ``clone`` and ``pull`` through the port's CLI;
    the reference's CLI then logs, checks out and fscks all three
    repositories clean, with the port's checkouts bit for bit."""
    port = cli_of(PORT)
    work, remote, dest = (str(tmp_path / n) for n in ("work", "remote",
                                                      "dest"))
    assert port(["-C", work, "train", "--steps", "4",
                 "--commit-every", "2"]) == 0
    assert json.loads(capsys.readouterr().out)["latest_step"] == 4
    assert port(["-C", work, "remote", "add", "origin", remote]) == 0
    assert port(["-C", work, "push", "origin"]) == 0
    assert port(["clone", remote, dest]) == 0
    capsys.readouterr()
    assert port(["-C", work, "train", "--steps", "2",
                 "--commit-every", "2"]) == 0
    assert json.loads(capsys.readouterr().out)["start_step"] == 4
    assert port(["-C", work, "push", "origin"]) == 0
    capsys.readouterr()
    assert port(["-C", dest, "pull", "origin"]) == 0
    pulled = json.loads(capsys.readouterr().out)
    assert pulled["merge"]["conflicts"] == []
    for path in (work, remote, dest):
        g_port = PORT.core.LineageGraph(path=path, store=PORT.store(path))
        g_ref = REF.core.LineageGraph(path=path, store=REF.store(path))
        assert sorted(g_ref.nodes) == ["cli-train/step2", "cli-train/step4",
                                       "cli-train/step6"]
        _, log = _output(cli_of(REF), ["-C", path, "log"], capsys)
        assert "cli-train/step6" in log
        for name, node in g_ref.nodes.items():
            rc, out = _output(cli_of(REF), ["-C", path, "checkout", name],
                              capsys)
            assert rc == 0 and json.loads(out)["params"] > 0
            want = _checkout(g_port.store, node.artifact_ref)
            got = _checkout(g_ref.store, node.artifact_ref)
            assert set(got) == set(want)
            for k, v in got.items():
                assert v.dtype == want[k].dtype
                assert v.tobytes() == want[k].tobytes()
        rc, out = _output(cli_of(REF), ["-C", path, "fsck"], capsys)
        assert rc == 0 and json.loads(out)["ok"]


# ---------------------------------------------------------------------------
# bf16: a reduced qwen3-0.6b lineage written by the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_repo(tmp_path_factory):
    """base -> ft of a 2-layer reduced qwen3-0.6b in bf16, committed by
    the port's host store; returns (path, {node: {key: carrier}})."""
    path = str(tmp_path_factory.mktemp("bf16"))
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                              dtype="bfloat16", n_layers=2)
    base = to_artifact(init_params(cfg, torch.Generator().manual_seed(0)),
                       cfg.name)
    rng = np.random.default_rng(1)
    ft = {k: bf16.narrow(bf16.widen(v) + rng.normal(
        0, 1e-2, v.shape).astype(np.float32)) for k, v in base.params.items()}
    g = PORT.core.LineageGraph(path=path, store=PORT.store(path))
    g.add_node(base, "base")
    g.add_edge("base", "ft")
    g.add_node(to_artifact(ft, cfg.name), "ft")
    return path, {n: _checkout(g.store, g.nodes[n].artifact_ref)
                  for n in ("base", "ft")}


def _ml(carrier):
    return np.asarray(carrier).view(np.uint16).view(ml_dtypes.bfloat16)


@pytest.mark.parametrize("node", ["base", "ft"])
@pytest.mark.parametrize("key", ["embed/tok", "layers/mlp/w_in"])
def test_bf16_param_prints_bfloat16_and_the_widened_norm(bf16_repo, capsys,
                                                         node, key):
    path, models = bf16_repo
    assert cli_of(PORT)(["-C", path, "param", node, key]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["dtype"] == "bfloat16"
    value = models[node][key]
    assert bf16.is_bf16(value)
    assert doc["shape"] == list(value.shape)
    want = float(np.linalg.norm(_ml(value).astype(np.float64)))
    assert doc["l2_norm"] == want
    # the carrier's bits read as integers give another, wrong, norm
    assert want != float(np.linalg.norm(np.asarray(value, np.float64)))


@pytest.mark.parametrize("node", ["base", "ft"])
def test_bf16_param_rms_matches_ml_dtypes(bf16_repo, node):
    _, models = bf16_repo
    params = models[node]
    wide = [_ml(v).astype(np.float64) for v in params.values()]
    want = float(np.sqrt(sum(float((w * w).sum()) for w in wide)
                         / sum(w.size for w in wide)))
    model = PORT.core.ModelArtifact(PORT.core.LayerGraph(), params)
    assert port_cli._param_rms(model) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("node", ["base", "ft"])
def test_reference_param_on_a_bf16_lineage_raises_as_pinned(bf16_repo,
                                                            node):
    """The reference cannot read its own bf16 objects back (ROADMAP §3):
    its ``param`` raises on the ``|V2`` array it gets."""
    path, _ = bf16_repo
    with pytest.raises(ValueError,
                       match="setting an array element with a sequence"):
        ref_cli.main(["-C", path, "param", node, "embed/tok"])


# ---------------------------------------------------------------------------
# the device option
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("command", [
    ["log"], ["show", "ft"], ["param", "ft", "L0/w"], ["checkout", "ft"],
    ["diff", "base", "ft"], ["stats"], ["fsck"], ["gc"],
    ["diag", "run", "--builtin"], ["remote", "list"], ["push", "elsewhere"],
    ["obs", "metrics"], ["obs", "trace"], ["clone", "SRC", "fresh"],
    ["train", "--steps", "1"], ["hub", "serve", "--port", "0"],
    ["hub", "gc"], ["serve", "prod=node:ft", "--port", "0"]],
    ids=lambda c: "-".join(c))
def test_store_commands_raise_without_a_card(tmp_path, monkeypatch, command):
    path = str(tmp_path / "repo")
    _seed_chain(PORT, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.replace("SRC", path).replace("fresh", str(tmp_path / "fresh"))
            .replace("elsewhere", str(tmp_path / "elsewhere"))
            for a in command]
    with pytest.raises(KernelError, match="no CUDA device"):
        port_cli.main(["-C", path, *argv])
    # asking for the CPU outright is the same refusal, not a fallback
    with pytest.raises(KernelError, match="no CUDA device"):
        port_cli.main(["--backend", "cuda", "-C", path, *argv])


@pytest.mark.parametrize("argv,backend,serve_backend,effective", [
    (["serve", "p=node:x"], "cuda", None, "cuda"),
    (["--backend", "ref", "serve", "p=node:x"], "ref", None, "ref"),
    (["serve", "--backend", "ref", "p=node:x"], "cuda", "ref", "ref"),
    (["--backend", "ref", "serve", "--backend", "cuda", "p=node:x"], "ref",
     "cuda", "cuda"),
    (["--backend", "ref", "log"], "ref", None, "ref"),
])
def test_both_backend_spellings_parse_to_one_meaning(argv, backend,
                                                     serve_backend, effective):
    args = port_cli.build_parser().parse_args(argv)
    assert args.backend == backend
    assert getattr(args, "serve_backend", None) == serve_backend
    assert (getattr(args, "serve_backend", None) or args.backend) == effective


def test_unknown_backend_is_refused():
    with pytest.raises(SystemExit):
        port_cli.build_parser().parse_args(["--backend", "tpu", "log"])


class _Bound(Exception):
    pass


@pytest.mark.parametrize("spelling", [
    ["--backend", "ref", "serve", "prod=node:ft"],
    ["serve", "--backend", "ref", "prod=node:ft"]], ids=["global", "serve"])
def test_serve_opens_its_pool_on_the_backend_asked_for(tmp_path, monkeypatch,
                                                       spelling):
    import repro_torch.serve as serve
    path = str(tmp_path)
    _seed_chain(PORT, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = {}

    def make_server(app, host, port):
        seen.update(pool=app.pool.backend, store=app.pool.store.backend)
        raise _Bound

    monkeypatch.setattr(serve, "make_server", make_server)
    with pytest.raises(_Bound):
        port_cli.main(["-C", path, *spelling])
    assert seen == {"pool": "ref", "store": "ref"}


# ---------------------------------------------------------------------------
# the diagnostics ledger across the packages
# ---------------------------------------------------------------------------


def _builtin_test(pkg, path):
    g = pkg.core.LineageGraph(path=path, store=pkg.store(path))
    MODULES[pkg.name]._register_builtin_probes(g)
    (test,) = g.tests
    return test


def test_builtin_probe_identity_differs_between_packages(tmp_path):
    path = str(tmp_path)
    _seed_chain(REF, path)
    ref_id = ref_diag.test_identity_hash(_builtin_test(REF, path))
    port_id = port_diag.test_identity_hash(_builtin_test(PORT, path))
    # stable within a package (bytecode and constants) ...
    assert ref_id == ref_diag.test_identity_hash(_builtin_test(REF, path))
    assert port_id == port_diag.test_identity_hash(_builtin_test(PORT, path))
    # ... and not across them: the port's probe widens bf16 first
    assert ref_id != port_id


@pytest.mark.parametrize("first", [REF, PORT], ids=lambda p: p.name)
def test_a_ledger_of_one_package_is_executed_again_by_the_other(
        tmp_path, capsys, first):
    path = str(tmp_path)
    _seed_chain(REF, path)
    second = PORT if first is REF else REF
    runs = {}
    for label, pkg in (("first", first), ("second", second),
                       ("first again", first), ("second again", second)):
        assert cli_of(pkg)(["-C", path, "diag", "run", "--builtin"]) == 0
        runs[label] = json.loads(capsys.readouterr().out)
    assert runs["first"]["executed"] == 2
    assert runs["second"]["executed"] == 2 and runs["second"]["memo_hits"] == 0
    for label in ("first again", "second again"):
        assert runs[label]["executed"] == 0
        assert runs[label]["cache_hit_ratio"] == 1.0
    # the same f32 RMS from both probes
    for node in ("base", "ft"):
        values = {runs[k]["results"][node]["builtin/param_rms"]["value"]
                  for k in runs}
        assert len(values) == 1


# ---------------------------------------------------------------------------
# the daemons, as subprocesses of the module entry point
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def daemon(argv, timeout=120.0):
    """``python -m repro_torch.cli --backend ref *argv`` in a subprocess;
    yields (its URL, the lines it printed up to it), killed on exit."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.cli", "--backend", "ref", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        deadline = time.monotonic() + timeout
        lines = []
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            url = next((w for w in line.split() if w.startswith("http://")),
                       None)
            if url is not None:
                yield url, lines
                return
        raise AssertionError(f"no URL printed: {''.join(lines)}")
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_hub_daemon_prints_its_url_and_takes_a_push(tmp_path, capsys):
    src, hub, dest = (str(tmp_path / n) for n in ("src", "hub", "dest"))
    _seed_versions(PORT, src)
    cli = cli_of(PORT)
    with daemon(["-C", hub, "hub", "serve", "--port", "0"]) as (url, lines):
        assert lines[-1].startswith(f"mgit hub: serving {hub} at {url}")
        assert cli(["-C", src, "remote", "add", "origin",
                    url + "/r/team"]) == 0
        assert cli(["-C", src, "push", "origin"]) == 0
        assert cli(["clone", url + "/r/team", dest]) == 0
        capsys.readouterr()
        assert cli(["-C", dest, "pull", "origin"]) == 0
        assert json.loads(capsys.readouterr().out)["objects_transferred"] == 0
        assert cli(["hub", "stats", url]) == 0
        assert json.loads(capsys.readouterr().out)
        assert cli(["hub", "gc", url]) == 0
        assert isinstance(json.loads(capsys.readouterr().out), dict)
    assert sorted(PORT.core.LineageGraph(path=dest).nodes) == ["m@v1", "m@v2"]


def test_serve_daemon_answers_with_the_host_views_probe(tmp_path):
    path = str(tmp_path)
    g = _seed_chain(PORT, path)
    from repro_torch.serve import ModelPool
    host = ModelPool(PORT.store(path), backend="ref")
    with daemon(["-C", path, "serve", "prod=node:ft", "canary=node:base",
                 "--port", "0"]) as (url, lines):
        assert "2 endpoint(s)" in lines[-1]
        for name, node in (("prod", "ft"), ("canary", "base")):
            ref = g.nodes[node].artifact_ref
            out = _post(f"{url}/api/predict/{name}", {})
            probe = host.get(ref).probe()
            assert out["ref"] == ref
            assert out["y"] == [float(v) for v in probe.ravel()[:16]]
            assert out["mean"] == float(probe.mean())
        with urllib.request.urlopen(url + "/api/stats", timeout=60) as r:
            stats = json.loads(r.read())
        assert stats["pool"]["views_built"] >= 2
