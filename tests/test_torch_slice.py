"""End-to-end parity of the port's main path with the reference package.

One model is carried across with ``repro_torch.convert`` (paper-bert-small
narrowed by ``ModelConfig.reduced()``, f32), and the same lineage is
committed through both packages: base -> ft1 -> ft2 -> ft3 (sparse
finetune noise) plus ``task-head``, a child of ft1 whose ``lm_head`` is
re-initialised (its delta overflows int8). The finetuned parameters are
made once with numpy and handed to both. Both packages must write the same
``artifact_ref``s, check out the same bits from a freshly opened store, and
each package's ``fsck`` must be clean on the other's repository.

The port runs two ways here: ``backend="ref"`` (the numpy twins) and its
device path with the device mapped to the CPU, where every kernel wrapper
runs its plain torch version. The run is repeated with the chunk engine
off and with a chunk threshold small enough that the larger tensors take
it.
"""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.core import LineageGraph as RefLineage
from repro.core import ModelArtifact as RefArtifact
from repro.models import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.store import ArtifactStore as RefStore
from repro.store.checkpoint import flatten_state, state_graph

import repro_torch.convert as convert
from repro_torch.common.hashing import tensor_hash
from repro_torch.core import LineageGraph
from repro_torch.kernels import ops
from repro_torch.store import ArtifactStore

CHUNKED = dict(chunk_threshold=128 * 1024, chunk_min=16 * 1024,
               chunk_avg=32 * 1024, chunk_max=64 * 1024)
LAYOUTS = {"whole": dict(chunk_threshold=0), "chunked": CHUNKED}
NODES = ("base", "ft1", "ft2", "ft3", "task-head")


@pytest.fixture(scope="module")
def lineage_params():
    """{node: flat f32 params}, made once with numpy from a seed."""
    cfg = dataclasses.replace(ref_get_config("paper-bert-small").reduced(),
                              dtype="float32")
    base = flatten_state(ref_init_params(cfg, 0))
    rng = np.random.default_rng(1234)

    def finetune(parent, scale):
        return {k: (v + rng.normal(scale=scale, size=v.shape)
                    * (rng.random(v.shape) < 0.3)).astype(np.float32)
                for k, v in parent.items()}

    params = {"base": base}
    params["ft1"] = finetune(base, 5e-5)
    params["ft2"] = finetune(params["ft1"], 1e-4)
    params["ft3"] = finetune(params["ft2"], 7e-5)
    head = dict(params["ft1"])
    shape = head["lm_head"].shape
    head["lm_head"] = (rng.normal(size=shape) / np.sqrt(shape[0])
                       ).astype(np.float32)
    params["task-head"] = head
    return cfg.name, params


def _commit(graph, make_artifact, params, arch):
    """base -> ft1 -> ft2 -> ft3 by version edges, task-head under ft1."""
    graph.add_node(make_artifact(params["base"]), "base")
    for parent, child in (("base", "ft1"), ("ft1", "ft2"), ("ft2", "ft3")):
        graph.add_node(None, child, model_type=arch)
        graph.add_version_edge(parent, child)
        graph.add_node(make_artifact(params[child]), child)
    graph.add_node(None, "task-head", model_type=arch)
    graph.add_edge("ft1", "task-head")
    graph.add_node(make_artifact(params["task-head"]), "task-head")
    return {n: graph.nodes[n].artifact_ref for n in NODES}


def _commit_reference(root, arch, params, layout):
    def make(flat):
        return RefArtifact(state_graph(flat, arch), flat, model_type=arch)
    return _commit(RefLineage(path=root, store=RefStore(root=root, **layout)),
                   make, params, arch)


def _commit_port(root, arch, params, layout, backend):
    def make(flat):
        return convert.to_artifact(flat, arch)
    store = ArtifactStore(root=root, backend=backend, **layout)
    return _commit(LineageGraph(path=root, store=store), make, params, arch)


def _checkout(store, refs):
    """{node: {key: array}} from ``store``, asserting each truth hash."""
    out = {}
    for node, ref in refs.items():
        art = store.materialize_artifact(ref)
        manifest = store.get_manifest(ref)
        for key, value in art.params.items():
            assert tensor_hash(value) == manifest["params"][key]["hash"], \
                (node, key)
        out[node] = {k: np.asarray(v) for k, v in art.params.items()}
    return out


@pytest.fixture
def device_path_on_cpu(monkeypatch):
    """Run the store's device path with the "cuda" device mapped to the CPU,
    counting the kernel wrappers' calls that ``ops`` makes."""
    monkeypatch.setitem(ops._DEVICES, "cuda", "cpu")
    calls = {}
    for name in ("snapshot_fused_flat", "delta_quantize_flat",
                 "dequant_apply_flat", "chain_apply_flat"):
        fn = getattr(ops, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("backend", ["ref", "cuda-on-cpu"])
def test_port_commits_and_checks_out_like_reference(tmp_path, request,
                                                    lineage_params, layout,
                                                    backend):
    arch, params = lineage_params
    cfg = LAYOUTS[layout]
    ref_root, port_root = str(tmp_path / "ref"), str(tmp_path / "port")
    calls = (request.getfixturevalue("device_path_on_cpu")
             if backend == "cuda-on-cpu" else None)
    ref_refs = _commit_reference(ref_root, arch, params, cfg)
    port_refs = _commit_port(port_root, arch, params, cfg,
                             "ref" if backend == "ref" else "cuda")
    assert port_refs == ref_refs

    # fresh stores on both roots: nothing comes from a commit-warmed cache
    ref_store = RefStore(root=ref_root, **cfg)
    port_store = ArtifactStore(root=port_root, backend="ref", **cfg)
    ref_out = _checkout(ref_store, ref_refs)
    port_out = _checkout(port_store, port_refs)
    for node in NODES:
        assert ref_out[node].keys() == port_out[node].keys()
        for key, value in ref_out[node].items():
            assert value.dtype == port_out[node][key].dtype
            np.testing.assert_array_equal(value.view(np.uint8),
                                          port_out[node][key].view(np.uint8))

    # each package's fsck is clean on the other's repository
    roots = list(ref_refs.values())
    assert RefStore(root=port_root, **cfg).fsck(roots)["ok"]
    assert ArtifactStore(root=ref_root, backend="ref", **cfg).fsck(roots)["ok"]

    manifests = [port_store.get_manifest(r) for r in port_refs.values()]
    kinds = {e["kind"] for m in manifests for e in m["params"].values()}
    assert "delta" in kinds
    assert ("chunked" in kinds) == (layout == "chunked")
    head = port_store.get_manifest(port_refs["task-head"])["params"]["lm_head"]
    if head["kind"] == "delta":
        assert head["qdtype"] == "int32"   # the int8 overflow fallback
    if backend != "ref":
        # the device path on the CPU went through every kernel wrapper
        # (checkout from a fresh device-path store folds the 3-hop chains)
        dev_store = ArtifactStore(root=port_root, backend="cuda", **cfg)
        dev_out = _checkout(dev_store, port_refs)
        for node in NODES:
            for key, value in port_out[node].items():
                np.testing.assert_array_equal(value, dev_out[node][key])
        wanted = {"snapshot_fused_flat", "dequant_apply_flat",
                  "chain_apply_flat"}
        if layout == "whole":
            wanted.add("delta_quantize_flat")
        assert wanted <= set(calls), calls


def test_reference_and_port_params_convert_identically(lineage_params):
    arch, params = lineage_params
    flat = params["ft2"]
    ref_art = RefArtifact(state_graph(flat, arch), flat, model_type=arch)
    port_art = convert.to_artifact(flat, arch)
    assert port_art.graph.to_json() == ref_art.graph.to_json()
    assert port_art.param_hashes() == ref_art.param_hashes()
    for k, v in port_art.params.items():
        np.testing.assert_array_equal(v, flat[k])


ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)",
                              re.MULTILINE)


def test_port_sources_import_no_jax_and_no_reference():
    examples = sorted((ROOT / "examples" / "torch").glob("*.py"))
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + examples)
    assert len(files) > 30
    assert PORT / "diag" / "runner.py" in files
    assert PORT / "remote" / "sync.py" in files
    assert PORT / "hub" / "routes.py" in files
    assert PORT / "cli.py" in files
    assert [f.stem for f in examples] == ["federated", "finetune_cascade",
                                          "quickstart", "serve_batched"]
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files
                 for m in FORBIDDEN_IMPORT.finditer(f.read_text())]
    assert offenders == []


def test_every_port_module_imports_with_jax_blocked():
    code = textwrap.dedent("""
        import importlib, json, pkgutil, sys
        sys.modules["jax"] = None      # any import of jax now raises
        sys.modules["repro"] = None    # and so does the reference package
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                       "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        loaded = [m for m, mod in sys.modules.items() if mod is not None
                  and (m.split(".")[0] in ("jax", "jaxlib", "repro"))]
        assert not loaded, loaded
        print(json.dumps(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(json.loads(out.stdout))
    assert len(names) >= 30
    # the lineage operations and the diagnostics engine are among them
    assert {f"repro_torch.core.{m}" for m in ("diff", "merge", "cascade",
                                              "auto")} <= names
    assert {f"repro_torch.diag.{m}" for m in ("runner", "transfer", "gate",
                                              "blame")} <= names
    # and the collaboration layer
    assert {f"repro_torch.remote.{m}" for m in (
        "transport", "negotiate", "journal", "http", "sync")} <= names
    assert {f"repro_torch.hub.{m}" for m in (
        "auth", "app", "gc", "routes", "replica")} <= names
