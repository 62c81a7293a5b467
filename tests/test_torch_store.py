"""The port's storage substrate against the reference package, on the CPU.

Codec bytes, pack records and CAS keys must be identical, a CAS written by
either package must reopen in the other, and ``delta_compression`` must
give the same ``ParamDelta`` blobs. Also covered: the numpy twins, the
model templates and weight conversion, the sharding cuts the chunk layer
reads, and the store's refusal to fall back to the CPU by default.
"""

import dataclasses
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import ModelArtifact as RefArtifact
from repro.dist.sharding import shard_cuts as ref_shard_cuts
from repro.models import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.models.model import param_shapes as ref_param_shapes
from repro.store import CAS as RefCAS
from repro.store import ArtifactStore as RefStore
from repro.store import delta_compression as ref_delta_compression
from repro.store import lcs_param_matching as ref_lcs
from repro.store.checkpoint import flatten_state, state_graph
from repro.store.codecs import CODECS as REF_CODECS
from repro.store.codecs import get_codec as ref_get_codec
from repro.store.delta import host_dequant as ref_host_dequant

import repro_torch.convert as convert
from repro_torch.common.hashing import tensor_hash
from repro_torch.dist import shard_cuts
from repro_torch.kernels import ops
from repro_torch.models import get_config, init_params, param_shapes
from repro_torch.store import (CAS, CODECS, ArtifactStore, delta_compression,
                               lcs_param_matching)
from repro_torch.store.codecs import get_codec
from repro_torch.store.delta import (decompress_param, host_dequant,
                                     host_snapshot)

from helpers import make_chain_model


def _codec_input(dtype: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    base = np.concatenate([
        rng.integers(-3, 4, size=3000), np.zeros(2000, np.int64),
        rng.integers(-120, 120, size=500), [-1, 0, 1, 127, -127]])
    if dtype == "uint32":
        return base.astype(np.int64).astype(np.uint32)
    return base.astype(dtype)


@pytest.mark.parametrize("dtype", ["int8", "int32", "uint32"])
@pytest.mark.parametrize("codec", sorted(REF_CODECS))
def test_codec_bytes_identical(codec, dtype):
    assert sorted(CODECS) == sorted(REF_CODECS)
    arr = _codec_input(dtype)
    blob = CODECS[codec].encode(arr)
    assert blob == REF_CODECS[codec].encode(arr)
    # the dtype is always passed: xd's decode defaults to uint32
    out = CODECS[codec].decode(blob, arr.size, dtype=dtype)
    np.testing.assert_array_equal(out, arr)
    np.testing.assert_array_equal(
        REF_CODECS[codec].decode(blob, arr.size, dtype=dtype), out)


@pytest.mark.parametrize("name, preset", [("lzma", 0), ("lzma", 1),
                                          ("zlib", 1), ("zlib", 9)])
def test_tuned_codec_bytes_identical(name, preset):
    arr = _codec_input("int8")
    assert (get_codec(name, preset).encode(arr)
            == ref_get_codec(name, preset).encode(arr))


def _objects():
    rng = np.random.default_rng(2)
    small = rng.normal(size=(64, 3)).astype(np.float32)        # packed
    large = rng.normal(size=(300, 300)).astype(np.float32)     # loose
    return small, large, b"delta-blob" * 40, b'{"manifest": 1}'


def test_cas_keys_and_pack_records_identical(tmp_path):
    small, large, blob, manifest = _objects()
    stores = {"ref": RefCAS(str(tmp_path / "ref")),
              "port": CAS(str(tmp_path / "port"))}
    keys = {}
    for name, cas in stores.items():
        with cas.batch():
            keys[name] = [cas.put_tensor(small), cas.put_tensor(large),
                          cas.put_bytes(blob),
                          cas.put_bytes(manifest, key="m_test")]
        cas.flush()
    assert keys["ref"] == keys["port"]
    assert keys["port"][0] == tensor_hash(small)
    for sub in ("packs", "objects"):
        ref_dir, port_dir = tmp_path / "ref" / sub, tmp_path / "port" / sub
        names = sorted(os.listdir(ref_dir))
        assert names == sorted(os.listdir(port_dir))
        for n in names:
            if n.endswith(".pack") or sub == "objects":
                assert ((ref_dir / n).read_bytes()
                        == (port_dir / n).read_bytes()), n


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cas_reopens_across_packages(tmp_path, writer):
    small, large, blob, _ = _objects()
    make = {"ref": RefCAS, "port": CAS}
    cas = make[writer](str(tmp_path))
    keys = [cas.put_tensor(small), cas.put_tensor(large), cas.put_bytes(blob)]
    cas.flush()
    other = make["port" if writer == "ref" else "ref"](str(tmp_path))
    np.testing.assert_array_equal(other.get_tensor(keys[0]), small)
    np.testing.assert_array_equal(other.get_tensor(keys[1]), large)
    assert other.get_bytes(keys[2]) == blob
    assert other.fsck()["ok"]


def _pair(seed=0):
    parent = make_chain_model(seed=seed, d=32)
    rng = np.random.default_rng(seed + 1)
    child_params = {}
    for k, v in parent.params.items():
        step = rng.normal(scale=5e-5, size=v.shape) * (rng.random(v.shape) < 0.3)
        child_params[k] = (v + step).astype(np.float32)
    child_params["head/w"] = rng.normal(size=parent.params["head/w"].shape
                                        ).astype(np.float32)   # int8 overflow
    child = RefArtifact(parent.graph, child_params, model_type="toy")
    return parent, child


def _port(art):
    from repro_torch.core import LayerGraph, ModelArtifact
    return ModelArtifact(LayerGraph.from_json(art.graph.to_json()),
                         dict(art.params), model_type=art.model_type,
                         metadata=dict(art.metadata))


@pytest.mark.parametrize("ref_backend", [None, "ref"])
@pytest.mark.parametrize("per_param", [True, False])
def test_delta_compression_blobs_identical(ref_backend, per_param):
    parent, child = _pair()
    r = ref_delta_compression(child, parent, per_param=per_param,
                              backend=ref_backend)
    p = delta_compression(_port(child), _port(parent), per_param=per_param,
                          backend="ref")
    assert (p.accepted, p.raw_bytes, p.compressed_bytes) == \
        (r.accepted, r.raw_bytes, r.compressed_bytes)
    assert sorted(p.deltas) == sorted(r.deltas)
    assert {d.qdtype for d in p.deltas.values()} == {"int8", "int32"}
    for k, d in r.deltas.items():
        pd = p.deltas[k]
        assert (pd.blob, pd.qdtype, pd.codec, pd.shape, pd.dtype) == \
            (d.blob, d.qdtype, d.codec, d.shape, d.dtype)
        np.testing.assert_array_equal(p.reconstructed.params[k],
                                      r.reconstructed.params[k])
        # invert the delta through the numpy twin
        np.testing.assert_array_equal(
            decompress_param(parent.params[k], pd, backend="ref"),
            r.reconstructed.params[k])


def test_lcs_matching_identical():
    parent, _ = _pair()
    other = make_chain_model(seed=3, d=32, n_layers=6)
    assert lcs_param_matching(_port(parent), _port(other)) == \
        ref_lcs(parent, other)


@pytest.mark.parametrize("eps", [1e-4, 1e-3, 5e-5])
def test_numpy_twins_match_reference_and_plain_versions(eps):
    rng = np.random.default_rng(4)
    p1 = (rng.normal(size=(97, 53)) * 3).astype(np.float32)
    p2 = (p1 + rng.normal(scale=1e-3, size=p1.shape)).astype(np.float32)
    q, nz, narrow = host_snapshot(p1, p2, eps)
    qo, nzo, _, narrow_o = ops.snapshot_fused(p1, p2, eps=eps, backend="ref",
                                              with_fingerprint=False)
    assert (nz, narrow) == (nzo, narrow_o)
    np.testing.assert_array_equal(q, qo)
    q32 = rng.integers(-2000, 2000, size=p1.shape).astype(np.int32)
    out = host_dequant(p1, q32, eps)
    np.testing.assert_array_equal(out, ref_host_dequant(p1, q32, eps))
    np.testing.assert_array_equal(
        out, ops.dequant_apply(p1, q32, eps=eps, backend="ref"))
    half = host_dequant(p1, q32, eps, out_dtype="float16")
    assert half.dtype == np.float16
    np.testing.assert_array_equal(
        half, ref_host_dequant(p1, q32, eps, out_dtype="float16"))
    # bfloat16 computes: the host carrier, with the reference's bits
    brain = host_dequant(p1, q32, eps, out_dtype="bfloat16")
    assert brain.dtype == np.uint16 and tensor_hash(brain) == tensor_hash(
        ref_host_dequant(p1, q32, eps, out_dtype=ml_dtypes.bfloat16))
    np.testing.assert_array_equal(
        brain, ref_host_dequant(p1, q32, eps, out_dtype=ml_dtypes.bfloat16)
        .view(np.uint16))


@pytest.mark.parametrize("n_shards", [1, 2, 4, 7])
def test_shard_cuts_identical(n_shards):
    cfg = ref_get_config("paper-bert")
    for path, shape in ref_param_shapes(cfg).items():
        assert shard_cuts(path, shape, 4, n_shards) == \
            ref_shard_cuts(path, shape, 4, n_shards)


def _cut_input(kind: str) -> bytes:
    rng = np.random.default_rng(23)
    if kind == "random":
        return rng.integers(0, 256, 3 * 2 ** 20, dtype=np.uint8).tobytes()
    if kind == "low-entropy":     # few byte values: hits come often
        return rng.integers(0, 3, 3 * 2 ** 20, dtype=np.uint8).tobytes()
    # zeros then noise: no hit for megabytes, so the max_size cut is forced
    return bytes(2 ** 20) + rng.integers(0, 256, 2 ** 20,
                                         dtype=np.uint8).tobytes()


@pytest.mark.parametrize("kind", ["random", "low-entropy", "zeros"])
@pytest.mark.parametrize("itemsize,sizes", [
    (1, (4096, 16384, 65536)), (4, (16 * 1024, 32 * 1024, 256 * 1024)),
    (2, (128 * 1024, 512 * 1024, 2 ** 20)), (4, (3, 4096, 300 * 1024))])
def test_cut_points_identical(kind, itemsize, sizes):
    """The port's early-exit cut search chooses the reference's cuts."""
    from repro.store import chunks as ref_chunks

    from repro_torch.store import chunks

    data = _cut_input(kind)

    def read(offset, size):
        return data[offset:offset + size]

    lo, avg, hi = sizes
    kw = dict(min_size=lo, avg_size=avg, max_size=hi,
              segments=[len(data) // 3 // itemsize * itemsize])
    got = chunks.cut_points(read, len(data), itemsize, **kw)
    assert got == ref_chunks.cut_points(read, len(data), itemsize, **kw)
    assert len(got) >= 3     # a cut beside the segment bound and the end


@pytest.mark.parametrize("arch", ["paper-bert", "paper-bert-small"])
def test_param_shapes_and_init_match_reference(arch):
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    assert param_shapes(cfg) == ref_param_shapes(ref_get_config(arch))
    if arch == "paper-bert":
        n = sum(int(np.prod(s)) for s in param_shapes(cfg).values())
        assert n == 131_835_648
        return
    small = cfg.reduced()
    ours = init_params(small, generator=torch.Generator().manual_seed(0))
    theirs = flatten_state(ref_init_params(ref_get_config(arch).reduced(), 0))
    assert list(ours) == list(theirs)
    for k, v in ours.items():
        assert tuple(v.shape) == theirs[k].shape and v.dtype == torch.float32
        if k.endswith(("ln1", "ln2", "final_norm")):
            assert not v.any() and not theirs[k].any()
        else:
            fan_in = v.shape[-2] if v.dim() >= 2 else v.shape[-1]
            assert abs(float(v.std()) * fan_in ** 0.5 - 1.0) < 0.05, k
    again = init_params(small, torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k], v) for k, v in ours.items())


def test_convert_carries_reference_weights():
    cfg = ref_get_config("paper-bert-small").reduced()
    flat = flatten_state(ref_init_params(cfg, 0))
    art = convert.to_artifact(flat, cfg.name, metadata={"arch": cfg.name})
    ref_art = RefArtifact(state_graph(flat, cfg.name), flat,
                          model_type=cfg.name, metadata={"arch": cfg.name})
    assert art.graph.to_json() == ref_art.graph.to_json()
    assert art.param_hashes() == ref_art.param_hashes()
    torch_flat = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    assert convert.to_artifact(torch_flat, cfg.name).param_hashes() == \
        ref_art.param_hashes()
    # bfloat16 weights carry across too (as uint16 bits named bfloat16)
    w = torch.linspace(-2, 2, 7).to(torch.bfloat16)
    brain = convert.to_artifact({"w": w}, "m")
    ref_brain = RefArtifact(state_graph({"w": w.float().numpy().astype(
        ml_dtypes.bfloat16)}, "m"), {"w": w.float().numpy().astype(
            ml_dtypes.bfloat16)}, model_type="m")
    assert brain.param_hashes() == ref_brain.param_hashes()
    assert brain.graph.to_json() == ref_brain.graph.to_json()


def test_store_default_backend_is_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArtifactStore()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ArtifactStore(root=str(tmp_path))
    parent, _ = _pair()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        delta_compression(_port(parent), _port(parent))
    assert ArtifactStore(backend="ref").backend == "ref"


def test_serial_store_path_matches_reference(tmp_path):
    """``pipelined=False`` (hop-by-hop truth, per-hop ops dispatch) writes
    the same manifests as the reference's serial path."""
    parent, child = _pair()
    grand = RefArtifact(child.graph, {k: (v + 1e-4).astype(np.float32)
                                      for k, v in child.params.items()},
                        model_type="toy")
    ref_store = RefStore(root=str(tmp_path / "ref"), pipelined=False)
    port_store = ArtifactStore(root=str(tmp_path / "port"), pipelined=False,
                               backend="ref")
    refs = []
    for store, wrap in ((ref_store, lambda a: a), (port_store, _port)):
        r0 = store.commit_artifact("p", wrap(parent))
        r1 = store.commit_artifact("c", wrap(child), parent_ref=r0)
        r2 = store.commit_artifact("g", wrap(grand), parent_ref=r1)
        refs.append((r0, r1, r2))
    assert refs[0] == refs[1]
    fresh = ArtifactStore(root=str(tmp_path / "port"), pipelined=False,
                          backend="ref")
    fresh_ref = RefStore(root=str(tmp_path / "ref"), pipelined=False)
    for k in parent.params:
        np.testing.assert_array_equal(fresh.materialize_param(refs[1][2], k),
                                      fresh_ref.materialize_param(refs[0][2], k))


def _f16_chain(seed=0):
    """base -> ft -> ft2 in float16: sparse finetune noise on every tensor,
    and a re-initialised head in ft (its delta overflows int8)."""
    parent, child = _pair(seed)
    rng = np.random.default_rng(seed + 7)
    base = RefArtifact(parent.graph, {k: v.astype(np.float16)
                                      for k, v in parent.params.items()},
                       model_type="toy")
    ft = RefArtifact(parent.graph, {k: v.astype(np.float16)
                                    for k, v in child.params.items()},
                     model_type="toy")
    ft2 = RefArtifact(parent.graph, {
        k: (v.astype(np.float32) + rng.normal(scale=2e-3, size=v.shape)
            * (rng.random(v.shape) < 0.3)).astype(np.float16)
        for k, v in ft.params.items()}, model_type="toy")
    return base, ft, ft2


@pytest.mark.parametrize("backend", ["ref", "cuda-on-cpu"])
def test_f16_chain_manifest_refs_equal_reference(tmp_path, monkeypatch,
                                                 backend):
    """An f16 lineage commits to the reference's manifest refs through the
    port's host path and through its card path (device mapped to the CPU,
    where the f16 dequant runs the wrapper's plain version), and checks
    out bit for bit alike."""
    calls = []
    if backend != "ref":
        monkeypatch.setitem(ops._DEVICES, "cuda", "cpu")
        wrapped = ops.dequant_apply_flat

        def counted(p1, q, eps=1e-4, out_dtype=None):
            calls.append((p1.dtype, out_dtype))
            return wrapped(p1, q, eps, out_dtype=out_dtype)
        monkeypatch.setattr(ops, "dequant_apply_flat", counted)
    models = _f16_chain()
    ref_store = RefStore(root=str(tmp_path / "ref"), chunk_threshold=0)
    port_store = ArtifactStore(root=str(tmp_path / "port"), chunk_threshold=0,
                               backend="ref" if backend == "ref" else "cuda")
    refs = []
    for store, wrap in ((ref_store, lambda a: a), (port_store, _port)):
        r0 = store.commit_artifact("base", wrap(models[0]))
        r1 = store.commit_artifact("ft", wrap(models[1]), parent_ref=r0)
        r2 = store.commit_artifact("ft2", wrap(models[2]), parent_ref=r1)
        refs.append([r0, r1, r2])
    assert refs[0] == refs[1]
    kinds = {e["kind"] for e in port_store.get_manifest(refs[1][2])
             ["params"].values()}
    assert "delta" in kinds
    fresh_ref = RefStore(root=str(tmp_path / "ref"), chunk_threshold=0)
    fresh = ArtifactStore(root=str(tmp_path / "port"), chunk_threshold=0,
                          backend="ref" if backend == "ref" else "cuda")
    for r in refs[1]:
        want = fresh_ref.materialize_artifact(r).params
        got = fresh.materialize_artifact(r).params
        manifest = fresh.get_manifest(r)["params"]
        for k, v in want.items():
            assert np.asarray(got[k]).dtype == np.float16
            assert tensor_hash(np.asarray(got[k])) == manifest[k]["hash"]
            np.testing.assert_array_equal(np.asarray(got[k]).view(np.uint16),
                                          np.asarray(v).view(np.uint16))
    assert fresh.fsck(refs[1])["ok"]
    if backend != "ref":
        assert (torch.float16, "float16") in calls, calls
