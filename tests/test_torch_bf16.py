"""The port's bfloat16 path against the reference package, on the CPU.

numpy has no bfloat16 without ``ml_dtypes``, so the port holds a bf16
tensor on the host as its bits in a uint16 array named ``bfloat16``
(``repro_torch/common/bf16.py``). The reference holds it as an
``ml_dtypes`` array. Everything here is bit for bit unless a tolerance is
stated:

* the carrier: widening, round-to-nearest-even narrowing (±0, subnormals,
  ties, overflow to inf, NaNs) against ``ml_dtypes`` and ``jnp.astype``,
  the npy bytes, and a genuine uint16 tensor staying uint16;
* the kernels' plain versions on bf16 against the reference's
  ``backend="ref"`` oracle and its Pallas kernels in interpret mode;
* the store: the stock reference cannot read its own bf16 objects back
  (``cas.py`` returns ``|V2``), so its delta commits, checkouts, ``fsck``
  and restores of bf16 fail. Those failures are pinned. The parity tests
  teach the reference to read its objects inside the test only (a
  monkeypatched ``_tensor_from_npy_view``); with that shim both packages
  write the same manifests, CAS keys and npy bytes and check out the same
  bits;
* a bf16 view's ``probe`` widens its weights (never reads the carrier's
  bits as integers), as the reference's probe of its ``ml_dtypes``
  weights does;
* the slice: a reduced bf16 qwen3-0.6b lineage, its pool view, and
  ``prefill``/``decode_step`` within 3e-2 of the reference (the bf16
  tolerance of the reference's own kernel tests).
"""

import dataclasses
import io

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.store.cas as ref_cas_module
from repro.core import ModelArtifact as RefArtifact
from repro.kernels import ops as ref_ops
from repro.models import get_config as ref_get_config
from repro.models.model import decode_step as ref_decode_step
from repro.models.model import prefill as ref_prefill
from repro.serve import ResidentView as RefView
from repro.store import ArtifactStore as RefStore
from repro.store.checkpoint import CheckpointManager as RefManager
from repro.store.checkpoint import flatten_state as ref_flatten
from repro.store.checkpoint import state_graph
from repro.store.delta import host_dequant as ref_host_dequant

import repro_torch.convert as convert
from repro_torch.common import bf16
from repro_torch.common.hashing import TensorHasher, tensor_hash
from repro_torch.core import LayerGraph, ModelArtifact
from repro_torch.kernels import ops, ref
from repro_torch.kernels.delta_quantize import (delta_quantize_flat,
                                                dequant_apply_flat)
from repro_torch.models import decode_step, get_config, prefill
from repro_torch.serve import ModelPool, ResidentView
from repro_torch.store import CAS, ArtifactStore, CheckpointManager
from repro_torch.store.delta import host_dequant, host_snapshot

from helpers import make_chain_model

EPS = 1e-4
BF16 = ml_dtypes.bfloat16
# f32 bit patterns whose bf16 rounding is an edge case: ±0, the smallest
# and largest subnormals, ties to even (down and up), the largest finite
# value (rounds to inf), ±inf, and NaNs of both signs with payloads
EDGE_BITS = np.array([
    0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x007FFFFF, 0x807FFFFF,
    0x3F808000, 0x3F818000, 0xBF808000, 0x3F80FFFF, 0x3F807FFF, 0x7F7FFFFF,
    0xFF7FFFFF, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
    0x7FA00000, 0xFFFFFFFF], dtype=np.uint32)


def _bits(x) -> np.ndarray:
    """The 16 raw bits of any bf16 array: carrier, ml_dtypes or torch."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _ml(x: np.ndarray) -> np.ndarray:
    """An f32 array as the reference's ml_dtypes bf16."""
    return np.asarray(x, np.float32).astype(BF16)


def _carrier(ml: np.ndarray) -> np.ndarray:
    """The reference's ml_dtypes bf16 array as the port's carrier."""
    return convert.to_numpy(ml)


# ---------------------------------------------------------------------------
# the carrier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["edges", "normal", "random bits"])
def test_narrow_rounds_as_ml_dtypes_jnp_and_the_plain_version(source):
    rng = np.random.default_rng(0)
    if source == "edges":
        x = EDGE_BITS.view(np.float32)
    elif source == "normal":
        x = (rng.standard_normal(50_000) * 10.0 ** rng.integers(
            -40, 38, 50_000)).astype(np.float32)
    else:
        x = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(
            np.uint32).view(np.float32)
    want = _bits(_ml(x))
    np.testing.assert_array_equal(_bits(bf16.narrow(x)), want)
    np.testing.assert_array_equal(
        _bits(np.asarray(jnp.asarray(x).astype(jnp.bfloat16))), want)
    np.testing.assert_array_equal(
        _bits(ref.to_bfloat16(torch.from_numpy(x.copy()))), want)
    # torch's own cast rounds numbers alike and differs on NaNs only
    nan = np.isnan(x)
    torch_bits = _bits(torch.from_numpy(x.copy()).to(torch.bfloat16))
    np.testing.assert_array_equal(torch_bits[~nan], want[~nan])


def test_widen_is_exact_and_torch_views_share_bits():
    bits = np.arange(0, 2**16, dtype=np.uint16)
    c = bf16.carry(bits)
    assert bf16.is_bf16(c) and bf16.dtype_name(c) == "bfloat16"
    wide = bf16.widen(c)
    np.testing.assert_array_equal(wide.view(np.uint32),
                                  bits.astype(np.uint32) << 16)
    finite = np.isfinite(wide)
    np.testing.assert_array_equal(
        wide[finite], bits.view(BF16).astype(np.float32)[finite])
    t = bf16.to_torch(c)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(t), bits)
    back = bf16.from_torch(t)
    assert bf16.is_bf16(back)
    np.testing.assert_array_equal(back.view(np.uint16), bits)
    # the carrier survives the store's plumbing
    for view in (c.reshape(256, 256), c[3:], np.asarray(c), c.copy(),
                 np.frombuffer(c.tobytes(), dtype=bf16.DTYPE),
                 np.ascontiguousarray(c[::2])):
        assert bf16.is_bf16(view)


@pytest.mark.parametrize("shape", [(3, 4), (), (5,), (2, 3, 7)])
def test_npy_bytes_and_tensor_hash_equal_the_reference(shape, tmp_path):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ml = _ml(x)
    c = _carrier(ml)
    buf = io.BytesIO()
    np.save(buf, ml, allow_pickle=False)
    assert buf.getvalue()[:64].find(b"'<V2'") > 0
    port = CAS(root=str(tmp_path / "port"))
    refc = ref_cas_module.CAS(root=str(tmp_path / "ref"))
    key = port.put_tensor(c)
    assert key == refc.put_tensor(ml) == tensor_hash(c)
    assert port.get_bytes(key) == refc.get_bytes(key) == buf.getvalue()
    hasher = TensorHasher(shape, "bfloat16")
    hasher.update(c.tobytes())
    assert hasher.hexdigest() == key
    back = port.get_tensor(key)
    assert bf16.is_bf16(back) and back.shape == shape
    np.testing.assert_array_equal(back.view(np.uint16), _bits(ml))
    assert port.fsck()["ok"]


def test_genuine_uint16_stays_uint16(tmp_path):
    u = np.random.default_rng(2).integers(0, 2**16, (17, 9)).astype(np.uint16)
    assert not bf16.is_bf16(u) and bf16.dtype_name(u) == "uint16"
    assert tensor_hash(u) != tensor_hash(bf16.carry(u))
    port = CAS(root=str(tmp_path / "port"))
    refc = ref_cas_module.CAS(root=str(tmp_path / "ref"))
    key = port.put_tensor(u)
    assert key == refc.put_tensor(u)
    assert port.get_bytes(key) == refc.get_bytes(key)
    back = port.get_tensor(key)
    assert back.dtype == np.uint16 and not bf16.is_bf16(back)
    np.testing.assert_array_equal(back, u)
    # through a store commit and checkout as well
    store = ArtifactStore(root=str(tmp_path / "store"), backend="ref")
    art = convert.to_artifact({"w": u, "b": bf16.carry(u[0])}, "m")
    r = store.commit_artifact("m", art)
    manifest = store.get_manifest(r)["params"]
    assert (manifest["w"]["dtype"], manifest["b"]["dtype"]) == \
        ("uint16", "bfloat16")
    out = ArtifactStore(root=str(tmp_path / "store"),
                        backend="ref").materialize_artifact(r).params
    assert out["w"].dtype == np.uint16 and not bf16.is_bf16(out["w"])
    assert bf16.is_bf16(out["b"])
    t = convert.to_tensor(u)
    assert t.dtype == torch.uint16


def test_cas_refuses_a_genuine_void2_tensor(tmp_path):
    """A V2 payload reads back as bfloat16, so a raw 2-byte void array is
    refused rather than stored under a key its read-back cannot match."""
    bits = np.arange(12, dtype=np.uint16)
    port = CAS(root=str(tmp_path / "port"))
    with pytest.raises(TypeError, match="2-byte void"):
        port.put_tensor(bits.view("V2"))
    assert port.put_tensor(bits.view(BF16)) == port.put_tensor(
        bf16.carry(bits)) == tensor_hash(bf16.carry(bits))


@pytest.mark.parametrize("carrier", [False, True])
def test_to_torch_shares_or_copies(carrier):
    a = np.arange(6, dtype=np.uint16).reshape(2, 3)
    a = bf16.carry(a) if carrier else a
    dtype = torch.bfloat16 if carrier else torch.uint16
    shared = bf16.to_torch(a)
    assert shared.dtype == dtype and tuple(shared.shape) == (2, 3)
    assert shared.data_ptr() == a.ctypes.data
    copied = bf16.to_torch(a, copy=True)
    assert copied.data_ptr() != a.ctypes.data
    ro = a.copy()
    ro.flags.writeable = False
    assert bf16.to_torch(ro).data_ptr() != ro.ctypes.data
    strided = bf16.to_torch(a[:, ::2])
    np.testing.assert_array_equal(strided.view(torch.int16).numpy(),
                                  a[:, ::2].view(np.int16))
    scalar = bf16.to_torch(a[0, 1, ...], copy=True)   # a 0-dim array
    assert scalar.dim() == 0 and scalar.dtype == dtype


def test_convert_carries_bf16_both_ways():
    x = np.random.default_rng(3).standard_normal((4, 6)).astype(np.float32)
    ml = _ml(x)
    from_ml = convert.to_numpy(ml)
    from_torch = convert.to_numpy(torch.from_numpy(x).to(torch.bfloat16))
    for c in (from_ml, from_torch):
        assert bf16.is_bf16(c)
        np.testing.assert_array_equal(c.view(np.uint16), _bits(ml))
    t = convert.to_tensor(from_ml)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(t), _bits(ml))
    art = convert.to_artifact({"w": torch.from_numpy(x).to(torch.bfloat16)},
                              "m")
    ref_art = RefArtifact(art.graph, {"w": ml}, model_type="m")
    assert art.param_hashes() == ref_art.param_hashes()


# ---------------------------------------------------------------------------
# the kernels' plain versions and numpy twins
# ---------------------------------------------------------------------------

def _bf16_pair(shape, scale, seed):
    """(ml p1, ml p2): bf16 parent and child, the child a finetune (or an
    overflowing edit at large ``scale``) of the parent."""
    rng = np.random.default_rng(seed)
    p2 = rng.normal(scale=0.04, size=shape).astype(np.float32)
    p1 = p2 + (rng.normal(scale=scale, size=shape)
               * (rng.random(shape) < 0.3)).astype(np.float32)
    return _ml(p1), _ml(p2)


@pytest.mark.parametrize("scale", [1e-3, 5e-2])
@pytest.mark.parametrize("shape", [(257, 33), (2048, 128), (3, 5, 7)])
def test_bf16_quantize_matches_reference(shape, scale):
    a, b = _bf16_pair(shape, scale, seed=shape[0])
    qr, nzr = ref_ops.delta_quantize(a, b, eps=EPS, backend="ref")
    qi, nzi = ref_ops.delta_quantize(a, b, eps=EPS, backend="interpret")
    ca, cb = _carrier(a), _carrier(b)
    q, nz = ops.delta_quantize(ca, cb, eps=EPS, backend="ref")
    np.testing.assert_array_equal(q, np.asarray(qr))
    np.testing.assert_array_equal(q, np.asarray(qi))
    assert nz == nzr == nzi
    tq, tnz = delta_quantize_flat(bf16.to_torch(ca), bf16.to_torch(cb), EPS)
    np.testing.assert_array_equal(tq.numpy(), q)
    assert int(tnz) == nz
    # the fused pass's narrow decision, and the numpy twin
    qs, nzs, _fp, narrow = ops.snapshot_fused(ca, cb, eps=EPS, backend="ref",
                                              with_fingerprint=False)
    qr8, nzr8, _, narrow_r = ref_ops.snapshot_fused(
        a, b, eps=EPS, backend="ref", with_fingerprint=False)
    qh, nzh, narrow_h = host_snapshot(ca, cb, EPS)
    assert narrow == narrow_r == narrow_h == (scale < 1e-2)
    assert nzs == nzr8 == nzh == nz
    np.testing.assert_array_equal(qs, np.asarray(qr8))
    np.testing.assert_array_equal(qh, np.asarray(qr8))


@pytest.mark.parametrize("n", [8192 * 2, 65537])
def test_bf16_block_zeros_match_reference(n, monkeypatch):
    a, b = _bf16_pair((n,), 1e-3, seed=n)
    qj, nzj, blocks_j = ref_ops.delta_quantize(a, b, backend="interpret",
                                               return_block_zeros=True)
    monkeypatch.setitem(ops._DEVICES, "cuda", "cpu")
    q, nz, blocks = ops.delta_quantize(_carrier(a), _carrier(b),
                                       backend="cuda",
                                       return_block_zeros=True)
    np.testing.assert_array_equal(q, np.asarray(qj))
    assert nz == nzj
    np.testing.assert_array_equal(blocks, np.asarray(blocks_j))


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(257, 33), (2048, 128)])
def test_bf16_dequant_matches_reference(shape, out_dtype):
    a, _ = _bf16_pair(shape, 1e-3, seed=7)
    q = np.random.default_rng(8).integers(-3000, 3000, shape).astype(np.int32)
    want = np.asarray(ref_ops.dequant_apply(a, q, eps=EPS, backend="ref",
                                            out_dtype=out_dtype))
    ca = _carrier(a)
    got = ops.dequant_apply(ca, q, eps=EPS, backend="ref",
                            out_dtype=out_dtype)
    twin = host_dequant(ca, q, EPS, out_dtype=out_dtype)
    flat = dequant_apply_flat(bf16.to_torch(ca), torch.from_numpy(q), EPS,
                              out_dtype=out_dtype)
    if out_dtype == "bfloat16":
        assert bf16.is_bf16(got) and bf16.is_bf16(twin)
        assert flat.dtype == torch.bfloat16
        for x in (got, twin, flat):
            np.testing.assert_array_equal(_bits(x), _bits(want))
        # the Pallas kernel in interpret mode rounds to bf16 too, but XLA
        # may contract its multiply-subtract into one rounding, so it can
        # differ from its own oracle by one ulp on a few elements; the port
        # follows the oracle (the exactness rule of the storage kernels)
        inter = _bits(np.asarray(ref_ops.dequant_apply(
            a, q, eps=EPS, backend="interpret"))).astype(np.int32)
        off = np.abs(_bits(got).astype(np.int32) - inter)
        assert off.max() <= 1 and (off > 0).mean() < 1e-4
    else:
        for x in (got, twin, flat.numpy()):
            assert x.dtype == np.float32
            np.testing.assert_array_equal(x.view(np.int32),
                                          want.view(np.int32))


def test_bf16_dequant_narrowing_edges():
    """Results at the rounding edges: ±0, subnormals, ties, overflow to
    inf and NaN parents, through every bf16 narrowing of the port."""
    parent = _ml(EDGE_BITS.view(np.float32))
    q = np.zeros(parent.shape, np.int32)
    q[6:9] = [1, -1, 2]
    want = np.asarray(ref_ops.dequant_apply(parent, q, eps=EPS,
                                            backend="ref"))
    c = _carrier(parent)
    for got in (host_dequant(c, q, EPS, out_dtype="bfloat16"),
                ops.dequant_apply(c, q, eps=EPS, backend="ref"),
                dequant_apply_flat(bf16.to_torch(c), torch.from_numpy(q),
                                   EPS)):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # an f32 parent whose result rounds at the edges, against the
    # reference's numpy twin (its jnp oracle flushes f32 subnormals to zero
    # on the CPU; numpy, torch and the CUDA kernel keep them)
    f32 = EDGE_BITS.view(np.float32).copy()
    want = ref_host_dequant(f32, q, EPS, out_dtype=BF16)
    np.testing.assert_array_equal(
        _bits(host_dequant(f32, q, EPS, out_dtype="bfloat16")), _bits(want))
    np.testing.assert_array_equal(
        _bits(ops.dequant_apply(f32, q, eps=EPS, backend="ref",
                                out_dtype="bfloat16")), _bits(want))


@pytest.mark.parametrize("hops", [1, 3])
def test_bf16_chain_apply_matches_reference(hops):
    """The fold of a bf16 base (not on the card's path: bf16 hops are never
    folded) against the reference's oracle, bf16 and f32 out."""
    base, _ = _bf16_pair((300, 41), 1e-3, seed=11)
    rng = np.random.default_rng(12)
    qs = [rng.integers(-100, 100, base.shape).astype(np.int8)
          for _ in range(hops)]
    for out_dtype in (None, "float32"):
        want = np.asarray(ref_ops.chain_apply(base, qs, eps=EPS,
                                              backend="ref",
                                              out_dtype=out_dtype))
        got = ops.chain_apply(_carrier(base), qs, eps=EPS, backend="ref",
                              out_dtype=out_dtype)
        assert bf16.is_bf16(got) == (out_dtype is None)
        np.testing.assert_array_equal(np.asarray(got).view(np.uint8),
                                      want.view(np.uint8))


# ---------------------------------------------------------------------------
# the store, against the reference taught to read its own bf16 objects
# ---------------------------------------------------------------------------

@pytest.fixture
def ref_reads_bf16(monkeypatch):
    """The reference's CAS decodes a ``V2`` npy payload as ml_dtypes
    bfloat16 (in this test only; ``src/repro`` is not changed)."""
    stock = ref_cas_module._tensor_from_npy_view

    def shim(view):
        arr = stock(view)
        if arr is not None and arr.dtype.kind == "V" \
                and arr.dtype.itemsize == 2:
            arr = arr.view(BF16)
        return arr
    monkeypatch.setattr(ref_cas_module, "_tensor_from_npy_view", shim)


def _bf16_lineage(seed=0):
    """base -> ft -> ft2 and task-head (ft with its head re-drawn: that
    delta overflows int8) as reference ml_dtypes artifacts."""
    parent = make_chain_model(seed=seed, d=32)
    rng = np.random.default_rng(seed + 7)
    graph = parent.graph

    def child_of(params, scale):
        return {k: _ml(v.astype(np.float32) + rng.normal(scale=scale,
                       size=v.shape) * (rng.random(v.shape) < 0.3))
                for k, v in params.items()}
    base = {k: _ml(v) for k, v in parent.params.items()}
    ft = child_of(base, 2e-2)
    ft2 = child_of(ft, 2e-2)
    head = dict(ft)
    head["head/w"] = _ml(rng.normal(size=head["head/w"].shape))
    return {n: RefArtifact(graph, p, model_type="toy")
            for n, p in (("base", base), ("ft", ft), ("ft2", ft2),
                         ("task-head", head))}


def _to_port(art):
    return ModelArtifact(LayerGraph.from_json(art.graph.to_json()),
                         {k: convert.to_numpy(v) for k, v in art.params.items()},
                         model_type=art.model_type,
                         metadata=dict(art.metadata))


def _commit_lineage(store, models, wrap):
    r0 = store.commit_artifact("base", wrap(models["base"]))
    r1 = store.commit_artifact("ft", wrap(models["ft"]), parent_ref=r0)
    r2 = store.commit_artifact("ft2", wrap(models["ft2"]), parent_ref=r1)
    rh = store.commit_artifact("task-head", wrap(models["task-head"]),
                               parent_ref=r1)
    return [r0, r1, r2, rh]


def _objects(root):
    """{key: bytes} of every object of a CAS directory."""
    cas = ref_cas_module.CAS(root=root)
    return {k: cas.get_bytes(k) for k in cas.keys()}


@pytest.mark.parametrize("backend", ["ref", "cuda-on-cpu"])
def test_bf16_lineage_matches_the_shimmed_reference(tmp_path, monkeypatch,
                                                    ref_reads_bf16, backend):
    """Manifest refs, CAS keys and object bytes (npy '<V2' included) equal
    the reference's; checkouts are bit-equal; fsck is clean. On the card's
    path (device mapped to the CPU) bf16 hops go through dequant_apply
    with bf16 -> bf16 and the overflowing head through delta_quantize on
    bf16 operands."""
    calls = []
    if backend != "ref":
        monkeypatch.setitem(ops._DEVICES, "cuda", "cpu")
        wrapped_dq, wrapped_q = ops.dequant_apply_flat, ops.delta_quantize_flat

        def dq(p1, q, eps=1e-4, out_dtype=None):
            calls.append(("dequant", p1.dtype, ref.torch_dtype(out_dtype)))
            return wrapped_dq(p1, q, eps, out_dtype=out_dtype)

        def quant(p1, p2, eps=1e-4, tile=None):
            calls.append(("quantize", p1.dtype, p2.dtype))
            return wrapped_q(p1, p2, eps, tile=tile)
        monkeypatch.setattr(ops, "dequant_apply_flat", dq)
        monkeypatch.setattr(ops, "delta_quantize_flat", quant)
    models = _bf16_lineage()
    ref_store = RefStore(root=str(tmp_path / "ref"), chunk_threshold=0)
    port_store = ArtifactStore(root=str(tmp_path / "port"), chunk_threshold=0,
                               backend="ref" if backend == "ref" else "cuda")
    want = _commit_lineage(ref_store, models, lambda a: a)
    got = _commit_lineage(port_store, models, _to_port)
    assert got == want
    kinds = {e["kind"] for r in got[1:]
             for e in port_store.get_manifest(r)["params"].values()}
    assert "delta" in kinds
    # the re-drawn head overflows int8; its int32 delta saves nothing
    # against 2-byte values, so it is stored full, as in the reference
    head = port_store.get_manifest(got[3])["params"]["head/w"]
    assert head["kind"] == "full" and head["dtype"] == "bfloat16"
    ref_store.cas.flush()
    port_store.cas.flush()
    ref_objs, port_objs = _objects(str(tmp_path / "ref")), \
        _objects(str(tmp_path / "port"))
    assert sorted(port_objs) == sorted(ref_objs)
    assert all(port_objs[k] == ref_objs[k] for k in ref_objs)
    assert any(b"'<V2'" in v[:128] for v in port_objs.values())
    fresh_ref = RefStore(root=str(tmp_path / "ref"), chunk_threshold=0)
    fresh = ArtifactStore(root=str(tmp_path / "port"), chunk_threshold=0,
                          backend="ref" if backend == "ref" else "cuda")
    for r in got:
        theirs = fresh_ref.materialize_artifact(r).params
        ours = fresh.materialize_artifact(r).params
        manifest = fresh.get_manifest(r)["params"]
        for k, v in theirs.items():
            assert bf16.is_bf16(ours[k])
            assert tensor_hash(ours[k]) == manifest[k]["hash"]
            np.testing.assert_array_equal(_bits(ours[k]), _bits(v))
    assert fresh.fsck(got)["ok"]
    if backend != "ref":
        assert ("dequant", torch.bfloat16, torch.bfloat16) in calls, calls
        assert ("quantize", torch.bfloat16, torch.bfloat16) in calls, calls


def test_bf16_chunked_lineage_matches_the_shimmed_reference(
        tmp_path, monkeypatch, ref_reads_bf16):
    """bf16 tensors over a small chunk threshold take the chunk engine (raw
    chunks: its per-chunk deltas are f32 only, in both packages). The stock
    reference cannot chunk a bf16 tensor at all (a memoryview refuses the
    ml_dtypes type); the test teaches its chunk source to read the bytes."""
    import repro.store.chunks as ref_chunks
    models = _bf16_lineage(seed=4)
    kw = dict(chunk_threshold=1024, chunk_min=256, chunk_avg=512,
              chunk_max=1024)
    with pytest.raises(ValueError, match="cannot include dtype"):
        RefStore(root=str(tmp_path / "stock"), **kw).commit_artifact(
            "base", models["base"])
    stock_init = ref_chunks.ArraySource.__init__

    def byte_view(self, arr):
        arr = np.asarray(arr)
        stock_init(self, arr.view(np.uint8) if arr.dtype == BF16 else arr)
        self.shape, self.dtype = tuple(arr.shape), arr.dtype
    monkeypatch.setattr(ref_chunks.ArraySource, "__init__", byte_view)
    ref_store = RefStore(root=str(tmp_path / "ref"), **kw)
    port_store = ArtifactStore(root=str(tmp_path / "port"), backend="ref",
                               **kw)
    want = _commit_lineage(ref_store, models, lambda a: a)
    got = _commit_lineage(port_store, models, _to_port)
    assert got == want
    kinds = {e["kind"] for e in port_store.get_manifest(got[2])
             ["params"].values()}
    assert "chunked" in kinds
    fresh_ref = RefStore(root=str(tmp_path / "ref"), **kw)
    fresh = ArtifactStore(root=str(tmp_path / "port"), backend="ref", **kw)
    for r in got:
        theirs = fresh_ref.materialize_artifact(r).params
        ours = fresh.materialize_artifact(r).params
        for k, v in theirs.items():
            assert bf16.is_bf16(ours[k])
            np.testing.assert_array_equal(_bits(ours[k]), _bits(v))
    assert fresh.fsck(got)["ok"]


# ---------------------------------------------------------------------------
# the stock reference's bf16 faults, pinned; the port reads its repository
# ---------------------------------------------------------------------------

def test_stock_reference_cannot_read_its_bf16_objects(tmp_path):
    models = _bf16_lineage(seed=2)
    ref_store = RefStore(root=str(tmp_path / "ref"), chunk_threshold=0)
    r0 = ref_store.commit_artifact("base", models["base"])
    # a delta commit against a bf16 parent: host_snapshot cannot widen |V2
    with pytest.raises(ValueError, match="setting an array element"):
        ref_store.commit_artifact("ft", models["ft"], parent_ref=r0)
    fresh = RefStore(root=str(tmp_path / "ref"), chunk_threshold=0)
    out = fresh.materialize_artifact(r0).params
    assert {str(np.asarray(v).dtype) for v in out.values()} == {"|V2"}
    report = fresh.fsck([r0])
    assert not report["ok"] and len(report["corrupt"]) == len(models["base"]
                                                               .params)
    # the port reads the reference's repository back as bf16, fsck clean
    port = ArtifactStore(root=str(tmp_path / "ref"), chunk_threshold=0,
                         backend="ref")
    ours = port.materialize_artifact(r0).params
    manifest = port.get_manifest(r0)["params"]
    for k, v in models["base"].params.items():
        assert bf16.is_bf16(ours[k])
        assert tensor_hash(ours[k]) == manifest[k]["hash"]
        np.testing.assert_array_equal(_bits(ours[k]), _bits(v))
    assert port.fsck([r0])["ok"]
    # and commits a bf16 derivative on top of it, which the shimless
    # reference could not
    r1 = port.commit_artifact("ft", _to_port(models["ft"]), parent_ref=r0)
    assert port.fsck([r0, r1])["ok"]


def _bf16_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": _ml(rng.standard_normal((64, 300))),
                       "b": _ml(rng.standard_normal((96,)))},
            "step": np.asarray(seed, np.int32)}


def _next_state(state, seed):
    rng = np.random.default_rng(seed)
    out = {"params": {}, "step": state["step"] + 1}
    for k, v in state["params"].items():
        wide = v.astype(np.float32)
        out["params"][k] = _ml(wide + rng.normal(scale=1e-2, size=v.shape)
                               * (rng.random(v.shape) < 0.3))
    return out


@pytest.mark.parametrize("verify", [False, True])
def test_bf16_checkpoint_restores_bit_for_bit(tmp_path, verify):
    """A bf16 full step and an exact-tier (xdelta) step restore bit for bit
    in the port; the stock reference's restore of the full step raises."""
    s0 = _bf16_state()
    s1 = _next_state(s0, 1)
    port = CheckpointManager(str(tmp_path / "port"), async_save=False,
                             backend="ref")
    port.save(0, convert.state_from_reference(s0))
    port.save(1, convert.state_from_reference(s1))
    refm = RefManager(str(tmp_path / "ref"), async_save=False)
    refm.save(0, s0)
    refm.save(1, s1)
    kinds = {s: {e["kind"] for e in port.store.get_manifest(
        port.lineage.nodes[port._node_name(s)].artifact_ref)["params"]
        .values()} for s in (0, 1)}
    assert kinds[0] == {"full"} and "xdelta" in kinds[1]
    fresh = CheckpointManager(str(tmp_path / "port"), async_save=False,
                              backend="ref")
    for step, state in ((0, s0), (1, s1)):
        flat, got_step = fresh.restore(step, verify=verify)
        assert got_step == step
        for k, v in ref_flatten(state).items():
            if k.startswith("params/"):
                assert bf16.is_bf16(flat[k])
                np.testing.assert_array_equal(_bits(flat[k]), _bits(v))
    # the port also restores the reference's directory
    across = CheckpointManager(str(tmp_path / "ref"), async_save=False,
                               backend="ref")
    flat, _ = across.restore(1, verify=verify)
    np.testing.assert_array_equal(_bits(flat["params/w"]),
                                  _bits(s1["params"]["w"]))
    # into a template of torch bf16 tensors
    template = convert.state_from_reference(s1)
    state, _ = fresh.restore(1, template=template, verify=verify)
    assert state["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(state["params"]["w"]),
                                  _bits(s1["params"]["w"]))
    # the stock reference reads the full step back as |V2: a template
    # restore cannot cast it, and a verified one calls it corrupt
    stock = RefManager(str(tmp_path / "ref"), async_save=False)
    flat, _ = stock.restore(0)
    assert str(flat["params/w"].dtype) == "|V2"
    with pytest.raises(OSError if verify else ValueError,
                       match="corruption" if verify else "cast"):
        stock.restore(0, template=s0, verify=verify)


# ---------------------------------------------------------------------------
# the slice: a reduced bf16 qwen3-0.6b lineage, served
# ---------------------------------------------------------------------------

SLICE_TOL = 3e-2   # the reference kernel tests' bf16 tolerance


@pytest.fixture(scope="module")
def qwen3_bf16():
    """(reference cfg, port cfg, {node: flat ml_dtypes params}): reduced
    qwen3-0.6b in bf16, weights made with numpy from a seed."""
    kw = dict(dtype="bfloat16", remat="none", n_layers=2)
    ref_cfg = dataclasses.replace(ref_get_config("qwen3-0.6b").reduced(), **kw)
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), **kw)
    from repro.models.model import param_shapes as ref_param_shapes
    rng = np.random.default_rng(5)
    base = {}
    for k, shape in ref_param_shapes(ref_cfg).items():
        if k.endswith("norm") or "norm" in k.split("/")[-1]:
            base[k] = _ml(rng.normal(scale=0.1, size=shape))
        else:
            fan = shape[-2] if len(shape) >= 2 else shape[-1]
            base[k] = _ml(rng.normal(size=shape) / np.sqrt(fan))

    def ft(params, scale):
        return {k: _ml(v.astype(np.float32) + rng.normal(
            scale=scale, size=v.shape) * (rng.random(v.shape) < 0.3))
            for k, v in params.items()}
    ft1 = ft(base, 2e-2)
    ft2 = ft(ft1, 2e-2)
    return ref_cfg, cfg, {"base": base, "ft1": ft1, "ft2": ft2}


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def test_slice_qwen3_bf16_lineage_pool_and_serving(tmp_path, monkeypatch,
                                                   ref_reads_bf16,
                                                   qwen3_bf16):
    """The slice as a whole: the lineage commits to the reference's refs,
    pool views (host and card path) equal the host checkout bit for bit,
    and prefill + decode on the view stay in bf16 and within SLICE_TOL of
    the reference's on the same weights."""
    ref_cfg, cfg, flats = qwen3_bf16
    arts = {n: RefArtifact(state_graph(p, ref_cfg.name), p,
                           model_type=ref_cfg.name) for n, p in flats.items()}
    ref_store = RefStore(root=str(tmp_path / "ref"), chunk_threshold=0)
    port_store = ArtifactStore(root=str(tmp_path / "port"), chunk_threshold=0,
                               backend="ref")
    refs = []
    for store, wrap in ((ref_store, lambda a: a),
                        (port_store, lambda a: convert.to_artifact(
                            a.params, a.model_type))):
        r0 = store.commit_artifact("base", wrap(arts["base"]))
        r1 = store.commit_artifact("ft1", wrap(arts["ft1"]), parent_ref=r0)
        r2 = store.commit_artifact("ft2", wrap(arts["ft2"]), parent_ref=r1)
        refs.append([r0, r1, r2])
    assert refs[0] == refs[1]
    r2 = refs[1][2]
    entries = port_store.get_manifest(r2)["params"].values()
    assert "delta" in {e["kind"] for e in entries}
    assert {e["dtype"] for e in entries} == {"bfloat16"}
    host = ArtifactStore(root=str(tmp_path / "port"), chunk_threshold=0,
                         backend="ref").materialize_artifact(r2).params
    theirs = RefStore(root=str(tmp_path / "ref"),
                      chunk_threshold=0).materialize_artifact(r2).params
    views = {}
    for backend in ("ref", "cuda"):
        if backend == "cuda":
            monkeypatch.setitem(ops._DEVICES, "cuda", "cpu")
        store = ArtifactStore(root=str(tmp_path / "port"), chunk_threshold=0,
                              backend=backend)
        pool = ModelPool(store, backend=backend, verify=True)
        views[backend] = pool.get(r2).artifact.params
    for k, v in host.items():
        np.testing.assert_array_equal(_bits(v), _bits(theirs[k]))
        for params in views.values():
            assert bf16.is_bf16(params[k])
            np.testing.assert_array_equal(_bits(params[k]), _bits(v))
    # serve the view's weights (ft2's stored truth) in both packages
    params = convert.to_params(views["cuda"])
    ref_params = _nest({k: jnp.asarray(v) for k, v in theirs.items()})
    tokens = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    ref_logits, ref_cache = ref_prefill(ref_cfg, ref_params,
                                        {"tokens": jnp.asarray(tokens)},
                                        max_len=16)
    logits, cache = prefill(cfg, params, {"tokens": torch.from_numpy(tokens)},
                            max_len=16)
    assert logits.dtype == cache["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(),
                               np.asarray(ref_logits, np.float32),
                               atol=SLICE_TOL, rtol=0)
    token = np.argmax(np.asarray(ref_logits, np.float32), -1).astype(
        np.int32)[:, None]
    for pos in range(12, 16):
        ref_logits, ref_cache = ref_decode_step(
            ref_cfg, ref_params, jnp.asarray(token), ref_cache,
            jnp.asarray(pos, jnp.int32))
        logits, cache = decode_step(cfg, params, torch.from_numpy(token),
                                    cache, pos)
        assert logits.dtype == cache["v"].dtype == torch.bfloat16
        np.testing.assert_allclose(logits.float().numpy(),
                                   np.asarray(ref_logits, np.float32),
                                   atol=SLICE_TOL, rtol=0)
        token = np.argmax(np.asarray(ref_logits, np.float32), -1).astype(
            np.int32)[:, None]


def test_bf16_view_probe_equals_the_probe_over_widened_weights(qwen3_bf16):
    """``ResidentView.probe`` (the response of ``/predict``) of a bf16
    view equals the probe of the same weights widened to f32, and the
    reference's probe of its ``ml_dtypes`` weights, bit for bit."""
    ref_cfg, cfg, flats = qwen3_bf16
    theirs = flats["ft2"]
    art = convert.to_artifact(theirs, cfg.name)
    assert all(bf16.is_bf16(v) for v in art.params.values())
    got = ResidentView("ft2", art, [], 0, 0.0).probe()
    widened = convert.to_artifact(
        {k: bf16.widen(v) for k, v in art.params.items()}, cfg.name)
    want = ResidentView("ft2-f32", widened, [], 0, 0.0).probe()
    np.testing.assert_array_equal(got, want)
    ref_art = RefArtifact(state_graph(theirs, ref_cfg.name), theirs,
                          model_type=ref_cfg.name)
    np.testing.assert_array_equal(got, RefView("ft2", ref_art, [], 0,
                                               0.0).probe())
    # the carrier's bits read as integers give another response
    as_ints = convert.to_artifact(
        {k: np.asarray(v, np.float32) for k, v in art.params.items()},
        cfg.name)
    assert not np.array_equal(got, ResidentView("ints", as_ints, [], 0,
                                                0.0).probe())
