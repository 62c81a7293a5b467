"""The port's kernel layer against the reference package, on the CPU.

Each plain torch version (``repro_torch/kernels/ref.py``) must equal the
reference's ``backend="ref"`` oracle bit for bit over the reference kernel
tests' shape sweep and f32/bf16/f16 inputs: quantized deltas, zero counts,
the int8-narrowing decision, dequant and chain outputs, and the raw
fingerprint pair. Where deltas are finetune-sized, the reference's Pallas
kernels in interpret mode agree too. The CUDA kernels themselves run only
on the card; ``chip_smoke.py`` holds them against these plain versions.
Here the wrappers' CPU path, ``ops``' dispatch, the no-fallback rules and
the ctypes bindings of the CUDA sources are checked.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.kernels.chain_apply import chain_apply_ref as jchain_apply_ref
from repro.kernels.fingerprint import fingerprint_2d
from repro.kernels.snapshot_fused import snapshot_fused_ref as jsnapshot_ref

from repro_torch.common import bf16
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.chain_apply import chain_apply_flat
from repro_torch.kernels.delta_quantize import (delta_quantize_flat,
                                                dequant_apply_flat)
from repro_torch.kernels.fingerprint import fingerprint_flat
from repro_torch.kernels.snapshot_fused import snapshot_fused_flat

SHAPES = [(8,), (100,), (128, 128), (257, 33), (1024,), (3, 5, 7),
          (2048, 128), (1, 1)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
# finetune-sized deltas, int8-overflowing ones, and large ones where a
# multiply by 1/scale would round differently from the true division
DELTA_SCALES = [1e-4, 3e-2, 3.0]


def _pair(shape, dtype, scale, seed):
    """(jax p1, jax p2, torch p1, torch p2) with equal values, from numpy
    f32 cast once to ``dtype`` by each framework (both round to nearest)."""
    rng = np.random.default_rng(seed)
    p2 = rng.normal(size=shape).astype(np.float32)
    p1 = (p2 + rng.normal(scale=scale, size=shape)).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return (jnp.asarray(p1).astype(jdt), jnp.asarray(p2).astype(jdt),
            torch.from_numpy(p1).to(tdt), torch.from_numpy(p2).to(tdt))


def _f32_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy().view(np.int32)
    return np.asarray(x.astype(jnp.float32)).view(np.int32)


@pytest.mark.parametrize("scale", DELTA_SCALES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_delta_quantize_ref_bit_identical(shape, dtype, scale):
    j1, j2, t1, t2 = _pair(shape, dtype, scale, seed=len(shape) * 7 + 1)
    qj, nzj = jref.delta_quantize_ref(j1, j2)
    qt, nzt = ref.delta_quantize_ref(t1, t2)
    assert qt.dtype == torch.int32 and tuple(qt.shape) == shape
    np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
    assert int(nzj) == int(nzt)


@pytest.mark.parametrize("scale", DELTA_SCALES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_snapshot_fused_ref_bit_identical(shape, dtype, scale):
    j1, j2, t1, t2 = _pair(shape, dtype, scale, seed=len(shape) * 11 + 2)
    q8j, zj, oj = jsnapshot_ref(jnp.ravel(j1), jnp.ravel(j2))
    q8t, zt, ot = ref.snapshot_fused_ref(t1, t2)
    assert q8t.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(q8j), q8t.numpy().ravel())
    assert (int(zj), int(oj)) == (int(zt), int(ot))
    # the narrowing decision and the returned q through ops
    qj, nzj, _, narrow_j = ref_ops.snapshot_fused(j1, j2, backend="ref",
                                                  with_fingerprint=False)
    qt, nzt, fp, narrow_t = ops.snapshot_fused(t1, t2, backend="ref",
                                               with_fingerprint=False)
    assert fp is None and narrow_j == narrow_t and nzj == nzt
    assert np.asarray(qj).dtype == qt.dtype
    np.testing.assert_array_equal(np.asarray(qj), qt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_dequant_apply_ref_bit_identical(shape, dtype):
    rng = np.random.default_rng(len(shape) * 13 + 3)
    j1, _, t1, _ = _pair(shape, dtype, 1e-4, seed=len(shape) * 13 + 4)
    q = rng.integers(-30000, 30000, size=shape).astype(np.int32)
    outj = jref.dequant_apply_ref(j1, jnp.asarray(q))
    outt = ref.dequant_apply_ref(t1, torch.from_numpy(q))
    assert outt.dtype == t1.dtype
    np.testing.assert_array_equal(_f32_bits(outj), _f32_bits(outt))
    # an explicit f32 result skips the cast back to the input's dtype
    outj = jref.dequant_apply_ref(j1, jnp.asarray(q), out_dtype=jnp.float32)
    outt = ref.dequant_apply_ref(t1, torch.from_numpy(q), out_dtype="float32")
    np.testing.assert_array_equal(_f32_bits(outj), _f32_bits(outt))


@pytest.mark.parametrize("k", [1, 3, 6])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_chain_apply_ref_bit_identical(shape, k):
    rng = np.random.default_rng(len(shape) * 17 + k)
    base = rng.normal(size=shape).astype(np.float32)
    qs = np.stack([rng.integers(-20000, 20000, size=shape).astype(np.int32)
                   for _ in range(k)])
    outj = jchain_apply_ref(jnp.asarray(base), jnp.asarray(qs))
    outt = ref.chain_apply_ref(torch.from_numpy(base), torch.from_numpy(qs))
    np.testing.assert_array_equal(_f32_bits(outj), _f32_bits(outt))
    # the fold identity: one dequant of the exact int32 sum
    single = ref.dequant_apply_ref(torch.from_numpy(base),
                                   torch.from_numpy(qs.sum(0, dtype=np.int32)))
    np.testing.assert_array_equal(_f32_bits(single), _f32_bits(outt))


@pytest.mark.parametrize("dtype", sorted(DTYPES) + ["int32"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fingerprint_ref_raw_pair(shape, dtype):
    rng = np.random.default_rng(len(shape) * 19 + 5)
    if dtype == "int32":
        x = rng.integers(-2**31, 2**31 - 1, size=shape).astype(np.int32)
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    else:
        xj, _, xt, _ = _pair(shape, dtype, 1.0, seed=len(shape) * 19 + 6)
    pj = np.asarray(jref.fingerprint_ref(xj)).astype(np.int64)
    pt = ref.fingerprint_ref(xt).numpy()
    np.testing.assert_array_equal(pj, pt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 1024), (1000, 33)], ids=str)
def test_fingerprint_interpret_kernel_matches_plain_version(shape, dtype):
    """The reference's Pallas ``fingerprint_2d`` (interpret mode) over its
    padded layout gives the raw pair the port's wrapper computes on the CPU
    (its plain version), for a tile-aligned and a ragged tensor."""
    _, _, xt, _ = _pair(shape, dtype, 1.0, seed=len(shape) * 23 + 9)
    xj = jnp.asarray(xt.to(torch.float32).numpy()).astype(DTYPES[dtype][0])
    bits, _ = ref_ops._bits_2d(xj)
    pj = fingerprint_2d(bits, block_rows=ref_ops._block_rows(bits.shape[0]),
                        interpret=True)
    before = fingerprint_flat.launches
    pt = fingerprint_flat(xt)
    assert fingerprint_flat.launches == before
    assert pt.dtype == torch.int64 and pt.shape == (2,)
    np.testing.assert_array_equal(np.asarray(pj).astype(np.int64),
                                  pt.numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES) + ["int32"])
@pytest.mark.parametrize("shape", [(8,), (257, 33), (2048, 128)], ids=str)
def test_fingerprint_cpu_path_unchanged(shape, dtype):
    """``ops.fingerprint`` on the CPU still hashes the padded layout as
    before the kernel existed, and equals the reference's 64-bit value
    (the salt is Python's hash of the same tuple in this process)."""
    rng = np.random.default_rng(len(shape) * 29 + 3)
    if dtype == "int32":
        x = rng.integers(-2**31, 2**31 - 1, size=shape).astype(np.int32)
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    else:
        xj, _, xt, _ = _pair(shape, dtype, 1.0, seed=len(shape) * 29 + 4)
    got = ops.fingerprint(xt, backend="ref")
    # the CPU path as it was: bits zero-padded to (rows, 1024), rows % 8 == 0
    bits = ref.bits_u32(xt)
    rows = -(-bits.shape[0] // 1024)
    rows = -(-rows // 8) * 8
    padded = torch.zeros(rows * 1024, dtype=torch.int64)
    padded[:bits.shape[0]] = bits
    h1, h2 = (int(v) for v in ref.fingerprint_bits(padded))
    salt = hash((tuple(xt.shape), dtype)) & 0xFFFFFFFF
    assert got == ((h1 ^ salt) << 32) | h2
    assert got == ref_ops.fingerprint(xj, backend="ref")


def test_fingerprint_sensitivity():
    x = np.random.default_rng(0).normal(size=(256, 256)).astype(np.float32)
    f0 = ops.fingerprint(x, backend="ref")
    y = x.copy()
    y[13, 200] += 1e-3
    assert ops.fingerprint(y, backend="ref") != f0          # value change
    assert ops.fingerprint(x.reshape(128, 512), backend="ref") != f0
    assert ops.fingerprint(x, backend="ref") == f0          # deterministic
    # low word (unsalted) equals the reference's padded-layout hash
    assert (ops.fingerprint(x, backend="ref") & 0xFFFFFFFF
            == ref_ops.fingerprint(x, backend="ref") & 0xFFFFFFFF)


@pytest.mark.parametrize("shape", [(100,), (256, 1024), (257, 33)], ids=str)
def test_ops_match_reference_interpret_kernels(shape):
    """Finetune-sized deltas: the reference's Pallas kernels (interpret
    mode) and the port's ``ops`` agree exactly."""
    rng = np.random.default_rng(7)
    p2 = rng.normal(size=shape).astype(np.float32)
    p1 = (p2 + rng.normal(scale=1e-4, size=shape)).astype(np.float32)
    qj, nzj = ref_ops.delta_quantize(p1, p2, backend="interpret")
    qt, nzt = ops.delta_quantize(p1, p2, backend="ref")
    np.testing.assert_array_equal(np.asarray(qj), qt)
    assert nzj == nzt
    sj = ref_ops.snapshot_fused(p1, p2, backend="interpret",
                                with_fingerprint=False)
    st = ops.snapshot_fused(p1, p2, backend="ref", with_fingerprint=False)
    np.testing.assert_array_equal(np.asarray(sj[0]), st[0])
    assert (sj[1], sj[3]) == (st[1], st[3])
    outj = ref_ops.dequant_apply(p1, qj, backend="interpret")
    outt = ops.dequant_apply(p1, qt, backend="ref")
    np.testing.assert_array_equal(np.asarray(outj), outt)
    qs = [qt.astype(np.int8), qt, -qt]
    cj = ref_ops.chain_apply(p1, qs, backend="interpret")
    ct = ops.chain_apply(p1, qs, backend="ref")
    np.testing.assert_array_equal(np.asarray(cj), ct)


def test_ops_overflow_fallback_and_block_zeros():
    p2 = np.zeros(1000, np.float32)
    p1 = p2.copy()
    p1[3] = 1.0  # delta / 2e-4 = 5000 >> int8
    q, nz, fp, narrow = ops.snapshot_fused(p1, p2, backend="ref")
    assert not narrow and q.dtype == np.int32 and int(q[3]) > 127
    assert nz == 999 and fp == ops.fingerprint(p2, backend="ref")
    q2, nz2, blocks = ops.delta_quantize(p1, p2, backend="ref",
                                         return_block_zeros=True)
    np.testing.assert_array_equal(q, q2)
    assert nz2 == 999 and blocks is None


def test_ops_return_numpy_in_requested_dtype():
    rng = np.random.default_rng(3)
    p1 = rng.normal(size=(64, 33)).astype(np.float32)
    q = rng.integers(-100, 100, size=p1.shape).astype(np.int8)
    ro = p1.copy()
    ro.flags.writeable = False   # CAS views are read-only
    out = ops.dequant_apply(ro, q, backend="ref", out_dtype="float16")
    assert isinstance(out, np.ndarray) and out.dtype == np.float16
    np.testing.assert_array_equal(
        out, np.asarray(ref_ops.dequant_apply(p1, q, backend="ref",
                                              out_dtype="float16")))
    # bfloat16 computes too: the host carrier (uint16 bits named bfloat16)
    # with the reference's bits
    out = ops.dequant_apply(ro, q, backend="ref", out_dtype="bfloat16")
    assert isinstance(out, np.ndarray) and out.dtype == np.uint16
    assert bf16.is_bf16(out) and bf16.dtype_name(out) == "bfloat16"
    np.testing.assert_array_equal(
        out.view(np.uint16),
        np.asarray(ref_ops.dequant_apply(p1, q, backend="ref",
                                         out_dtype=jnp.bfloat16))
        .view(np.uint16))


@pytest.mark.parametrize("wrapper, args", [
    (delta_quantize_flat, ("f32", "f32")),
    (dequant_apply_flat, ("f32", "i32")),
    (snapshot_fused_flat, ("f32", "f32")),
    (chain_apply_flat, ("f32", "stack")),
    (fingerprint_flat, ("f32",)),
], ids=lambda v: getattr(v, "__name__", ""))
def test_wrappers_run_plain_version_on_cpu_only(wrapper, args):
    rng = np.random.default_rng(5)
    make = {
        "f32": lambda: torch.from_numpy(rng.normal(size=(257, 33))
                                        .astype(np.float32)),
        "i32": lambda: torch.from_numpy(rng.integers(-9, 9, size=(257, 33))
                                        .astype(np.int32)),
        "stack": lambda: torch.from_numpy(
            rng.integers(-9, 9, size=(2, 257, 33)).astype(np.int32)),
    }
    tensors = [make[a]() for a in args]
    before = wrapper.launches
    got = wrapper(*tensors)
    plain = {delta_quantize_flat: ref.delta_quantize_ref,
             snapshot_fused_flat: ref.snapshot_fused_ref,
             chain_apply_flat: ref.chain_apply_ref,
             dequant_apply_flat: ref.dequant_apply_ref,
             fingerprint_flat: ref.fingerprint_padded}[wrapper](*tensors)
    for g, p in zip(got if isinstance(got, tuple) else (got,),
                    plain if isinstance(plain, tuple) else (plain,)):
        assert torch.equal(g, p)
    assert wrapper.launches == before   # the plain version is no launch
    # a tensor on any other device never reaches the plain version
    meta = [t.to("meta") for t in tensors]
    with pytest.raises(ValueError, match="CUDA device"):
        wrapper(*meta)


def test_default_backend_raises_without_card():
    assert not torch.cuda.is_available()
    x = np.ones(8, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.default_backend()
    for call in (lambda: ops.delta_quantize(x, x),
                 lambda: ops.dequant_apply(x, x.astype(np.int32)),
                 lambda: ops.chain_apply(x, [x.astype(np.int32)]),
                 lambda: ops.snapshot_fused(x, x, with_fingerprint=False),
                 lambda: ops.fingerprint(x)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # naming the card explicitly raises the same way
    for call in (lambda: ops.fingerprint(x, backend="cuda"),
                 lambda: ops.delta_quantize(x, x, backend="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="unknown backend"):
        ops.delta_quantize(x, x, backend="interpret")


def test_cuda_sources_match_their_ctypes_bindings():
    """Every C entry point has the argument count its ctypes binding
    declares (plus device and stream), and every source names the TPU
    kernel it replaces."""
    replaced = {"delta_quantize": ["delta_quantize_2d", "dequant_apply_2d"],
                "snapshot_fused": ["snapshot_fused_2d"],
                "chain_apply": ["chain_apply_2d"],
                "fingerprint": ["fingerprint_2d"],
                "flash_attention": ["flash_attention"]}
    for name in build.SOURCES:
        text = (build.CSRC / f"{name}.cu").read_text()
        found = {m.group(1): len(m.group(2).split(","))
                 for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)',
                                      text)}
        assert found == {fn: len(args)
                         for fn, args in build.SIGNATURES[name].items()}
        for kernel in replaced[name]:
            assert f"repro/kernels/{name}.py::{kernel}" in text
        assert "#include \"common.cuh\"" in text
    assert set(replaced) == set(build.SOURCES)
    common = (build.CSRC / "common.cuh").read_text()
    assert "__fdiv_rn" in common and "__fmul_rn" in common


def test_build_needs_nvcc_and_keys_libraries_by_source(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["chain_apply"])
    before = build.library_path("chain_apply")
    assert before.parent == tmp_path / "out"
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    assert build.library_path("chain_apply") == before
    (csrc / "chain_apply.cu").write_text(
        (csrc / "chain_apply.cu").read_text() + "\n// edited\n")
    assert build.library_path("chain_apply") != before


def _reference_tile_zeros(q_flat: np.ndarray) -> np.ndarray:
    """A numpy model of the reference kernel's per-tile zero counts: q zero
    padded to (rows, 1024), rows = ⌈n / 1024⌉ rounded up to a multiple of
    8, cut into tiles of the first of 256, 128, ..., 8 rows that divides
    rows (``repro/kernels/ops.py::_to_2d``, ``_block_rows``)."""
    n = q_flat.size
    rows = -(-n // 8192) * 8
    block = next(c for c in (256, 128, 64, 32, 16, 8) if rows % c == 0)
    padded = np.zeros(rows * 1024, np.int32)
    padded[:n] = q_flat
    return (padded.reshape(-1, block * 1024) == 0).sum(axis=1).astype(np.int32)


# n = 4 x 16384 + 1: 72 rows in tiles of 8 rows, the last tile one real
# element and 8191 padding zeros; n = 73733: tiles of 16 rows; one tile
@pytest.mark.parametrize("n", [65537, 73733, 3000])
def test_block_zeros_per_tile_match_reference(n, monkeypatch):
    rng = np.random.default_rng(n)
    p2 = rng.normal(size=n).astype(np.float32)
    p1 = (p2 + rng.normal(scale=1e-4, size=n)
          * (rng.random(n) < 0.5)).astype(np.float32)
    qj, nzj, blocks_j = ref_ops.delta_quantize(p1, p2, backend="interpret",
                                               return_block_zeros=True)
    model = _reference_tile_zeros(np.asarray(qj))
    np.testing.assert_array_equal(np.asarray(blocks_j), model)
    # the card's path, with its device mapped to the CPU: the wrapper's
    # plain per-tile counts plus the padding the ops layer adds
    monkeypatch.setitem(ops._DEVICES, "cuda", "cpu")
    q, nz, blocks = ops.delta_quantize(p1, p2, backend="cuda",
                                       return_block_zeros=True)
    np.testing.assert_array_equal(q, np.asarray(qj))
    assert nz == nzj == int((q == 0).sum())
    assert blocks.dtype == np.int32
    np.testing.assert_array_equal(blocks, model)
    assert ops.delta_quantize(p1, p2, backend="ref",
                              return_block_zeros=True)[2] is None


def test_delta_quantize_flat_tile_counts_on_cpu():
    q = torch.tensor([0, 1, 0, 0] * 200, dtype=torch.int32)
    p2 = torch.zeros(800)
    p1 = q.to(torch.float32) * np.float32(ref.quant_scale(1e-4))
    got, tiles = delta_quantize_flat(p1, p2, tile=256)
    assert torch.equal(got, q)
    assert tiles.tolist() == [192, 192, 192, 24]
    assert tiles.dtype == torch.int32
    with pytest.raises(ValueError, match="multiple of 256"):
        delta_quantize_flat(p1, p2, tile=100)


def test_require_dtype_takes_f16_and_still_refuses_bf16():
    """bf16 no longer waits for a ROADMAP item: the storage kernels take it
    (the name is kept from when they refused it). A float type a kernel
    does not take still raises NotImplementedError naming what it takes."""
    floats = (torch.float32, torch.float16, torch.bfloat16)
    for dtype in floats:
        build.require_dtype(dtype, floats, "p1")
    assert not hasattr(build, "BF16_ITEM")
    with pytest.raises(NotImplementedError) as err:
        build.require_dtype(torch.float64, floats, "p1")
    assert "other float types" not in str(err.value)
    assert "float32 and float16 and bfloat16" in str(err.value)
    with pytest.raises(TypeError, match="expected int32"):
        build.require_dtype(torch.int64, (torch.int32,), "q")
    with pytest.raises(NotImplementedError, match="takes float32"):
        build.require_dtype(torch.bfloat16, (torch.float32,), "base")


@pytest.mark.parametrize("out_dtype", [None, "float32", "float16"])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_f16_dequant_and_quantize_on_the_card_path(dtype, out_dtype,
                                                   monkeypatch):
    """The f16 operands the kernels now take, through the card's path with
    its device mapped to the CPU: equal to the reference oracle and the
    numpy twins bit for bit (the reference's interpret kernel may contract
    its dequant into one rounding, which the oracle does not)."""
    from repro_torch.store.delta import host_dequant, host_snapshot
    rng = np.random.default_rng(21)
    p2 = rng.normal(scale=0.05, size=(257, 33)).astype(dtype)
    p1 = (p2.astype(np.float32) + rng.normal(scale=3e-2, size=p2.shape)
          ).astype(dtype)
    monkeypatch.setitem(ops._DEVICES, "cuda", "cpu")
    q, nz = ops.delta_quantize(p1, p2, backend="cuda")
    qj, nzj = ref_ops.delta_quantize(p1, p2, backend="ref")
    np.testing.assert_array_equal(q, np.asarray(qj))
    assert nz == nzj
    q_twin, nz_twin, _ = host_snapshot(p1, p2, 1e-4)
    np.testing.assert_array_equal(q, q_twin.astype(np.int32))
    assert nz == nz_twin
    out = ops.dequant_apply(p1, q, backend="cuda", out_dtype=out_dtype)
    want_dtype = out_dtype or dtype
    assert out.dtype == np.dtype(want_dtype)
    oj = np.asarray(ref_ops.dequant_apply(p1, qj, backend="ref",
                                          out_dtype=out_dtype))
    np.testing.assert_array_equal(out.view(np.uint8), oj.view(np.uint8))
    twin = host_dequant(p1, q, 1e-4, out_dtype=want_dtype)
    np.testing.assert_array_equal(out.view(np.uint8), twin.view(np.uint8))


def test_whole_tensor_counts_are_int64_and_tile_counts_unchanged():
    """The kernels count zeros and overflows in 64 bits, so a leaf may hold
    more than 2^31 elements; the wrappers' plain versions give the same
    dtypes. A tile's count (at most 256 x 1024) stays int32, and the
    ``ops`` results are the reference's as before."""
    rng = np.random.default_rng(5)
    p2 = rng.normal(size=70001).astype(np.float32)
    p1 = (p2 + rng.normal(scale=3e-4, size=70001)
          * (rng.random(70001) < 0.5)).astype(np.float32)
    t1, t2 = torch.from_numpy(p1), torch.from_numpy(p2)
    q, nz = delta_quantize_flat(t1, t2)
    assert nz.dtype == torch.int64 and nz.dim() == 0
    assert int(nz) == int((q == 0).sum())
    _, zeros, ovf = snapshot_fused_flat(t1, t2)
    assert zeros.dtype == ovf.dtype == torch.int64
    assert int(zeros) == int(nz)
    _, tiles = delta_quantize_flat(t1, t2, tile=8192)
    assert tiles.dtype == torch.int32
    assert tiles.tolist() == ref.tile_zero_counts(q, 8192).tolist()
    assert int(tiles.sum()) == int(nz)
    qj, nzj, blocks_j = ref_ops.delta_quantize(p1, p2, backend="interpret",
                                               return_block_zeros=True)
    assert ops.delta_quantize(p1, p2, backend="ref")[1] == nzj


class _CardTensor:
    """What ``build.on_card`` reads of a contiguous CUDA tensor of ``n``
    elements, without a card."""

    def __init__(self, n):
        self.device, self.n = torch.device("cuda", 0), n

    def is_contiguous(self):
        return True

    def numel(self):
        return self.n


def test_storage_kernels_take_operands_above_2_31_elements():
    """No element limit is left for the storage kernels; flash attention,
    held on the card only below 2^31 elements, keeps its own in its
    launch (a dry run's meta operands of any size still pass)."""
    from repro_torch.kernels import flash_attention as fa
    big = _CardTensor(2**31 + 2**20)
    assert build.on_card(big, _CardTensor(2**32 + 1))
    q = torch.empty((1, 8, 2**20, 256), device="meta", dtype=torch.bfloat16)
    k = torch.empty((1, 1, 2**20, 256), device="meta", dtype=torch.bfloat16)
    assert q.numel() == fa.MAX_ELEMENTS + 1
    with pytest.raises(ValueError, match="at most 2147483647"):
        fa._launch(q, k, k, True, 0, 0)
    assert fa.flash_attention(q, k, k).shape == q.shape
