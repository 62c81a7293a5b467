"""The port's flash attention against the reference package, on the CPU.

The wrapper runs its plain version here (CPU tensors); the CUDA kernel is
held against that plain version on the card by ``chip_smoke.py``. Inputs
are made with numpy from a seed and fed to both packages; bf16 inputs are
the same f32 draws rounded to bf16 on each side. Tolerances are the
reference test's (``tests/test_kernels.py``): 2e-5 in f32, 3e-2 in bf16.

Head dims 256 and 200 (the card's 256 instantiation, paligemma-3b's
head dim) are held against the reference kernel too.

It also pins a reference behaviour: the Pallas kernel's block skip ignores
``prefix_len``, so once a prefix-LM prefix reaches past a query block it
drops key blocks the prefix makes visible. The port follows the oracle.

The kernel's arithmetic plan is checked here by emulation in torch (the
kernel itself runs only on the card): f32 as three TF32 passes (3xTF32),
bf16 with scores scaled in f32 after the product and P rounded to bf16
before P @ V, each against the reference's oracle.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention import flash_attention_ref as ref_oracle
from repro.kernels.flash_attention import hbm_bytes as ref_hbm_bytes

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.models import get_config
from repro_torch.models.layers import chunked_attention

# the reference test's five mask specs (tests/test_kernels.py)
SPECS = [
    dict(B=2, Hq=4, Hkv=2, S=64, hd=16, causal=True),
    dict(B=1, Hq=8, Hkv=1, S=32, hd=8, causal=True),          # MQA
    dict(B=2, Hq=4, Hkv=4, S=64, hd=16, causal=True, window=24),
    dict(B=1, Hq=4, Hkv=2, S=48, hd=16, causal=True, prefix_len=16),
    dict(B=2, Hq=2, Hkv=2, S=64, hd=16, causal=False),
]
# f16 (not in the reference test): f16 keeps three more mantissa bits than
# bf16, so a third of bf16's tolerance still leaves room for the output's
# rounding (2^-11 relative) and the kernel's f16 P
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2),
          "float16": (jnp.float16, torch.float16, 1e-2)}
# head dims 256 (paligemma-3b's, MQA) and 200 (padded to the 256
# instantiation on the card), with and without a prefix inside the
# reference kernel's first 16-row block
WIDE_SPECS = [
    dict(B=1, Hq=8, Hkv=1, S=32, hd=256, causal=True),
    dict(B=1, Hq=8, Hkv=1, S=32, hd=256, causal=True, prefix_len=12),
    dict(B=2, Hq=2, Hkv=2, S=48, hd=200, causal=True),
    dict(B=2, Hq=2, Hkv=2, S=48, hd=200, causal=True, prefix_len=16),
]


def _inputs(spec, seed=0):
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, S, hd = (spec[k] for k in ("B", "Hq", "Hkv", "S", "hd"))
    return (rng.normal(size=(B, Hq, S, hd)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, hd)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, hd)).astype(np.float32))


def _masks(spec):
    return {k: spec[k] for k in ("causal", "window", "prefix_len")
            if k in spec}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("spec", SPECS + WIDE_SPECS, ids=lambda s: "-".join(
    f"{k}{v}" for k, v in s.items()))
def test_plain_version_matches_reference_kernel_and_oracle(spec, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(spec)
    kw = _masks(spec)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, **kw)
    assert flash_attention.launches == before   # the plain version is no launch
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    assert torch.equal(got, flash_attention_ref(tq, tk, tv, **kw))
    kernel = ref_flash(jq, jk, jv, qc=16, kc=16, interpret=True, **kw)
    oracle = ref_oracle(jq, jk, jv, **kw)
    np.testing.assert_allclose(_f32(got), _f32(kernel), atol=tol)
    np.testing.assert_allclose(_f32(got), _f32(oracle), atol=tol)


@pytest.mark.parametrize("spec", SPECS + [
    dict(B=1, Hq=4, Hkv=2, S=200, hd=16, causal=True, prefix_len=100),
    dict(B=1, Hq=2, Hkv=1, S=100, hd=16, causal=True, window=40),
], ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_plain_version_matches_port_chunked_attention(spec):
    """The same function as the model's training attention, in the
    model's (B, S, H, hd) layout, over chunks of 16."""
    q, k, v = _inputs(spec, seed=1)
    kw = _masks(spec)
    cfg = dataclasses.replace(get_config("paper-bert-small"), attn_chunk=16,
                              window=kw.get("window", 0))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, **kw)
    chunked = chunked_attention(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), cfg,
        causal=kw["causal"], prefix_len=kw.get("prefix_len", 0))
    np.testing.assert_allclose(got.numpy(), chunked.transpose(1, 2).numpy(),
                               atol=2e-5)


@pytest.mark.parametrize("prefix_len", [24, 40])
def test_reference_pallas_prefix_skip_is_pinned(prefix_len):
    """Reference behaviour: at S=48 with 16-row blocks and a prefix past
    the first block, the Pallas kernel skips key blocks the prefix makes
    visible and differs from its own oracle by more than 0.5. The port's
    plain version (what its CUDA kernel is held to) matches the oracle."""
    spec = dict(B=1, Hq=4, Hkv=2, S=48, hd=16)
    q, k, v = _inputs(spec)
    kw = dict(causal=True, prefix_len=prefix_len)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    oracle = np.asarray(ref_oracle(jq, jk, jv, **kw))
    pallas = np.asarray(ref_flash(jq, jk, jv, qc=16, kc=16, interpret=True,
                                  **kw))
    assert np.abs(pallas - oracle).max() > 0.5
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), oracle, atol=2e-5)


def test_ragged_sequence_and_long_prefix_match_oracle():
    """Lengths that are not a multiple of the kernel's 64-row tile, and a
    prefix that runs past a tile, as chip_smoke.py gives the kernel."""
    for spec, kw in ((dict(B=2, Hq=4, Hkv=2, S=200, hd=64),
                      dict(causal=True, prefix_len=100)),
                     (dict(B=1, Hq=2, Hkv=2, S=77, hd=32), dict(causal=True)),
                     (dict(B=1, Hq=2, Hkv=1, S=130, hd=16),
                      dict(causal=True, window=50))):
        q, k, v = _inputs(spec, seed=2)
        got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
        oracle = ref_oracle(*(jnp.asarray(a) for a in (q, k, v)), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-5)


def test_wrapper_checks_shapes_and_devices():
    q = torch.zeros(1, 4, 8, 16)
    kv = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="pair"):
        flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="expected q"):
        flash_attention(q[0], kv, kv)
    with pytest.raises(ValueError, match="could see no key"):
        flash_attention(q, kv[:, :, :4], kv[:, :, :4], window=2)
    # meta tensors (a dry run) give the result's shape and compute
    # nothing; a mix of devices never reaches the plain version
    out = flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q.to("meta"), kv, kv)


def test_flops_count_visible_pairs_and_hbm_bytes_match_reference():
    assert fa.flops(1, 1, 4, 4, 8) == 4 * 8 * 10          # causal: 10 pairs
    assert fa.flops(1, 1, 4, 4, 8, causal=False) == 4 * 8 * 16
    assert fa.flops(1, 1, 4, 4, 8, prefix_len=3) == 4 * 8 * 13
    assert fa.flops(2, 3, 4, 4, 8, window=2) == 2 * 3 * 4 * 8 * 7
    # the serving shape's bound in the chip smoke: 3.2 GFLOP causal
    assert fa.flops(8, 12, 512, 512, 64) == 4 * 8 * 12 * 64 * 512 * 513 // 2
    for args in ((1, 4, 2, 1024, 1024, 64), (2, 8, 8, 512, 512, 128)):
        for qc in (64, 512):
            assert fa.hbm_bytes(*args, qc=qc) == ref_hbm_bytes(*args, qc=qc)


def test_roofline_hand_counts():
    """The bound of one call on an H100 SXM: bytes of q, k, v and out once
    at 3.35 TB/s against the visible pairs' operations at 989 TFLOP/s
    (bf16) or as three TF32 passes at 495 TFLOP/s (f32)."""
    serve = (8, 12, 12, 512, 512, 64)   # paper-bert prefill, causal
    pairs = 8 * 12 * 512 * 513 // 2
    assert fa.flops(8, 12, 512, 512, 64) == 4 * 64 * pairs == 3_227_516_928
    ms, by = fa.roofline(*serve, torch.bfloat16)
    assert by == "bytes"
    assert ms == pytest.approx(25_165_824 / 3.35e12 * 1e3)       # 0.0075 ms
    assert round(ms, 4) == 0.0075
    ms, by = fa.roofline(*serve, torch.float32)
    assert by == "operations"
    assert ms == pytest.approx(3 * 3_227_516_928 / 495e12 * 1e3)  # 0.0196 ms
    assert round(ms, 4) == 0.0196
    # qwen3-0.6b's attention at 4096 tokens: operations bound both dtypes
    qwen = (1, 16, 8, 4096, 4096, 128)
    ops = 4 * 128 * 16 * 4096 * 4097 // 2
    assert fa.roofline(*qwen, torch.bfloat16) == (
        pytest.approx(ops / 989e12 * 1e3), "operations")
    assert fa.roofline(*qwen, torch.float32) == (
        pytest.approx(3 * ops / 495e12 * 1e3), "operations")
    # a window halves nothing here but the visible pairs
    assert fa.roofline(*serve, torch.float32, window=64)[0] < ms
    # paligemma-3b's prefill in phase 8: 256 patches (a bidirectional
    # prefix) + 512 text tokens, MQA at head_dim 256; 327,936 visible
    # pairs per head (256 x 256 in the prefix rows, 257 + ... + 768 after)
    pali = (8, 8, 1, 768, 768, 256)
    pairs = 256 * 256 + sum(range(257, 769))
    assert pairs == 327_936
    ops = 4 * 256 * 8 * 8 * pairs
    assert fa.flops(8, 8, 768, 768, 256, prefix_len=256) == ops
    ms, by = fa.roofline(*pali, torch.bfloat16, prefix_len=256)
    assert by == "operations" and round(ms, 4) == 0.0217
    assert ms == pytest.approx(ops / 989e12 * 1e3)
    nbytes = (2 * 8 * 8 * 768 + 2 * 8 * 1 * 768) * 256 * 2
    assert nbytes == 56_623_104 and round(nbytes / 3.35e12 * 1e3, 4) == 0.0169
    # f16 runs on the same tensor cores at the same rate as bf16
    assert fa.roofline(*serve, torch.float16) == fa.roofline(
        *serve, torch.bfloat16)
    with pytest.raises(TypeError):
        fa.roofline(*serve, torch.float64)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: f32 rounded to 10 mantissa bits, ties away from
    zero (add half of the dropped 13 bits' range to the magnitude, then
    clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    big = _tf32(x)
    return big, _tf32(x - big)


def test_tf32_rounding_emulation():
    half_ulp = 2.0 ** -11          # half of TF32's ulp at 1
    x = torch.tensor([1 + half_ulp, -(1 + half_ulp), 1 + half_ulp / 2,
                      1 + 3 * half_ulp, 3.0], dtype=torch.float32)
    assert _tf32(x).tolist() == [1 + 2 * half_ulp, -(1 + 2 * half_ulp), 1.0,
                                 1 + 4 * half_ulp, 3.0]
    big, small = _split(torch.tensor([1 / 3], dtype=torch.float32))
    assert big.item() != 1 / 3 and abs(big.item() + small.item() - 1 / 3) < 1e-7


def _plan_f32(q, k, v, passes):
    """The f32 kernel's arithmetic on (B, H, S, hd) f32 inputs, causal:
    scores from ``passes`` TF32 products (3: small*big + big*small +
    big*big; 1: big*big), scaled in f32, unnormalised p = exp(s - max),
    P @ V the same way, divided by the row sums of p at the end."""
    def product(a, b):
        (ab, as_), (bb, bs) = _split(a), _split(b)
        if passes == 1:
            return ab @ bb
        return as_ @ bb + ab @ bs + ab @ bb

    S, hd = q.shape[-2], q.shape[-1]
    s = product(q, k.transpose(-1, -2)) * hd ** -0.5
    ok = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(ok, s, torch.full_like(s, fa.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return product(p, v) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("hd", [64, 128])
def test_3xtf32_plan_meets_f32_tolerance_and_one_pass_does_not(hd):
    """Three TF32 passes stay within f32's 2e-5 of the oracle; a single
    pass keeps about three decimal digits and does not."""
    q, k, v = _inputs(dict(B=1, Hq=2, Hkv=2, S=512, hd=hd), seed=3)
    oracle = np.asarray(ref_oracle(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    three = _plan_f32(tq, tk, tv, passes=3).numpy()
    np.testing.assert_allclose(three, oracle, atol=2e-5)
    one = _plan_f32(tq, tk, tv, passes=1).numpy()
    assert np.abs(one - oracle).max() > 2e-5


def test_bf16_plan_meets_bf16_tolerance_with_gqa():
    """bf16 at head_dim 128 with GQA: scores accumulated in f32 from bf16
    operands and scaled in f32 after the product (hd^-0.5 is no power of
    two here), P rounded to bf16 for P @ V while the row sums use the f32
    p: within bf16's 3e-2 of the oracle on the same bf16 inputs."""
    q, k, v = _inputs(dict(B=1, Hq=4, Hkv=2, S=512, hd=128), seed=4)
    oracle = ref_oracle(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                        causal=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    kf = tk.repeat_interleave(2, dim=1).float()
    vf = tv.repeat_interleave(2, dim=1).float()
    s = (tq.float() @ kf.transpose(-1, -2)) * 128 ** -0.5
    ok = torch.ones(512, 512, dtype=torch.bool).tril()
    s = torch.where(ok, s, torch.full_like(s, fa.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = ((p.to(torch.bfloat16).float() @ vf) / p.sum(-1, keepdim=True))
    np.testing.assert_allclose(_f32(out.to(torch.bfloat16)), _f32(oracle),
                               atol=3e-2)


def test_f16_plan_meets_f16_tolerance_with_gqa():
    """The f16 instantiation's arithmetic: the bf16 plan with f16 operands
    and P rounded to f16 for P @ V, within f16's 1e-2 of the oracle on the
    same f16 inputs (the reference's kernel widens f16 to f32)."""
    q, k, v = _inputs(dict(B=1, Hq=4, Hkv=2, S=512, hd=128), seed=5)
    jq, jk, jv = (jnp.asarray(a, jnp.float16) for a in (q, k, v))
    oracle = ref_oracle(jq, jk, jv, causal=True)
    kernel = ref_flash(jq, jk, jv, qc=128, kc=128, interpret=True,
                       causal=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.float16) for a in (q, k, v))
    kf = tk.repeat_interleave(2, dim=1).float()
    vf = tv.repeat_interleave(2, dim=1).float()
    s = (tq.float() @ kf.transpose(-1, -2)) * 128 ** -0.5
    ok = torch.ones(512, 512, dtype=torch.bool).tril()
    s = torch.where(ok, s, torch.full_like(s, fa.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = ((p.to(torch.float16).float() @ vf) / p.sum(-1, keepdim=True))
    for want in (oracle, kernel):
        np.testing.assert_allclose(_f32(out.to(torch.float16)), _f32(want),
                                   atol=1e-2)
    # the wrapper's plain version, which the CPU runs
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(_f32(got), _f32(kernel), atol=1e-2)


def test_kernel_operands_pad_head_dim_and_align():
    """What the wrapper hands the kernel: head dims padded with zeros to a
    multiple of 8, bases 16-byte aligned, other tensors as they are."""
    q = torch.randn(1, 2, 5, 20)
    k = torch.randn(1, 1, 5, 20)
    kq, kk, kv = fa.kernel_operands(q, k, k)
    assert kq.shape == (1, 2, 5, 24) and kk.shape == (1, 1, 5, 24)
    assert torch.equal(kq[..., :20], q) and not kq[..., 20:].any()
    flat = torch.randn(1 + 2 * 5 * 16)
    shifted = flat[1:].view(1, 2, 5, 16)   # contiguous, 4 bytes off
    assert shifted.data_ptr() % 16
    kq, kk, kv = fa.kernel_operands(shifted, shifted, shifted)
    assert kq.data_ptr() % 16 == 0 and torch.equal(kq, shifted)
    aligned = torch.randn(1, 2, 5, 16)
    assert fa.kernel_operands(aligned, aligned, aligned)[0] is aligned
    # above 128 the same rule: 250 -> 256, 200 (a multiple of 8) as it is
    wide = torch.randn(1, 1, 3, 250)
    assert fa.kernel_operands(wide, wide, wide)[0].shape[-1] == 256
    wide = torch.randn(1, 1, 3, 200)
    assert fa.kernel_operands(wide, wide, wide)[0] is wide
    assert fa.MAX_HEAD_DIM == 256

