"""The port's flash attention against the reference package, on the CPU.

The wrapper runs its plain version here (CPU tensors); the CUDA kernel is
held against that plain version on the card by ``chip_smoke.py``. Inputs
are made with numpy from a seed and fed to both packages; bf16 inputs are
the same f32 draws rounded to bf16 on each side. Tolerances are the
reference test's (``tests/test_kernels.py``): 2e-5 in f32, 3e-2 in bf16.

It also pins a reference behaviour: the Pallas kernel's block skip ignores
``prefix_len``, so once a prefix-LM prefix reaches past a query block it
drops key blocks the prefix makes visible. The port follows the oracle.
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
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


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
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(
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
    # a tensor on any other device never reaches the plain version
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))


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
