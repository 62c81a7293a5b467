"""The frozen formulas pinned at one shape each to what the port's
``flash_attention.roofline`` and PERF.md's kernel table give today."""

import pytest

from mgitbench import formulas


@pytest.mark.parametrize("dtype,ms", [("float32", 0.0196),
                                      ("bfloat16", 0.0075)])
def test_flash_bound_is_the_ports(dtype, ms):
    import torch
    from repro_torch.kernels.flash_attention import roofline
    got = formulas.flash_bound_s(8, 12, 12, 512, 512, 64, dtype) * 1e3
    port, _ = roofline(8, 12, 12, 512, 512, 64, getattr(torch, dtype))
    assert got == pytest.approx(port, rel=1e-12)
    assert round(got, 4) == ms


def test_flash_visible_pairs_with_a_prefix_and_window():
    from repro_torch.kernels.flash_attention import flops
    for kw in ({}, {"prefix_len": 256}, {"window": 100}):
        assert formulas.flash_ops(2, 8, 768, 768, 256, **kw) == \
            flops(2, 8, 768, 768, 256, **kw)


@pytest.mark.parametrize("nbytes,ms", [
    (formulas.snapshot_fused_bytes(12 * 768 * 3072), 0.0761),
    (formulas.delta_quantize_bytes(768 * 30522, "float32", "float32"), 0.0840),
    (formulas.dequant_apply_bytes(12 * 768 * 3072, "float32", "float32"),
     0.1014),
    (formulas.dequant_apply_bytes(28 * 1024 * 3072, "bfloat16", "bfloat16"),
     0.2103),
    (formulas.chain_apply_bytes(12 * 768 * 3072, 3), 0.1690),
])
def test_storage_bounds_are_the_kernel_tables(nbytes, ms):
    assert round(formulas.bytes_bound_s(nbytes) * 1e3, 4) == ms


def test_dense_sequence_ops_by_hand():
    m = {"family": "dense", "n_layers": 12, "d_model": 768, "n_heads": 12,
         "n_kv_heads": 12, "head_dim": 64, "d_ff": 3072, "vocab_size": 30522,
         "mlp_type": "gelu"}
    per_token = 2 * 12 * (4 * 768 * 768 + 2 * 768 * 3072)
    attn = 4 * 12 * 12 * 64 * (100 * 101 // 2)
    head = 2 * 768 * 30522
    assert formulas.sequence_ops(m, 100, 1) == per_token * 100 + attn + head


def test_ssm_sequence_ops_by_hand():
    m = {"family": "ssm", "n_layers": 48, "d_model": 1536, "ssm_state": 128,
         "ssm_expand": 2, "ssm_head_dim": 64, "ssm_conv_width": 4,
         "vocab_size": 50288}
    layer = (2 * 1536 * (2 * 3072 + 256 + 48) + 2 * 4 * (3072 + 256)
             + 4 * 3072 * 128 + 2 * 3072 * 1536)
    assert formulas.sequence_ops(m, 512, 8) == \
        48 * layer * 519 + 2 * 1536 * 50288 * 8
