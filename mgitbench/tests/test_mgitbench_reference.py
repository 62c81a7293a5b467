"""The plain references against the port at a tiny size on the CPU, and
the frozen parameter layout against the port's."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mgitbench import common
from mgitbench.reference import algorithm1
from mgitbench.reference.model import Model, round_to
from mgitbench.weights import Weights, nested, param_specs
from tiny import TINY_DENSE, TINY_SSM, drive, tiny_run

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob(
    "*.json"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
@pytest.mark.parametrize("tiny", [False, True])
def test_layout_is_the_ports(path, tiny):
    from repro_torch.models.model import flat_paths, param_structs
    m = json.loads(path.read_text())["model"]
    if tiny:
        m = dict(m, **(TINY_DENSE if m["family"] == "dense" else TINY_SSM))
    port = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in flat_paths(param_structs(common.port_config(m))
                                   ).items()}
    assert param_specs(m) == dict(sorted(port.items()))


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_model_matches_port_forward(family):
    from repro_torch.models.model import forward
    cell = ("paper-bert-f32.classify" if family == "dense"
            else "mamba2-780m-bf16.longdoc")
    run = tiny_run(cell)
    run.config["model"]["dtype"] = "float32"
    w = Weights(run.config, 3, "cpu")
    params = w.derive(w.base(), 1)
    tokens = torch.randint(1, 512, (3, 40), generator=torch.Generator()
                           .manual_seed(0))
    cfg = common.port_config(run.model)
    with torch.no_grad():
        port = forward(cfg, nested(params), {"tokens": tokens})
        ref = Model(run.model, params).logits(tokens, 0)
    assert torch.allclose(port, ref, atol=1e-4, rtol=1e-4), \
        float((port - ref).abs().max())


@pytest.mark.parametrize("cell", ["paper-bert-f32.lineage",
                                  "mamba2-780m-bf16-l8.lineage"])
def test_algorithm1_is_the_stores_bit_for_bit(cell):
    """Every checkout of a tiny lineage on the store's host path equals the
    NumPy reconstruction, and the control (one precision lower) does not."""
    run = drive(tiny_run(cell))
    assert run.checks["checkout_bits_differing"]["value"] == 0
    assert run.records["leaves_compared"][0]["n"] > 0
    control = drive(tiny_run(cell, control=True))
    assert control.checks["checkout_bits_differing"]["value"] > 0


def test_bf16_rounding_is_torchs():
    x = torch.randn(100_000, generator=torch.Generator().manual_seed(1))
    x[:4] = torch.tensor([1.0 + 2**-8, 1.0 + 3 * 2**-8, -0.0, 3e38])  # ties
    want = x.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(algorithm1.narrow_bf16(x.numpy()), want)
    assert np.array_equal(algorithm1.widen_bf16(want),
                          x.to(torch.bfloat16).float().numpy())


def test_fp8_rounding_is_torchs():
    x = torch.randn(100_000, generator=torch.Generator().manual_seed(2)) * 30
    want = x.to(torch.float8_e4m3fn).float().numpy()
    assert np.array_equal(algorithm1.fp8_e4m3(x.numpy()), want)


def test_tf32_rounding_keeps_ten_bits():
    x = torch.randn(10_000, generator=torch.Generator().manual_seed(3))
    r = round_to(x, "tf32")
    assert int((r.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(((r - x) / x).abs().max()) <= 2.0 ** -11
