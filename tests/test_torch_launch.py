"""The port's dry run (``repro_torch.launch``) against the reference, on the CPU.

Shapes and dtypes of every input of every arch × shape cell, at full
width and without allocating (meta tensors in the port, ShapeDtypeStructs
in the reference), equal the reference's; so do the parameter counts and
the analytic MODEL_FLOPS. The counters are held to hand counts: the
forward FLOPs of a reduced dense config (2·m·n·k per product), the live
bytes and saved bytes of a small function, the flash operator's FLOP
formula against ``flash_attention.flops`` on every mask case of
``tests/test_torch_flash.py``. Cells run on meta without raising, a train
cell's two-microbatch measurement stands for any count of microbatches,
and ``cfg.remat`` moves its activation bytes.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.launch.shapes import SHAPES as REF_SHAPES
from repro.launch.shapes import input_specs as ref_input_specs
from repro.models import get_config as ref_get_config
from repro.models.model import cache_structs as ref_cache_structs
from repro.models.model import flat_paths as ref_flat_paths
from repro.models.model import param_structs as ref_param_structs

from repro_torch.common.tree import flatten_with_path
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import dtype_name
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import SHAPES, cell_inputs, input_specs
from repro_torch.models import get_config
from repro_torch.models.model import (cache_structs, flat_paths, forward,
                                      param_structs)

from test_torch_flash import SPECS, WIDE_SPECS


def _described(tree):
    """{path: (shape, dtype name)} of a tree of meta tensors or
    ShapeDtypeStructs."""
    out = {}
    for path, leaf in flatten_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            out["/".join(path)] = (tuple(leaf.shape), dtype_name(leaf.dtype))
        else:
            out["/".join(path)] = (tuple(leaf.shape), str(np.dtype(leaf.dtype)))
    return out


@pytest.fixture(scope="module")
def reference_dryrun():
    """The reference's ``repro.launch.dryrun``. Its import appends 512 host
    devices to XLA_FLAGS; JAX is initialised first, so this process keeps
    its one device, and the variable is put back afterwards."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as ref_dryrun
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return ref_dryrun


@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_param_and_cache_structs_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    params = param_structs(cfg)
    assert all(t.device.type == "meta" for t in flat_paths(params).values())
    want = {p: (tuple(s.shape), str(np.dtype(s.dtype)))
            for p, s in ref_flat_paths(ref_param_structs(rcfg)).items()}
    assert _described(params) == {
        p: want[p] for p in sorted(want)} and list(want) != []
    enc = 32 if cfg.family in ("encdec", "audio") else 0
    assert _described(cache_structs(cfg, 2, 64, enc)) == _described(
        ref_cache_structs(rcfg, 2, 64, enc))


@pytest.mark.parametrize("shape", list(REF_SHAPES))
@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_input_specs_match_reference(arch, shape):
    assert SHAPES[shape] == dataclasses.replace(
        SHAPES[shape], **dataclasses.asdict(REF_SHAPES[shape]))
    try:
        want = ref_input_specs(arch, shape, mesh=None)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            input_specs(arch, shape)
        assert str(got.value) == str(e)
        return
    got = input_specs(arch, shape)
    assert _described(got) == _described(want)


@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_counts_and_model_flops_match_reference(arch, reference_dryrun):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert dryrun.count_params(cfg) == reference_dryrun.count_params(rcfg)
    assert (dryrun.count_active_params(cfg)
            == reference_dryrun.count_active_params(rcfg))
    for shape in SHAPES:
        assert dryrun.model_flops(cfg, SHAPES[shape]) == \
            reference_dryrun.model_flops(rcfg, REF_SHAPES[shape])


def _hand_forward_flops(cfg, B, S):
    """2·m·n·k for each product of the forward pass: the projections, the
    MLP, every (query block, key block) pair of the chunked attention
    (none is skipped) and the tied unembedding."""
    T, D, hd, F = B * S, cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    per_layer = (2 * T * D * Hq * hd + 2 * 2 * T * D * Hkv * hd
                 + 2 * T * Hq * hd * D
                 + (3 if cfg.mlp_type == "swiglu" else 2) * 2 * T * D * F
                 + 2 * 2 * B * S * S * Hq * hd)
    return cfg.n_layers * per_layer + 2 * T * D * cfg.vocab_size


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "starcoder2-15b"])
def test_forward_flops_equal_hand_count(arch):
    cfg = get_config(arch).reduced()
    B, S = 2, 128                       # two 64-token chunks each way
    params = param_structs(cfg)
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
    with torch.utils.flop_counter.FlopCounterMode(display=False) as counter:
        logits = forward(cfg, params, {"tokens": tokens})
    assert logits.shape == (B, S, cfg.vocab_size)
    assert counter.get_total_flops() == _hand_forward_flops(cfg, B, S)


def test_live_and_saved_bytes_equal_hand_count():
    """y = relu(x @ w1) @ w2, summed, with grad: x (4, 8), w1 (8, 16), w2
    (16, 2) in f32 are 768 bytes of inputs. x @ w1 (256 B) and its relu
    (256 B) are both alive at once: the peak is 768 + 512. Autograd keeps
    the relu's result (256 B) besides the inputs; the matrix products
    count 2·4·8·16 + 2·4·16·2 FLOPs; the output is the 4-byte loss."""
    x = torch.empty((4, 8), device="meta")
    w1 = torch.empty((8, 16), device="meta", requires_grad=True)
    w2 = torch.empty((16, 2), device="meta", requires_grad=True)
    with torch.enable_grad():
        m = dryrun.measure(lambda a, b, c: (torch.relu(a @ b) @ c).sum(),
                           (x, w1, w2))
    assert m["argument_bytes"] == 768
    assert m["peak_bytes"] == 768 + 512
    assert m["flops"] == 2 * 4 * 8 * 16 + 2 * 4 * 16 * 2
    assert m["flops_by_dtype"] == {"float32": m["flops"]}
    assert m["output_bytes"] == 4 and m["alias_bytes"] == 0
    # no backward ran: the saved bytes are only reported after one
    assert m["saved_bytes"] is None
    loss_and_grads = lambda a, b, c: torch.autograd.grad(   # noqa: E731
        (torch.relu(a @ b) @ c).sum(), (b, c))
    with torch.enable_grad():
        m = dryrun.measure(loss_and_grads, (x, w1, w2))
    assert m["saved_bytes"] == 256
    # when the backward pass starts: inputs, the relu, the loss and the
    # backward's seed (a 4-byte one)
    assert m["backward_live"] == 768 + 256 + 4 + 4
    assert m["output_bytes"] == 512 + 128      # the two gradients


@pytest.mark.parametrize("spec", SPECS + WIDE_SPECS + [
    dict(B=1, Hq=4, Hkv=2, S=200, hd=16, causal=True, prefix_len=100),
    dict(B=1, Hq=2, Hkv=1, S=100, hd=16, causal=True, window=40),
    dict(B=1, Hq=2, Hkv=1, S=130, hd=16, causal=True, window=50),
    dict(B=1, Hq=2, Hkv=2, S=77, hd=32, causal=True)],
    ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_flash_flop_formula_equals_flops(spec):
    kw = {k: spec[k] for k in ("causal", "window", "prefix_len") if k in spec}
    B, Hq, Hkv, S, hd = (spec[k] for k in ("B", "Hq", "Hkv", "S", "hd"))
    q = torch.empty((B, Hq, S, hd), device="meta")
    kv = torch.empty((B, Hkv, S, hd), device="meta")
    with torch.utils.flop_counter.FlopCounterMode(display=False) as counter:
        out = fa.flash_attention(q, kv, kv, **kw)
    assert out.shape == q.shape and out.device.type == "meta"
    assert counter.get_total_flops() == fa.flops(B, Hq, S, S, hd, **kw)
    assert fa.flash_attention.launches == 0      # meta launches nothing


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b", "mamba2-780m",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2", "paligemma-3b"])
def test_cells_run_on_meta(arch, shape):
    """Each family's serving cells at the cells' full lengths, at a reduced
    width and depth, with attention chunks of 8192 (an encoder's chunked
    attention over 32768 frames then walks 4 x 4 blocks, not 512 x 512)
    and the full config's SSM chunk."""
    base = get_config(arch)
    cfg = dataclasses.replace(base.reduced(), dtype=base.dtype,
                              attn_chunk=8192, ssm_chunk=base.ssm_chunk)
    r = dryrun.run_cell(arch, shape, cfg=cfg, search=False)
    if not base.subquadratic and shape == "long_500k":
        assert r["status"] == "skipped"
        return
    assert r["status"] == "ok" and r["flops"] > 0
    assert r["peak_bytes"] >= r["memory_analysis"]["argument_bytes"] > 0
    if r["kind"] == "prefill" and cfg.family != "ssm":
        assert r["bytes"]["cache"] > 0
    assert r["roofline"]["bound_s"] == max(r["roofline"]["compute"],
                                           r["roofline"]["memory"])


def test_two_microbatches_stand_for_any_count():
    """FLOPs scale with the microbatches and the peak repeats after the
    second: a train step of 4 microbatches counts twice the FLOPs of one
    of 2 at the same microbatch, and its peak is higher only by what the
    step keeps of each microbatch (its loss: under 1 KiB each)."""
    cfg = get_config("qwen3-0.6b").reduced()
    cell = dataclasses.replace(SHAPES["train_4k"], seq=64)
    m = {}
    for k in (2, 4):
        c = dataclasses.replace(cell, batch=2 * k, microbatches=k)
        specs = cell_inputs(cfg, c)
        fn, order = dryrun.build_step(cfg, c)
        m[k] = dryrun.measure(fn, tuple(specs[o] for o in order))
    assert m[4]["flops"] == 2 * m[2]["flops"]
    assert 0 <= m[4]["peak_bytes"] - m[2]["peak_bytes"] <= 2 * 1024


def test_remat_moves_activation_bytes_of_a_train_cell():
    cfg = get_config("qwen3-0.6b").reduced(attn_chunk=1024)
    r = {remat: dryrun.run_cell("qwen3-0.6b", "train_4k", remat=remat,
                                cfg=cfg, batch=1, search=False)
         for remat in ("none", "dots", "full")}
    live = {k: v["bytes"]["activations_live"] for k, v in r.items()}
    saved = {k: v["bytes"]["activations_saved"] for k, v in r.items()}
    assert live["full"] < live["dots"] < live["none"]
    assert saved["full"] < saved["none"]
    assert r["full"]["remat"] == "full" and r["full"]["microbatches"] == 16
    # recomputation adds forward FLOPs; the products' count does not move
    assert r["none"]["flops"] < r["dots"]["flops"] <= r["full"]["flops"]
    assert len({v["model_flops"] for v in r.values()}) == 1


@pytest.mark.parametrize("peak, limit, want", [
    (lambda b: 10 + 3 * b, 40, 10),          # affine: found from 1 and 2
    (lambda b: 10 + 3 * b, 12, 0),
    (lambda b: 10 + 3 * b, 13, 1),
    (lambda b: 10 + 3 * b, 16, 2),
    # flat until the activations pass the update's peak, then affine
    (lambda b: max(1000, 900 + 7 * b), 1500, 85),
    (lambda b: 1000, 2000, 2**16),           # never grows: the search's cap
])
def test_largest_batch_search(peak, limit, want):
    calls = []

    def counted(b):
        calls.append(b)
        if b > 2**40:
            raise RuntimeError("numel: integer multiplication overflow")
        return peak(b)
    assert dryrun.largest_batch(counted, limit, {}) == want
    assert len(calls) == len(set(calls)) <= 40


def test_cap_is_searched_only_where_it_does_not_fit():
    """With a cap, a cell runs at the cap when the cap fits (one run, no
    search) and at the largest batch that fits when it does not."""
    base = get_config("mamba2-780m")
    cfg = dataclasses.replace(base.reduced(), dtype=base.dtype)
    card = (dryrun.CARD_BYTES, "card")
    roomy = dryrun.run_cell("mamba2-780m", "decode_32k", cfg=cfg, cap=4,
                            capacity=card)
    assert roomy["batch"] == 4 and roomy["fits"]
    assert roomy["largest_batch"] is None
    assert list(roomy["peaks_by_batch"]) == [4]
    two = dryrun.run_cell("mamba2-780m", "decode_32k", cfg=cfg, batch=2,
                          search=False, capacity=card)
    tight = (two["peak_bytes"] + dryrun.HEADROOM_BYTES, "card")
    r = dryrun.run_cell("mamba2-780m", "decode_32k", cfg=cfg, cap=4,
                        capacity=tight)
    assert r["largest_batch"] == 2 and r["batch"] == 2 and r["fits"]
    assert r["peak_bytes"] == two["peak_bytes"]


def test_run_cells_in_processes_equals_serial():
    """Cells run in spawned processes give the serial run's results, each
    under its job's index."""
    base = get_config("mamba2-780m")
    cfg = dataclasses.replace(base.reduced(), dtype=base.dtype)
    jobs = [("mamba2-780m", shape, dict(cfg=cfg, search=False))
            for shape in ("long_500k", "decode_32k")]
    keys = ("status", "shape", "batch", "flops", "peak_bytes")
    serial = {i: {k: r[k] for k in keys} for i, r in dryrun.run_cells(jobs)}
    pooled = {i: {k: r[k] for k in keys}
              for i, r in dryrun.run_cells(jobs, processes=2)}
    assert pooled == serial
    assert [serial[i]["shape"] for i in (0, 1)] == ["long_500k", "decode_32k"]


def test_sweep_cli_writes_cells(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k,decode_32k",
                 "--out", str(out)])
    import json
    got = json.loads(out.read_text())
    assert set(got) == {"mamba2-780m|long_500k|1xH100",
                        "mamba2-780m|decode_32k|1xH100"}
    r = got["mamba2-780m|long_500k|1xH100"]
    assert r["status"] == "ok" and r["fits"] and r["largest_batch"] >= 1
    assert r["mesh"] == "1xH100" and r["chips"] == 1
    dryrun.main(["--arch", "mamba2-780m", "--shape", "long_500k",
                 "--out", str(out)])
    assert "[cached]" in capsys.readouterr().out
