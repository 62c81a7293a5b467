"""Granite-4.0-H-Small on the port, on the CPU at a small Granite-shaped
size in f32, with seeded weights.

The reference is the benchmark's plain one (``mgitbench/families/
granite_hybrid.py`` through ``mgitbench/reference/model.py``), the one
reference of this architecture in the repository; it imports nothing of
the port. It leaves out the division of the logits by ``logits_scaling``
(a power of two), so the port's logits are compared times that scale.

* ``forward``, and ``ServeEngine`` prefill and decode on a ragged batch,
  against the reference's logits, and the attention sublayer alone.
  Tolerance: 1e-5 of the largest reference value. Both run in f32 with
  products in other orders (the SSD's chunked form against the
  reference's exact block scan, grouped products against a loop over the
  experts, flash's plain version against dense softmax), which differ by
  a few f32 ulps a layer (about 3e-7 of the largest logit here); rotary
  positions in the attention, or its default scale, would be off by 3e-4
  and 2e-2.
* The expert share: the routed parts of the two halves of the experts,
  each routed over all of them, with the shared expert counted once, add
  up to the uncut layer.
* Dropless routing computes every choice at a T at which the capacity
  path drops some.
* The traced counts of the dropless MoE, and its refusal of experts
  other than SwiGLUs.
* A reduced mamba2 and a reduced mixtral forward are the same bits as
  before the Granite fields existed.
"""

import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mgitbench.families import granite_hybrid  # noqa: E402
from mgitbench.reference.model import Model, served_gaps  # noqa: E402
from mgitbench.weights import Weights, nested  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.models import (ModelConfig, decode_step, forward,  # noqa: E402
                                get_config, init_params, prefill)
from repro_torch.models.layers import attention_layer, moe  # noqa: E402
from repro_torch.models.model import _nested  # noqa: E402
from repro_torch.serve.engine import ServeEngine, left_align  # noqa: E402

CONFIG = json.loads((ROOT / "mgitbench" / "configs"
                     / "granite-4.0-h-small-bf16-ep2.json").read_text())
# two periods, 6 of 12 experts held, every width cut; the rest is Granite's
SMALL = dict(n_layers=20, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=32, shared_d_ff=64, n_experts=12, n_local_experts=6,
             experts_per_token=4, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
             vocab_size=256, dtype="float32")
TOL = 1e-5
FIELDS = {f.name for f in dataclasses.fields(ModelConfig)}


def small_model(**overrides):
    """(model dict, port config, flat f32 weights drawn from a seed)."""
    m = {**CONFIG["model"], **SMALL, **overrides}
    config = {"model": m, "derivative": CONFIG["derivative"]}
    params = Weights(config, 2**31 + 5, "cpu").base()
    return m, ModelConfig(**{k: v for k, v in m.items() if k in FIELDS}), \
        params


def tokens(shape, seed=0, vocab=256):
    return torch.randint(1, vocab, shape,
                         generator=torch.Generator().manual_seed(seed))


def close(port, ref):
    gap = float((port - ref).abs().max())
    assert gap <= TOL * float(ref.abs().max()), gap


def test_the_registered_arch_is_the_published_one():
    cfg = get_config("granite-4.0-h-small")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.attn_period,
            cfg.attn_offset, cfg.moe_period) == ("hybrid", 40, 4096, 10, 5, 1)
    assert [cfg.is_attention_layer(i) for i in range(40)] == [
        t == "attention" for t in CONFIG["layer_types"]]
    assert (cfg.n_experts, cfg.held_experts, cfg.experts_per_token,
            cfg.d_ff, cfg.shared_d_ff) == (72, 72, 10, 768, 1536)
    small = cfg.reduced()
    assert (small.attn_period, small.attn_offset, small.moe_period,
            small.n_layers) == (10, 5, 1, 10)
    assert all(small.is_moe_layer(i) for i in range(small.n_layers))


def test_forward_matches_the_reference():
    m, cfg, params = small_model()
    tok = tokens((2, 30))
    with torch.no_grad():
        port = forward(cfg, nested(params), {"tokens": tok})
        ref = Model(m, params).logits(tok, 0)
    close(port * cfg.logits_scaling, ref)


def test_engine_prefill_and_decode_on_a_ragged_batch_match_the_reference():
    m, cfg, params = small_model()
    B, W, n = 3, 24, 5
    tok = tokens((B, W), seed=1)
    lengths = torch.tensor([24, 17, 9])
    engine = ServeEngine(cfg, nested(params), max_len=W + n, device="cpu")
    served = engine.generate({"tokens": tok, "lengths": lengths}, n)
    rows = left_align(tok, lengths)
    full = torch.cat([rows, served[:, :-1].long()], 1)
    with torch.no_grad():
        ref = Model(m, params).logits(full, W - 1)         # (B, n, V)
        assert float(served_gaps(ref, served).max()) <= TOL * float(
            ref.abs().max())
        logits, cache = prefill(cfg, nested(params), {"tokens": rows},
                                max_len=W + n)
        port = [logits]
        for i in range(n - 1):
            logits, cache = decode_step(cfg, nested(params),
                                        served[:, i:i + 1], cache, W + i)
            port.append(logits)
    close(torch.stack(port, 1) * cfg.logits_scaling, ref)


@pytest.mark.parametrize("cached", [False, True])
def test_attention_has_no_positions_and_the_configured_scale(cached):
    """The attention sublayer alone, without a cache (the port's training
    attention) and with one (a prefill: flash attention's plain version
    with the scale passed), against the reference's."""
    m, cfg, params = small_model()
    B, S = 2, 30
    h = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    p = {k.rsplit("/", 1)[-1]: v[0] for k, v in params.items()
         if k.startswith("groups/attn/")}
    shape = (B, S, cfg.n_kv_heads, cfg.head_dim)
    cache = ({"k": torch.zeros(shape), "v": torch.zeros(shape)} if cached
             else None)
    with torch.no_grad():
        got = attention_layer(h, p, cfg, positions=torch.arange(S),
                              cache=cache)
        want = granite_hybrid.attention(Model(m, params), h, 0)
    close(got, want)


def moe_params(m, params, j=0):
    """The weights of MoE sublayer ``j`` of group 0."""
    return {k.rsplit("/", 1)[-1]: v[0, j] for k, v in params.items()
            if k.startswith("groups/moe/")}


def test_two_halves_of_the_experts_add_up_to_the_uncut_layer():
    m, cfg, params = small_model(n_local_experts=0)
    p = moe_params(m, params, j=3)
    E, half = cfg.n_experts, cfg.n_experts // 2
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    cut = dataclasses.replace(cfg, n_local_experts=half)
    experts = ("w_gate", "w_in", "w_out")
    first = {**p, **{k: p[k][:half] for k in experts}}
    # the other chip's experts half .. E - 1, held from 0 up: the router's
    # columns rotated so each keeps its logit, its shared expert not added
    second = {**p, **{k: p[k][half:] for k in experts},
              "router": torch.roll(p["router"], -half, dims=1),
              "shared_w_out": torch.zeros_like(p["shared_w_out"])}
    with torch.no_grad():
        whole = moe(x, p, cfg)
        parts = moe(x, first, cut) + moe(x, second, cut)
        shared = moe(x, {**p, "w_out": torch.zeros_like(p["w_out"])}, cfg)
    assert E == 12
    gap = float((parts - whole).abs().max())
    assert gap <= 1e-6 * float(whole.abs().max()), gap
    # each half adds something beyond the shared expert
    assert float((moe(x, first, cut) - shared).abs().max()) > 1e-3 * float(
        whole.abs().max())


def routed_by_hand(x, p, cfg):
    """Every choice of every token computed, one token at a time."""
    xt = x.reshape(-1, x.shape[-1])
    logits = xt @ p["router"]
    top, sel = torch.topk(logits, cfg.experts_per_token, dim=-1)
    weights = torch.softmax(top, -1)
    out = []
    for t in range(xt.shape[0]):
        y = 0
        for k in range(cfg.experts_per_token):
            e = int(sel[t, k])
            if e < cfg.held_experts:
                h = torch.nn.functional.silu(xt[t] @ p["w_gate"][e]) * (
                    xt[t] @ p["w_in"][e])
                y = y + weights[t, k] * (h @ p["w_out"][e])
        h = torch.nn.functional.silu(xt[t] @ p["shared_w_gate"]) * (
            xt[t] @ p["shared_w_in"])
        out.append(y + h @ p["shared_w_out"])
    return torch.stack(out).reshape(x.shape)


@pytest.mark.parametrize("held", [0, 6])
def test_dropless_computes_every_choice_where_capacity_drops(held):
    m, cfg, params = small_model(n_local_experts=held)
    p = moe_params(m, params)
    # every token ranks the experts alike: experts 0 .. K - 1 get every
    # token, far past the capacity path's 1.25 T K / E slots
    x = torch.rand((2, 12, cfg.d_model),
                   generator=torch.Generator().manual_seed(3)) + 0.1
    p["router"] = torch.linspace(1.0, 0.1, cfg.n_experts).expand(
        cfg.d_model, cfg.n_experts).contiguous()
    with torch.no_grad():
        got = moe(x, p, cfg)
        want = routed_by_hand(x, p, cfg)
    gap = float((got - want).abs().max())
    assert gap <= 1e-5 * float(want.abs().max()), gap
    if held == 0:
        dropping = dataclasses.replace(cfg, dropless=False)
        with torch.no_grad():
            lost = float((moe(x, p, dropping) - want).abs().max())
        assert lost > 1e-2 * float(want.abs().max())


def test_traced_counts_of_the_dropless_moe():
    m, cfg, params = small_model()
    p = moe_params(m, params)
    x = torch.randn((2, 10, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    logits = x.reshape(20, -1) @ p["router"]
    local = int((torch.topk(logits, cfg.experts_per_token).indices
                 < cfg.held_experts).sum())
    obs.reset_trace()
    with obs.tracing():
        with torch.no_grad():
            moe(x, p, cfg)
    doc = obs.export_chrome_trace()
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    obs.reset_trace()
    want = {"moe.choices": 20 * cfg.experts_per_token,
            "moe.local_rows": local}
    # the local rows are added as a tensor and read as a number
    assert obs.counts() == want == doc["metadata"]["counts"]
    assert all(type(n) is int for n in obs.counts().values())
    assert {"moe.route", "moe.experts"} <= names
    assert 0 < local < 20 * cfg.experts_per_token


# SHA-256 of the logits' bytes, computed before the Granite fields existed
UNCHANGED = {
    "mamba2-780m":
        "7b91abc5368a2e26aeb00bf44be8f07a8c14357bb02fae1dab9de140115062bd",
    "mixtral-8x7b":
        "62ce8d0f21251feadcbe7925b53398762a5d43bf1515d04d6e33fe139d92d6c0",
}


@pytest.mark.parametrize("name", sorted(UNCHANGED))
def test_reduced_forward_is_unchanged_bit_for_bit(name):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_config(name).reduced(remat="none")
        params = _nested(init_params(cfg, torch.Generator().manual_seed(0)))
        tok = torch.randint(0, cfg.vocab_size, (2, 40),
                            generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            logits = forward(cfg, params, {"tokens": tok})
    finally:
        torch.set_num_threads(threads)
    assert hashlib.sha256(logits.numpy().tobytes()).hexdigest() == \
        UNCHANGED[name]


def test_dropless_experts_are_swiglus():
    m, cfg, params = small_model()
    p = moe_params(m, params)
    x = torch.randn((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="SwiGLU"):
        moe(x, p, dataclasses.replace(cfg, mlp_type="gelu"))
