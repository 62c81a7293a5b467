"""The port's model families against the reference package, on the CPU.

* ``param_shapes`` of all eleven configs at full size (shapes only).
* ``init_params``: every leaf's dtype in a bf16 model (the SSM's
  ``A_log``, ``dt_bias`` and ``D`` stay f32) and the SSM's deterministic
  leaves (``A_log`` within 2 ulp: XLA's ``linspace`` and ``log`` round
  otherwise than torch's; the other two bit for bit); ``convert``
  carries every family's leaves (4-D expert stacks, a hybrid's (groups,
  n, ...) stacks, f32 leaves in a bf16 model) across unchanged.
* moe (mixtral-8x7b, llama4-scout), ssm (mamba2-780m), hybrid (jamba),
  audio (seamless-m4t) and vlm (paligemma-3b) at ``cfg.reduced()``:
  ``forward``, ``prefill`` and three ``decode_step``\\ s within 2e-5 of the
  reference in f32 (matrix products sum in another order, so the bits
  differ), with the caches' contents.
* MoE at capacity factor 1.25 on a decode batch of 8 tokens that drops
  some, and a routing tie, which both packages break towards the lower
  expert index.
* ``ssd_chunked`` against the recurrent decode over the same tokens, and
  an encoder-decoder decoding from its cross cache alone.

Weights come from the reference's ``init_params`` carried across with
``convert.to_params``; inputs are made with numpy from seeds.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.models import list_archs as ref_list_archs
from repro.models.layers import moe as ref_moe
from repro.models.model import cache_shapes as ref_cache_shapes
from repro.models.model import decode_step as ref_decode_step
from repro.models.model import forward as ref_forward
from repro.models.model import param_shapes as ref_param_shapes
from repro.models.model import prefill as ref_prefill
from repro.models.ssm import ssd_chunked as ref_ssd_chunked
from repro.store.checkpoint import flatten_state

import repro_torch.convert as convert
from repro_torch.models import (ModelConfig, cache_shapes, decode_step,
                                flat_paths, forward, get_config, init_params,
                                list_archs, param_shapes, prefill)
from repro_torch.models.layers import moe, top_k
from repro_torch.models.ssm import ssd_chunked, ssm_layer

TOL = 2e-5
B, PROMPT, MAX_LEN, ENC_LEN = 2, 12, 16, 10
FAMILIES = ["mixtral-8x7b", "llama4-scout-17b-16e", "mamba2-780m",
            "jamba-1.5-large-398b", "seamless-m4t-large-v2", "paligemma-3b"]


def _cfgs(name, **overrides):
    cut = dict(remat="none", **overrides)
    return (dataclasses.replace(ref_get_config(name).reduced(), **cut),
            dataclasses.replace(get_config(name).reduced(), **cut))


@functools.lru_cache(maxsize=None)
def _model(name, **overrides):
    """(reference cfg, port cfg, reference params, port params)."""
    ref_cfg, cfg = _cfgs(name, **overrides)
    ref_params = ref_init_params(ref_cfg, 0)
    return ref_cfg, cfg, ref_params, convert.to_params(
        flatten_state(ref_params))


def _batch(cfg, seed=3, batch=B, prompt=PROMPT):
    """A family's inputs as numpy: tokens, and frames or patches."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt))
           .astype(np.int32)}
    if cfg.family in ("encdec", "audio"):
        out["frames"] = rng.normal(size=(batch, ENC_LEN, cfg.d_model)) \
            .astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            size=(batch, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return out


def _close(ref, port, what):
    np.testing.assert_allclose(np.asarray(ref, np.float32),
                               port.to(torch.float32).numpy(), atol=TOL,
                               rtol=0, err_msg=what)


def _close_caches(ref_cache, cache, what):
    ref_flat, flat = flatten_state(ref_cache), flat_paths(cache)
    assert sorted(ref_flat) == sorted(flat)
    for key, value in ref_flat.items():
        assert tuple(flat[key].shape) == value.shape, key
        _close(value, flat[key], f"{what} cache {key}")


# ---------------------------------------------------------------------------
# shapes, init and conversion
# ---------------------------------------------------------------------------

# the one arch only the port has
PORT_ARCHS = ["granite-4.0-h-small"]


def test_all_eleven_configs_are_registered_with_the_reference_fields():
    """Every reference arch is registered with the reference's fields, and
    with the port's own (granite's) fields at their defaults, which change
    nothing; granite-4.0-h-small is the one arch only the port has."""
    assert list_archs() == sorted(ref_list_archs() + PORT_ARCHS)
    assert len(list_archs()) == 13   # eleven, paper-bert-small, granite
    for name in ref_list_archs():
        assert get_config(name) == ModelConfig(
            **dataclasses.asdict(ref_get_config(name)))


@pytest.mark.parametrize("name", sorted(ref_list_archs()))
def test_param_shapes_match_reference_at_full_size(name):
    assert param_shapes(get_config(name)) == ref_param_shapes(
        ref_get_config(name))


@pytest.mark.parametrize("name", FAMILIES)
def test_init_dtypes_and_deterministic_ssm_leaves_match_reference(name):
    ref_cfg, cfg = _cfgs(name, dtype="bfloat16")
    ref = flatten_state(ref_init_params(ref_cfg, 0))
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        got = convert.to_numpy(ours[key])
        assert got.shape == value.shape, key
        assert (str(value.dtype) == "bfloat16") == (
            ours[key].dtype == torch.bfloat16), key
        if key.rsplit("/", 1)[-1] in ("A_log", "dt_bias", "D"):
            assert value.dtype == np.float32 == got.dtype
            if key.endswith("A_log"):
                # log(linspace(1, 16, H)): XLA's linspace and log each
                # round differently from torch's, by at most one ulp
                np.testing.assert_array_max_ulp(got, value, maxulp=2)
            else:
                np.testing.assert_array_equal(got, value, err_msg=key)
        if key.rsplit("/", 1)[-1] in ("ln1", "ln2", "norm", "final_norm"):
            assert not got.view(np.uint8).any(), key


@pytest.mark.parametrize("name", FAMILIES)
def test_convert_carries_every_leaf_of_a_bf16_model(name):
    ref_cfg, _ = _cfgs(name, dtype="bfloat16")
    flat = flatten_state(ref_init_params(ref_cfg, 0))
    params = convert.to_params(flat)
    back = flat_paths(params)
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        got = convert.to_numpy(back[key])
        assert got.shape == value.shape, key
        np.testing.assert_array_equal(got.view(np.uint8),
                                      np.asarray(value).view(np.uint8))
    if ref_cfg.n_experts and ref_cfg.family != "hybrid":
        assert back["layers/moe/w_in"].dim() == 4
    if ref_cfg.family == "hybrid":
        assert back["groups/ssm/in_proj"].dim() == 4
        assert back["groups/moe/w_in"].dim() == 5


# ---------------------------------------------------------------------------
# forward, prefill and decode per family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_forward_prefill_and_decode_match_reference(name):
    ref_cfg, cfg, ref_params, params = _model(name)
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _close(ref_forward(ref_cfg, ref_params, jbatch),
           forward(cfg, params, tbatch), "forward logits")

    ref_logits, ref_cache = ref_prefill(ref_cfg, ref_params, jbatch,
                                        max_len=MAX_LEN)
    logits, cache = prefill(cfg, params, tbatch, max_len=MAX_LEN)
    _close(ref_logits, logits, "prefill logits")
    _close_caches(ref_cache, cache, "prefill")

    # a vlm's text continues after its visual prefix
    pos0 = PROMPT + (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)
    token = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)[:, None]
    for pos in range(pos0, pos0 + 3):
        ref_logits, ref_cache = ref_decode_step(
            ref_cfg, ref_params, jnp.asarray(token), ref_cache,
            jnp.asarray(pos, jnp.int32))
        logits, cache = decode_step(cfg, params, torch.from_numpy(token),
                                    cache, pos)
        _close(ref_logits, logits, f"decode logits at {pos}")
        _close_caches(ref_cache, cache, f"decode at {pos}")
        token = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)[:, None]


@pytest.mark.parametrize("name", FAMILIES)
def test_cache_shapes_match_reference(name):
    ref_cfg, cfg = _cfgs(name, dtype="bfloat16")
    ref = ref_cache_shapes(ref_cfg, 3, 20, enc_len=7)
    ours = cache_shapes(cfg, 3, 20, enc_len=7)
    assert {k: s for k, (s, _) in ours.items()} == {
        k: s for k, (s, _) in ref.items()}
    assert {k: str(d).removeprefix("torch.") for k, (_, d) in ours.items()} \
        == {k: str(np.dtype(d)) for k, (_, d) in ref.items()}


def test_encdec_decodes_from_its_cross_cache_alone():
    """After prefill the encoder never runs again: decode steps read the
    cross K/V cached at prefill (equal to the reference's), and changing
    the frames after prefill cannot reach them."""
    ref_cfg, cfg, ref_params, params = _model("seamless-m4t-large-v2")
    batch = _batch(cfg, seed=5)
    ref_logits, ref_cache = ref_prefill(
        ref_cfg, ref_params, {k: jnp.asarray(v) for k, v in batch.items()},
        max_len=MAX_LEN)
    _, cache = prefill(cfg, params,
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       max_len=MAX_LEN)
    assert tuple(cache["cross"]["k"].shape) == (
        cfg.n_layers, B, ENC_LEN, cfg.n_kv_heads, cfg.resolved_head_dim)
    for kv in ("k", "v"):
        _close(ref_cache["cross"][kv], cache["cross"][kv], f"cross {kv}")
    cross = {kv: cache["cross"][kv].clone() for kv in ("k", "v")}
    token = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)[:, None]
    ref_step, _ = ref_decode_step(ref_cfg, ref_params, jnp.asarray(token),
                                  ref_cache, jnp.asarray(PROMPT, jnp.int32))
    step, cache = decode_step(cfg, params, torch.from_numpy(token), cache,
                              PROMPT)
    _close(ref_step, step, "decode from the cross cache")
    for kv in ("k", "v"):
        assert torch.equal(cache["cross"][kv], cross[kv])


# ---------------------------------------------------------------------------
# MoE routing: capacity drops and ties
# ---------------------------------------------------------------------------

def _moe_case(seed, spread):
    """Reduced mixtral's first MoE layer at capacity factor 1.25 and 8
    tokens near one point (``spread`` apart), so that most of them pick
    the same two experts."""
    ref_cfg, cfg, ref_params, params = _model("mixtral-8x7b",
                                              capacity_factor=1.25)
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(1, 1, cfg.d_model))
    x = (base + spread * rng.normal(size=(8, 1, cfg.d_model))).astype(
        np.float32)
    ref_p = jax.tree_util.tree_map(lambda a: a[0], ref_params["layers"]["moe"])
    p = {k: v[0] for k, v in params["layers"]["moe"].items()}
    return ref_cfg, cfg, ref_p, p, x


def test_moe_drops_over_capacity_as_reference():
    ref_cfg, cfg, ref_p, p, x = _moe_case(7, 0.05)
    logits = x.reshape(8, -1) @ np.asarray(ref_p["router"])
    picks = np.argsort(-logits, axis=-1, kind="stable")[:, :2]
    C = int(1.25 * 8 * 2 / cfg.n_experts)
    assert np.bincount(picks.ravel(), minlength=cfg.n_experts).max() > C
    want = ref_moe(jnp.asarray(x), ref_p, ref_cfg)
    got = moe(torch.from_numpy(x), p, cfg)
    _close(want, got, "moe output with drops")
    # a dropped token's output has lost that expert's share
    full = moe(torch.from_numpy(x), p,
               dataclasses.replace(cfg, capacity_factor=4.0))
    assert not torch.allclose(got, full, atol=1e-3)


def test_moe_decode_batch_of_8_with_drops_matches_reference():
    ref_cfg, cfg, ref_params, params = _model("mixtral-8x7b",
                                              capacity_factor=1.25)
    batch = _batch(cfg, seed=11, batch=8, prompt=6)
    ref_logits, ref_cache = ref_prefill(
        ref_cfg, ref_params, {"tokens": jnp.asarray(batch["tokens"])},
        max_len=MAX_LEN)
    logits, cache = prefill(cfg, params,
                            {"tokens": torch.from_numpy(batch["tokens"])},
                            max_len=MAX_LEN)
    _close(ref_logits, logits, "prefill logits")
    token = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)[:, None]
    for pos in range(6, 9):
        ref_logits, ref_cache = ref_decode_step(
            ref_cfg, ref_params, jnp.asarray(token), ref_cache,
            jnp.asarray(pos, jnp.int32))
        logits, cache = decode_step(cfg, params, torch.from_numpy(token),
                                    cache, pos)
        _close(ref_logits, logits, f"decode logits at {pos}")
        token = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)[:, None]


def test_routing_ties_break_towards_the_lower_expert_as_reference():
    logits = np.array([[0.5, 2.0, 1.0, 2.0], [3.0, 3.0, 3.0, 3.0],
                       [1.0, 0.0, 1.0, 0.0]], np.float32)
    ref_values, ref_idx = jax.lax.top_k(jnp.asarray(logits), 2)
    values, idx = top_k(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(values.numpy(), np.asarray(ref_values))
    assert idx.tolist() == [[1, 3], [0, 1], [0, 2]]

    # experts 1 and 3 share a router column: every token ties them, and
    # the tie decides who keeps the capacity slots
    ref_cfg, cfg, ref_p, p, x = _moe_case(9, 0.05)
    router = np.asarray(ref_p["router"]).copy()
    router[:, 3] = router[:, 1]
    router[:, 1] += 10.0 * x[0, 0] / np.linalg.norm(x[0, 0]) ** 2
    router[:, 3] = router[:, 1]
    ref_p = dict(ref_p, router=jnp.asarray(router))
    p = dict(p, router=torch.from_numpy(router))
    _close(ref_moe(jnp.asarray(x), ref_p, ref_cfg),
           moe(torch.from_numpy(x), p, cfg), "moe output with tied experts")


# ---------------------------------------------------------------------------
# SSM: chunked scan against the recurrence
# ---------------------------------------------------------------------------

def test_ssd_chunked_matches_reference_and_the_recurrent_decode():
    rng = np.random.default_rng(2)
    Bb, S, H, P, N = 2, 24, 3, 4, 5
    xh = rng.normal(size=(Bb, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(Bb, S, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(Bb, S, N)).astype(np.float32)
              for _ in range(2))
    init = rng.normal(size=(Bb, H, N, P)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (xh, dt, A, Bm, Cm, init)]
    for chunk in (8, 7, 64):      # 7 tiles 24 tokens as chunks of 6
        y, state = ssd_chunked(*t[:5], chunk, init_state=t[5])
        ref_y, ref_state = ref_ssd_chunked(
            *(jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)), chunk,
            init_state=jnp.asarray(init))
        _close(ref_y, y, f"y, chunk {chunk}")
        _close(ref_state, state, f"state, chunk {chunk}")
    # the recurrence, token by token
    s = t[5].clone()
    for i in range(S):
        s = (s * torch.exp(t[1][:, i] * t[2])[..., None, None]
             + torch.einsum("bh,bn,bhp->bhnp", t[1][:, i], t[3][:, i],
                            t[0][:, i]))
        y_i = torch.einsum("bn,bhnp->bhp", t[4][:, i], s)
        torch.testing.assert_close(y[:, i], y_i, atol=TOL, rtol=0)
    torch.testing.assert_close(state, s, atol=TOL, rtol=0)


def test_ssm_layer_prefill_equals_token_by_token_decode():
    _, cfg, _, params = _model("mamba2-780m")
    sp = {k: v[0] for k, v in params["layers"]["ssm"].items()}
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 10, cfg.d_model)).astype(np.float32))
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state

    def empty():
        return {"state": torch.zeros((2, cfg.n_ssm_heads, cfg.ssm_state,
                                      cfg.ssm_head_dim)),
                "conv": torch.zeros((2, cfg.ssm_conv_width - 1, conv_dim))}

    y, cache = ssm_layer(x, sp, cfg, cache=empty())
    steps, c = [], empty()
    for i in range(10):
        y_i, c = ssm_layer(x[:, i:i + 1], sp, cfg, cache=c)
        steps.append(y_i)
    torch.testing.assert_close(torch.cat(steps, dim=1), y, atol=TOL, rtol=0)
    for key in ("state", "conv"):
        torch.testing.assert_close(c[key], cache[key], atol=TOL, rtol=0)
