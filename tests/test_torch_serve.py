"""The port's serving slice against the reference package, on the CPU.

* Model: ``prefill`` and ``decode_step`` on qwen3-0.6b ``.reduced()`` and
  paper-bert-small cut to 2 layers, with a linear cache and with
  ``window=8`` (a ring buffer that the 12-token prompt overflows): last-
  token logits and the cache's K/V within 2e-5 of the reference (matrix
  products sum in another order, so the bits differ).
* Engine: the reference's engine tests, each also requiring the port's
  tokens to equal the reference ``ServeEngine``'s on the same weights; an
  audio model's frames and a vlm's patches reach prefill, and a vlm
  decodes after its visual prefix (the reference's engine does not:
  pinned).
* Pool: a lineage committed by the reference store; the port's pool views
  equal the reference pool's bit for bit with the same counters, on the
  host (``backend="ref"``) and on its device path with the device mapped
  to the CPU, where multi-hop segments go through ``chain_apply``.
* Router, watcher and HTTP: the reference's tests on a lineage written by
  the port, and the port's HTTP responses against the reference
  ``ServeApp``'s on the same repository.

Weights and inputs are made with numpy from seeds and handed to both.
"""

import dataclasses
import functools
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_chain_model, perturb
from repro.models import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.models.model import cache_shapes as ref_cache_shapes
from repro.models.model import decode_step as ref_decode_step
from repro.models.model import forward as ref_forward
from repro.models.model import prefill as ref_prefill
from repro.remote.transport import lineage_etag as ref_lineage_etag
from repro.serve import LineageWatcher as RefWatcher
from repro.serve import LocalLineageSource as RefSource
from repro.serve import ModelPool as RefPool
from repro.serve import Router as RefRouter
from repro.serve import ServeApp as RefApp
from repro.serve import ServeEngine as RefEngine
from repro.serve import batch_lengths as ref_batch_lengths
from repro.serve import left_align as ref_left_align
from repro.serve import parse_endpoint_spec as ref_parse
from repro.serve import resolve_branch_head as ref_resolve
from repro.serve import start_in_thread as ref_start
from repro.store import ArtifactStore as RefStore
from repro.store.checkpoint import flatten_state

import repro_torch.convert as convert
import repro_torch.models.layers as layers
from repro_torch.core import LayerGraph, LineageGraph, ModelArtifact
from repro_torch.kernels import ops
from repro_torch.models import (ModelConfig, cache_shapes, decode_step,
                                flat_paths, forward, get_config, prefill)
from repro_torch.serve import (BitIdentityError, EndpointUnavailable,
                               HubLineageSource, LineageWatcher,
                               LocalLineageSource, ModelPool, Router,
                               ServeApp, ServeEngine, batch_lengths,
                               left_align, parse_endpoint_spec,
                               resolve_branch_head, start_in_thread)
from repro_torch.serve.watch import lineage_etag
from repro_torch.store import ArtifactStore

TOL = 2e-5
PROMPT, MAX_LEN = 12, 16


# ---------------------------------------------------------------------------
# model: prefill + decode against the reference
# ---------------------------------------------------------------------------

def _cfgs(name, **overrides):
    cut = dict(remat="none", **overrides)
    if name == "paper-bert-small":
        cut["n_layers"] = 2
    return (dataclasses.replace(ref_get_config(name).reduced(), **cut),
            dataclasses.replace(get_config(name).reduced(), **cut))


@functools.lru_cache(maxsize=None)
def _model(name, window=0):
    """(reference cfg, port cfg, reference params, port params): the
    reference's init_params carried across with convert.to_params."""
    ref_cfg, cfg = _cfgs(name, window=window)
    ref_params = ref_init_params(ref_cfg, 0)
    return ref_cfg, cfg, ref_params, convert.to_params(
        flatten_state(ref_params))


def _close(ref, port, what):
    np.testing.assert_allclose(np.asarray(ref), port.numpy(), atol=TOL,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("name", ["qwen3-0.6b", "paper-bert-small"])
def test_prefill_and_decode_match_reference(name, window):
    ref_cfg, cfg, ref_params, params = _model(name, window)
    # the reference's fields alike, the port's own (granite's) at defaults
    assert cfg == ModelConfig(**dataclasses.asdict(ref_cfg))
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    ref_logits, ref_cache = ref_prefill(ref_cfg, ref_params,
                                        {"tokens": jnp.asarray(tokens)},
                                        max_len=MAX_LEN)
    logits, cache = prefill(cfg, params, {"tokens": torch.from_numpy(tokens)},
                            max_len=MAX_LEN)
    _close(ref_logits, logits, "prefill logits")
    for kv in ("k", "v"):
        assert tuple(cache[kv].shape) == ref_cache[kv].shape
        _close(ref_cache[kv], cache[kv], f"prefill cache {kv}")
    token = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)[:, None]
    for pos in range(PROMPT, MAX_LEN):     # a ring of 8 wraps here
        ref_logits, ref_cache = ref_decode_step(
            ref_cfg, ref_params, jnp.asarray(token), ref_cache,
            jnp.asarray(pos, jnp.int32))
        logits, cache = decode_step(cfg, params, torch.from_numpy(token),
                                    cache, pos)
        _close(ref_logits, logits, f"decode logits at {pos}")
        for kv in ("k", "v"):
            _close(ref_cache[kv], cache[kv], f"decode cache {kv} at {pos}")
        token = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)[:, None]


def test_prefill_attention_goes_through_flash_wrapper(monkeypatch):
    """Every layer's prefill attention calls the flash wrapper (its plain
    version here); decode steps do not."""
    ref_cfg, cfg, _, params = _model("qwen3-0.6b")
    calls = []

    def counted(*args, **kwargs):
        calls.append(kwargs)
        return flash(*args, **kwargs)
    flash = layers.flash_attention
    monkeypatch.setattr(layers, "flash_attention", counted)
    tokens = torch.zeros((1, 5), dtype=torch.int32)
    _, cache = prefill(cfg, params, {"tokens": tokens}, max_len=8)
    assert len(calls) == cfg.n_layers
    assert all(c == dict(causal=True, window=cfg.window, prefix_len=0)
               for c in calls)
    decode_step(cfg, params, tokens[:, :1], cache, 5)
    assert len(calls) == cfg.n_layers


def test_cache_write_past_linear_end_clamps_in_reference_and_raises_here():
    """Reference behaviour: ``dynamic_update_slice`` clamps a write past the
    end of a linear cache so that it ends at the last slot. The port writes
    its cache in place and raises instead."""
    ref_cfg, cfg, ref_params, params = _model("paper-bert-small")
    tokens = np.arange(1, 1 + MAX_LEN, dtype=np.int32)[None]
    _, ref_cache = ref_prefill(ref_cfg, ref_params,
                               {"tokens": jnp.asarray(tokens)},
                               max_len=MAX_LEN)
    full = np.asarray(ref_cache["k"]).copy()
    _, ref_cache = ref_decode_step(ref_cfg, ref_params,
                                   jnp.asarray(tokens[:, :1]), ref_cache,
                                   jnp.asarray(MAX_LEN, jnp.int32))
    after = np.asarray(ref_cache["k"])
    assert not np.array_equal(after[:, :, -1], full[:, :, -1])  # clamped
    np.testing.assert_array_equal(after[:, :, :-1], full[:, :, :-1])
    _, cache = prefill(cfg, params, {"tokens": torch.from_numpy(tokens)},
                       max_len=MAX_LEN)
    with pytest.raises(ValueError, match="past the cache"):
        decode_step(cfg, params, torch.from_numpy(tokens[:, :1]), cache,
                    MAX_LEN)


@pytest.mark.parametrize("window", [0, 8, 64])
def test_cache_shapes_match_reference(window):
    for name in ("qwen3-0.6b", "paper-bert-small"):
        ref_cfg, cfg = _cfgs(name, window=window)
        ref = ref_cache_shapes(ref_cfg, 3, 20)
        ours = cache_shapes(cfg, 3, 20)
        assert {k: s for k, (s, _) in ours.items()} == {
            k: s for k, (s, _) in ref.items()}
        assert all(d == torch.float32 for _, d in ours.values())
    # every family has a cache now (tests/test_torch_families.py holds
    # each one's against the reference); an SSM's holds state, not K/V
    ref_cfg, cfg = _cfgs("mamba2-780m", window=window)
    assert {k: s for k, (s, _) in cache_shapes(cfg, 3, 20).items()} == {
        k: s for k, (s, _) in ref_cache_shapes(ref_cfg, 3, 20).items()}
    with pytest.raises(ValueError, match="unknown family"):
        cache_shapes(dataclasses.replace(cfg, family="rnn"), 1, 4)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "paper-bert-small"])
def test_to_params_round_trips_reference_init_params(name):
    _, _, ref_params, params = _model(name)
    flat = flatten_state(ref_params)
    back = flat_paths(params)
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        got = convert.to_numpy(back[key])
        assert got.dtype == value.dtype and got.shape == value.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      value.view(np.uint8))


# ---------------------------------------------------------------------------
# engine: the reference's engine tests, tokens equal to the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    ref_cfg, cfg, ref_params, params = _model("qwen3-0.6b")
    return (RefEngine(ref_cfg, ref_params, max_len=16),
            ServeEngine(cfg, params, max_len=16, device="cpu"))


def _toks(rows):
    return np.array(rows, np.int32)


def _generate(engines, batch, n):
    """Both engines' tokens, which must be equal; returns the port's."""
    ref_engine, engine = engines
    ref_out = ref_engine.generate(
        {k: jnp.asarray(v) for k, v in batch.items()}, n)
    out = engine.generate({k: torch.from_numpy(np.asarray(v))
                           for k, v in batch.items()}, n)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    return out.numpy()


@pytest.mark.parametrize("rows, lengths, pad_id, want", [
    ([[1, 2, 3, 4], [5, 6, 7, 8]], [4, 2], 0, [[1, 2, 3, 4], [0, 0, 5, 6]]),
    ([[9, 9, 0]], [1], 7, [[7, 7, 9]]),
])
def test_left_align_matches_reference(rows, lengths, pad_id, want):
    got = left_align(torch.from_numpy(_toks(rows)),
                     torch.tensor(lengths, dtype=torch.int32), pad_id=pad_id)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_left_align(
            jnp.asarray(_toks(rows)), jnp.asarray(lengths, jnp.int32),
            pad_id=pad_id)))


def test_batch_lengths_sources_and_clamp():
    tokens = _toks([[1, 2, 3], [4, 5, 6]])
    assert batch_lengths({"tokens": torch.from_numpy(tokens)}) is None
    for extra, want in (({"mask": [[1, 1, 1], [1, 0, 0]]}, [3, 1]),
                        ({"mask": np.ones((2, 3)), "lengths": [2, 0]},
                         [2, 1])):
        got = batch_lengths({"tokens": torch.from_numpy(tokens),
                             **{k: torch.tensor(np.asarray(v))
                                for k, v in extra.items()}})
        ref = ref_batch_lengths({"tokens": jnp.asarray(tokens),
                                 **{k: jnp.asarray(v)
                                    for k, v in extra.items()}})
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_generate_zero_and_one_tokens(engines):
    batch = {"tokens": _toks([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]])}
    out0 = _generate(engines, batch, 0)
    assert out0.shape == (2, 0)
    out1 = _generate(engines, batch, 1)   # exactly one prefill, no decode
    assert out1.shape == (2, 1)
    out3 = _generate(engines, batch, 3)
    assert out3.shape == (2, 3)
    np.testing.assert_array_equal(out3[:, :1], out1)


def test_full_width_row_matches_unpadded_run(engines):
    row = [3, 1, 4, 1, 5, 9]
    got = _generate(engines, {"tokens": _toks([row, [2, 7, 0, 0, 0, 0]]),
                              "lengths": np.array([6, 2], np.int32)}, 4)
    solo = _generate(engines, {"tokens": _toks([row])}, 4)
    np.testing.assert_array_equal(got[0], solo[0])


def test_ragged_batch_matches_single_row_runs(engines):
    rows = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 0, 0, 0], [8, 0, 0, 0, 0, 0]]
    lens = [6, 3, 1]
    got = _generate(engines, {"tokens": _toks(rows),
                              "lengths": np.array(lens, np.int32)}, 4)
    for i, (row, n) in enumerate(zip(rows, lens)):
        solo = _generate(engines, {"tokens": _toks([row]),
                                   "lengths": np.array([n], np.int32)}, 4)
        np.testing.assert_array_equal(got[i], solo[0], err_msg=f"row {i}")


def test_mask_and_lengths_agree(engines):
    rows = [[5, 6, 7, 8], [1, 2, 0, 0]]
    a = _generate(engines, {"tokens": _toks(rows),
                            "lengths": np.array([4, 2], np.int32)}, 3)
    b = _generate(engines, {"tokens": _toks(rows),
                            "mask": np.array([[1, 1, 1, 1], [1, 1, 0, 0]])},
                  3)
    np.testing.assert_array_equal(a, b)


def test_engine_passes_frames_to_an_audio_model_as_reference():
    """An encoder-decoder's ``frames`` reach prefill: the port's engine
    gives the reference engine's tokens on the same weights and frames,
    and other frames give other tokens."""
    ref_cfg, cfg, ref_params, params = _model("seamless-m4t-large-v2")
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, PROMPT))
             .astype(np.int32),
             "frames": rng.normal(size=(2, 10, cfg.d_model))
             .astype(np.float32)}
    ref = RefEngine(ref_cfg, ref_params, max_len=MAX_LEN)
    engine = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    out = _generate((ref, engine), batch, 4)
    other = engine.generate({"tokens": torch.from_numpy(batch["tokens"]),
                             "frames": torch.zeros((2, 10, cfg.d_model))}, 4)
    assert not np.array_equal(other.numpy(), out)


def test_vlm_engine_decodes_after_the_prefix_unlike_reference():
    """A vlm's prompt ends at slot n_prefix_tokens + S - 1, so the port's
    engine decodes from n_prefix_tokens + S: each greedy token is the
    argmax of ``forward`` over the patches and the extended text, and one
    decode step's logits equal that forward's within 2e-5.

    Reference behaviour (pinned): its engine decodes from S, where the
    first step overwrites a prompt slot and rotates the token at the wrong
    position, so its logits miss the forward's by far more."""
    ref_cfg, cfg, ref_params, params = _model("paligemma-3b")
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    patches = rng.normal(size=(2, cfg.n_prefix_tokens, cfg.d_model)) \
        .astype(np.float32)
    batch = {"tokens": torch.from_numpy(tokens),
             "patches": torch.from_numpy(patches)}
    engine = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    out = engine.generate(batch, 3)
    for i in (1, 2):
        ext = torch.cat([batch["tokens"], out[:, :i]], dim=1)
        logits = forward(cfg, params, {"tokens": ext, "patches":
                                       batch["patches"]})[:, -1]
        assert torch.equal(torch.argmax(logits, -1).to(torch.int32),
                           out[:, i])

    ref_logits, ref_cache = ref_prefill(
        ref_cfg, ref_params, {"tokens": jnp.asarray(tokens),
                              "patches": jnp.asarray(patches)},
        max_len=MAX_LEN)
    token = np.argmax(np.asarray(ref_logits), -1).astype(np.int32)[:, None]
    want = np.asarray(ref_forward(
        ref_cfg, ref_params,
        {"tokens": jnp.asarray(np.concatenate([tokens, token], 1)),
         "patches": jnp.asarray(patches)}))[:, -1]
    _, cache = prefill(cfg, params, batch, max_len=MAX_LEN)
    ours, _ = decode_step(cfg, params, torch.from_numpy(token), cache,
                          PROMPT + cfg.n_prefix_tokens)
    _close(want, ours, "vlm decode step at prefix + S")
    # the reference engine's position: S (src/repro/serve/engine.py)
    theirs, _ = ref_decode_step(ref_cfg, ref_params, jnp.asarray(token),
                                ref_cache, jnp.asarray(PROMPT, jnp.int32))
    assert np.abs(np.asarray(theirs) - want).max() > 0.1


def test_engine_defaults_to_the_card():
    assert not torch.cuda.is_available()
    _, cfg, _, params = _model("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, max_len=16)


# ---------------------------------------------------------------------------
# pool: bit-equal views and counters against the reference pool
# ---------------------------------------------------------------------------

CHUNK_KW = dict(chunk_threshold=64 * 1024, chunk_min=16 * 1024,
                chunk_avg=32 * 1024, chunk_max=64 * 1024)
COUNTERS = ("views_built", "hits", "misses", "params_aliased",
            "params_applied", "chain_hops", "segments_applied",
            "fused_applies", "params_verified", "bytes_aliased")


def _port_artifact(artifact):
    """A reference ModelArtifact (tests/helpers.py) as the port's."""
    return ModelArtifact(LayerGraph.from_json(artifact.graph.to_json()),
                         dict(artifact.params),
                         model_type=artifact.model_type,
                         metadata=dict(artifact.metadata))


def _reference_lineage(root, **kw):
    """Refs committed by the reference store: two single-layer derivatives
    of a base, a three-hop chain over L1/w (one folded segment) and a
    wider toy model whose large tensor is chunked under ``CHUNK_KW``."""
    store = RefStore(root=root, **kw)
    base = make_chain_model(seed=0, d=160)
    base_ref = store.commit_artifact("base", base)
    refs = [store.commit_artifact(f"d{i}", perturb(base, key, seed=10 + i),
                                  parent_ref=base_ref)
            for i, key in enumerate(("L0/w", "L3/w"))]
    cur, ref = base, base_ref
    for i in range(1, 4):
        cur = perturb(cur, "L1/w", seed=i)
        ref = store.commit_artifact(f"v{i}", cur, parent_ref=ref)
    return refs + [ref]


def _same_views(ref_pool, pool, refs):
    for ref in refs:
        want, got = ref_pool.get(ref), pool.get(ref)
        assert sorted(got.params) == sorted(want.params)
        for key, value in want.params.items():
            mine = np.asarray(got.params[key])
            assert mine.dtype == value.dtype and mine.shape == value.shape
            np.testing.assert_array_equal(mine.view(np.uint8),
                                          np.asarray(value).view(np.uint8),
                                          err_msg=f"{ref}:{key}")
        assert sorted(got.aliased) == sorted(want.aliased)
        assert got.private_bytes == want.private_bytes
    mine, theirs = pool.stats(), ref_pool.stats()
    return ({k: mine[k] for k in COUNTERS}, {k: theirs[k] for k in COUNTERS},
            mine, theirs)


@pytest.mark.parametrize("layout", ["whole", "chunked"])
def test_pool_views_and_counters_match_reference(tmp_path, layout):
    kw = CHUNK_KW if layout == "chunked" else {}
    root = str(tmp_path)
    refs = _reference_lineage(root, **kw)
    ref_pool = RefPool(RefStore(root=root, **kw))
    pool = ModelPool(ArtifactStore(root=root, backend="ref", **kw),
                     backend="ref")
    mine, theirs, stats, ref_stats = _same_views(ref_pool, pool, refs)
    assert mine == theirs
    assert stats["base_ref"] == ref_stats["base_ref"]
    assert stats["base_bytes"] == ref_stats["base_bytes"]
    if layout == "whole":   # the 3-hop chain folds into one segment
        assert mine["chain_hops"] >= 3 and mine["segments_applied"] >= 1
    else:                   # its tensor is chunked: the store's executor
        assert mine["chain_hops"] == 0 and mine["params_verified"] >= 3


def test_pool_device_path_folds_segments_through_chain_apply(tmp_path,
                                                             monkeypatch):
    """The card's routing with its device mapped to the CPU: the three-hop
    segment goes through ``ops.chain_apply`` (the kernel wrapper's plain
    version here), bit-identical to the reference pool's host fold."""
    monkeypatch.setitem(ops._DEVICES, "cuda", "cpu")
    calls = []
    wrapper = ops.chain_apply_flat

    def counted(*args, **kwargs):
        calls.append(args[1].shape)
        return wrapper(*args, **kwargs)
    monkeypatch.setattr(ops, "chain_apply_flat", counted)
    root = str(tmp_path)
    refs = _reference_lineage(root)
    ref_pool = RefPool(RefStore(root=root))
    pool = ModelPool(ArtifactStore(root=root, backend="cuda"),
                     backend="cuda")
    mine, theirs, _, _ = _same_views(ref_pool, pool, refs)
    assert mine["fused_applies"] > 0 and theirs["fused_applies"] == 0
    assert len(calls) == mine["fused_applies"]
    assert all(shape[0] == 3 for shape in calls)     # the 3-hop segment
    assert {k: v for k, v in mine.items() if k != "fused_applies"} == {
        k: v for k, v in theirs.items() if k != "fused_applies"}


def test_pool_defaults_to_the_card(tmp_path):
    store = ArtifactStore(root=str(tmp_path), backend="ref")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelPool(store)


def _port_seed(tmp_path, keys=("L0/w", "L3/w")):
    store = ArtifactStore(root=str(tmp_path), backend="ref")
    base = make_chain_model(seed=0)
    base_ref = store.commit_artifact("base", _port_artifact(base))
    refs = [store.commit_artifact(
        f"d{i}", _port_artifact(perturb(base, key, seed=10 + i)),
        parent_ref=base_ref) for i, key in enumerate(keys)]
    return store, refs


def test_pool_verify_catches_divergence(tmp_path, monkeypatch):
    store, (r0, _) = _port_seed(tmp_path)
    pool = ModelPool(store, backend="ref")
    pool.ensure_base(r0)
    bad = lambda *a, **k: np.zeros((1,), np.float32)  # noqa: E731
    monkeypatch.setattr(pool, "_apply_chain", bad)
    monkeypatch.setattr(store, "materialize_param", bad)
    with pytest.raises(BitIdentityError):
        pool.get(r0)


def test_pool_one_family_guard(tmp_path):
    store = ArtifactStore(root=str(tmp_path), backend="ref")
    ra = store.commit_artifact("a", _port_artifact(make_chain_model(seed=0)))
    rb = store.commit_artifact("b", _port_artifact(make_chain_model(seed=7)))
    pool = ModelPool(store, backend="ref")
    pool.get(ra)
    with pytest.raises(ValueError, match="one pool per model family"):
        pool.get(rb)


def test_pool_lru_eviction_and_hits(tmp_path):
    store, refs = _port_seed(tmp_path, keys=("L0/w", "L2/w", "L3/w"))
    pool = ModelPool(store, max_resident=2, backend="ref")
    pool.get(refs[0])
    pool.get(refs[0])
    assert pool.stats()["hits"] == 1
    pool.get(refs[1])
    pool.get(refs[2])
    assert len(pool.resident_refs) == 2
    assert refs[0] not in pool.resident_refs
    assert pool.stats()["evictions"] == 1
    view = pool.get(refs[0])
    truth = store.materialize_artifact(refs[0])
    np.testing.assert_array_equal(np.asarray(view.params["L0/w"]),
                                  np.asarray(truth.params["L0/w"]))


def test_pool_budget_evicts_private_bytes(tmp_path):
    store, refs = _port_seed(tmp_path)
    pool = ModelPool(store, budget_bytes=1, backend="ref")
    pool.get(refs[0])
    pool.get(refs[1])
    assert pool.resident_refs == [refs[1]]  # never evicts below one view
    assert pool.stats()["evictions"] == 1


# ---------------------------------------------------------------------------
# router, watcher, HTTP
# ---------------------------------------------------------------------------

@pytest.fixture
def repo(tmp_path):
    """base@v1 with two branch derivatives, written by the port."""
    store = ArtifactStore(root=str(tmp_path), backend="ref")
    g = LineageGraph(path=str(tmp_path), store=store)
    base = make_chain_model(seed=0)
    g.add_node(_port_artifact(base), "base@v1")
    for name, key, seed in (("main", "L0/w", 11), ("ab-test", "L3/w", 12)):
        g.add_edge("base@v1", name)
        g.add_node(_port_artifact(perturb(base, key, seed=seed)), name)
    return str(tmp_path), store, g, base


def _pool(store):
    return ModelPool(store, backend="ref")


def _join(g, x, y):
    """A join node of x and y (two provenance parents), as a merge would
    write it: what promotes a model into a branch. Its params average the
    two parents'."""
    name = f"merge({x},{y})"
    px, py = g.get_model(x).params, g.get_model(y).params
    joined = {k: ((np.asarray(px[k]) + np.asarray(py[k])) / 2)
              .astype(np.float32) for k in px}
    g.add_edge(x, name)
    g.add_edge(y, name)
    g.add_node(g.get_model(x).replace_params(joined), name)
    return name


@pytest.mark.parametrize("spec", ["prod=branch:main", "prod=main",
                                  "pin=node:x@v2", "raw=ref:m_abc",
                                  "noeq", "a=", "=branch:x", "a=weird:x"])
def test_parse_endpoint_spec_matches_reference(spec):
    try:
        want = ref_parse(spec)
    except ValueError:
        with pytest.raises(ValueError):
            parse_endpoint_spec(spec)
        return
    assert parse_endpoint_spec(spec) == want


def _n(name, children=(), parents=(), vc=(), vp=()):
    return {"name": name, "children": list(children),
            "parents": list(parents), "version_children": list(vc),
            "version_parents": list(vp)}


@pytest.mark.parametrize("docs, root", [
    ([_n("m", vc=["m@v2"]), _n("m@v2", vp=["m"], vc=["m@v3"]),
      _n("m@v3", vp=["m@v2"])], "m"),
    ([_n("m", children=["ft"]), _n("ft", parents=["m"])], "m"),
    ([_n("m", children=["ft", "merge(m,o)"]), _n("o", children=["merge(m,o)"]),
      _n("ft", parents=["m"]), _n("merge(m,o)", parents=["m", "o"])], "o"),
    ([_n("a", vc=["b"]), _n("b", vc=["a"])], "a"),
])
def test_branch_heads_match_reference(docs, root):
    nodes = {d["name"]: d for d in docs}
    assert resolve_branch_head(nodes, root) == ref_resolve(nodes, root)
    with pytest.raises(KeyError):
        resolve_branch_head(nodes, "missing")


def test_router_branch_endpoints_and_join_promotion(repo):
    _, store, g, base = repo
    router = Router(_pool(store), ["prod=branch:main",
                                   "canary=branch:ab-test"])
    with pytest.raises(ValueError, match="duplicate"):
        Router(_pool(store), ["p=branch:main", "p=branch:ab-test"])
    report = router.refresh(g.to_payload())
    assert report["prod"]["status"] == "swapped"
    assert report["canary"]["status"] == "swapped"
    a, b = router.predict("prod"), router.predict("canary")
    assert a["ref"] != b["ref"] and a["y"] != b["y"]
    # deriving an experiment FROM main must not advance prod
    g.add_edge("main", "experiment")
    g.add_node(_port_artifact(perturb(base, "L2/w", seed=5)), "experiment")
    assert router.refresh(g.to_payload())["prod"]["status"] == "unchanged"
    # promote = a join: both branch heads land on it
    join = _join(g, "main", "ab-test")
    r3 = router.refresh(g.to_payload())
    assert r3["prod"]["status"] == "swapped"
    assert r3["prod"]["node"] == r3["canary"]["node"] == join
    assert router.predict("prod")["ref"] == router.predict("canary")["ref"]


def test_quarantine_gates_traffic(repo):
    _, store, g, base = repo
    pool = _pool(store)
    router = Router(pool, ["prod=branch:main"])
    router.refresh(g.to_payload())
    good = router.predict("prod")
    g.nodes["main"].metadata["quarantined"] = True
    g.save()
    assert router.refresh(g.to_payload())["prod"]["status"] == "gate_blocked"
    assert router.endpoints["prod"].stats()["gate"]
    assert router.predict("prod")["ref"] == good["ref"]  # last healthy view
    r2 = Router(pool, ["p2=branch:main"])
    assert r2.refresh(g.to_payload())["p2"]["status"] == "gate_blocked"
    with pytest.raises(EndpointUnavailable, match="quarantined"):
        r2.predict("p2")
    g.nodes["main"].metadata["quarantined"] = False
    g.save()
    assert r2.refresh(g.to_payload())["p2"]["status"] == "swapped"
    assert r2.predict("p2")["ref"] == good["ref"]


def test_refresh_failure_isolated_per_endpoint(repo):
    _, store, g, base = repo
    router = Router(_pool(store), ["prod=branch:main", "ghost=branch:nope"])
    report = router.refresh(g.to_payload())
    assert report["prod"]["status"] == "swapped"
    assert report["ghost"]["status"] == "error"
    router.predict("prod")
    with pytest.raises(EndpointUnavailable):
        router.predict("ghost")


def _publish_v2(g, base):
    g.add_node(_port_artifact(perturb(base, "L1/w", seed=77)), "main@v2")
    g.add_version_edge("main", "main@v2")


def test_swap_is_zero_drop_under_lease(repo):
    _, store, g, base = repo
    router = Router(_pool(store), ["prod=branch:main"])
    router.refresh(g.to_payload())
    ep = router.endpoints["prod"]
    with ep.lease() as view:
        before = view.probe()
        _publish_v2(g, base)
        assert router.refresh(g.to_payload())["prod"]["status"] == "swapped"
        assert ep.current_ref != view.ref
        assert ep.stats()["draining"] == 1
        np.testing.assert_array_equal(view.probe(), before)
    assert ep.stats()["draining"] == 0
    assert router.predict("prod")["node"] == "main@v2"


def test_concurrent_predicts_survive_swaps(repo):
    _, store, g, base = repo
    router = Router(_pool(store), ["prod=branch:main"])
    p1 = g.to_payload()
    _publish_v2(g, base)
    p2 = g.to_payload()
    router.refresh(p1)
    errors, stop = [], threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                router.predict("prod")
            except Exception as exc:  # noqa: BLE001 — any drop is a failure
                errors.append(exc)
                return

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for payload in (p2, p1, p2, p1, p2):
        router.refresh(payload)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not errors
    assert router.endpoints["prod"].swaps >= 6


def test_local_watcher_detects_publish(repo):
    root, store, g, base = repo
    router = Router(_pool(store), ["prod=branch:main"])
    watcher = LineageWatcher(LocalLineageSource(root), router,
                             interval_s=0.01)
    r1 = watcher.poll()
    assert r1["changed"] and r1["endpoints"]["prod"]["status"] == "swapped"
    # the same etag as the reference's remote protocol derives
    assert r1["etag"] == ref_lineage_etag(g.to_payload())
    assert r1["etag"] == lineage_etag(g.to_payload())
    assert watcher.poll()["changed"] is False
    _publish_v2(g, base)
    r3 = watcher.poll()
    assert r3["changed"] and r3["endpoints"]["prod"]["node"] == "main@v2"
    assert watcher.stats()["changes"] == 2
    assert lineage_etag(None) == ref_lineage_etag(None) == "absent"
    # the hub source builds its transport without touching the network
    source = HubLineageSource("http://localhost:1")
    assert source.describe() == "hub:http://localhost:1"


def test_serve_shares_the_hub_and_remote_objects():
    """serve keeps no copies: ``_safe_id`` is the hub's, ``GZIP_FLOOR`` the
    HTTP transport's, the etag functions the remote transport's."""
    import repro_torch.hub.routes as hub_routes
    import repro_torch.remote.http as remote_http
    import repro_torch.remote.transport as remote_transport
    import repro_torch.serve.routes as serve_routes
    import repro_torch.serve.watch as serve_watch
    assert serve_routes._safe_id is hub_routes._safe_id
    assert serve_routes.GZIP_FLOOR is remote_http.GZIP_FLOOR
    assert serve_watch.lineage_etag is remote_transport.lineage_etag
    assert serve_watch.ETAG_ABSENT is remote_transport.ETAG_ABSENT
    assert not hasattr(serve_watch, "HUB_ITEM")


def test_hub_watcher_swaps_prod_when_a_push_lands(repo, tmp_path):
    """A ``LineageWatcher`` on ``HubLineageSource`` over a port hub (token
    auth, the pool over the hub's own directory): the first poll resolves
    ``prod`` to the branch head with the hub's etag, an unchanged hub is no
    change, and a push of main@v2 swaps ``prod`` to it on the next poll;
    its view equals a view of the pushing repository's bit for bit. A
    wrong token fails the poll."""
    from repro_torch.hub import HubService
    from repro_torch.hub import start_in_thread as start_hub
    from repro_torch.remote import HttpTransport, RemoteState, push
    root, store, g, base = repo
    service = HubService(str(tmp_path / "hub"), token="tok", backend="ref")
    server, _ = start_hub(service)
    try:
        hub = HttpTransport(server.url, token="tok")
        push(g, hub, state=RemoteState(root, "origin"))
        pool = _pool(ArtifactStore(root=service.root, backend="ref"))
        router = Router(pool, ["prod=branch:main"])
        watcher = LineageWatcher(HubLineageSource(server.url, token="tok"),
                                 router, interval_s=0.01)
        assert watcher.source.describe() == f"hub:{server.url}"
        first = watcher.poll()
        assert first["changed"] and first["endpoints"]["prod"]["node"] == "main"
        assert first["etag"] == lineage_etag(g.to_payload()) \
            == service.default.lineage()[1]
        assert watcher.poll()["changed"] is False
        _publish_v2(g, base)
        push(g, hub, state=RemoteState(root, "origin"))
        swapped = watcher.poll()
        assert swapped["changed"]
        assert swapped["endpoints"]["prod"]["status"] == "swapped"
        assert swapped["endpoints"]["prod"]["node"] == "main@v2"
        ref = g.nodes["main@v2"].artifact_ref
        assert router.endpoints["prod"].current_ref == ref
        with router.endpoints["prod"].lease() as view:
            want = _pool(store).get(ref)
            for k, v in want.params.items():
                np.testing.assert_array_equal(
                    np.asarray(view.params[k]).view(np.uint8),
                    np.asarray(v).view(np.uint8))
            np.testing.assert_array_equal(view.probe(), want.probe())
        assert watcher.stats()["changes"] == 2
        intruder = LineageWatcher(HubLineageSource(server.url, token="nope"),
                                  router)
        with pytest.raises(PermissionError):
            intruder.poll()
    finally:
        server.shutdown()
        server.server_close()


def _call(url, body=None):
    """(status, json) of a GET (``body`` None) or a POST."""
    req = urllib.request.Request(
        url, method="GET" if body is None else "POST",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _stable(doc):
    """A response with its timings and per-process counters removed."""
    if isinstance(doc, dict):
        return {k: _stable(v) for k, v in doc.items()
                if k not in ("last_swap_s", "build_s", "request_latency")}
    if isinstance(doc, list):
        return [_stable(v) for v in doc]
    return doc


def test_http_responses_match_reference(repo):
    """The same repository served by both packages answers every route
    alike, predictions bit for bit."""
    root, store, g, base = repo
    specs = ["prod=branch:main", "canary=branch:ab-test", "gone=branch:nope"]
    apps = []
    for Pool, Store, R, W, S, App, start in (
            (RefPool, RefStore, RefRouter, RefWatcher, RefSource, RefApp,
             ref_start),
            (_pool, lambda root: ArtifactStore(root=root, backend="ref"),
             Router, LineageWatcher, LocalLineageSource, ServeApp,
             start_in_thread)):
        router = R(Pool(Store(root=root)), specs)
        watcher = W(S(root), router, interval_s=30)
        server, _ = start(App(router, router.pool, watcher))
        apps.append(server)
    requests = [("/api/ping", None), ("/api/refresh", {}),
                ("/api/endpoints", None),
                ("/api/predict/prod", {}),
                ("/api/predict/canary", {"x": [[1.0] * 16]}),
                ("/api/predict/gone", {}), ("/api/predict/nope", {}),
                ("/api/predict/..", {}), ("/api/nothing", None)]
    try:
        answers = [[_call(s.url + path, body) for path, body in requests]
                   for s in apps]
        _publish_v2(g, base)
        g.nodes["ab-test"].metadata["quarantined"] = True
        g.save()
        for s, out in zip(apps, answers):
            out += [_call(s.url + path, body) for path, body in (
                ("/api/refresh", {}), ("/api/predict/prod", {}),
                ("/api/predict/canary", {}), ("/api/endpoints", None))]
        stats = [_call(s.url + "/api/stats")[1] for s in apps]
    finally:
        for s in apps:
            s.shutdown()
            s.server_close()
    ref_answers, port_answers = answers
    assert [c for c, _ in port_answers] == [c for c, _ in ref_answers]
    assert [c for c, _ in port_answers] == [
        200, 200, 200, 200, 200, 503, 400, 404, 404, 200, 200, 200, 200]
    for (code, mine), (_, theirs) in zip(port_answers, ref_answers):
        assert _stable(mine) == _stable(theirs)
    assert port_answers[10][1]["node"] == "main@v2"
    for key in ("requests", "predictions", "gate_refusals"):
        assert stats[1][key] == stats[0][key]
    for key in COUNTERS:
        assert stats[1]["pool"][key] == stats[0]["pool"][key]
    assert _stable(stats[1]["router"]) == _stable(stats[0]["router"])
    assert _stable(stats[1]["watch"]) == _stable(stats[0]["watch"])


def test_http_gate_refusal_is_503(repo):
    root, store, g, base = repo
    g.nodes["main"].metadata["quarantined"] = True
    g.save()
    router = Router(_pool(store), ["prod=branch:main"])
    watcher = LineageWatcher(LocalLineageSource(root), router, interval_s=30)
    watcher.poll()
    app = ServeApp(router, router.pool, watcher)
    server, _ = start_in_thread(app)
    try:
        code, body = _call(server.url + "/api/predict/prod", {})
        assert code == 503 and "quarantined" in body["error"]
        assert app.counters["gate_refusals"] == 1
    finally:
        server.shutdown()
        server.server_close()
