"""The engine's decode step replayed as a CUDA graph, on the CPU.

* Eligibility (``serve.engine.graph_eligible``): of the configurations the
  port registers, only the ``ssm`` family's cache holds no K/V, so only it
  replays.
* ``models.model._embed`` fills its float32 scale on the device (a graph
  cannot capture a host-to-device copy): the old expression's bits in f32
  and bf16, and a reduced mamba2's prefill and decode logits and caches
  bit-identical with the old ``_embed``.
* A CPU engine steps eagerly: traced, it counts eager steps and no capture
  or replay, and its tokens equal the reference engine's for an ``ssm``
  model.
* The replay path with ``torch.cuda``'s graph, streams and pool stood in
  for by host fakes, whose replay re-runs the step on the graph's static
  buffers: tokens equal to an eager engine's over requests at two batch
  sizes (each request's prefill cache copied in on its first step), one
  capture per batch size, and a caller that finds the engine's lock held
  steps eagerly.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_config as ref_get_config
from repro.models import init_params as ref_init_params
from repro.serve import ServeEngine as RefEngine
from repro.store.checkpoint import flatten_state

import repro_torch.models.model as model
from repro_torch import obs
from repro_torch.convert import to_params
from repro_torch.kernels.ref import torch_dtype
from repro_torch.models import (decode_step, get_config, init_params,
                                list_archs, prefill)
from repro_torch.serve import ServeEngine, graph_eligible

PROMPT, MAX_LEN, N_TOKENS = 12, 16, 4


def _old_embed(cfg, params, tokens):
    """``_embed`` as it was: the scale copied from the host each call."""
    x = params["embed"]["tok"][tokens]
    x = x * torch.tensor(np.sqrt(cfg.d_model).astype(np.float32),
                         device=x.device)
    return x.to(torch_dtype(cfg.dtype))


def _mamba2(dtype="float32"):
    cfg = dataclasses.replace(get_config("mamba2-780m").reduced(),
                              remat="none", dtype=dtype)
    return cfg, to_params(init_params(cfg, torch.Generator().manual_seed(0)))


def _tokens(cfg, batch, seed=1):
    return torch.randint(0, cfg.vocab_size, (batch, PROMPT),
                         generator=torch.Generator().manual_seed(seed),
                         dtype=torch.int32)


# -- eligibility and the embedding's scale ------------------------------------

@pytest.mark.parametrize("name", list_archs())
def test_only_the_ssm_family_replays(name):
    cfg = get_config(name)
    assert graph_eligible(cfg) == (cfg.family == "ssm")
    assert graph_eligible(cfg.reduced()) == (cfg.family == "ssm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_model", [64, 768, 1536])
def test_embed_scale_is_bit_identical_to_the_copied_scalar(dtype, d_model):
    cfg = dataclasses.replace(get_config("mamba2-780m").reduced(),
                              d_model=d_model, dtype=dtype)
    g = torch.Generator().manual_seed(d_model)
    table = torch.randn((97, d_model), generator=g).to(torch_dtype(dtype))
    params = {"embed": {"tok": table}}
    tokens = torch.randint(0, 97, (3, 5), generator=g, dtype=torch.int32)
    got = model._embed(cfg, params, tokens)
    want = _old_embed(cfg, params, tokens)
    assert got.dtype == want.dtype == torch_dtype(dtype)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_prefill_and_decode_bit_identical_with_the_old_embed(
        dtype, monkeypatch):
    cfg, params = _mamba2(dtype)
    tokens = _tokens(cfg, 2)

    def run():
        with torch.inference_mode():
            logits, cache = prefill(cfg, params, {"tokens": tokens}, MAX_LEN)
            steps = [logits]
            for i in range(3):
                token = torch.argmax(logits, -1).to(torch.int32)[:, None]
                logits, cache = decode_step(cfg, params, token, cache,
                                            PROMPT + i)
                steps.append(logits)
        return steps, cache

    got, got_cache = run()
    monkeypatch.setattr(model, "_embed", _old_embed)
    want, want_cache = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for key in ("state", "conv"):
        assert torch.equal(got_cache[key], want_cache[key])


# -- the engine on the CPU ----------------------------------------------------

def test_cpu_engine_counts_only_eager_steps():
    cfg, params = _mamba2()
    engine = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    assert not engine.replays
    with obs.tracing():
        engine.generate({"tokens": _tokens(cfg, 2)}, N_TOKENS)
        engine.generate({"tokens": _tokens(cfg, 3)}, 1)
    counts = obs.counts()
    assert counts["engine.decode_eager_steps"] == N_TOKENS - 1
    assert "engine.decode_graph_replays" not in counts
    assert "engine.decode_graph_captures" not in counts
    assert engine._graphs == {}


def test_ssm_generate_matches_the_reference_engine():
    ref_cfg = dataclasses.replace(ref_get_config("mamba2-780m").reduced(),
                                  remat="none")
    cfg = dataclasses.replace(get_config("mamba2-780m").reduced(),
                              remat="none")
    ref_params = ref_init_params(ref_cfg, 0)
    engine = ServeEngine(cfg, to_params(flatten_state(ref_params)),
                         max_len=MAX_LEN, device="cpu")
    tokens = _tokens(cfg, 2).numpy()
    lengths = np.array([PROMPT, 7], np.int32)
    want = RefEngine(ref_cfg, ref_params, max_len=MAX_LEN).generate(
        {"tokens": jnp.asarray(tokens), "lengths": jnp.asarray(lengths)},
        N_TOKENS)
    got = engine.generate({"tokens": torch.from_numpy(tokens),
                           "lengths": torch.from_numpy(lengths)}, N_TOKENS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the replay path, with host fakes for torch.cuda ---------------------------

class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def replaying(monkeypatch):
    """(an ``ssm`` engine on the CPU that takes the replay path, an eager
    engine on the same weights, the fake graphs made). A fake capture runs
    the step once on the static buffers (a real one only records it); a
    replay runs it again and writes the static outputs."""
    cfg, params = _mamba2()
    engine = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    eager = ServeEngine(cfg, params, max_len=MAX_LEN, device="cpu")
    made = []

    class Graph:
        def __init__(self):
            self.modes, self.replays = [], 0
            made.append(self)

        def capture_begin(self, pool=None, capture_error_mode="global"):
            self.modes.append(capture_error_mode)

        def capture_end(self):
            pass

        def replay(self):
            self.replays += 1
            g = next(g for g in engine._graphs.values() if g.graph is self)
            token, logits, _ = engine._step(engine.params, g.cache, g.token,
                                            0)
            g.next_token.copy_(token)
            g.logits.copy_(logits)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    engine.replays = True
    return engine, eager, made


def test_replayed_tokens_equal_eager_over_requests_and_batch_sizes(
        replaying):
    engine, eager, made = replaying
    requests = [_tokens(engine.cfg, batch, seed)
                for batch, seed in ((2, 1), (3, 2), (2, 3), (2, 4))]
    requests = [{"tokens": tokens, "lengths": torch.arange(
        PROMPT - len(tokens), PROMPT, dtype=torch.int32)}
        for tokens in requests]
    want = [eager.generate(request, N_TOKENS) for request in requests]
    with obs.tracing():
        for request, tokens in zip(requests, want):
            assert torch.equal(engine.generate(request, N_TOKENS), tokens)
        engine.generate({"tokens": _tokens(engine.cfg, 5)}, 1)
    steps = len(requests) * (N_TOKENS - 1)
    assert sorted(engine._graphs) == [2, 3]
    assert [g.modes for g in made] == [["thread_local"]] * 2
    assert sum(g.replays for g in made) == steps
    counts = obs.counts()
    assert counts["engine.decode_graph_captures"] == 2
    assert counts["engine.decode_graph_replays"] == steps
    assert "engine.decode_eager_steps" not in counts


def test_a_caller_that_finds_the_lock_held_steps_eagerly(replaying):
    engine, eager, made = replaying
    request = {"tokens": _tokens(engine.cfg, 2)}
    want = eager.generate(request, N_TOKENS)
    with engine._lock, obs.tracing():
        assert torch.equal(engine.generate(request, N_TOKENS), want)
    assert obs.counts()["engine.decode_eager_steps"] == N_TOKENS - 1
    assert made == [] and engine._graphs == {}
    engine.generate(request, N_TOKENS)                  # the lock was freed
    assert sorted(engine._graphs) == [2]


def test_a_failed_capture_raises_and_frees_the_lock(replaying, monkeypatch):
    engine, _, _ = replaying

    step, calls = engine._step, []

    def broken(*args):
        calls.append(args)
        if len(calls) == 2:                 # the warm-up passes, the capture
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return step(*args)
    monkeypatch.setattr(engine, "_step", broken)
    with pytest.raises(RuntimeError, match="capturing"):
        engine.generate({"tokens": _tokens(engine.cfg, 2)}, N_TOKENS)
    assert engine._graphs == {} and not engine._lock.locked()
