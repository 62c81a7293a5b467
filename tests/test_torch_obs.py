"""The port's tracing (``repro_torch.obs``): scoped counts, the clock the
device trace shares, and the spans and counts inside the store, the
storage entry points and the serving engine."""

import sys
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch.serve.engine as engine_mod
from repro_torch import obs
from repro_torch import core
from repro_torch.common import bf16
from repro_torch.convert import to_params
from repro_torch.kernels import ops
from repro_torch.models import get_config, init_params
from repro_torch.obs import trace
from repro_torch.serve.engine import ServeEngine
from repro_torch.store import ArtifactStore

from helpers import finetune_like
from torch_helpers import make_chain_model


@pytest.fixture(autouse=True)
def _clean_trace():
    """Tracing state is process-global; leave it as we found it (off)."""
    obs.disable()
    obs.reset_trace()
    yield
    assert not obs.is_enabled()
    obs.reset_trace()


def _events(doc):
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"]


# -- counts ------------------------------------------------------------------

def test_off_is_one_branch_and_the_cached_null_span():
    obs.enable()
    obs.count("x", 2)
    obs.disable()
    assert obs.span("a", key=1) is trace._NULL_SPAN
    assert obs.count("x", 5) is None
    assert obs.counts() == {"x": 2}
    here = trace.__file__
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            obs.count("x", 5)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == here and d.size_diff > 0]
    assert grown == []
    assert obs.counts() == {"x": 2}


def test_counts_zero_on_enable_and_survive_the_harness_order():
    """The benchmark's window: reset, enable, work, disable, export, reset;
    its metric readers run after all of that."""
    obs.enable()
    obs.count("stale", 7)
    obs.disable()
    obs.reset_trace()
    obs.enable()
    assert obs.counts() == {}
    obs.count("ops.h2d_bytes", 40)
    obs.count("ops.h2d_bytes", 2)
    obs.count("ops.h2d_copies")
    obs.enable()                     # already on: not a switch, keeps them
    obs.disable()
    doc = obs.export_chrome_trace()
    obs.reset_trace()
    want = {"ops.h2d_bytes": 42, "ops.h2d_copies": 1}
    assert doc["metadata"]["counts"] == want
    assert obs.counts() == want
    obs.count("ops.h2d_bytes", 1)    # off: not counted
    assert obs.counts() == want
    with obs.tracing():
        assert obs.counts() == {}
        obs.count("a")
        with obs.tracing():          # nested, still on: keeps them
            obs.count("a")
    assert obs.counts() == {"a": 2}


def test_counts_from_many_threads_add_up():
    threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with obs.tracing():
            workers = [threading.Thread(
                target=lambda: [obs.count("n", 3) for _ in range(per)])
                for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
            assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert obs.counts() == {"n": 3 * threads * per}


# -- the clock ---------------------------------------------------------------

def test_clock_puts_a_span_on_the_profilers_clock():
    """``metadata.clock`` maps a span to Unix nanoseconds, the clock of
    torch.profiler's events: a span holds a ``record_function`` opened
    inside it, and a ``record_function`` holds a span opened inside it,
    each within 1 ms. Both ways round, a delay on a loaded host only
    widens the outer region, so only a clock off by more than 1 ms (plus
    that delay) fails."""
    obs.reset_trace()
    with obs.tracing():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("warm"):
                pass
            with obs.span("outer span"):
                with record_function("inner function"):
                    time.sleep(0.01)
            with record_function("outer function"):
                with obs.span("inner span"):
                    time.sleep(0.01)
    doc = obs.export_chrome_trace()
    clock = doc["metadata"]["clock"]
    assert clock["read_gap_ns"] >= 0
    spans = {e["name"]: (clock["unix_ns"] + round(e["ts"] * 1000),
                         clock["unix_ns"] + round((e["ts"] + e["dur"]) * 1000))
             for e in _events(doc)}
    functions = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()}
    ms = 1_000_000
    for outer, inner in ((spans["outer span"], functions["inner function"]),
                         (functions["outer function"], spans["inner span"])):
        assert outer[0] - ms <= inner[0] < inner[1] <= outer[1] + ms


# -- the store ---------------------------------------------------------------

def _parents(events):
    by_id = {e["args"]["span_id"]: e for e in events}

    def chain(e):
        out = []
        while e["args"]["parent_id"] is not None:
            e = by_id[e["args"]["parent_id"]]
            out.append(e["name"])
        return out
    return chain


def test_store_spans_nest_where_the_work_happens(tmp_path):
    """A chain base -> d1 -> d2 on a host store: each commit's parent
    read-back and stored-truth dequant, and each checkout's reads, LZMA
    decodes and fold apply, nest under the spans that hold them; nothing
    crosses to a card, so the copy counts stay 0."""
    root = str(tmp_path)
    store = ArtifactStore(root=root, backend="ref")
    base = make_chain_model(core, seed=0, d=32)
    d1 = finetune_like(base, seed=1, scale=1e-3, density=1.0)
    d2 = finetune_like(d1, seed=2, scale=1e-3, density=1.0)
    ref = store.commit_artifact("base", base)
    with obs.tracing():
        ref = store.commit_artifact("d1", d1, ref)
        ref = store.commit_artifact("d2", d2, ref)
        fresh = ArtifactStore(root=root, backend="ref")
        got = fresh.materialize_artifact(ref)
    assert store.get_manifest(ref)["depth"] == 2
    assert set(got.params) == set(d2.params)
    events = _events(obs.export_chrome_trace())
    chain = _parents(events)
    names = [e["name"] for e in events]
    n_leaves = len(base.params)
    assert names.count("commit.parent") == 2
    assert names.count("commit.truth") == 2 * n_leaves
    # three reads a leaf: the base tensor and each of two hops' blobs
    assert names.count("checkout.read") >= 3 * n_leaves
    assert names.count("checkout.decode") >= 2 * n_leaves
    assert names.count("checkout.apply") >= n_leaves
    for e in events:
        if e["name"] == "commit.parent":
            assert chain(e)[0] == "store.commit"
        elif e["name"] == "commit.truth":
            assert chain(e)[:2] == ["commit.delta", "store.commit"]
        elif e["name"].startswith("checkout.") and e["name"] != \
                "checkout.param":
            assert "checkout.param" in chain(e)
    assert not any(k.startswith("ops.") for k in obs.counts())


def test_copies_are_counted_where_a_tensor_crosses():
    """``_to`` counts a copy only while tracing, only where the tensor
    changes device, and its bytes at the dtype it crosses in (the bf16
    carrier as 2 bytes an element); the meta device stands in for the
    card."""
    meta = torch.device("meta")
    a = np.ones((3, 5), np.float32)
    ops._to(a, meta)
    with obs.tracing():
        ops._to(a, meta)
        ops._to(a.astype(np.int8), meta)
        ops._to(bf16.narrow(a), meta)
        ops._to(np.zeros(0, np.float32), meta)
        ops._to(a, torch.device("cpu"))
        ops.to_host(torch.ones(4))
        ops.delta_quantize(a, a * 0.5, backend="ref")
    assert obs.counts() == {"ops.h2d_copies": 3,
                            "ops.h2d_bytes": 60 + 15 + 30}


# -- the engine --------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    cfg = get_config("paper-bert-small").reduced()
    params = to_params(init_params(cfg, torch.Generator().manual_seed(0)))
    return ServeEngine(cfg, params, max_len=32, device="cpu")


@pytest.mark.parametrize("declared", ["lengths", "mask", "none"])
def test_engine_counts_slots_and_prompt_tokens(engine, declared,
                                               monkeypatch):
    """A ragged batch of 3 x 8 counts 24 slots and its clamped lengths as
    prompt tokens (a length of 0 holds one slot, 11 is cut to 8); prefill
    and each decode step are spanned, through the module's ``prefill`` and
    ``decode_step``, which the benchmark times from outside."""
    called = {"prefill": 0, "decode_step": 0}
    for name in called:
        fn = getattr(engine_mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            called[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(engine_mod, name, counted)
    tokens = torch.randint(1, engine.cfg.vocab_size, (3, 8),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens}
    want = 24
    if declared == "lengths":
        batch["lengths"] = torch.tensor([0, 5, 11])
        want = 1 + 5 + 8
    elif declared == "mask":
        batch["mask"] = (torch.arange(8)[None, :]
                         < torch.tensor([[2], [8], [3]])).int()
        want = 2 + 8 + 3
    untraced = engine.generate(batch, 4)
    with obs.tracing():
        out = engine.generate(batch, 4)
    assert torch.equal(out, untraced)
    assert obs.counts() == {"engine.prefill_slots": 24,
                            "engine.prompt_tokens": want}
    assert called == {"prefill": 2, "decode_step": 6}
    events = _events(obs.export_chrome_trace())
    chain = _parents(events)
    names = [e["name"] for e in events]
    assert names.count("engine.generate") == 1
    assert names.count("engine.prefill") == 1
    assert names.count("engine.decode_step") == 3
    for e in events:
        if e["name"] != "engine.generate":
            assert chain(e) == ["engine.generate"]
