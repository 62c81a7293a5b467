"""``decode_graph_share.serve``: the share of the engine's decode steps
that replayed a CUDA graph, from the program's counts; None, never
raising, where the program counted no step or has no counts, as a program
without the replay path has not."""

import pytest

from mgitbench import harness
from repro_torch import obs

NAME = "decode_graph_share.serve"


def program_counts(**counts):
    """Leave ``counts`` as the last traced scope's totals."""
    obs.reset_trace()
    with obs.tracing():
        for name, n in counts.items():
            obs.count(name.replace("__", "."), n)


@pytest.fixture(autouse=True)
def _no_counts():
    program_counts()
    yield
    program_counts()


def run():
    return harness.make_run("mamba2-780m-bf16.longdoc", seed=1, seconds=1.0,
                            trace=True)


@pytest.mark.parametrize("replays, eager, want", [
    (196, 4, 98.0), (211, 0, 100.0), (0, 7, 0.0)])
def test_reads_the_share_of_replayed_steps(replays, eager, want):
    program_counts(engine__decode_graph_replays=replays,
                   engine__decode_eager_steps=eager,
                   engine__decode_graph_captures=3)
    assert harness.read_metric(NAME, run()) == pytest.approx(want)


def test_reads_nothing_without_steps_or_counts(monkeypatch):
    assert harness.read_metric(NAME, run()) is None     # nothing counted
    program_counts(engine__prefill_slots=1000, engine__prompt_tokens=743)
    assert harness.read_metric(NAME, run()) is None     # a parent's counts
    program_counts(engine__decode_graph_captures=1)
    assert harness.read_metric(NAME, run()) is None     # no step
    monkeypatch.delattr(obs, "counts")
    assert harness.read_metric(NAME, run()) is None     # no counts at all


def test_is_listed_for_longdoc_alone():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    assert entry["workloads"] == ["mamba2-780m-bf16.longdoc"]
    assert entry["source"] == "program_counter"
    assert entry["moves"] == "serve_p95_ms"
    for cell in bench["workloads"]:
        listed = NAME in {m["name"] for m in harness.metrics_for(
            bench, cell["name"], True)}
        assert listed == (cell["name"] == "mamba2-780m-bf16.longdoc")


def test_a_traced_tiny_longdoc_run_on_the_cpu_steps_eagerly():
    """On the CPU the engine steps eagerly: the share reads 0 over the
    window's steps."""
    from mgitbench.tests.tiny import drive, tiny_run
    got = drive(tiny_run("mamba2-780m-bf16.longdoc", trace=True))
    counts = obs.counts()
    steps = len(got.records["requests"]) * (got.traffic["generated"] - 1)
    assert counts["engine.decode_eager_steps"] == steps > 0
    assert harness.read_metric(NAME, got) == 0.0
