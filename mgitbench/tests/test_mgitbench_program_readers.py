"""The readers of the program's own spans and counts, on a synthetic run
and device trace: what each reads, and that each reads nothing (None),
never raising, where the program or the trace has nothing for it, as a
program without these spans and counts has not."""

import pytest

from mgitbench import harness
from mgitbench.devtrace import DeviceTrace
from repro_torch import obs

READERS = ("checkout.decode_s_per_GB", "commit.parent_s_per_GB",
           "commit.truth_s_per_GB", "host_copy_GBps.lineage",
           "decode_idle.serve", "prefill_pad_share.serve")


def read(name, run):
    return harness.read_metric(name, run)


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


def lineage_run():
    run = harness.make_run("paper-bert-f32.lineage", seed=1, seconds=1.0,
                           trace=True)
    run.spans = [("lineage.commit", 0.0, 10.0),
                 ("lineage.checkout", 10.0, 14.0),
                 ("lineage.make_derivative", 14.0, 15.0)]
    span = [("commit.parent", 0.5, 2.5), ("commit.truth", 3.0, 3.5),
            ("commit.truth", 3.2, 3.7), ("checkout.decode", 11.0, 11.5),
            ("checkout.decode", 11.2, 11.5),
            ("checkout.decode", 1.0, 2.0)]     # inside a commit's read-back
    run.program_spans = [{"name": n, "t0": a, "t1": b} for n, a, b in span]
    run.records = {"commits": [{"bytes": 2e9}],
                   "checkouts": [{"bytes": 4e9}]}
    trace = DeviceTrace()
    trace.t0_host, trace.t1_host = 0.0, 15.0
    trace.events = [("Memcpy HtoD (Pageable -> Device)", 1.0, 1.5),
                    ("kernel", 1.5, 1.6),
                    ("Memcpy DtoH (Device -> Pageable)", 11.0, 11.5),
                    ("Memcpy DtoH (Device -> Pageable)", 14.2, 14.3)]
    run.device_trace = trace
    return run


def test_lineage_readers_read_the_program_spans_and_counts():
    run = lineage_run()
    assert read("commit.parent_s_per_GB", run) == pytest.approx(1.0)
    assert read("commit.truth_s_per_GB", run) == pytest.approx(0.5)
    assert read("checkout.decode_s_per_GB", run) == pytest.approx(0.2)
    program_counts(ops__h2d_copies=1, ops__h2d_bytes=3e9,
                   ops__d2h_copies=1, ops__d2h_bytes=1e9)
    # 4 GB over the two copies inside commit and checkout (the one in
    # make_derivative is not the storage path's)
    assert read("host_copy_GBps.lineage", run) == pytest.approx(4.0)


def test_copy_rate_needs_the_counts_to_account_for_every_copy():
    run = lineage_run()
    program_counts(ops__h2d_copies=1, ops__h2d_bytes=3e9)
    assert read("host_copy_GBps.lineage", run) is None
    program_counts(ops__h2d_copies=2, ops__h2d_bytes=3e9,
                   ops__d2h_copies=1, ops__d2h_bytes=1e9)
    assert read("host_copy_GBps.lineage", run) is None
    program_counts(ops__h2d_copies=1, ops__h2d_bytes=3e9,
                   ops__d2h_copies=1, ops__d2h_bytes=1e9)
    run.device_trace = None
    assert read("host_copy_GBps.lineage", run) is None


def serve_run(cell="mamba2-780m-bf16.longdoc"):
    run = harness.make_run(cell, seed=1, seconds=1.0, trace=True)
    trace = DeviceTrace()
    trace.t0_host, trace.t1_host = 0.0, 10.0
    trace.events = [("prefill", 0.0, 2.0), ("step", 2.0, 2.1),
                    ("step", 3.0, 3.3)]
    run.device_trace = trace
    run.program_spans = [{"name": "engine.decode_step", "t0": 2.0, "t1": 3.0},
                         {"name": "engine.decode_step", "t0": 3.0, "t1": 4.0},
                         {"name": "engine.prefill", "t0": 0.0, "t1": 2.0}]
    return run


def test_serve_readers():
    run = serve_run()
    # 0.4 of the 2 decode-step seconds busy
    assert read("decode_idle.serve", run) == pytest.approx(80.0)
    program_counts(engine__prefill_slots=1000, engine__prompt_tokens=743)
    assert read("prefill_pad_share.serve", run) == pytest.approx(25.7)


def test_readers_find_nothing_without_the_programs_spans_and_counts(
        monkeypatch):
    """A program without the spans or ``obs.counts`` reads None in every
    cell the readers are listed for (the benchmark's own spans, of the
    same names, do not count as the program's)."""
    monkeypatch.delattr(obs, "counts")
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for cell in bench["workloads"]:
        run = (lineage_run() if cell["traffic"] == "lineage"
               else serve_run(cell["name"]))
        run.spans = run.spans + [(s["name"], s["t0"], s["t1"])
                                 for s in run.program_spans]
        run.program_spans = []
        for m in harness.metrics_for(bench, cell["name"], True):
            if m["name"] in READERS:
                assert read(m["name"], run) is None, (cell, m["name"])


def test_serve_readers_find_nothing_without_steps_or_a_trace():
    run = serve_run()
    run.program_spans = [s for s in run.program_spans
                         if s["name"] != "engine.decode_step"]
    assert read("decode_idle.serve", run) is None
    run = serve_run()
    run.device_trace = None
    assert read("decode_idle.serve", run) is None
    assert read("prefill_pad_share.serve", run) is None   # nothing counted


def test_the_readers_are_listed_for_their_cells():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    lineage = ["paper-bert-f32.lineage", "mamba2-780m-bf16-l8.lineage"]
    want = {"checkout.decode_s_per_GB": lineage,
            "commit.parent_s_per_GB": lineage,
            "commit.truth_s_per_GB": lineage,
            "host_copy_GBps.lineage": lineage,
            "decode_idle.serve": ["mamba2-780m-bf16.longdoc"],
            "prefill_pad_share.serve": ["paper-bert-f32.classify",
                                        "mamba2-780m-bf16.longdoc"]}
    got = {m["name"]: m for m in bench["per_layer"] if m["name"] in READERS}
    assert {k: m["workloads"] for k, m in got.items()} == want
    assert {m["source"] for m in got.values()} == {"program_span"}
    for name, cells in want.items():
        for cell in cells:
            assert name in {m["name"] for m in harness.metrics_for(
                bench, cell, True)}


@pytest.mark.parametrize("cell", ["paper-bert-f32.lineage",
                                  "mamba2-780m-bf16.longdoc"])
def test_a_traced_tiny_run_reads_the_programs_spans_and_counts(cell):
    """A traced run of the cell at the tiny size on the CPU: the readers of
    program spans and counts read numbers; those that need the device
    trace read nothing, as there is none."""
    from mgitbench.tests.tiny import drive, tiny_run
    run = drive(tiny_run(cell, trace=True))
    got = {name: read(name, run) for name in READERS}
    if cell.endswith(".lineage"):
        for name in ("checkout.decode_s_per_GB", "commit.parent_s_per_GB",
                     "commit.truth_s_per_GB"):
            assert got[name] > 0, name
        assert got["prefill_pad_share.serve"] is None
    else:
        reqs = run.records["requests"]
        slots = sum(len(r["lengths"]) * r["width"] for r in reqs)
        real = sum(r["real_tokens"] for r in reqs)
        assert got["prefill_pad_share.serve"] == pytest.approx(
            100.0 * (1 - real / slots))
        steps = [s for s in run.program_spans
                 if s["name"] == "engine.decode_step"]
        assert len(steps) == len(reqs) * (run.traffic["generated"] - 1)
    assert got["host_copy_GBps.lineage"] is None
    assert got["decode_idle.serve"] is None
