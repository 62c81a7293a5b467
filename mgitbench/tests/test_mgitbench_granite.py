"""The Granite cell's pieces on the CPU: its family's layout against the
port's, its plain reference against the port's forward at a tiny size,
the two readers it brings on a synthetic run (and the None they read
where the program or the trace has nothing), and tiny runs of the cell."""

import pytest
import torch

from mgitbench import common, harness
from mgitbench.devtrace import DeviceTrace, Probe
from mgitbench.families import granite_hybrid
from mgitbench.reference.model import Model
from mgitbench.weights import Weights, nested, param_specs
from repro_torch import obs
from tiny import drive, tiny_run

CELL = "granite-4.0-h-small-bf16-ep2.rag"
# one whole period at tiny widths: 8 experts, 4 held, top-4
TINY_GRANITE = dict(n_layers=10, d_model=64, n_heads=4, n_kv_heads=2,
                    head_dim=16, d_ff=32, shared_d_ff=64, n_experts=8,
                    n_local_experts=4, experts_per_token=4, ssm_state=16,
                    ssm_head_dim=16, ssm_chunk=32, vocab_size=512)
ROOFLINE, IDLE = "moe_experts_roofline.serve", "moe_idle.serve"


def model(**kw):
    return {**harness.make_run(CELL, seed=1, seconds=1.0, trace=False).model,
            **TINY_GRANITE, **kw}


def test_layout_is_the_ports_at_a_whole_period():
    from repro_torch.models.model import flat_paths, param_structs
    for m in (model(), model(n_layers=20, n_local_experts=0)):
        port = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in flat_paths(param_structs(common.port_config(m))
                                       ).items()}
        assert param_specs(m) == dict(sorted(port.items()))


def test_reference_matches_port_forward():
    from repro_torch.models.model import forward
    m = model(dtype="float32", n_layers=20)
    w = Weights({"model": m, "derivative": {"delta_rms_share": 0.03,
                                            "frozen_layers": 0,
                                            "freeze_every": 2}}, 3, "cpu")
    params = w.derive(w.base(), 1)
    tokens = torch.randint(1, 512, (3, 40),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        port = forward(common.port_config(m), nested(params),
                       {"tokens": tokens}) * m["logits_scaling"]
        ref = Model(m, params).logits(tokens, 0)
    gap = float((port - ref).abs().max())
    assert gap <= 1e-5 * float(ref.abs().max()), gap


def test_token_ops_count_the_held_share():
    """3.3 GFLOP a token through the cell's 10 layers: 9 Mamba2 sublayers,
    one attention's projections, 10 routers, 10 x 10 x 36/72 routed and 10
    shared SwiGLUs."""
    m = harness.make_run(CELL, seed=1, seconds=1.0, trace=False).model
    D, d_in, N, H = 4096, 8192, 128, 128
    mamba = 2 * D * (2 * d_in + 2 * N + H) + 2 * 4 * (d_in + 2 * N) \
        + 4 * d_in * N + 2 * d_in * D
    attn = 2 * (D * (32 + 16) * 128 + 32 * 128 * D)
    moe = 2 * D * 72 + 6 * D * (5 * 768 + 1536)
    assert granite_hybrid.token_ops(m) == 9 * mamba + attn + 10 * moe
    assert granite_hybrid.context_ops(m, 3) == 4 * 32 * 128 * 6


def grouped_calls(bound):
    """A probe's record of two grouped products: one over 3 of 4 groups
    of rows, one over a single row."""
    probe = Probe()
    w = torch.empty((4, 4096, 768), dtype=torch.bfloat16, device="meta")
    rows = torch.empty((1000, 4096), dtype=torch.bfloat16, device="meta")
    probe.calls[PROBE_KEY] = [
        bound(rows, w, torch.tensor([300, 300, 900, 1000], dtype=torch.int32)),
        bound(rows, w, torch.tensor([0, 1, 1, 1], dtype=torch.int32))]
    return probe


PROBE_KEY = ("repro_torch.models.layers", "grouped_mm")


def serve_run(kernel="GroupProblemShape_gemm", launches=2):
    run = harness.make_run(CELL, seed=1, seconds=1.0, trace=True)
    trace = DeviceTrace()
    trace.t0_host, trace.t1_host = 0.0, 10.0
    trace.events = [("prep", 0.0, 0.5), ("other", 1.0, 2.0)] + [
        (kernel, 3.0 + i, 3.0 + i + 0.004) for i in range(launches)]
    run.device_trace = trace
    run.program_spans = [{"name": "moe.route", "t0": 0.0, "t1": 1.0},
                         {"name": "moe.experts", "t0": 1.0, "t1": 4.0},
                         {"name": "engine.prefill", "t0": 0.0, "t1": 5.0}]
    return run


def test_roofline_bound_counts_computed_rows_and_used_experts():
    module = harness.metric_module(ROOFLINE)
    assert module.PROBE[:2] == PROBE_KEY
    bound = module.PROBE[3]
    w = torch.empty((4, 4096, 768), dtype=torch.bfloat16, device="meta")
    rows = torch.empty((1000, 4096), dtype=torch.bfloat16, device="meta")
    for ends, R, used in (([300, 300, 900, 1000], 1000, 3),
                          ([0, 1, 1, 1], 1, 1)):
        ops = 2 * R * 4096 * 768 / 989e12
        nbytes = (R * (4096 + 768) + used * 4096 * 768) * 2 / 3.35e12
        assert float(bound(rows, w, torch.tensor(ends))) == pytest.approx(
            max(ops, nbytes))
    # many rows through few experts: operations bound it
    many = torch.empty((100000, 4096), dtype=torch.bfloat16, device="meta")
    assert float(bound(many, w, torch.tensor([0, 0, 0, 100000]))) == \
        pytest.approx(2 * 100000 * 4096 * 768 / 989e12)


class Offsets:
    """Offsets that count their reads to the host."""

    def __init__(self, ends):
        self.ends, self.reads = ends, 0

    def tolist(self):
        self.reads += 1
        return list(self.ends)


def test_roofline_bound_reads_the_offsets_only_when_read():
    bound = harness.metric_module(ROOFLINE).PROBE[3]
    w = torch.empty((4, 4096, 768), dtype=torch.bfloat16, device="meta")
    rows = torch.empty((1000, 4096), dtype=torch.bfloat16, device="meta")
    offsets = [Offsets([300, 300, 900, 1000]), Offsets([0, 1, 1, 1])]
    calls = [bound(rows, w, o) for o in offsets]
    assert [o.reads for o in offsets] == [0, 0]      # nothing in the window
    total = sum(calls)
    assert total == pytest.approx(float(calls[0]) + float(calls[1]))
    assert [o.reads for o in offsets] == [1, 1]      # each read once


def test_roofline_reads_the_probed_calls_over_the_kernels_seconds():
    module = harness.metric_module(ROOFLINE)
    run = serve_run()
    run.probe = grouped_calls(module.PROBE[3])
    want = 100.0 * sum(run.probe.calls[PROBE_KEY]) / 0.008
    assert harness.read_metric(ROOFLINE, run) == pytest.approx(want)
    run.probe.calls[PROBE_KEY].pop()          # a launch not accounted for
    assert harness.read_metric(ROOFLINE, run) is None
    run = serve_run(kernel="another_gemm")    # no launch of the kernel
    run.probe = grouped_calls(module.PROBE[3])
    assert harness.read_metric(ROOFLINE, run) is None
    run.probe, run.device_trace = None, None  # an untraced run
    assert harness.read_metric(ROOFLINE, run) is None


def test_moe_idle_reads_the_idle_share_of_the_moe_spans():
    run = serve_run()
    # busy 0.5 + 1.0 + 0.004 of the spans' 4 s (the prefill span is not
    # the MoE's)
    assert harness.read_metric(IDLE, run) == pytest.approx(
        100.0 * (1 - 1.504 / 4.0))
    run.program_spans = [s for s in run.program_spans
                         if not s["name"].startswith("moe.")]
    assert harness.read_metric(IDLE, run) is None   # a program without them
    run = serve_run()
    run.device_trace = None
    assert harness.read_metric(IDLE, run) is None


def test_the_new_metrics_are_listed_for_the_cell_alone():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for name in (ROOFLINE, IDLE):
        entry = next(m for m in bench["per_layer"] if m["name"] == name)
        assert entry["workloads"] == [CELL]
        assert entry["moves"] == "serve_p95_ms"
    listed = {m["name"] for m in harness.metrics_for(bench, CELL, True)}
    assert {ROOFLINE, IDLE, "decode_idle.serve", "mfu.serve",
            "device_idle.serve", "prefill_pad_share.serve",
            "serve_tokens_per_s.engine"} <= listed
    assert not {"flash_attention_roofline.serve",
                "decode_graph_share.serve"} & listed


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_of_the_cell_is_correct(trace):
    run = drive(tiny_run(CELL, trace=trace, model_kw=TINY_GRANITE,
                         rate_per_s=4))
    assert run.correct, run.checks
    assert run.records["tokens_compared"][0]["n"] > 0
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    out = harness.result(run, bench)
    if trace:
        counts = obs.counts()
        assert counts["moe.choices"] > counts["moe.local_rows"] > 0
        names = {s["name"] for s in run.program_spans}
        assert {"moe.route", "moe.experts"} <= names
        # no device trace on the CPU: neither reader finds anything
        assert ROOFLINE not in out["metrics"]
        assert IDLE not in out["metrics"]
    else:
        assert set(out["metrics"]) == {"serve_p95_ms", "setup_s"}


def test_the_control_is_rejected_at_a_tiny_size():
    """fp8 e4m3 in the program's place moves the served tokens' gaps to at
    least three times the program's own, on three seeds. At this size the
    model gets an output head of its own, as the tiny longdoc control
    does: with a tied head a tiny random model repeats its input token and
    no precision flips one."""
    kw = dict(model_kw={**TINY_GRANITE, "tie_embeddings": False},
              rate_per_s=12, seconds=0.5, check_requests=6, sequences=8,
              generated=4)
    for seed in (11, 12, 13):
        program = drive(tiny_run(CELL, seed=seed, **kw))
        control = drive(tiny_run(CELL, seed=seed, control=True, **kw))
        got = program.checks["logit_gap"]["value"]
        assert program.correct
        assert control.checks["logit_gap"]["value"] >= 3 * got
        assert control.checks["logit_gap"]["value"] > 0
