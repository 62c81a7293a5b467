"""Cells at a size a CPU test run holds: the same generators, a tiny model,
the store on its host path (``backend="ref"``) and the engine on the CPU."""

from __future__ import annotations

import copy
import tempfile
import time
from pathlib import Path

from mgitbench import harness

TINY_DENSE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                  head_dim=16, d_ff=128, vocab_size=512)
TINY_SSM = dict(n_layers=2, d_model=64, ssm_state=16, ssm_head_dim=16,
                ssm_chunk=32, vocab_size=512)
TINY_SERVE = dict(sequences=4, prompt_min=8, prompt_max=64, width_multiple=16,
                  pool_requests=6, check_requests=4)


def tiny_run(cell: str, seed: int = 2**31 + 11, seconds: float = 1.0,
             trace: bool = False, control: bool = False, model_kw=None,
             **traffic_kw):
    """A ``harness.Run`` of ``cell`` at the tiny size, not yet driven."""
    run = harness.make_run(cell, seed=seed, seconds=seconds, trace=trace,
                           device="cpu", backend="ref",
                           scratch=Path(tempfile.mkdtemp()), control=control)
    run.config = config = copy.deepcopy(run.config)
    m = config["model"]
    m.update(TINY_DENSE if m["family"] == "dense" else TINY_SSM)
    m.update(model_kw or {})
    config["vocab_size"] = m["vocab_size"]
    config["derivative"]["frozen_layers"] = 1
    run.traffic = traffic = dict(run.traffic)
    if traffic["kind"] == "serve":
        traffic.update(TINY_SERVE)
    traffic.update(traffic_kw)
    return run


def drive(run):
    harness.execute(run, time.perf_counter())
    return run
