"""The control of each cell, at a size a CPU test run holds: the plain
reference one precision below the configuration's, put in the program's
place before the same check, reads far above the program on three seeds
where the program comes out correct. On the chip the same code runs at the
cells' own sizes: ``python3 mgitbench/run.py ... --control 1``.

Lineage: the control (bf16 for an f32 lineage, fp8 e4m3 for a bf16 one)
must differ from the reference, whose limit is 0. Serving: the control
(TF32 for f32, fp8 e4m3 for bf16) must flip served tokens by at least three
times the program's widest gap; for f32 also past the cell's limit. The
tiny state-space model gets an output head of its own: with a tied head at
this size every token repeats the one before, so no precision flips one.
"""

import pytest

from tiny import drive, tiny_run

SEEDS = [11, 12, 13]
CASES = {
    "paper-bert-f32.lineage": ({}, None),
    "mamba2-780m-bf16-l8.lineage": ({}, None),
    "paper-bert-f32.classify": (dict(check_requests=200, sequences=32,
                                     rate_per_s=400), None),
    "mamba2-780m-bf16.longdoc": (dict(check_requests=100, sequences=8,
                                      generated=4, rate_per_s=400),
                                 {"tie_embeddings": False}),
}


@pytest.mark.parametrize("cell", sorted(CASES))
def test_control_is_rejected(cell):
    traffic, model_kw = CASES[cell]
    seconds = 0.5 if traffic else 1.0
    for seed in SEEDS:
        program, control = (
            drive(tiny_run(cell, seed=seed, seconds=seconds, control=c,
                           model_kw=model_kw, **traffic))
            for c in (False, True))
        assert program.correct, program.checks
        (name, got), = program.checks.items()
        low = control.checks[name]["value"]
        if name == "checkout_bits_differing":
            assert got["value"] == 0 and low > got["limit"]
        else:
            assert low >= 3 * got["value"] and low > 0
        if name == "checkout_bits_differing" or cell.startswith(
                "paper-bert-f32"):
            assert not control.correct, control.checks
