"""The whole step's share of the card's peak: operations the real tokens
of the completed requests need (``formulas.sequence_ops``), over the
seconds the engine spent serving them (each request's ``generate`` call,
its tokens made to its answer on the host; waits for arrivals left out),
over the configuration dtype's peak (float32 outside the tensor cores,
67 TFLOP/s; bfloat16 989 TFLOP/s)."""

from mgitbench import formulas


def read(run):
    reqs = run.records.get("requests") or []
    serving = sum(r["finished"] - r["start"] for r in reqs)
    if not reqs or serving <= 0 or run.device != "cuda":
        return None
    peak = formulas.PEAK_OPS_PER_S[run.model["dtype"]]
    return 100.0 * sum(r["ops"] for r in reqs) / serving / peak
