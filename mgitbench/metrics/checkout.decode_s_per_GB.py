"""Seconds of the program's ``checkout.decode`` spans (the LZMA decode of
each hop's quantized delta, summed over the store's worker threads) that
lie inside the benchmark's ``lineage.checkout`` spans, per GB (1e9 bytes)
checked out in the traced window. Decodes inside a commit's read-back of
its parent are left out."""


def inside(s, intervals) -> bool:
    mid = 0.5 * (s["t0"] + s["t1"])
    return any(a <= mid <= b for a, b in intervals)


def read(run):
    checkouts = [(a, b) for name, a, b in run.spans
                 if name == "lineage.checkout"]
    secs = sum(s["t1"] - s["t0"] for s in run.program_spans
               if s["name"] == "checkout.decode" and inside(s, checkouts))
    gb = sum(c["bytes"] for c in run.records.get("checkouts") or []) / 1e9
    return secs / gb if secs > 0 and gb > 0 else None
