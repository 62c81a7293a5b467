"""Seconds of the program's ``commit.truth`` spans (each leaf's stored
value worked out by the dequant kernel, its copies to and from the card
included, summed over the store's worker threads) per GB (1e9 bytes) of
derivatives committed in the traced window."""


def read(run):
    secs = sum(s["t1"] - s["t0"] for s in run.program_spans
               if s["name"] == "commit.truth")
    gb = sum(c["bytes"] for c in run.records.get("commits") or []) / 1e9
    return secs / gb if secs > 0 and gb > 0 else None
