"""Logical megabytes (1e6 bytes) of the versions checked out in the window
over the summed wall seconds of those checkouts, each through a fresh
store handle (host clock)."""


def read(run):
    outs = run.records.get("checkouts") or []
    secs = sum(c["s"] for c in outs)
    return sum(c["bytes"] for c in outs) / 1e6 / secs if secs else None
