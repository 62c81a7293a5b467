"""Logical megabytes (1e6 bytes) of the derivatives committed in the
window over the summed wall seconds of those commits (host clock)."""


def read(run):
    commits = run.records.get("commits") or []
    secs = sum(c["s"] for c in commits)
    return sum(c["bytes"] for c in commits) / 1e6 / secs if secs else None
