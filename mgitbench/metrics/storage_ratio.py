"""Logical bytes of the derivatives committed in the window over the bytes
their commits added to the repository's files on disk (the benchmark's
own reading of the file sizes; the base is not counted)."""


def read(run):
    commits = run.records.get("commits") or []
    disk = sum(c["disk"] for c in commits)
    return sum(c["bytes"] for c in commits) / disk if disk > 0 else None
