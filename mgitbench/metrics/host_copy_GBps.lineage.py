"""Bytes the program counted crossing between host and card in its storage
entry points (``ops.h2d_bytes`` + ``ops.d2h_bytes``), in GB (1e9 bytes),
over the device seconds of the trace's ``Memcpy HtoD`` and ``Memcpy DtoH``
operations inside the benchmark's ``lineage.commit`` and
``lineage.checkout`` spans. Read only where the counted copies account
for every one of those operations, as a roofline is read only where the
recorded calls account for every launch."""

KINDS = ("Memcpy HtoD", "Memcpy DtoH")


def program_counts():
    from repro_torch import obs
    counts = getattr(obs, "counts", None)
    return counts() if counts is not None else {}


def read(run):
    trace = run.device_trace
    counts = program_counts()
    copies = counts.get("ops.h2d_copies", 0) + counts.get("ops.d2h_copies", 0)
    nbytes = counts.get("ops.h2d_bytes", 0) + counts.get("ops.d2h_bytes", 0)
    if trace is None or not copies:
        return None
    spans = [(a, b) for name, a, b in run.spans
             if name in ("lineage.commit", "lineage.checkout")]
    secs, ops = 0.0, 0
    for name, a, b in trace.events:
        mid = 0.5 * (a + b)
        if name.startswith(KINDS) and any(s0 <= mid <= s1
                                          for s0, s1 in spans):
            secs += b - a
            ops += 1
    if ops != copies or secs <= 0:
        return None
    return nbytes / 1e9 / secs
