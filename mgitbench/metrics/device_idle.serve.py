"""Share of the seconds the engine spent serving requests (each request's
``generate`` call, its tokens made to its answer on the host) in which no
kernel, copy or memset ran on the card (torch.profiler's device trace).
Waits for arrivals are left out, so the offered load does not set it."""


def read(run):
    dt = run.device_trace
    reqs = run.records.get("requests") or []
    spans = [(r["start"], r["finished"]) for r in reqs]
    serving = sum(b - a for a, b in spans)
    if dt is None or not dt.events or serving <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_within(spans) / serving)
