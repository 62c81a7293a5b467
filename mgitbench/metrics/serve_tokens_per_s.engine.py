"""Real prompt tokens and generated tokens of the requests completed in
the window, over the seconds the engine spent serving them (each
request's ``generate`` call, its tokens made to its answer on the host;
waits for arrivals left out); pads are not counted. Counted by the
benchmark from what it sent and received (host clock)."""


def read(run):
    reqs = run.records.get("requests") or []
    serving = sum(r["finished"] - r["start"] for r in reqs)
    if not reqs or serving <= 0:
        return None
    return sum(r["real_tokens"] + r["generated_tokens"]
               for r in reqs) / serving
