"""Share of the seconds inside the program's ``engine.decode_step`` spans
(one greedy decode step each, as the host issues it) in which no kernel,
copy or memset ran on the card (torch.profiler's device trace)."""


def read(run):
    dt = run.device_trace
    spans = [(s["t0"], s["t1"]) for s in run.program_spans
             if s["name"] == "engine.decode_step"]
    stepping = sum(b - a for a, b in spans)
    if dt is None or not dt.events or stepping <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_within(spans) / stepping)
