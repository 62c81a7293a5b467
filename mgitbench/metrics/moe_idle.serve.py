"""Share of the seconds inside the program's ``moe.*`` spans (the dropless
MoE's routing and its experts, as the host issues them) in which no
kernel, copy or memset ran on the card (torch.profiler's device trace)."""


def read(run):
    dt = run.device_trace
    spans = [(s["t0"], s["t1"]) for s in run.program_spans
             if s["name"].startswith("moe.")]
    inside = sum(b - a for a, b in spans)
    if dt is None or not dt.events or inside <= 0:
        return None
    return 100.0 * (1.0 - dt.busy_within(spans) / inside)
