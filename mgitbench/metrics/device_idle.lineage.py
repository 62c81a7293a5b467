"""Share of the traced window in which no kernel, copy or memset ran on the
card (torch.profiler's device trace)."""


def read(run):
    dt = run.device_trace
    if dt is None or dt.window_s <= 0 or not dt.events:
        return None
    return 100.0 * (1.0 - dt.busy_s() / dt.window_s)
