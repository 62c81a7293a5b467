"""95th percentile, in milliseconds, of the latency of every request
completed in the window: from when its client sent it to when its tokens
were on the host (host clock)."""

import numpy as np


def read(run):
    reqs = run.records.get("requests") or []
    if not reqs:
        return None
    lat = [r["finished"] - r["sent"] for r in reqs]
    return 1e3 * float(np.percentile(lat, 95))
