#!/usr/bin/env python3
"""Host microseconds per call of the port's flash-attention wrapper.

    python3 experiments/flash_host_overhead.py [--src DIR] [--calls N]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
so that one script measures two trees of the port, one process each. It
builds the flash kernel, then, in bf16 at the prefill calls of
``chip_smoke.py``'s phase 4d (qwen3-0.6b, (8, 16 q / 8 kv, 512, 128)
causal) and phase 8 (paligemma-3b, (8, 8 q / 1 kv, 768, 256) with a
256-token prefix), issues ``--calls`` calls back to back and times them on
the host's clock without waiting for the card: the launch queue holds them
all, so the figure is the host's cost of issuing one call. The same calls
are timed on the card by CUDA events. Where the tree registers the
operator ``torch.ops.mgit.flash_attention``, a direct call of the operator
is timed as well. Each figure is the median of 7 repeats. Needs one CUDA
card; prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {
    "4d qwen3-0.6b prefill": (dict(B=8, Hq=16, Hkv=8, S=512, hd=128),
                              dict(causal=True)),
    "8 paligemma-3b prefill": (dict(B=8, Hq=8, Hkv=1, S=768, hd=256),
                               dict(causal=True, prefix_len=256)),
}
REPEATS = 7


def time_calls(fn, calls):
    """(host us per call, device ms per call) of ``calls`` calls of ``fn``,
    medians over ``REPEATS``."""
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    host, device = [], []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host.append((time.perf_counter() - t0) / calls * 1e6)
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end) / calls)
    return statistics.median(host), statistics.median(device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("flash_host_overhead: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build.build(["flash_attention"])
    try:     # the operator, where this tree registers it
        op = torch.ops.mgit.flash_attention
    except AttributeError:
        op = None
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"src": os.path.abspath(args.src), "card": card,
           "calls": args.calls, "torch": torch.__version__}
    for label, (shape, masks) in SHAPES.items():
        B, Hq, Hkv, S, hd = (shape[k] for k in ("B", "Hq", "Hkv", "S", "hd"))
        q, k, v = (torch.randn(d, generator=gen, device="cuda").to(
            torch.bfloat16) for d in ((B, Hq, S, hd), (B, Hkv, S, hd),
                                      (B, Hkv, S, hd)))
        row = {}
        row["wrapper_host_us"], row["wrapper_ms"] = time_calls(
            lambda: flash_attention(q, k, v, **masks), args.calls)
        if op is not None:
            causal, window = masks.get("causal", True), 0
            prefix = masks.get("prefix_len", 0)
            row["op_host_us"], row["op_ms"] = time_calls(
                lambda: op(q, k, v, causal, window, prefix), args.calls)
        out[label] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
