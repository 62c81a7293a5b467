#!/usr/bin/env python3
"""Replayed against eager decode steps of mamba2-780m in bf16 on one card.

    python3 experiments/decode_graph_check.py [--seed N] [--prompt 512]

Makes the benchmark's ``mamba2-780m-bf16`` weights on the card from the
seed (``mgitbench/configs/mamba2-780m-bf16.json``, ``mgitbench/weights.py``:
full size, 48 layers). First it holds ``models.model._embed`` against its
old expression (a float32 scale copied from the host) in bf16 and f32, and
shows what a host scalar would give instead. Then, for each batch size B
in 1, 2, 8 and 32, one prefill of B x ``--prompt`` random tokens, and for
runs of 2, 8 and 64 greedy tokens, with ``torch.profiler`` (CUDA activity)
off and on: the same steps twice from copies of the prefill's cache,
eagerly (``make_serve_step``) and replayed by a fresh ``ServeEngine``'s
``DecodeGraph`` (captured in the case, under the profiler when it is on).
One JSON line a case: bits of tokens and logits that differ (0: bit for
bit), the capture's seconds, ms a step on the host's clock eager and
replayed (synchronised after the run), host ms to issue one replay, device
ms per replay (CUDA events over 20 replays), how long a lone replay on an
idle card takes to return and then to finish on the card (so whether the
profiler makes a launch wait), the static bytes (input token and cache)
and what the capture added to the allocated memory.
Last, ``generate`` of 8 tokens at a ragged B = 2 x 2048 (replayed) against
the same engine with its lock held (eager). Needs one CUDA card; prints its
name and power limit first, and ``ok`` last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.join(ROOT, "src"), ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

BATCHES = (1, 2, 8, 32)
STEPS = (2, 8, 64)
DEVICE_REPLAYS = 20


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def differing(a, b) -> int:
    """Elements whose bits differ between two tensors of one dtype."""
    import torch
    if a.dtype in (torch.bfloat16, torch.float16):
        a, b = a.view(torch.int16), b.view(torch.int16)
    elif a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def embed_check(cfg, params) -> dict:
    import numpy as np
    import torch

    from repro_torch.models import model
    tok = torch.randint(1, 50277, (2, 64), device="cuda")
    scale = np.sqrt(cfg.d_model).astype(np.float32)
    out = {}
    for dtype in ("bfloat16", "float32"):
        table = params["embed"]["tok"].to(getattr(torch, dtype))
        old = (table[tok] * torch.tensor(scale, device="cuda")).to(
            table.dtype)
        new = model._embed(dataclasses.replace(cfg, dtype=dtype),
                           {"embed": {"tok": table}}, tok)
        host = (table[tok] * float(scale)).to(table.dtype)
        out[dtype] = {"filled_vs_copied": differing(new, old),
                      "host_scalar_vs_copied": differing(host, old),
                      "elements": old.numel()}
    return out


def case(cfg, params, logits0, cache0, n, prompt, profiled) -> dict:
    import torch

    from repro_torch.common.tree import leaves
    from repro_torch.serve import ServeEngine, make_serve_step

    B = logits0.shape[0]
    step = make_serve_step(cfg)
    prof = None
    if profiled:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    with torch.inference_mode():
        first = torch.argmax(logits0, dim=-1).to(torch.int32)[:, None]
        cache = {k: v.clone() for k, v in cache0.items()}
        token, eager = first, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n - 1):
            token, logits, cache = step(params, cache, token, prompt + i)
            eager.append((token, logits))
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        del cache

        engine = ServeEngine(cfg, params, max_len=prompt + max(STEPS),
                             device="cuda")
        allocated = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        graph = engine._graph(B)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        added = torch.cuda.memory_allocated() - allocated
        cache = {k: v.clone() for k, v in cache0.items()}
        token, replayed, issue = first, [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n - 1):
            h0 = time.perf_counter()
            token = graph.step(token, cache if i == 0 else None)
            issue.append(time.perf_counter() - h0)
            replayed.append((token, graph.logits.clone()))
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(DEVICE_REPLAYS):
            graph.graph.replay()
        end.record()
        torch.cuda.synchronize()
        device_ms = start.elapsed_time(end) / DEVICE_REPLAYS
        returns, drains = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            graph.graph.replay()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            returns.append(t1 - t0)
            drains.append(time.perf_counter() - t1)
    device_events = None
    if prof is not None:
        prof.__exit__(None, None, None)
        device_events = sum(
            1 for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA)
    static = sum(t.numel() * t.element_size()
                 for t in [graph.token, *leaves(graph.cache)])
    line = {
        "B": B, "tokens": n, "profiled": profiled,
        "token_bits_differing": sum(differing(a[0], b[0])
                                    for a, b in zip(eager, replayed)),
        "logit_bits_differing": sum(differing(a[1], b[1])
                                    for a, b in zip(eager, replayed)),
        "logits_compared": sum(a[1].numel() for a in eager),
        "max_abs_logit_diff": max(
            [float((a[1].float() - b[1].float()).abs().max())
             for a, b in zip(eager, replayed)] or [0.0]),
        "capture_s": round(capture_s, 4),
        "eager_step_ms": round(eager_s / (n - 1) * 1e3, 3),
        "replayed_step_ms": round(replay_s / (n - 1) * 1e3, 3),
        "replay_issue_ms": round(sorted(issue)[len(issue) // 2] * 1e3, 4),
        "replay_device_ms": round(device_ms, 4),
        "lone_replay_returns_ms": round(sorted(returns)[2] * 1e3, 4),
        "lone_replay_then_drains_ms": round(sorted(drains)[2] * 1e3, 4),
        "static_bytes": static, "capture_added_bytes": added,
        "device_events": device_events}
    del engine, graph
    return line


def generate_check(cfg, params, gen) -> dict:
    import torch

    from repro_torch.serve import ServeEngine
    lengths = torch.tensor([2048, 700], device="cuda")
    tokens = torch.randint(1, 50277, (2, 2048), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens, "lengths": lengths}
    engine = ServeEngine(cfg, params, max_len=2048 + 8, device="cuda")
    replayed = engine.generate(batch, 8)
    with engine._lock:
        eager = engine.generate(batch, 8)
    return {"generate_tokens_differing": differing(replayed, eager),
            "captured_batches": sorted(engine._graphs)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=2**31 + 26)
    parser.add_argument("--prompt", type=int, default=512)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("decode_graph_check: no CUDA device", file=sys.stderr)
        return 2
    from mgitbench.common import port_config
    from mgitbench.weights import Weights, generator, nested
    from repro_torch.models import prefill

    print(f"device: {card_line()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    with open(os.path.join(ROOT, "mgitbench", "configs",
                           "mamba2-780m-bf16.json")) as f:
        config = json.load(f)
    cfg = port_config(config["model"])
    params = nested(Weights(config, args.seed, "cuda").base())
    print(f"embed: {json.dumps(embed_check(cfg, params))}", flush=True)
    gen = generator(args.seed, "cuda")
    bad = 0
    for B in BATCHES:
        tokens = torch.randint(1, 50277, (B, args.prompt), generator=gen,
                               device="cuda")
        with torch.inference_mode():
            logits0, cache0 = prefill(cfg, params, {"tokens": tokens},
                                      args.prompt + max(STEPS))
        for n in STEPS:
            for profiled in (False, True):
                line = case(cfg, params, logits0, cache0, n, args.prompt,
                            profiled)
                bad += line["token_bits_differing"] + line[
                    "logit_bits_differing"]
                print(f"case: {json.dumps(line)}", flush=True)
        del logits0, cache0
        torch.cuda.empty_cache()
    line = generate_check(cfg, params, gen)
    bad += line["generate_tokens_differing"]
    print(f"generate: {json.dumps(line)}", flush=True)
    print(f"peak_allocated_bytes {torch.cuda.max_memory_allocated()}")
    print(json.dumps({"ok": bad == 0, "bits_differing": bad}), flush=True)
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
