#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it puts ``src`` on ``sys.path`` itself and
imports nothing of JAX or of the reference package. Phases, each of which
exits non-zero on failure:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the CUDA kernels with nvcc and prints the seconds;
3. kernels: runs each kernel's wrapper at the main path's shapes, at ragged
   shapes and with an overflowing delta, and holds it bit for bit against
   its plain torch version on the same card inputs and against the numpy
   twin on the host; times the kernel and the plain version;
4. main path: commits a full-width paper-bert (f32, random weights from a
   seed) lineage base -> ft1 -> ft2 -> ft3 plus task-head (a child of ft1
   with a re-initialised lm_head) through ``ArtifactStore(chunk_threshold=
   0)`` on the card, reopens the repository, checks out ft3 and task-head,
   and requires every checked-out tensor to match its manifest hash, a
   host (``backend="ref"``) checkout of the same repository, and the live
   weights within the quantization bound, a clean ``fsck``, and at least
   one launch of every kernel in that run;
5. the same lineage with the default chunk threshold, whose large tensors
   take the host chunk engine: bit-identical checkouts and a clean fsck.

The line before last is one JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
F32_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
EPS = 1e-4
SRC = "src/repro_torch/kernels/csrc"
NODES = ("base", "ft1", "ft2", "ft3", "task-head")
CHECKOUT = ("ft3", "task-head")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events, warm."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a, b) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def same_bits(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def kernel_cases(gen):
    """(label, p1, p2) f32 pairs on the card: the main path's shapes with a
    finetune-sized delta, ragged shapes, and an overflowing delta."""
    import torch

    def pair(shape, scale):
        p2 = torch.randn(shape, generator=gen, device="cuda") * 0.036
        noise = torch.randn(shape, generator=gen, device="cuda") * scale
        keep = torch.rand(shape, generator=gen, device="cuda") < 0.3
        return p2 + noise * keep, p2

    out = []
    for shape in ((12, 768, 3072), (30522, 768), (257, 33), (1,)):
        out.append((f"{shape} finetune", *pair(shape, 1e-4)))
    out.append(("(768, 30522) overflow", *pair((768, 30522), 0.05)))
    out.append(("(257, 33) overflow", *pair((257, 33), 0.05)))
    return out


def check_kernels(gen):
    """Hold every kernel against its plain version and its numpy twin.

    Returns {kernel: largest |kernel - plain or twin| over all cases}."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.chain_apply import chain_apply_flat
    from repro_torch.kernels.delta_quantize import (delta_quantize_flat,
                                                    dequant_apply_flat)
    from repro_torch.kernels.snapshot_fused import snapshot_fused_flat
    from repro_torch.store.delta import host_dequant, host_snapshot

    scale = np.float32(ref.quant_scale(EPS))
    errs = {k: 0.0 for k in ("snapshot_fused", "delta_quantize",
                             "dequant_apply", "chain_apply")}
    bad = []

    def hold(kernel, label, got, plain, twin):
        errs[kernel] = max(errs[kernel], max_abs(got, plain),
                           max_abs(got.cpu(), twin))
        if not same_bits(got, plain):
            bad.append(f"{kernel} {label}: differs from its plain version")
        if not same_bits(got.cpu(), twin):
            bad.append(f"{kernel} {label}: differs from the numpy twin")

    for label, p1, p2 in kernel_cases(gen):
        h1, h2 = p1.cpu().numpy(), p2.cpu().numpy()
        q32_np = np.floor((h1 - h2) / scale + np.float32(0.5)).astype(np.int32)
        q8, zeros, ovf = snapshot_fused_flat(p1, p2, EPS)
        q8_p, zeros_p, ovf_p = ref.snapshot_fused_ref(p1, p2, EPS)
        hold("snapshot_fused", label, q8, q8_p,
             torch.from_numpy(np.clip(q32_np, -127, 127).astype(np.int8)))
        counts = (int(zeros), int(ovf))
        twin_counts = (int((q32_np == 0).sum()),
                       int((np.abs(q32_np) > 127).sum()))
        if counts != (int(zeros_p), int(ovf_p)) or counts != twin_counts:
            bad.append(f"snapshot_fused {label}: counts {counts} vs plain "
                       f"{(int(zeros_p), int(ovf_p))} vs twin {twin_counts}")
        _, tnz, narrow = host_snapshot(h1, h2, EPS)
        if narrow != (counts[1] == 0) or tnz != counts[0]:
            bad.append(f"snapshot_fused {label}: host_snapshot disagrees")
        if "overflow" in label and counts[1] == 0:
            bad.append(f"{label}: the delta did not overflow int8")

        q, nz = delta_quantize_flat(p1, p2, EPS)
        q_p, nz_p = ref.delta_quantize_ref(p1, p2, EPS)
        hold("delta_quantize", label, q, q_p, torch.from_numpy(q32_np))
        if int(nz) != int(nz_p) or int(nz) != twin_counts[0]:
            bad.append(f"delta_quantize {label}: zero count {int(nz)} vs "
                       f"{int(nz_p)} vs {twin_counts[0]}")

        out = dequant_apply_flat(p1, q, EPS)
        out_p = ref.dequant_apply_ref(p1, q, EPS, out_dtype=torch.float32)
        hold("dequant_apply", label, out, out_p,
             torch.from_numpy(host_dequant(h1, q32_np, EPS)))

        # a three-hop fold: the kernel sums the int32 stack in registers
        qs = torch.stack([q, -(q // 2), q // 3]).contiguous()
        chained = chain_apply_flat(p1, qs, EPS)
        chained_p = ref.chain_apply_ref(p1, qs, EPS)
        qsum = qs.sum(dim=0, dtype=torch.int32).cpu().numpy()
        hold("chain_apply", label, chained, chained_p,
             torch.from_numpy(host_dequant(h1, qsum, EPS)))
    torch.cuda.synchronize()
    for line in bad:
        print(f"MISMATCH {line}", flush=True)
    if bad:
        fail(f"{len(bad)} kernel checks failed")
    print("kernels: all four equal their plain versions and numpy twins bit "
          "for bit", flush=True)
    return errs


def time_kernels(gen):
    """Kernel and plain-version milliseconds at the main path's largest
    shapes, with the bound each could reach on an H100 SXM."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.chain_apply import chain_apply_flat
    from repro_torch.kernels.delta_quantize import (delta_quantize_flat,
                                                    dequant_apply_flat)
    from repro_torch.kernels.snapshot_fused import snapshot_fused_flat

    def pair(shape, scale):
        p2 = torch.randn(shape, generator=gen, device="cuda") * 0.036
        return p2 + torch.randn(shape, generator=gen, device="cuda") * scale, p2

    w1, w2 = pair((12, 768, 3072), 1e-4)      # layers/mlp/w_in: the largest
    h1, h2 = pair((768, 30522), 0.05)          # lm_head re-initialised
    q_w, _ = delta_quantize_flat(w1, w2, EPS)
    qs3 = torch.stack([q_w, q_w, q_w]).contiguous()   # ft3's 3-hop fold
    n_w, n_h = w1.numel(), h1.numel()
    rows = {
        "snapshot_fused": (
            lambda: snapshot_fused_flat(w1, w2, EPS),
            lambda: ref.snapshot_fused_ref(w1, w2, EPS),
            9 * n_w, 4 * n_w, "(12, 768, 3072) f32"),
        "delta_quantize": (
            lambda: delta_quantize_flat(h1, h2, EPS),
            lambda: ref.delta_quantize_ref(h1, h2, EPS),
            12 * n_h, 4 * n_h, "(768, 30522) f32"),
        "dequant_apply": (
            lambda: dequant_apply_flat(w1, q_w, EPS),
            lambda: ref.dequant_apply_ref(w1, q_w, EPS),
            12 * n_w, 2 * n_w, "(12, 768, 3072) f32 + int32"),
        "chain_apply": (
            lambda: chain_apply_flat(w1, qs3, EPS),
            lambda: ref.chain_apply_ref(w1, qs3, EPS),
            (8 + 4 * 3) * n_w, 2 * n_w, "(12, 768, 3072) f32 + 3 x int32"),
    }
    out = {}
    for name, (kernel, plain, nbytes, flops, shape) in rows.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_OPS_PER_S * 1e3
        out[name] = {
            "ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 5),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "shape": shape}
    return out


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def make_lineage(cfg, seed: int):
    """{node: flat f32 numpy params}: random paper-bert weights from a
    seeded torch.Generator, three sparse finetunes, and task-head (ft1
    with lm_head re-initialised)."""
    import numpy as np
    import torch

    from repro_torch.convert import to_numpy
    from repro_torch.models import init_params

    gen = torch.Generator().manual_seed(seed)
    base = {k: to_numpy(v) for k, v in init_params(cfg, generator=gen).items()}

    def finetune(parent, scale):
        out = {}
        for k, v in parent.items():
            t = torch.from_numpy(v)
            noise = torch.randn(t.shape, generator=gen) * scale
            keep = torch.rand(t.shape, generator=gen) < 0.3
            out[k] = (t + noise * keep).numpy()
        return out

    params = {"base": base}
    params["ft1"] = finetune(base, 5e-5)
    params["ft2"] = finetune(params["ft1"], 1e-4)
    params["ft3"] = finetune(params["ft2"], 7e-5)
    head = dict(params["ft1"])
    shape = head["lm_head"].shape
    head["lm_head"] = (torch.randn(shape, generator=gen)
                       / np.sqrt(shape[0])).numpy()
    params["task-head"] = head
    return params


def commit_lineage(root, arch, params, **store_kw):
    """Commit the lineage through LineageGraph + ArtifactStore; return the
    store."""
    from repro_torch.convert import to_artifact
    from repro_torch.core import LineageGraph
    from repro_torch.store import ArtifactStore

    store = ArtifactStore(root=root, **store_kw)
    graph = LineageGraph(path=root, store=store)
    graph.add_node(to_artifact(params["base"], arch), "base")
    for parent, child in (("base", "ft1"), ("ft1", "ft2"), ("ft2", "ft3")):
        graph.add_node(None, child, model_type=arch)
        graph.add_version_edge(parent, child)
        graph.add_node(to_artifact(params[child], arch), child)
    graph.add_node(None, "task-head", model_type=arch)
    graph.add_edge("ft1", "task-head")
    graph.add_node(to_artifact(params["task-head"], arch), "task-head")
    return store


def check_out(root, nodes, **store_kw):
    """Reopen the repository in a fresh store and lineage; materialize
    ``nodes``. Returns (store, refs, {node: {key: array}})."""
    from repro_torch.core import LineageGraph
    from repro_torch.store import ArtifactStore

    store = ArtifactStore(root=root, **store_kw)
    graph = LineageGraph(path=root, store=store)
    refs = {n: graph.nodes[n].artifact_ref for n in graph.nodes}
    out = {n: dict(store.materialize_artifact(refs[n]).params) for n in nodes}
    return store, refs, out


def verify(label, store, refs, out, params, reference=None):
    """Hash-exact checkouts, agreement with a reference checkout and with
    the live weights, and a clean fsck."""
    import numpy as np

    from repro_torch.common.hashing import tensor_hash
    from repro_torch.kernels.ref import quant_scale

    bound = float(np.float32(quant_scale(EPS)))
    worst = 0.0
    for node, tensors in out.items():
        manifest = store.get_manifest(refs[node])
        if set(tensors) != set(manifest["params"]):
            fail(f"{label}: {node} checked out other params than committed")
        for key, value in tensors.items():
            value = np.asarray(value)
            live = params[node][key]
            if value.shape != live.shape or value.dtype != np.float32:
                fail(f"{label}: {node}:{key} is {value.dtype}{value.shape}")
            if not np.isfinite(value).all():
                fail(f"{label}: {node}:{key} has non-finite values")
            if tensor_hash(value) != manifest["params"][key]["hash"]:
                fail(f"{label}: {node}:{key} does not match its manifest hash")
            if reference is not None and not np.array_equal(
                    value.view(np.int32), np.asarray(reference[node][key])
                    .view(np.int32)):
                fail(f"{label}: {node}:{key} differs from the host checkout")
            err = float(np.abs(value.astype(np.float64) - live).max())
            worst = max(worst, err)
            if err > bound:
                fail(f"{label}: {node}:{key} is {err} from the live weights "
                     f"(bound {bound})")
    report = store.fsck(list(refs.values()))
    if not report["ok"]:
        fail(f"{label}: fsck is not clean: "
             f"{ {k: report[k] for k in ('corrupt', 'missing_objects', 'refcount_drift')} }")
    print(f"{label}: checkouts hash-exact, max |checkout - live| = {worst} "
          f"(bound {bound}), fsck clean", flush=True)


def wrappers():
    from repro_torch.kernels.chain_apply import chain_apply_flat
    from repro_torch.kernels.delta_quantize import (delta_quantize_flat,
                                                    dequant_apply_flat)
    from repro_torch.kernels.snapshot_fused import snapshot_fused_flat
    return {"snapshot_fused": snapshot_fused_flat,
            "delta_quantize": delta_quantize_flat,
            "dequant_apply": dequant_apply_flat,
            "chain_apply": chain_apply_flat}


def main_path(cfg, params, workdir, card):
    """Phase 4: whole-tensor lineage on the card. Returns launch counts."""
    import torch

    root = os.path.join(workdir, "whole")
    counted = wrappers()
    for w in counted.values():
        w.launches = 0
    t0 = time.perf_counter()
    store = commit_lineage(root, cfg.name, params, chunk_threshold=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    store2, refs, out = check_out(root, CHECKOUT, chunk_threshold=0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: w.launches for k, w in counted.items()}
    print(f"main path: commit {t1 - t0:.3f} s, checkout of "
          f"{'+'.join(CHECKOUT)} {t2 - t1:.3f} s, compression ratio "
          f"{store.compression_ratio():.3f}, launches {json.dumps(launches)} "
          f"({card})", flush=True)
    _, _, host = check_out(root, CHECKOUT, chunk_threshold=0, backend="ref")
    verify("main path", store2, refs, out, params, reference=host)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        fail(f"main path launched no {', '.join(missing)} kernel")
    return launches


def chunked_path(cfg, params, workdir):
    """Phase 5: the same lineage with the default chunk threshold."""
    root = os.path.join(workdir, "chunked")
    t0 = time.perf_counter()
    store = commit_lineage(root, cfg.name, params)
    t1 = time.perf_counter()
    store2, refs, out = check_out(root, CHECKOUT)
    t2 = time.perf_counter()
    kinds = {}
    for e in store2.get_manifest(refs["ft3"])["params"].values():
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    print(f"chunked path: commit {t1 - t0:.3f} s, checkout {t2 - t1:.3f} s, "
          f"compression ratio {store.compression_ratio():.3f}, ft3 entries "
          f"{json.dumps(kinds)}", flush=True)
    if "chunked" not in kinds:
        fail("chunked path: no tensor took the chunk engine")
    _, _, host = check_out(root, CHECKOUT, backend="ref")
    verify("chunked path", store2, refs, out, params, reference=host)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.models import get_config

    # phase 1: device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card}; {torch.cuda.device_count()} visible; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # phase 2: build, one nvcc per source, all at once
    t0 = time.perf_counter()
    seconds = build.build()
    print(f"build: {time.perf_counter() - t0:.3f} s wall "
          f"({json.dumps({k: round(v, 3) for k, v in seconds.items()})})",
          flush=True)
    for name in build.SOURCES:
        log = (build.build_dir() / f"{name}.log").read_text().strip()
        print(f"ptxas {name}: {' | '.join(log.splitlines()[-4:])}", flush=True)

    # phase 3: kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    errs = check_kernels(gen)
    timing = time_kernels(gen)

    # phases 4 and 5: the main path at full width
    cfg = dataclasses.replace(get_config("paper-bert"), dtype="float32")
    t0 = time.perf_counter()
    params = make_lineage(cfg, args.seed)
    n_params = sum(v.size for v in params["base"].values())
    print(f"lineage: {cfg.name} f32, {n_params} params per model, "
          f"{len(NODES)} models, made in {time.perf_counter() - t0:.3f} s",
          flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip-smoke-",
                               dir=os.path.join(ROOT, "build"))
    try:
        launches = main_path(cfg, params, workdir, card)
        chunked_path(cfg, params, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    replaces = {
        "snapshot_fused": ("snapshot_fused.cu",
                           "src/repro/kernels/snapshot_fused.py:73"),
        "delta_quantize": ("delta_quantize.cu",
                           "src/repro/kernels/delta_quantize.py:55"),
        "dequant_apply": ("delta_quantize.cu",
                          "src/repro/kernels/delta_quantize.py:86"),
        "chain_apply": ("chain_apply.cu",
                        "src/repro/kernels/chain_apply.py:60"),
    }
    kernels = []
    for name, (source, where) in replaces.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{SRC}/{source}",
            "replaces": where, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": t["shape"]})
    for k in kernels:
        print(f"kernel {k['name']}: {k['ms']:.4f} ms at {k['shape']} "
              f"(bound {k['bound_ms']:.4f} ms, plain {k['plain_ms']:.4f} ms), "
              f"{k['launches']} launches on the main path", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
