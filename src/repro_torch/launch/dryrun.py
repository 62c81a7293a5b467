"""Dry run of every arch × shape cell on one H100, through meta tensors.

    python -m repro_torch.launch.dryrun [--arch A,B|all] [--shape S|all]
        [--out experiments/dryrun_torch.json] [--force]
        [--microbatches N] [--remat none|dots|full] [--jobs N]

The counterpart of the reference package's ``repro/launch/dryrun.py``,
which lowers and compiles each cell for a TPU mesh. Here each cell's step
runs once on ``torch.device("meta")`` inputs (``launch/shapes.py``): a
meta tensor has a shape and a dtype but no data, so the step allocates
nothing, computes nothing, and full-size configs run on any host. For
each cell it records:

* FLOPs, from ``torch.utils.flop_counter.FlopCounterMode`` over the step
  (forward and backward of a train step, ``prefill``, one
  ``decode_step``), split by the operands' dtype; flash attention counts
  through the formula its operator registers;
* bytes by kind: parameters, optimizer state, gradients, cache, batch,
  the activations a train step keeps for its backward pass (the saved
  tensors that ``torch.autograd.graph.saved_tensors_hooks`` sees, and all
  the bytes alive when the backward pass starts, which also holds what a
  checkpointed layer keeps), and the peak of live bytes (``LiveBytes``);
* ``fits``: whether that peak, plus ``HEADROOM_BYTES``, fits the card's
  memory, and the largest batch (a train cell: the largest microbatch)
  that does;
* roofline terms at the H100 SXM's rates: FLOPs over the dtype's peak,
  and the step's inputs read once and new outputs written once over the
  memory rate; the larger is ``bound_s``, the least time the card could
  take.

A train cell's step runs two of its microbatches. Every microbatch has the
same shapes, so its FLOPs are one microbatch's times the count, exactly,
and the live bytes after the second repeat those of the second but for
the step's record of each microbatch's loss (under 1 KiB each). The
numbers are predictions computed on the host; ``chip_smoke.py`` phase 11
holds some of them against runs on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.common.tree import leaves
from repro_torch.launch.shapes import (SHAPES, ShapeCell, cell_inputs,
                                       cell_supported)
from repro_torch.models.config import ModelConfig, get_config
from repro_torch.models.model import param_shapes

# H100 SXM, NVIDIA's data sheet (dense rates). float32 products run outside
# the tensor cores: the port turns TF32 off (chip_smoke.py).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
HBM_BW = 3.35e12
CARD = "NVIDIA H100 80GB HBM3"
# torch.cuda.get_device_properties(0).total_memory of an H100 80GB HBM3
# at 700 W (PyTorch 2.11, CUDA 12.8); used when the dry run runs without
# a card
CARD_BYTES = 85_017_493_504
# kept free of the model's tensors: the CUDA context, cuBLAS workspaces,
# and the caching allocator's rounding and fragmentation
HEADROOM_BYTES = 4 * 2**30

ARCHS = [
    "starcoder2-15b", "yi-6b", "qwen3-0.6b", "deepseek-coder-33b",
    "seamless-m4t-large-v2", "mamba2-780m", "llama4-scout-17b-16e",
    "mixtral-8x7b", "jamba-1.5-large-398b", "paligemma-3b",
]


def count_params(cfg: ModelConfig) -> int:
    return int(sum(int(np.prod(s)) for s in param_shapes(cfg).values()))


def count_active_params(cfg: ModelConfig) -> int:
    """Per-token active parameters (MoE: top-k + shared experts only)."""
    total = 0
    for path, shape in param_shapes(cfg).items():
        n = int(np.prod(shape))
        if "/moe/w_" in path and "shared" not in path:
            n = n * cfg.experts_per_token // max(cfg.n_experts, 1)
        total += n
    return total


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """Analytic MODEL_FLOPS for the cell (6·N·D train, 2·N·D fwd-only)."""
    n_active = count_active_params(cfg)
    if cell.kind == "train":
        return 6.0 * n_active * cell.batch * cell.seq
    if cell.kind == "prefill":
        return 2.0 * n_active * cell.batch * cell.seq
    return 2.0 * n_active * cell.batch  # decode: one token per sequence


def build_step(cfg: ModelConfig, cell: ShapeCell):
    """(fn, argument names) of the cell's step, the port's own functions:
    the train step, ``prefill`` to the cell's length, or one
    ``decode_step`` at the cache's last slot."""
    if cell.kind == "train":
        from repro_torch.train.step import make_train_step
        return (make_train_step(cfg, n_microbatches=cell.microbatches),
                ("state", "batch"))
    if cell.kind == "prefill":
        from repro_torch.models.model import prefill
        return (lambda params, batch: prefill(cfg, params, batch,
                                              max_len=cell.seq),
                ("params", "batch"))
    from repro_torch.models.model import decode_step
    return (lambda params, token, cache, pos: decode_step(
        cfg, params, token, cache, cell.seq - 1),
        ("params", "token", "cache", "pos"))


def _nbytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


class LiveBytes(TorchDispatchMode):
    """The bytes of tensor storages alive, op by op, and their peak.

    ``resident`` are the tensors alive before the step (its inputs). Each
    op's outputs add the bytes of every storage not seen yet, and a
    storage's bytes come off when it is freed; views and in-place results
    share a storage already counted and add nothing. This is the caching
    allocator's count without its rounding, and the counterpart of XLA's
    argument + output + temp - alias. The mode also counts FLOPs by dtype
    with ``FlopCounterMode``'s formulas, and serves as the
    ``saved_tensors_hooks`` pair that counts saved activations."""

    def __init__(self, resident, count_flops: bool = True):
        super().__init__()
        self.count_flops = count_flops
        self._sizes: Dict[int, int] = {}
        self.live = self.peak = 0
        self.resident = set()
        for t in resident:
            st = t.untyped_storage()
            self.resident.add(id(st))
            self._add(st)
        self.start = self.peak = self.live
        self.flops_by_dtype: Dict[str, int] = defaultdict(int)
        self._saved: Dict[int, int] = {}
        self.backward_live: Optional[int] = None

    def _add(self, st) -> None:
        key = id(st)
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = (flop_registry.get(func._overloadpacket)
                   if self.count_flops else None)
        if formula is not None:
            dtype = next(a.dtype for a in tree_leaves((args, kwargs))
                         if isinstance(a, torch.Tensor))
            self.flops_by_dtype[str(dtype).removeprefix("torch.")] += \
                formula(*args, **kwargs, out_val=out)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t.untyped_storage())
        return out

    def pack(self, t: torch.Tensor) -> torch.Tensor:
        if self.backward_live is None:   # the first forward pass only
            st = t.untyped_storage()
            if id(st) not in self.resident:
                self._saved[id(st)] = st.nbytes()
        return t

    def unpack(self, t: torch.Tensor) -> torch.Tensor:
        if self.backward_live is None:
            self.backward_live = self.live
        return t

    @property
    def saved_bytes(self) -> int:
        return sum(self._saved.values())


def measure(fn: Callable, args: Tuple, flops: bool = True
            ) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under ``FlopCounterMode`` and ``LiveBytes``.

    Returns the FLOPs (total and by dtype), the peak and start of live
    bytes, the saved and live activation bytes of a backward pass (None
    without one), the bytes of the outputs in new storages and of those
    that alias an input, and the seconds on the host. ``flops=False``
    counts bytes only (FLOPs None), a third faster."""
    inputs = [t for t in leaves(list(args)) if isinstance(t, torch.Tensor)]
    tracker = LiveBytes(inputs, count_flops=flops)
    counter = (FlopCounterMode(display=False) if flops
               else contextlib.nullcontext())
    t0 = time.perf_counter()
    with tracker, counter, torch.autograd.graph.saved_tensors_hooks(
            tracker.pack, tracker.unpack):
        out = fn(*args)
    seconds = time.perf_counter() - t0
    total = counter.get_total_flops() if flops else None
    if flops and total != sum(tracker.flops_by_dtype.values()):
        raise RuntimeError(f"FLOPs by dtype {dict(tracker.flops_by_dtype)} "
                           f"do not add up to FlopCounterMode's {total}")
    outs = {}
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            outs[id(st)] = st.nbytes()
    new = sum(n for k, n in outs.items() if k not in tracker.resident)
    return {"flops": total,
            "flops_by_dtype": dict(tracker.flops_by_dtype) if flops else None,
            "peak_bytes": tracker.peak, "argument_bytes": tracker.start,
            "output_bytes": new, "alias_bytes": sum(outs.values()) - new,
            "saved_bytes": tracker.saved_bytes if tracker.backward_live
            is not None else None,
            "backward_live": tracker.backward_live, "seconds": seconds}


def _cell_args(cfg: ModelConfig, cell: ShapeCell, arch: str):
    """The step's inputs. A train cell gets two of its microbatches (see
    the module's docstring)."""
    measured = cell
    if cell.kind == "train" and cell.microbatches > 2:
        measured = dataclasses.replace(
            cell, batch=2 * (cell.batch // cell.microbatches), microbatches=2)
    specs = cell_inputs(cfg, measured, arch)
    fn, order = build_step(cfg, measured)
    return measured, fn, specs, tuple(specs[k] for k in order)


def _with_batch(cell: ShapeCell, batch: int) -> ShapeCell:
    """``cell`` at ``batch`` (a train cell: microbatch ``batch``)."""
    return dataclasses.replace(cell, batch=batch * (
        cell.microbatches if cell.kind == "train" else 1))


MAX_SEARCH_BATCH = 2**16


def largest_batch(peak: Callable[[int], int], limit: int,
                  known: Dict[int, int]) -> int:
    """The largest batch whose peak is at most ``limit`` (0 if batch 1
    does not fit; at most ``MAX_SEARCH_BATCH``).

    Where the peak grows with the batch it is close to affine, so batches
    1 and 2 place a guess, and a step above it confirms it. Where it does
    not grow yet (a train step whose peak is the optimizer update's, which
    no batch moves, until the activations pass it), the search doubles the
    batch. A bisection settles what is left. ``known`` caches {batch:
    peak}."""
    def fits(b):
        if b not in known:
            known[b] = peak(b)
        return known[b] <= limit
    if not fits(1):
        return 0
    lo, hi = 1, None                       # fits(lo); not fits(hi)
    if fits(2):
        lo = 2
        slope = known[2] - known[1]
        if slope > known[1] // 1000:
            guess = min(MAX_SEARCH_BATCH,
                        max(2, (limit - (known[1] - slope)) // slope))
            if fits(guess):
                lo = guess
            else:
                hi = guess
    else:
        hi = 2
    step = 1
    while hi is None:
        b = min(lo + step, MAX_SEARCH_BATCH)
        if fits(b):
            if b == MAX_SEARCH_BATCH:
                return b
            lo, step = b, step * 2
        else:
            hi = b
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo


def card_memory() -> Tuple[int, str]:
    """(bytes, card name) of device 0, or the H100 80GB's constant when
    this host has no card."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_properties(0).total_memory,
                torch.cuda.get_device_name(0))
    return CARD_BYTES, f"{CARD} (constant, no card on this host)"


def _bytes_by_kind(cfg, cell, specs, m) -> Dict[str, Optional[int]]:
    from repro_torch.models.model import cache_shapes
    out: Dict[str, Optional[int]] = {
        "params": 0, "optimizer": 0, "gradients": 0, "cache": 0, "batch": 0,
        "activations_saved": None, "activations_live": None}
    if cell.kind == "train":
        state = specs["state"]
        out["params"] = _nbytes(leaves(state["params"]))
        out["optimizer"] = _nbytes(leaves(state["opt"]))
        n = sum(t.numel() for t in leaves(state["params"]))
        accum = 4 * n if cell.microbatches > 1 else 0
        out["gradients"] = out["params"] + accum
        out["batch"] = _nbytes(leaves(specs["batch"]))
        out["activations_saved"] = m["saved_bytes"]
        out["activations_live"] = (m["backward_live"] - m["argument_bytes"]
                                   - accum)
        return out
    out["params"] = _nbytes(leaves(specs["params"]))
    if cell.kind == "prefill":
        out["batch"] = _nbytes(leaves(specs["batch"]))
        prefix = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
        enc = cell.seq if cfg.family in ("encdec", "audio") else 0
        out["cache"] = sum(
            int(np.prod(s)) * torch.empty((), dtype=d).element_size()
            for s, d in cache_shapes(cfg, cell.batch, cell.seq + prefix,
                                     enc).values())
    else:
        out["batch"] = _nbytes([specs["token"]])
        out["cache"] = _nbytes(leaves(specs["cache"]))
    return out


def run_cell(arch: str, shape: str, microbatches: Optional[int] = None,
             remat: Optional[str] = None, cfg: Optional[ModelConfig] = None,
             batch: Optional[int] = None, search: bool = True,
             cap: Optional[int] = None,
             capacity: Optional[Tuple[int, str]] = None) -> Dict[str, Any]:
    """Dry-run one cell on meta tensors.

    ``cfg`` overrides the arch's config (a cut depth), ``microbatches``
    the train cell's count, ``batch`` its batch (a train cell's: the
    microbatch). ``search`` finds the largest batch that fits. With
    ``cap`` the cell is reported at the cap when the cap fits (and nothing
    is searched), else at the largest batch that fits (at least 1), as
    ``chip_smoke.py`` runs it. ``capacity`` is (bytes, card name), by
    default ``card_memory()``."""
    cfg = cfg or get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    cell = SHAPES[shape]
    if microbatches is not None:
        cell = dataclasses.replace(
            cell, microbatches=microbatches,
            batch=cell.batch // cell.microbatches * microbatches)
    if batch is not None:
        cell = _with_batch(cell, batch)
    ok, why = cell_supported(cfg, cell)
    result: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": "1xH100",
                              "kind": cell.kind}
    if not ok:
        result.update(status="skipped", reason=why)
        return result
    capacity, device = capacity or card_memory()
    limit = capacity - HEADROOM_BYTES
    runs: Dict[int, Tuple] = {}

    def at(b: int, flops: bool):
        if b not in runs or (flops and runs[b][2]["flops"] is None):
            measured, fn, specs, args = _cell_args(cfg, _with_batch(cell, b),
                                                   arch)
            runs[b] = (measured, specs, measure(fn, args, flops=flops))
        return runs[b]

    def peak(b: int) -> int:     # the search reads peaks only
        return at(b, False)[2]["peak_bytes"]

    per = (cell.batch // cell.microbatches if cell.kind == "train"
           else cell.batch)
    largest = None
    if search and cap is not None and peak(cap) <= limit:
        per = cap
    elif search:
        largest = largest_batch(peak, limit, {})
        if cap is not None:
            per = max(1, min(largest, cap))
    cell = _with_batch(cell, per)
    measured, specs, m = at(per, True)
    scale = cell.microbatches // measured.microbatches   # 1 but for train
    flops = m["flops"] * scale
    flops_by_dtype = {k: v * scale for k, v in m["flops_by_dtype"].items()}
    t_compute = sum(n / PEAK_FLOPS[getattr(torch, k)]
                    for k, n in flops_by_dtype.items())
    moved = m["argument_bytes"] + m["output_bytes"]
    terms = {"compute": t_compute, "memory": moved / HBM_BW}
    mf = model_flops(cfg, cell)
    result.update(
        status="ok", chips=1, device=device, dtype=cfg.dtype,
        n_layers=cfg.n_layers, remat=cfg.remat, batch=cell.batch,
        seq=cell.seq, microbatches=cell.microbatches,
        measured_microbatches=measured.microbatches,
        dryrun_s=round(m["seconds"], 3),
        flops=flops, flops_by_dtype=flops_by_dtype,
        bytes=_bytes_by_kind(cfg, measured, specs, m),
        memory_analysis={
            "argument_bytes": m["argument_bytes"],
            "output_bytes": m["output_bytes"],
            "alias_bytes": m["alias_bytes"],
            "temp_bytes": (m["peak_bytes"] - m["argument_bytes"]
                           - m["output_bytes"] + m["alias_bytes"]),
            "peak_bytes_estimate": m["peak_bytes"]},
        peak_bytes=m["peak_bytes"], capacity_bytes=capacity,
        headroom_bytes=HEADROOM_BYTES,
        fits=m["peak_bytes"] <= limit,
        largest_batch=largest,
        largest_batch_of=("microbatch" if cell.kind == "train"
                          else "batch"),
        peaks_by_batch={b: r[2]["peak_bytes"] for b, r in sorted(runs.items())},
        roofline={**terms, "dominant": max(terms, key=terms.get),
                  "bound_s": max(terms.values()), "bytes_moved": moved},
        model_flops=mf,
        useful_flops_ratio=(mf / flops if flops else None),
        params=count_params(cfg), active_params=count_active_params(cfg),
        note=("predicted on the host from meta tensors; rates of an "
              "H100 SXM (989 TFLOP/s bf16/f16, 67 TFLOP/s f32, 3.35 TB/s)"),
    )
    return result


def _run_job(job: Tuple[str, str, Dict[str, Any]]) -> Dict[str, Any]:
    """``run_cell(arch, shape, **kwargs)`` with its host seconds, a
    failure recorded as the cell's result."""
    arch, shape, kwargs = job
    t0 = time.perf_counter()
    try:
        r = run_cell(arch, shape, **kwargs)
    except Exception as e:  # record the failure, keep sweeping
        r = {"arch": arch, "shape": shape, "mesh": "1xH100",
             "status": "error", "error": f"{type(e).__name__}: {e}",
             "traceback": traceback.format_exc()[-2000:]}
    r["cell_s"] = round(time.perf_counter() - t0, 3)
    return r


def run_cells(jobs, processes: int = 1):
    """(index, result) of ``_run_job`` for each (arch, shape, kwargs) of
    ``jobs``, as each ends; with ``processes`` > 1, that many cells at a
    time, each in its own spawned process (a meta run is host work on one
    core)."""
    if processes <= 1:
        for i, job in enumerate(jobs):
            yield i, _run_job(job)
        return
    import concurrent.futures as cf
    import multiprocessing as mp
    with cf.ProcessPoolExecutor(
            processes, mp_context=mp.get_context("spawn")) as ex:
        futures = {ex.submit(_run_job, job): i for i, job in enumerate(jobs)}
        for fut in cf.as_completed(futures):
            yield futures[fut], fut.result()


def summary(r: Dict[str, Any]) -> str:
    """One line for a cell's result."""
    if r.get("status") != "ok":
        return r.get("status", "?") + " " + r.get("reason",
                                                  r.get("error", ""))[:120]
    rt = r["roofline"]
    return (f"fits={r['fits']} largest_{r['largest_batch_of']}="
            f"{r['largest_batch']} peak={r['peak_bytes'] / 1e9:.3f}GB "
            f"bound={rt['bound_s'] * 1e3:.3f}ms dominant={rt['dominant']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in its own process")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results: Dict[str, Any] = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)
    todo = []
    for arch in archs:
        for shape in shapes:
            key = f"{arch}|{shape}|1xH100"
            if (key in results
                    and results[key].get("status") in ("ok", "skipped")
                    and args.microbatches is None and args.remat is None):
                print(f"[cached] {key}", flush=True)
            else:
                todo.append(key)

    kw = dict(microbatches=args.microbatches, remat=args.remat)
    jobs = [(*key.split("|")[:2], kw) for key in todo]
    for i, r in run_cells(jobs, args.jobs):
        results[todo[i]] = r
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"[done]   {todo[i]} -> {summary(r)} ({r['cell_s']} s)",
              flush=True)
    n = {s: sum(1 for r in results.values() if r.get("status") == s)
         for s in ("ok", "skipped", "error")}
    print(f"done: {n['ok']} ok, {n['skipped']} skipped, {n['error']} errors "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
