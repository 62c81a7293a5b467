"""The lineage generator: commit finetune-like derivatives, check versions out.

Set-up commits the base. Each round of the window makes derivative ``r``
(on the device, from the seed), commits it against its parent
(``ArtifactStore.commit_artifact``, durable as the store makes it), then
checks out one committed version through a fresh store handle on the same
repository (``materialize_artifact``; the handle's caches are cold, as in a
new ``mgit`` process). The version is drawn from the seed among those
committed at the depth just committed. The mix's parameters:

* ``base_every``: derivative ``r``'s parent is the base when ``r`` is a
  multiple of it, else derivative ``r - 1``, so chains reach that depth;
  rounds run in whole cycles of ``base_every``, until the window's
  seconds have passed, so that every run commits and checks out each depth
  equally often, however many cycles fit (a commit or checkout costs more
  the deeper its chain);
* ``store``: keyword arguments of ``ArtifactStore`` besides its defaults.

After the window every leaf of every checkout is compared, bit for bit,
with the NumPy Algorithm-1 reconstruction of the same base and
derivatives (``reference/algorithm1.py``). A control run (``--control
1``) puts, before that check, the reference's reconstruction one
precision lower in the store's place.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np

from mgitbench import common
from mgitbench.harness import Run, Window
from mgitbench.reference import algorithm1
from mgitbench.weights import Weights, derive_seed

STORAGE_KERNELS = ("delta_quantize", "snapshot_fused", "chain_apply")


def disk_bytes(root) -> int:
    total = 0
    for d, _, files in os.walk(root):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(d, f))
            except FileNotFoundError:
                pass
    return total


def _warm(run: Run) -> None:
    """One launch of each storage kernel, so that the window loads
    nothing."""
    if run.device != "cuda":
        return
    from repro_torch.kernels import ops
    a = np.linspace(-1, 1, 4096, dtype=np.float32)
    q, _, _, _ = ops.snapshot_fused(a, a * 0.5, with_fingerprint=False)
    ops.dequant_apply(a, q)
    ops.chain_apply(a, [q, q])
    ops.delta_quantize(a, a * 0.5)


def drive(run: Run, t_start: float) -> None:
    import torch
    from repro_torch.convert import to_artifact
    from repro_torch.store import ArtifactStore

    t = run.traffic
    every = int(t["base_every"])
    kind = run.model["name"]
    common.build_kernels(run, STORAGE_KERNELS)
    _warm(run)
    weights = Weights(run.config, run.seed, run.device)
    base = weights.base()
    root = str(run.scratch / "repo")
    store_kw = dict(t.get("store", {}), backend=run.backend)
    store = ArtifactStore(root=root, **store_kw)
    refs = {"base": store.commit_artifact("base", to_artifact(base, kind))}
    depth = {"base": 0}
    rng = np.random.default_rng(derive_seed(run.seed, 3))
    if run.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_start

    commits, checkouts, outputs = [], [], []
    parent_weights = None
    with Window(run) as win:
        r = 0
        while r % every or time.perf_counter() < win.deadline:
            name = f"d{r}"
            parent = "base" if r % every == 0 else f"d{r - 1}"
            with win.span("lineage.make_derivative"):
                child = weights.derive(base if parent == "base" else
                                       parent_weights, r)
                artifact = to_artifact(child, kind)
                nbytes = artifact.nbytes()
                disk0 = disk_bytes(root)
            run.attempted += 1
            with win.span("lineage.commit"):
                t0 = time.perf_counter()
                refs[name] = store.commit_artifact(name, artifact,
                                                   refs[parent])
                t1 = time.perf_counter()
            depth[name] = depth[parent] + 1
            commits.append({"name": name, "parent": parent, "bytes": nbytes,
                            "s": t1 - t0,
                            "disk": disk_bytes(root) - disk0})
            del artifact
            parent_weights = child
            pick = [v for v in refs if v != "base" and
                    depth[v] == depth[name]]
            version = pick[int(rng.integers(len(pick)))]
            run.attempted += 1
            with win.span("lineage.checkout"):
                t0 = time.perf_counter()
                fresh = ArtifactStore(root=root, **store_kw)
                params = dict(fresh.materialize_artifact(
                    refs[version]).params)
                t1 = time.perf_counter()
            del fresh
            checkouts.append({"version": version, "s": t1 - t0,
                              "bytes": sum(np.asarray(v).nbytes
                                           for v in params.values())})
            outputs.append((version, params))
            r += 1
    run.records = {"commits": commits, "checkouts": checkouts}
    if run.device == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del store, base, parent_weights, child
    gc.collect()
    if run.control:
        outputs = control_outputs(run, commits, outputs)
    check(run, commits, outputs)


def replay(run: Run, commits, precision=None) -> algorithm1.Lineage:
    """The reference's stored values of every committed version, from the
    base and the derivatives made again from the seed."""
    weights = Weights(run.config, run.seed, run.device)
    base = weights.base()
    ref = algorithm1.Lineage(precision=precision)
    ref.commit_base("base", common.host_weights(base))
    prev = None
    for r, c in enumerate(commits):
        child = weights.derive(base if c["parent"] == "base" else prev, r)
        ref.commit(c["name"], c["parent"], common.host_weights(child))
        prev = child
    return ref


def control_precision(run: Run) -> str:
    return "bfloat16" if run.model["dtype"] == "float32" else "float8_e4m3"


def control_outputs(run: Run, commits, outputs):
    """The control in the store's place: each checkout's leaves as the
    reference works them out one precision lower."""
    low = replay(run, commits, control_precision(run))
    return [(version, {k: low.stored(version, k) for k in params})
            for version, params in outputs]


def check(run: Run, commits, outputs) -> None:
    """Every leaf of every checkout, bit for bit, against the reference."""
    ref = replay(run, commits)
    bad = leaves = 0
    for version, params in outputs:
        want = ref.versions[version]
        for key in set(want) | set(params):
            leaves += 1
            if key not in want:
                bad += int(np.asarray(params[key]).size)
                continue
            if key not in params:
                bad += int(want[key].value.size)
                continue
            bad += algorithm1.mismatches(params[key], want[key].value)
    run.check("checkout_bits_differing", bad, 0)
    run.records["leaves_compared"] = [{"n": leaves}]
