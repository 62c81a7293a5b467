"""Continuous checkpointing — MGit versioning at training speed (§15).

Every ``save(step, state)`` cut becomes a *version node* in a lineage graph
whose storage flows through the step-delta commit engine
(:meth:`ArtifactStore.commit_step`): consecutive training states differ by
one optimizer excursion, so each commit moves only the changed leaves and
stores them as deltas against the previous step's committed truth.

A train state is a nested container of tensors (dicts, NamedTuples such as
``OptState``, lists), flattened in the reference package's
``jax.tree_util`` order into ``/``-joined paths (``params/embed/tok``,
``opt/mu/layers/attn/wq``, ``opt/count``), so both packages commit the
same manifests for the same state.

The manager layers four things over the store engine:

* **fingerprint short-circuit** — leaves of ``fingerprint_min_bytes`` or
  more are fingerprinted before transfer: a CUDA leaf by the fingerprint
  kernel where it lies (8 bytes cross to the host instead of the tensor),
  a CPU leaf by a host CRC pair. A leaf whose fingerprint matches the last
  enqueued snapshot is *skipped*: no host copy, no encode, its manifest
  entry re-references the parent's.
* **tiers** — ``tier="exact"`` (default) stores lossless bitpattern
  deltas; resume is bit-identical. ``tier="lossy"`` stores int8
  error-feedback-grid deltas (``repro_torch.dist.compression.ef_eps``)
  with an unquantized keyframe every ``keyframe_every`` commits;
  intermediate manifests carry ``lossy: true`` and ``restore`` resolves to
  the nearest exact ancestor unless ``allow_lossy``. In the lossy tier
  AdamW second moments (``state_regime == "moment2"``) are committed in
  the log domain (``log1p``/``expm1``).
* **double-buffered async commit** — ``save()`` never blocks on storage:
  one commit may be in flight while one snapshot waits; enqueueing onto
  an occupied slot *coalesces* (the waiting snapshot is replaced by the
  newer one, with skip-sets merged so no stale leaf survives).
* **crash atomicity** — a journal records the in-flight commit; the
  lineage file is written once per commit (fsync'd, atomic), *after* the
  manifest is durable. Recovery on construction rolls back any orphaned
  manifest, so a kill at any point resumes from the previous committed
  step with a clean ``fsck``.

The snapshot is a host copy made before ``save`` returns, so the trainer
may go on and replace or overwrite its tensors; the worker thread never
touches a device tensor. ``restore(template=...)`` puts every leaf on its
template leaf's device, in its dtype and shape.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from typing import Any, Dict, FrozenSet, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import bf16
from repro_torch.common.hashing import tensor_hash
from repro_torch.common.tree import flatten_with_path, unflatten
from repro_torch.convert import to_numpy
from repro_torch.core.lineage import LineageGraph
from repro_torch.kernels import ops
from repro_torch.models.graph import spec_graph, state_graph
from repro_torch.obs import REGISTRY, span
from repro_torch.optim.adamw import state_regime
from repro_torch.store.artifact_store import ArtifactStore

#: Histogram buckets for save()-side blocking time: sub-ms (pure enqueue)
#: through seconds (blocking full snapshot).
_OVERHEAD_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                     0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

#: save()-side blocking seconds per checkpoint cut, labeled by tier.
CKPT_OVERHEAD = {
    tier: REGISTRY.histogram(
        "checkpoint_overhead_seconds",
        help="training-loop blocking time spent in CheckpointManager.save",
        buckets=_OVERHEAD_BUCKETS, tier=tier)
    for tier in ("exact", "lossy")
}

#: Engine accounting, scrapeable as mgit_ckpt_* (DESIGN.md §15).
CKPT_STATS = REGISTRY.group(
    "mgit_ckpt",
    keys=("saves", "commits", "coalesced", "leaves_skipped",
          "leaves_transferred", "journal_rollbacks"),
    help="continuous checkpointing engine accounting")


def _keystr(path) -> str:
    """A flattened path as the reference renders it: entries joined by
    ``/``."""
    return "/".join(str(p) for p in path)


def _host_copy(leaf) -> np.ndarray:
    """A host numpy array of ``leaf`` that shares no memory with it."""
    if isinstance(leaf, torch.Tensor):
        return to_numpy(leaf.detach().to("cpu", copy=True))
    return to_numpy(np.array(leaf))


def flatten_state(state) -> Dict[str, np.ndarray]:
    """Nested state -> flat {path: host ndarray}. Copies from the device."""
    return {_keystr(path): _host_copy(leaf)
            for path, leaf in flatten_with_path(state)}


def _place(value: np.ndarray, leaf) -> Any:
    """``value`` in ``leaf``'s shape and dtype: a tensor on ``leaf``'s
    device when ``leaf`` is a tensor, else a numpy array."""
    value = np.asarray(value)
    if isinstance(leaf, torch.Tensor):
        # a copy: store values may be read-only CAS views
        t = bf16.to_torch(value, copy=True).reshape(tuple(leaf.shape))
        return t.to(device=leaf.device, dtype=leaf.dtype)
    dtype = getattr(leaf, "dtype", None)
    if dtype is not None and bf16.dtype_name(value) != bf16.dtype_name(dtype):
        value = value.astype(dtype)
    shape = getattr(leaf, "shape", None)
    if shape is not None and tuple(value.shape) != tuple(shape):
        value = value.reshape(shape)  # stored scalars are 1-D
    return value


def unflatten_state(template, flat: Dict[str, np.ndarray]):
    """Inverse of flatten_state given a template of the same structure."""
    paths = flatten_with_path(template)
    return unflatten(template, [_place(flat[_keystr(path)], leaf)
                                for path, leaf in paths])


class CheckpointManager:
    def __init__(self, directory: Optional[str], model_name: str = "model",
                 codec: str = "lzma", eps: float = 1e-4,
                 delta_enabled: bool = True, async_save: bool = True,
                 max_chain_depth: int = 8,
                 store: Optional[ArtifactStore] = None,
                 lineage: Optional[LineageGraph] = None,
                 tier: str = "exact", keyframe_every: int = 8,
                 fingerprint_min_bytes: int = 1 << 16,
                 fingerprint_device: Optional[bool] = None,
                 backend: Optional[str] = None) -> None:
        """``backend`` is the store's (``None``: the card, ``"ref"``: the
        host). ``fingerprint_device=None`` fingerprints a CUDA leaf with
        the kernel and a CPU leaf on the host; True and False force the
        device (plain version on the CPU) or the host fingerprint."""
        if tier not in ("exact", "lossy"):
            raise ValueError(f"unknown checkpoint tier {tier!r}")
        self.model_name = model_name
        self.store = store or ArtifactStore(
            root=directory, codec=codec, eps=eps, t_thr=float("inf"),
            delta_enabled=delta_enabled, max_chain_depth=max_chain_depth,
            backend=backend)
        self.lineage = lineage or LineageGraph(path=directory,
                                               store=self.store)
        self.async_save = async_save
        self.tier = tier
        self.keyframe_every = max(1, int(keyframe_every))
        self.fingerprint_min_bytes = int(fingerprint_min_bytes)
        self.fingerprint_device = fingerprint_device
        self._journal_path = (os.path.join(directory, "ckpt_journal.json")
                              if directory else None)
        # double-buffer slots: at most one commit in flight, one pending
        self._cond = threading.Condition()
        self._pending: Optional[tuple] = None
        self._inflight = False
        self._worker: Optional[threading.Thread] = None
        self._worker_dead = True
        self._closed = False
        self._error: Optional[BaseException] = None
        # step-delta engine state (worker-thread owned after __init__)
        self._last_fps: Dict[str, int] = {}
        self._prev_flat: Optional[Dict[str, np.ndarray]] = None
        self._prev_flat_ref: Optional[str] = None
        self._commits = 0
        self._recover_journal()

    # -- naming ----------------------------------------------------------------
    def _node_name(self, step: int) -> str:
        return f"{self.model_name}/step{step}"

    def _steps(self):
        return [
            int(n.rsplit("step", 1)[1]) for n in self.lineage.nodes
            if n.startswith(self.model_name + "/step")
            and self.lineage.nodes[n].artifact_ref is not None
        ]

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return max(steps) if steps else None

    # -- crash recovery ----------------------------------------------------------
    def _journal_write(self, payload: Dict[str, Any]) -> None:
        if self._journal_path is None:
            return
        tmp = self._journal_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._journal_path)

    def _journal_clear(self) -> None:
        if self._journal_path and os.path.exists(self._journal_path):
            os.remove(self._journal_path)

    def _recover_journal(self) -> None:
        """Roll back a commit interrupted between manifest land and the
        lineage pointer move (the lineage file is written once per commit,
        AFTER the manifest is durable)."""
        if not self._journal_path or not os.path.exists(self._journal_path):
            return
        try:
            with open(self._journal_path) as f:
                j = json.load(f)
        except (OSError, ValueError):
            j = {}
        ref = j.get("ref")
        stale = j.get("stale")
        referenced = {n.artifact_ref for n in self.lineage.nodes.values()}
        if ref is not None and ref not in referenced:
            # manifest (possibly partially) landed but lineage never saw
            # it: drop the orphan so refcounts match the reachable graph
            self.store.release(ref)
            self.store.cas.flush()
            CKPT_STATS["journal_rollbacks"] += 1
        elif (ref is not None and stale is not None
              and stale not in referenced):
            # re-commit of an existing step where the lineage DID land on
            # the new manifest: the superseded one is now orphaned, and the
            # journal's presence proves its release never ran (_commit
            # releases only after clearing the journal) — finish it here
            self.store.release(stale)
            self.store.cas.flush()
            CKPT_STATS["journal_rollbacks"] += 1
        self._journal_clear()

    # -- snapshot (fingerprint short-circuit) -------------------------------------
    def _device_fp(self, leaf) -> bool:
        if self.fingerprint_device is not None:
            return self.fingerprint_device
        return isinstance(leaf, torch.Tensor) and leaf.is_cuda

    @staticmethod
    def _host_fp(arr: np.ndarray) -> int:
        """64-bit host fingerprint: CRC32/Adler32 pair over the raw bytes,
        salted with shape+dtype."""
        a = np.ascontiguousarray(arr)
        view = a.view(np.uint8).reshape(-1)
        salt = repr((a.shape, bf16.dtype_name(a))).encode()
        return (zlib.crc32(view, zlib.crc32(salt)) << 32) | zlib.adler32(view)

    def _snapshot(self, state) -> Tuple[Dict[str, Optional[np.ndarray]],
                                        FrozenSet[str]]:
        """Flatten ``state``, skipping leaves whose fingerprint matches the
        last enqueued snapshot. Device fingerprints are computed BEFORE the
        host copy — an unchanged leaf moves 8 bytes, not the tensor. Every
        leaf that is kept is copied to the host here, synchronously."""
        flat: Dict[str, Optional[np.ndarray]] = {}
        fps: Dict[str, int] = {}
        skip = set()
        for path, leaf in flatten_with_path(state):
            key = _keystr(path)
            if isinstance(leaf, torch.Tensor):
                nbytes = leaf.numel() * leaf.element_size()
            else:
                nbytes = int(np.asarray(leaf).nbytes)
            if nbytes < self.fingerprint_min_bytes:
                flat[key] = _host_copy(leaf)
                continue
            if self._device_fp(leaf):
                on_card = isinstance(leaf, torch.Tensor) and leaf.is_cuda
                fp = int(ops.fingerprint(
                    leaf, backend="cuda" if on_card else "ref"))
                fps[key] = fp
                if self._last_fps.get(key) == fp:
                    flat[key] = None
                    skip.add(key)
                    continue
                flat[key] = _host_copy(leaf)
            else:
                arr = _host_copy(leaf)
                fp = self._host_fp(arr)
                fps[key] = fp
                if self._last_fps.get(key) == fp:
                    flat[key] = None
                    skip.add(key)
                    continue
                flat[key] = arr
        self._last_fps = fps
        return flat, frozenset(skip)

    # -- save ---------------------------------------------------------------------
    def save(self, step: int, state: Any,
             blocking: Optional[bool] = None) -> str:
        """Snapshot ``state`` as version ``step``. Returns node name.

        The fingerprint pass + device->host copy of changed leaves happens
        synchronously (the snapshot is immutable after that point); encode +
        IO runs on the worker thread. Async saves never block here: if a
        commit is already in flight AND one is pending, the pending snapshot
        is replaced (coalesce-to-latest) — the training loop stalls at most
        one commit behind storage."""
        self._check_error()
        t0 = time.perf_counter()
        name = self._node_name(step)
        with span("ckpt.snapshot", cat="ckpt", step=step,
                  model=self.model_name):
            flat, skip = self._snapshot(state)
        if blocking is None:
            blocking = not self.async_save
        if blocking:
            self._commit(step, name, flat, skip)
        else:
            self._enqueue((step, name, flat, skip))
        CKPT_STATS["saves"] += 1
        CKPT_STATS["leaves_skipped"] += len(skip)
        CKPT_STATS["leaves_transferred"] += len(flat) - len(skip)
        CKPT_OVERHEAD[self.tier].observe(time.perf_counter() - t0)
        return name

    @staticmethod
    def _merge(old: tuple, new: tuple) -> tuple:
        """Coalesce a pending snapshot with a newer one.

        The merged commit keeps the NEW step/values but may only skip a
        leaf that BOTH snapshots skipped: the eventual delta parent is the
        one the old snapshot was fingerprinted against, so a leaf that
        changed in between must ship the old snapshot's value (present
        there by construction — it wasn't skipped)."""
        _, _, old_flat, old_skip = old
        step, name, flat, skip = new
        merged_skip = frozenset(skip & old_skip)
        merged = dict(flat)
        for k in skip - merged_skip:
            merged[k] = old_flat[k]
        return (step, name, merged, merged_skip)

    def _enqueue(self, item: tuple) -> None:
        start = False
        with self._cond:
            if self._pending is not None:
                self._pending = self._merge(self._pending, item)
                CKPT_STATS["coalesced"] += 1
            else:
                self._pending = item
            self._cond.notify_all()
            if (self._worker_dead or self._worker is None
                    or not self._worker.is_alive()):
                self._worker_dead = False
                self._worker = threading.Thread(target=self._drain,
                                                daemon=True)
                start = True
        if start:
            self._worker.start()

    def _drain(self) -> None:
        while True:
            with self._cond:
                while self._pending is None:
                    if self._closed or not self._cond.wait(timeout=0.2):
                        if self._pending is None:  # idle or closing: die
                            self._worker_dead = True
                            return
                item, self._pending = self._pending, None
                self._inflight = True
            try:
                self._commit(*item)
            except BaseException as e:  # surfaced on next save()/wait()
                self._error = e
                with self._cond:
                    # a snapshot enqueued while this commit was failing
                    # skipped leaves against a baseline that never landed;
                    # its None leaves are unrecoverable — drop it along
                    # with the baseline
                    self._pending = None
                # the fingerprint baseline now references a commit that
                # never landed — next save must transfer everything
                self._last_fps = {}
                self._prev_flat = None
            finally:
                with self._cond:
                    self._inflight = False
                    self._cond.notify_all()

    def wait(self) -> None:
        with self._cond:
            while self._pending is not None or self._inflight:
                self._cond.wait(timeout=0.05)
        self._check_error()

    def close(self) -> None:
        """Drain pending commits and surface any async failure."""
        self.wait()
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def _check_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    # -- commit -------------------------------------------------------------------
    def _commit(self, step: int, name: str,
                flat: Dict[str, Optional[np.ndarray]],
                skip: FrozenSet[str] = frozenset()) -> None:
        commit_tier = "exact"
        prev_step = None
        for s in self._steps():
            if s < step and (prev_step is None or s > prev_step):
                prev_step = s
        parent_ref = (self.lineage.nodes[self._node_name(prev_step)]
                      .artifact_ref if prev_step is not None else None)
        if (self.tier == "lossy" and parent_ref is not None
                and self._commits % self.keyframe_every != 0):
            commit_tier = "lossy"
        # Re-commit of an already-committed step (restore rolled back to an
        # exact ancestor, then training re-ran forward past it): the node's
        # current manifest is superseded and must be released once the
        # lineage points at the new one, or its refs leak (fsck
        # refcount_drift). The journal carries it so a crash after the
        # lineage save still releases it on recovery.
        stale_node = self.lineage.nodes.get(name)
        stale_ref = (stale_node.artifact_ref if stale_node is not None
                     else None)
        with span("ckpt.commit", cat="ckpt", step=step, tier=commit_tier):
            work, transforms = self._apply_transforms(flat)
            metadata: Dict[str, Any] = {"step": step}
            if commit_tier == "lossy":
                metadata["lossy"] = True
            if transforms:
                metadata["transforms"] = transforms
            self._journal_write({"name": name, "step": step, "ref": None,
                                 "stale": stale_ref})
            parent_manifest = (self.store.get_manifest(parent_ref)
                               if parent_ref else None)
            graph_json = None
            if (parent_manifest is None
                    or set(work) != set(parent_manifest["params"])):
                graph_json = self._graph_json(work, parent_manifest)
            ref = self.store.commit_step(
                name, work, parent_ref, skip=skip, tier=commit_tier,
                model_type=self.model_name, metadata=metadata,
                graph_json=graph_json,
                # the live-flat shortcut is only the parent's committed
                # truth when the parent IS the commit it was captured from
                # (not after a rollback re-commit, where prev_step jumps
                # back past the step _prev_flat came from)
                parent_hint=(self._prev_flat
                             if (self.tier == "exact"
                                 and parent_ref is not None
                                 and self._prev_flat_ref == parent_ref)
                             else None),
                flush=False)
            # journal carries the ref BEFORE the durability point: a crash
            # on either side of the flush leaves either nothing visible or
            # an orphan the journal can roll back
            self._journal_write({"name": name, "step": step, "ref": ref,
                                 "stale": stale_ref})
            with span("commit.pack_fsync", cat="store"):
                self.store.cas.flush()
            # one lineage save per commit: batch the node + version edge +
            # artifact pointer, then write the (fsync'd, atomic) file once.
            # The artifact_ref lands AFTER the version edge so the edge
            # hook never re-compresses a node that is already step-encoded.
            prev_autosave = self.lineage.autosave
            self.lineage.autosave = False
            try:
                node = self.lineage.add_node(None, name,
                                             model_type=self.model_name)
                # detach the superseded ref first so the version-edge hook
                # can never re-compress the manifest we're about to replace
                node.artifact_ref = None
                if prev_step is not None:
                    self.lineage.add_version_edge(
                        self._node_name(prev_step), name)
                node.artifact_ref = ref
            finally:
                self.lineage.autosave = prev_autosave
            self.lineage.save()
            self._journal_clear()
            if stale_ref is not None:
                # only AFTER the (fsync'd) lineage points at the new
                # manifest — releasing earlier could leave the durable
                # lineage referencing a released ref after a crash. Holds
                # for stale_ref == ref too (bit-identical re-commit): the
                # commit re-increffed every object the manifest owns, and
                # this release undoes exactly that duplicate set.
                self.store.release(stale_ref)
                self.store.cas.flush()
        self._commits += 1
        CKPT_STATS["commits"] += 1
        if self.tier == "exact":
            base = (self._prev_flat
                    if self._prev_flat is not None
                    and self._prev_flat_ref == parent_ref else {})
            self._prev_flat = {k: (v if v is not None else base.get(k))
                               for k, v in flat.items()}
            self._prev_flat_ref = ref

    def _apply_transforms(self, flat: Dict[str, Optional[np.ndarray]]
                          ) -> Tuple[Dict[str, Optional[np.ndarray]],
                                     Dict[str, str]]:
        """Per-regime leaf transforms (lossy tier only): AdamW nu commits
        as log1p(v) so the uniform int8 grid quantizes *relative* error.
        Applied to keyframes too: the whole lossy chain lives in one
        domain, so consecutive hops stay small. Exact tier stores raw bits."""
        if self.tier != "lossy":
            return flat, {}
        work: Dict[str, Optional[np.ndarray]] = {}
        transforms: Dict[str, str] = {}
        for k, v in flat.items():
            if state_regime(k) == "moment2" and (
                    v is None or v.dtype == np.float32):
                transforms[k] = "log1p"
                work[k] = None if v is None else np.log1p(v)
            else:
                work[k] = v
        return work, transforms

    def _graph_json(self, work: Dict[str, Optional[np.ndarray]],
                    parent_manifest: Optional[Dict[str, Any]]) -> str:
        specs: Dict[str, Tuple[Tuple[int, ...], str]] = {}
        for k, v in work.items():
            if v is not None:
                specs[k] = (tuple(v.shape), bf16.dtype_name(v))
            else:
                pe = parent_manifest["params"][k]
                specs[k] = (tuple(pe.get("shape", ())),
                            pe.get("dtype", "float32"))
        return spec_graph(specs, self.model_name).to_json()

    # -- restore ---------------------------------------------------------------------
    def restore(self, step: Optional[int] = None, template: Any = None,
                verify: bool = False, allow_lossy: bool = False):
        """Load flat state (or a full state if ``template`` given).

        Returns ``(state, step)``. With a template, every tensor leaf comes
        back on its template leaf's device, in its dtype and shape. When
        the resolved step is a lossy intermediate and ``allow_lossy`` is
        False (the default — and the only safe choice for resuming
        training), the restore walks back to the nearest bit-exact
        ancestor and returns THAT step."""
        self.wait()
        # a restore may rewind training: the fingerprint/skip baseline and
        # live-flat shortcut describe the pre-restore head, not whatever
        # the caller resumes from — drop them (next save transfers fully)
        self._last_fps = {}
        self._prev_flat = None
        self._prev_flat_ref = None
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no committed checkpoint found")
        steps = sorted(self._steps())
        if step not in steps:
            raise FileNotFoundError(f"no committed checkpoint at step {step}")
        while not allow_lossy:
            node = self.lineage.nodes[self._node_name(step)]
            manifest = self.store.get_manifest(node.artifact_ref)
            if not (manifest.get("metadata") or {}).get("lossy"):
                break
            prior = [s for s in steps if s < step]
            if not prior:
                break  # first commit is always exact; defensive
            step = max(prior)
        node = self.lineage.nodes[self._node_name(step)]
        artifact = node.get_model()
        manifest = self.store.get_manifest(node.artifact_ref)
        if verify:
            # Bit-rot check against commit-time content hashes, one tensor
            # at a time (the lazy view materializes on access).
            for key, e in manifest["params"].items():
                expected = e.get("hash") or e.get("tensor")
                if expected is None:
                    continue  # pre-hash manifest (older store version)
                if tensor_hash(artifact.params[key]) != expected:
                    raise IOError(f"checkpoint corruption detected in {key!r}")
        transforms = (manifest.get("metadata") or {}).get("transforms") or {}
        if transforms:
            flat: Dict[str, np.ndarray] = {}
            for key in manifest["params"]:
                v = np.asarray(artifact.params[key])
                if transforms.get(key) == "log1p":
                    v = np.expm1(v)
                flat[key] = v
        else:
            flat = artifact.params
        if template is None:
            return flat, step
        return unflatten_state(template, flat), step

    def restore_sharded(self, template: Any, step: Optional[int] = None,
                        verify: bool = False, allow_lossy: bool = False):
        """Elastic restore: lay the checkpoint out per ``template``.

        On one device with no mesh, every tensor leaf goes to its template
        leaf's device (the checkpoint may have been written from another
        device or host)."""
        return self.restore(step=step, template=template, verify=verify,
                            allow_lossy=allow_lossy)


__all__ = ["CKPT_OVERHEAD", "CKPT_STATS", "CheckpointManager",
           "flatten_state", "unflatten_state", "spec_graph", "state_graph"]
