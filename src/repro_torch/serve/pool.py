"""Lineage-native model pool: one resident base, N delta-derived views.

The storage argument of the paper — dozens of finetunes share structure and
parameters with one base — has a serving analogue (DESIGN.md §13): keep the
chain base's parameters resident ONCE and materialize each derivative as a
delta application over them, so serving memory dedups the same way the CAS
does. The pool:

* loads the chain base of a manifest family exactly once (batched
  ``materialize_artifact`` checkout) and pins it;
* derives each served node's ``ResidentView`` by applying its folded
  per-segment deltas directly over the resident base arrays — fused
  ``ops.chain_apply`` (the CUDA kernel) on the card, int32 segment sum +
  one host dequant per segment on the host (bit-identical, DESIGN.md
  §10.2);
* aliases every parameter whose content hash matches a base parameter
  (the common case for sparse finetunes: unchanged tensors cost zero
  bytes per derivative);
* asserts bit-identity of every non-aliased parameter against the
  manifest's stored truth hash — a view that diverges from what
  ``load_artifact`` would return raises instead of serving;
* keeps an LRU over the derivative views' private (non-aliased) bytes, so
  N models stay resident in a fraction of N full copies.

Chunked (``kind: chunked``) parameters and stores with folding disabled
route through ``store.materialize_param`` — the chunk engine and the
hopwise executor are the reconstruction truth there — and get the same
bit-identity check.

Ported from the reference package's ``repro/serve/pool.py``. Views stay
numpy arrays on the host, as there: the truth hash is taken over host
bytes. Only the pool's backend default differs (see :class:`ModelPool`).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.common import bf16
from repro_torch.common.hashing import tensor_hash
from repro_torch.core.artifact import ModelArtifact
from repro_torch.core.graphir import LayerGraph
from repro_torch.kernels import ops
from repro_torch.obs import REGISTRY, span
from repro_torch.store.delta import decode_q, host_dequant


class BitIdentityError(AssertionError):
    """A pool-built parameter diverged from the manifest's stored truth."""


class ResidentView:
    """One served derivative: params resident over (mostly) base aliases.

    Lease accounting makes hot swaps drain-safe: a request holds a lease
    for its whole read, an endpoint swap only replaces the *pointer*, and
    the old view object stays fully usable until its last lease releases
    (``active_leases`` -> 0). Nothing is freed under an in-flight request.
    """

    def __init__(self, ref: str, artifact: ModelArtifact,
                 aliased: List[str], private_bytes: int,
                 build_s: float) -> None:
        self.ref = ref
        self.artifact = artifact
        self.aliased = aliased            # param keys borrowed from the base
        self.private_bytes = private_bytes
        self.build_s = build_s
        self.active_leases = 0
        self._lock = threading.Lock()

    @property
    def params(self) -> Dict[str, np.ndarray]:
        return self.artifact.params

    def acquire(self) -> None:
        with self._lock:
            self.active_leases += 1

    def release(self) -> None:
        with self._lock:
            self.active_leases -= 1

    def probe(self, x: Optional[np.ndarray] = None) -> np.ndarray:
        """Deterministic forward probe through the layer graph.

        Chains ``tanh(x @ w)`` through every 2-D parameter the running
        width matches, in topological order — the generic "response" for
        artifacts with no transformer config attached. Branch-pinned
        endpoints over different derivatives return different probes, and
        identical params always return identical probes."""
        ws = []
        for name in self.artifact.graph.topo_order():
            for pname, value in sorted(self.params.items()):
                if pname.startswith(name + "/") and np.ndim(value) == 2:
                    ws.append(bf16.widen(value))
        if not ws:
            raise ValueError(f"view {self.ref!r} has no 2-D params to probe")
        if x is None:
            x = np.ones((1, ws[0].shape[0]), np.float32)
        x = np.asarray(x, np.float32)
        for w in ws:
            if x.shape[-1] != w.shape[0]:
                continue
            x = np.tanh(x @ w)
        return x

    def stats(self) -> Dict[str, Any]:
        return {"ref": self.ref, "params": len(self.params),
                "aliased": len(self.aliased),
                "private_bytes": self.private_bytes,
                "active_leases": self.active_leases,
                "build_s": round(self.build_s, 6)}


class ModelPool:
    """LRU pool of :class:`ResidentView`\\ s over one pinned chain base.

    ``backend`` follows the kernels convention: ``None`` means the card
    (``ops.default_backend()``, which raises when there is none) and
    multi-hop segments go through the fused ``ops.chain_apply`` kernel;
    ``"ref"`` applies segments on the host (int32 sum + one dequant —
    bit-identical to the fused kernel).
    ``verify=False`` skips the per-param truth-hash assertion (benchmarks
    measuring raw build latency); serving keeps it on.
    """

    def __init__(self, store, max_resident: int = 8,
                 budget_bytes: Optional[int] = None,
                 backend: Optional[str] = None, verify: bool = True) -> None:
        self.store = store
        self.max_resident = max_resident
        self.budget_bytes = budget_bytes
        self.backend = backend or ops.default_backend()
        self.verify = verify
        self._lock = threading.RLock()
        self._views: "OrderedDict[str, ResidentView]" = OrderedDict()
        self._base_ref: Optional[str] = None
        self._base_by_hash: Dict[str, np.ndarray] = {}
        self.base_bytes = 0
        # registry-backed compat view (mgit_pool_* in /api/metrics)
        self.stats_counters = REGISTRY.group(
            "mgit_pool",
            keys=("views_built", "hits", "misses", "evictions",
                  "params_aliased", "params_applied", "chain_hops",
                  "segments_applied", "fused_applies", "params_verified",
                  "bytes_aliased"),
            help="serving pool residency counters")

    # -- base residency ------------------------------------------------------
    def base_ref_of(self, ref: str) -> str:
        """The depth-0 manifest under ``ref``'s delta-parent chain."""
        seen = set()
        cur = ref
        while True:
            if cur in seen:
                raise RuntimeError(f"delta_parents cycle at {cur!r}")
            seen.add(cur)
            parents = self.store.get_manifest(cur).get("delta_parents", [])
            if not parents:
                return cur
            cur = sorted(parents)[0]

    def ensure_base(self, ref: str) -> str:
        """Pin ``ref``'s chain base: one batched checkout, kept for the
        pool's lifetime. Returns the base manifest ref."""
        base_ref = self.base_ref_of(ref)
        with self._lock:
            if self._base_ref == base_ref:
                return base_ref
            if self._base_ref is not None:
                raise ValueError(
                    f"pool already resident on base {self._base_ref!r}; "
                    f"{ref!r} descends from {base_ref!r} — use one pool "
                    "per model family")
        artifact = self.store.materialize_artifact(base_ref)
        manifest = self.store.get_manifest(base_ref)
        by_hash: Dict[str, np.ndarray] = {}
        total = 0
        for key, entry in manifest["params"].items():
            value = np.asarray(artifact.params[key])
            by_hash[entry["hash"]] = value
            total += int(value.nbytes)
        with self._lock:
            self._base_ref = base_ref
            self._base_by_hash = by_hash
            self.base_bytes = total
        return base_ref

    # -- view residency ------------------------------------------------------
    def get(self, ref: str) -> ResidentView:
        """Resident view for ``ref`` (LRU: builds on miss, evicts beyond
        the resident budget; evicted views stay alive while leased)."""
        with self._lock:
            view = self._views.get(ref)
            if view is not None:
                self._views.move_to_end(ref)
                self.stats_counters["hits"] += 1
                return view
            self.stats_counters["misses"] += 1
        view = self._build_view(ref)
        with self._lock:
            self._views[ref] = view
            self._views.move_to_end(ref)
            self._evict_over_budget()
        return view

    def _evict_over_budget(self) -> None:
        def over() -> bool:
            if len(self._views) > self.max_resident:
                return True
            if self.budget_bytes is None:
                return False
            return sum(v.private_bytes
                       for v in self._views.values()) > self.budget_bytes
        while len(self._views) > 1 and over():
            self._views.popitem(last=False)
            self.stats_counters["evictions"] += 1

    def _build_view(self, ref: str) -> ResidentView:
        t0 = time.perf_counter()
        with span("pool.build_view", cat="serve", ref=ref):
            return self._build_view_inner(ref, t0)

    def _build_view_inner(self, ref: str, t0: float) -> ResidentView:
        self.ensure_base(ref)
        manifest = self.store.get_manifest(ref)
        params: Dict[str, np.ndarray] = {}
        aliased: List[str] = []
        private = 0
        for key, entry in manifest["params"].items():
            truth = entry["hash"]
            base_twin = self._base_by_hash.get(truth)
            if base_twin is not None:
                # content-addressed dedup: bit-identity holds by the hash
                # equality itself — no bytes, no verification pass needed
                params[key] = base_twin
                aliased.append(key)
                self._count(params_aliased=1,
                            bytes_aliased=int(base_twin.nbytes))
                continue
            if entry["kind"] == "delta" and self.store.fold_enabled:
                value = self._apply_chain(ref, key)
            else:
                # chunked entries, full entries and hopwise-truth stores:
                # the store's own executor IS the reconstruction truth
                value = np.asarray(self.store.materialize_param(ref, key))
            if self.verify:
                got = tensor_hash(value)
                if got != truth:
                    raise BitIdentityError(
                        f"pool-built {ref!r}:{key!r} hash {got} != stored "
                        f"truth {truth}")
                self._count(params_verified=1)
            params[key] = value
            private += int(value.nbytes)
            self._count(params_applied=1)
        artifact = ModelArtifact(
            graph=LayerGraph.from_json(manifest["graph"]),
            params=params,
            model_type=manifest.get("model_type", "generic"),
            metadata=manifest.get("metadata", {}),
        )
        self._count(views_built=1)
        return ResidentView(ref, artifact, aliased, private,
                            time.perf_counter() - t0)

    def _apply_chain(self, ref: str, key: str) -> np.ndarray:
        """Derivative param = base value + folded per-segment deltas.

        Same segmentation rule as the checkout executor (consecutive
        float32 hops sharing one eps fold into one exact int32 sum and ONE
        dequant, DESIGN.md §10.2), but executed over the pool's resident
        base arrays instead of the tensor cache."""
        t_ref, t_key, t_entry, hops = self.store.chain_recipe(ref, key)
        value = self._base_by_hash.get(t_entry["hash"])
        if value is None:
            # chain bottoms out off the resident base (e.g. a chunked
            # terminal): materialize it through the store, cached there
            value = np.asarray(self.store.materialize_param(t_ref, t_key))
        open_qs: List[np.ndarray] = []
        open_eps = 0.0
        for hop in hops:
            q = decode_q(hop, self.store.cas.get_view(hop.blob))
            self._count(chain_hops=1)
            if hop.dtype == "float32":
                if open_qs and hop.eps == open_eps:
                    open_qs.append(q)
                else:
                    if open_qs:
                        value = self._apply_segment(value, open_qs, open_eps)
                    open_qs, open_eps = [q], hop.eps
            else:
                # a non-f32 hop rounds to its dtype: applied on its own,
                # as the checkout executor applies it
                if open_qs:
                    value = self._apply_segment(value, open_qs, open_eps)
                    open_qs = []
                value = self._apply_hop(value, q, hop)
        if open_qs:
            value = self._apply_segment(value, open_qs, open_eps)
        return np.asarray(value).reshape(hops[-1].shape) if hops \
            else np.asarray(value)

    def _apply_hop(self, value: np.ndarray, q: np.ndarray, hop) -> np.ndarray:
        """One hop rounded to its own dtype (bf16, f16): the dequant kernel
        on device backends, its numpy twin on ``"ref"``."""
        if self.backend != "ref":
            out = ops.dequant_apply(np.asarray(value), q, eps=hop.eps,
                                    backend=self.backend,
                                    out_dtype=hop.dtype)
        else:
            out = host_dequant(value, q, hop.eps, out_dtype=hop.dtype)
        return np.asarray(out).reshape(hop.shape)

    def _apply_segment(self, value: np.ndarray, qs: List[np.ndarray],
                       eps: float) -> np.ndarray:
        self._count(segments_applied=1)
        if self.backend != "ref" and len(qs) > 1:
            self._count(fused_applies=1)
            return np.asarray(ops.chain_apply(
                np.asarray(value), qs, eps=eps, backend=self.backend,
                out_dtype="float32"))
        acc = qs[0] if qs[0].dtype == np.int32 else qs[0].astype(np.int32)
        for q in qs[1:]:
            acc = np.add(acc, q.reshape(acc.shape), dtype=np.int32)
        return host_dequant(value, acc, eps, out_dtype="float32")

    # -- bookkeeping ---------------------------------------------------------
    def _count(self, **deltas: int) -> None:
        with self._lock:
            for k, v in deltas.items():
                self.stats_counters[k] += v

    @property
    def resident_refs(self) -> List[str]:
        with self._lock:
            return list(self._views)

    def private_bytes(self) -> int:
        with self._lock:
            return sum(v.private_bytes for v in self._views.values())

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            views = [v.stats() for v in self._views.values()]
        return {
            "base_ref": self._base_ref,
            "base_bytes": self.base_bytes,
            "resident": len(views),
            "private_bytes": sum(v["private_bytes"] for v in views),
            "views": views,
            **self.stats_counters.snapshot(),
        }
