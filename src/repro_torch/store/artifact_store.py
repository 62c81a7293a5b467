"""ArtifactStore — manifests binding the CAS + delta compression to lineage nodes.

Committing an artifact produces a *manifest* (JSON, itself CAS-stored):

    {name, model_type, graph, metadata, depth,
     params: {key: {kind: "full", tensor: <hash>}
                  | {kind: "delta", blob: <hash>, parent_ref, parent_key,
                     codec, eps, shape, dtype, hash}}}

Full tensors dedup automatically through content hashing; delta entries point
at their parent manifest (paper §4). ``max_chain_depth`` bounds reconstruction
latency, like git packfile delta-depth limits (beyond-paper knob).

Reconstruction is *plan-based and lazy* (DESIGN.md §3.3–3.4), and both hot
paths are batched, pipelined engines (DESIGN.md §10):

* ``load_artifact`` returns a lazy artifact whose params materialize
  per-tensor on first access — checkout/diff/traversal never force a full
  model into memory;
* ``resolve_chain(ref, key)`` walks one parameter's delta chain iteratively
  and emits a flat :class:`ReconstructionPlan` — ``(blob, parent)`` hops down
  to the first full tensor (or a cache hit);
* ``materialize_param`` executes the chain with *segment folding*: runs of
  same-eps float32 hops accumulate into one exact int32 delta sum and apply
  as a SINGLE dequant (dequant is linear in q at fixed eps) — a depth-k
  uniform chain costs one dequant instead of k. Mixed-eps / non-f32 hops
  fall back to hop-by-hop within their own segments (§10.2);
* ``materialize_artifact`` is the batched checkout: per-param chains resolve
  against shared manifest/fold state and decode+fold fans out across a
  thread pool (LZMA decode releases the GIL);
* ``commit_artifact`` is a pipelined encoder by default: device quantization
  (``ops.snapshot_fused``) overlaps host codec work on a thread pool, the
  parent's reconstruction state resolves once per chain, and all objects
  land through one buffered ``CAS.batch()`` with a single fsync at the
  commit point. ``pipelined=False`` preserves the serial PR-1 path as the
  benchmark baseline (it implies ``fold_enabled=False`` — the two paths
  define reconstruction truth differently and must not be mixed in one
  store, §10.2);
* materialized tensors land in a byte-budget LRU (``cache_budget_bytes``)
  shared by every artifact the store serves; fold states (the open-segment
  ``(seg_base, Σq)`` pairs that let chains *extend* bit-exactly) land in a
  sibling :class:`FoldCache`.

Backends: ``backend=None`` means the card (``ops.default_backend()``,
which raises when there is none). There the commit quantize, commit truth,
single-hop dequant and folded chain checkout run the CUDA kernels through
``repro_torch.kernels.ops``. ``backend="ref"`` runs the numpy twins of
``store/delta.py`` on the host instead. The chunk engine quantizes and
dequantizes chunks with the numpy twins on either backend.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common import bf16
from repro_torch.common.hashing import TensorHasher, bytes_hash, tensor_hash
from repro_torch.dist.compression import ef_eps
from repro_torch.core.artifact import LazyParams, ModelArtifact, ParamRef
from repro_torch.core.graphir import LayerGraph
from repro_torch.kernels import ops
from repro_torch.obs import REGISTRY, propagate, span
from repro_torch.store import chunks as chunklib
from repro_torch.store.cas import CAS, DEFAULT_PACK_THRESHOLD, npy_bytes
from repro_torch.store.codecs import (bitpattern_apply, bitpattern_delta,
                                      get_codec, pick_codec)
from repro_torch.store.delta import (CompressResult, ParamDelta, decode_q,
                                     decompress_param, delta_compression,
                                     host_dequant, host_snapshot,
                                     lcs_param_matching)
from repro_torch.store.manifest_walk import walk_manifests


# ---------------------------------------------------------------------------
# Reconstruction plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeltaHop:
    """One delta application: child (ref, key) reconstructed from its parent."""

    ref: str            # manifest holding this delta entry
    key: str            # child param key
    blob: str           # CAS key of the compressed quantized delta
    codec: str
    eps: float
    shape: Tuple[int, ...]
    dtype: str
    qdtype: str


@dataclasses.dataclass(frozen=True)
class ReconstructionPlan:
    """Flat recipe for one parameter: start at ``base``, apply ``hops`` in order.

    ``base_kind`` is ``"full"`` (base is a CAS tensor hash) or ``"cache"``
    (base is a (ref, key) already materialized in the tensor cache)."""

    base_kind: str
    base: Any
    hops: Tuple[DeltaHop, ...]

    @property
    def depth(self) -> int:
        return len(self.hops)


@dataclasses.dataclass(frozen=True)
class FoldState:
    """Open-segment reconstruction state of one materialized parameter.

    The param's canonical value is ``dequant(seg_base, q_open, eps)``; a
    child hop with the same eps *extends* the segment bit-exactly:
    ``dequant(seg_base, q_open + q_child, eps)`` (int32 sums are exact, so
    the fold is associative even though float dequant is not). This is what
    lets commit derive a child's stored truth in one dequant and checkout
    collapse whole chains (DESIGN.md §10.2)."""

    seg_base: np.ndarray   # value BEFORE the open segment (read-only)
    q_open: np.ndarray     # int32 sum of the open segment's quantized deltas
    eps: float

    @property
    def nbytes(self) -> int:
        return int(self.seg_base.nbytes) + int(self.q_open.nbytes)


class TensorCache:
    """Byte-budget LRU over materialized tensors, keyed by (manifest_ref, key).

    Mutations are guarded by an RLock: the diagnostics runner (DESIGN.md §9)
    materializes parameters from a thread pool, and an unguarded
    ``move_to_end`` racing an eviction corrupts the OrderedDict."""

    def __init__(self, budget_bytes: int) -> None:
        self.budget_bytes = budget_bytes
        self._entries: "OrderedDict[Tuple[str, str], np.ndarray]" = OrderedDict()
        self._lock = threading.RLock()
        self.bytes_used = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Tuple[str, str]) -> Optional[np.ndarray]:
        with self._lock:
            arr = self._entries.get(key)
            if arr is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return arr

    def put(self, key: Tuple[str, str], arr: np.ndarray) -> None:
        nbytes = int(arr.nbytes)
        if nbytes > self.budget_bytes:
            return  # larger than the whole budget: never cacheable
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes_used -= int(old.nbytes)
            self._entries[key] = arr
            self.bytes_used += nbytes
            while self.bytes_used > self.budget_bytes and self._entries:
                _, evicted = self._entries.popitem(last=False)
                self.bytes_used -= int(evicted.nbytes)
                self.evictions += 1

    def contains(self, key: Tuple[str, str]) -> bool:
        with self._lock:
            return key in self._entries

    def drop_ref(self, ref: str) -> None:
        with self._lock:
            for k in [k for k in self._entries if k[0] == ref]:
                self.bytes_used -= int(self._entries.pop(k).nbytes)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.bytes_used = 0

    def __len__(self) -> int:
        return len(self._entries)


class FoldCache:
    """Byte-budget LRU over :class:`FoldState`, keyed by (manifest_ref, key).

    Purely a performance cache: a fold state is always recomputable from the
    chain, and extending from a cached state is bit-exact by construction
    (int32 sums), so eviction can never change reconstruction results."""

    def __init__(self, budget_bytes: int) -> None:
        self.budget_bytes = budget_bytes
        self._entries: "OrderedDict[Tuple[str, str], FoldState]" = OrderedDict()
        self._lock = threading.RLock()
        self.bytes_used = 0

    def get(self, key: Tuple[str, str]) -> Optional[FoldState]:
        with self._lock:
            fs = self._entries.get(key)
            if fs is not None:
                self._entries.move_to_end(key)
            return fs

    def put(self, key: Tuple[str, str], fs: FoldState) -> None:
        if fs.nbytes > self.budget_bytes:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes_used -= old.nbytes
            self._entries[key] = fs
            self.bytes_used += fs.nbytes
            while self.bytes_used > self.budget_bytes and self._entries:
                _, evicted = self._entries.popitem(last=False)
                self.bytes_used -= evicted.nbytes

    def drop_ref(self, ref: str) -> None:
        with self._lock:
            for k in [k for k in self._entries if k[0] == ref]:
                self.bytes_used -= self._entries.pop(k).nbytes

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.bytes_used = 0

    def __len__(self) -> int:
        return len(self._entries)


class ArtifactStore:
    """The ``store`` object a :class:`repro_torch.core.LineageGraph` plugs into."""

    def __init__(self, root: Optional[str] = None, codec: str = "lzma",
                 eps: float = 1e-4, t_thr: float = 0.5,
                 delta_enabled: bool = True, per_param: bool = True,
                 max_chain_depth: int = 8,
                 cache_budget_bytes: int = 256 * 2**20,
                 zero_frac_prefilter: float = 0.0,
                 backend: Optional[str] = None,
                 pack_threshold: int = DEFAULT_PACK_THRESHOLD,
                 pipelined: bool = True,
                 fold_enabled: bool = True,
                 fold_budget_bytes: int = 256 * 2**20,
                 lzma_preset: Optional[int] = None,
                 io_workers: Optional[int] = None,
                 chunk_threshold: Optional[int] = None,
                 chunk_window_bytes: int = chunklib.DEFAULT_WINDOW_BYTES,
                 chunk_min: int = chunklib.DEFAULT_MIN_CHUNK,
                 chunk_avg: int = chunklib.DEFAULT_AVG_CHUNK,
                 chunk_max: int = chunklib.DEFAULT_MAX_CHUNK,
                 chunk_mode: str = "cdc",
                 chunk_shards: int = 0) -> None:
        self.cas = CAS(root, pack_threshold=pack_threshold)
        # chunk layer (DESIGN.md §12): params >= chunk_threshold bytes are
        # stored as content-defined chunks instead of one monolithic object;
        # 0 disables chunking. chunk_window_bytes bounds commit/checkout
        # in-flight memory for chunked tensors; chunk_shards > 1 aligns the
        # chunk grid to that many axis-0 shard boundaries.
        self.chunk_threshold = (chunklib.DEFAULT_CHUNK_THRESHOLD
                                if chunk_threshold is None
                                else max(0, int(chunk_threshold)))
        self.chunk_window_bytes = int(chunk_window_bytes)
        self.chunk_min = int(chunk_min)
        self.chunk_avg = int(chunk_avg)
        self.chunk_max = int(chunk_max)
        self.chunk_mode = chunk_mode
        self.chunk_shards = int(chunk_shards)
        self.codec = codec
        self.eps = eps
        self.t_thr = t_thr
        self.delta_enabled = delta_enabled
        self.per_param = per_param
        self.max_chain_depth = max_chain_depth
        self.zero_frac_prefilter = zero_frac_prefilter
        self.backend = backend or ops.default_backend()
        self.pipelined = pipelined
        # The serial baseline defines truth hop-by-hop; folding defines it
        # segment-wise. One store must pick ONE definition (§10.2).
        self.fold_enabled = fold_enabled and pipelined
        # LZMA preset default: the pipelined engine ships with preset 0 —
        # on quantized-delta streams it compresses as well as preset 1 at
        # ~2x the encode/decode speed (see bench_compression's preset
        # sweep); the serial baseline keeps the historical preset-1 codec.
        if lzma_preset is None and pipelined and codec == "lzma":
            lzma_preset = 0
        self.lzma_preset = lzma_preset
        self.io_workers = io_workers or max(2, min(4, os.cpu_count() or 2))
        self._codec_obj = get_codec(codec, preset=lzma_preset)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._manifests: Dict[str, Dict[str, Any]] = {}
        self.cache = TensorCache(cache_budget_bytes)
        self.fold_cache = FoldCache(fold_budget_bytes)
        self.logical_bytes = 0
        self.last_result: Optional[CompressResult] = None
        # per-store materialization accounting (reset with reset_io_stats).
        # A registry-backed dict view: same `io_stats[k] += n` call sites,
        # but the counters are scrapeable as mgit_store_* and multi-key
        # snapshot/reset are atomic (DESIGN.md §14).
        self.io_stats = REGISTRY.group(
            "mgit_store",
            keys=("tensors_materialized", "bytes_materialized",
                  "chain_hops", "plans_resolved", "dequant_calls",
                  "hops_folded", "fold_hits", "chunks_written",
                  "chunk_bytes_written", "chunks_deduped",
                  "chunk_delta_blobs", "chunk_passthrough", "chunks_read",
                  "step_commits", "step_leaves_copied", "step_leaves_delta",
                  "step_leaves_xdelta", "step_leaves_full"),
            help="ArtifactStore I/O accounting")
        self._lock = threading.RLock()   # manifests dict + counters
        self._stats_path = (os.path.join(root, "store_stats.json")
                            if root else None)
        if self._stats_path and os.path.exists(self._stats_path):
            with open(self._stats_path) as f:
                payload = json.load(f)
            self.logical_bytes = payload.get("logical_bytes", 0)
            self._adopt_truth(payload.get("truth"))

    def _adopt_truth(self, recorded: Optional[str]) -> None:
        """Enforce one reconstruction-truth definition per repository.

        Fold and hop-by-hop reconstruction produce (equally valid but)
        different bits for depth>=2 chains, so manifests written under one
        definition must never be materialized under the other (§10.2). The
        definition is persisted in store_stats.json at first commit:

        * recorded == configured: fine;
        * recorded missing but commits exist (store_stats.json predates the
          marker — a PR-1..3 repo): its chains are hop-by-hop truth; adopt
          that rather than silently diverge from the recorded hashes;
        * recorded conflicts with an explicit config: fail fast."""
        configured = "fold" if self.fold_enabled else "hopwise"
        if recorded is None:
            if self.fold_enabled:
                self.fold_enabled = False
                self.pipelined = False
        elif recorded != configured:
            raise ValueError(
                f"store at {self.cas.root!r} was committed with "
                f"{recorded!r} reconstruction truth but this instance is "
                f"configured for {configured!r} — reopen with "
                f"{'pipelined=True (default)' if recorded == 'fold' else 'pipelined=False'} "
                f"(DESIGN.md §10.2: one truth definition per repository)")

    def _executor(self) -> ThreadPoolExecutor:
        """Shared worker pool for commit encode + batched checkout decode.

        Lazily created and kept for the store's lifetime — spawning a pool
        per operation costs more than a short commit's entire codec work.
        Workers never submit back into the pool (materialize_param is
        submission-free), so shared use cannot deadlock."""
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.io_workers,
                    thread_name_prefix="artifact-store-io")
            return self._pool

    # -- commit -----------------------------------------------------------------
    def commit_artifact(self, name: str, artifact: ModelArtifact,
                        parent_ref: Optional[str] = None,
                        tests: Sequence = ()) -> str:
        with span("store.commit", cat="store", model=name):
            return self._commit_artifact(name, artifact, parent_ref, tests)

    def _commit_artifact(self, name: str, artifact: ModelArtifact,
                         parent_ref: Optional[str],
                         tests: Sequence) -> str:
        with self._lock:
            self.logical_bytes += artifact.nbytes()
        self._persist_stats()
        entries: Dict[str, Any] = {}
        depth = 0

        # Chunk layer (DESIGN.md §12): params >= chunk_threshold go through
        # the streaming chunk engine and are carved OUT of the whole-tensor
        # delta stage — they must never be materialized as one array here.
        param_order = list(artifact.params)
        chunk_sources = self._chunk_candidates(artifact)
        parent_manifest = (self.get_manifest(parent_ref)
                           if parent_ref is not None else None)
        if chunk_sources:
            artifact = ModelArtifact(
                graph=artifact.graph,
                params={k: artifact.params[k] for k in param_order
                        if k not in chunk_sources},
                model_type=artifact.model_type,
                metadata=artifact.metadata)

        deltas = {}
        precomputed_hashes: Dict[str, str] = {}
        commit_result: Optional[CompressResult] = None
        if self.delta_enabled and parent_ref is not None and artifact.params:
            if parent_manifest["depth"] < self.max_chain_depth:
                if self.pipelined:
                    result = self._delta_compress_pipelined(
                        artifact, parent_ref, tests)
                else:
                    # serial baseline: lazy parent view, one param at a time
                    parent = self.load_artifact(parent_ref)
                    result = delta_compression(
                        artifact, parent, t_thr=self.t_thr, eps=self.eps,
                        codec=self.codec, tests=tests,
                        per_param=self.per_param,
                        zero_frac_prefilter=self.zero_frac_prefilter,
                        backend=self.backend)
                self.last_result = commit_result = result
                if result.accepted:
                    deltas = result.deltas
                    precomputed_hashes = result.param_hashes
                    depth = parent_manifest["depth"] + 1
                    # persist the *reconstructed* model as this version's truth
                    artifact = result.reconstructed

        with self.cas.batch():  # one append handle per pack, one fsync
            for key, source in chunk_sources.items():
                entries[key] = self._commit_chunked(key, source, parent_ref,
                                                    parent_manifest)
            if depth == 0 and any(e.get("parent_ref")
                                  for e in entries.values()):
                depth = parent_manifest["depth"] + 1
            for key in artifact.params:
                value = np.asarray(artifact.params[key])
                # content identity for every entry (worker-precomputed for
                # pipelined delta params)
                thash = precomputed_hashes.get(key) or tensor_hash(value)
                if key in deltas:
                    d = deltas[key]
                    blob_hash = self.cas.put_bytes(d.blob)
                    entries[key] = {"kind": "delta", "blob": blob_hash,
                                    "parent_ref": parent_ref,
                                    "parent_key": d.parent_key,
                                    "codec": d.codec,
                                    "eps": d.eps, "shape": list(d.shape),
                                    "dtype": d.dtype, "qdtype": d.qdtype,
                                    "hash": thash}
                else:
                    self.cas.put_tensor(value, key=thash)  # content-hash dedup
                    entries[key] = {"kind": "full", "tensor": thash,
                                    "shape": list(value.shape),
                                    "dtype": bf16.dtype_name(value),
                                    "hash": thash}

            # delta entries always carry parent_ref; chunked entries only
            # when at least one chunk is stored relative to the parent
            delta_parents = sorted({e["parent_ref"] for e in entries.values()
                                    if e.get("parent_ref")})
            with self.cas.batched_refcounts():
                for pref in delta_parents:
                    self.cas.incref(pref)  # parent must outlive child
            manifest = {
                "name": name,
                "model_type": artifact.model_type,
                "metadata": artifact.metadata,
                "graph": artifact.graph.to_json(),
                "params": entries,
                "depth": depth,
                "delta_parents": delta_parents,
            }
            payload = json.dumps(manifest, sort_keys=True, default=str).encode()
            ref = self.cas.put_bytes(payload, key="m_" + bytes_hash(payload))
        with self._lock:
            self._manifests[ref] = manifest
        if deltas and commit_result is not None:
            # seed the caches with this commit's reconstructed truth: the
            # NEXT commit onto this chain (or a checkout of it) resolves the
            # parent entirely from cache — zero decodes, zero dequants
            for ckey, st in commit_result.fold_states.items():
                self.fold_cache.put((ref, ckey), st)
            for ckey in deltas:
                value = artifact.params.get(ckey)
                if value is not None:
                    self.cache.put((ref, ckey), np.asarray(value))
        with span("commit.pack_fsync", cat="store"):
            self.cas.flush()  # commit point: index + refcounts durable
        return ref

    def _delta_compress_pipelined(self, child: ModelArtifact, parent_ref: str,
                                  tests: Sequence = ()) -> CompressResult:
        """Throughput-first Algorithm 1 (DESIGN.md §10.1).

        Stages, overlapped across a thread pool (GIL-releasing LZMA and
        CUDA launches):

        1. the parent's reconstruction state resolves ONCE per chain —
           ``materialize_artifact`` warms tensor + fold caches in a batch;
        2. per matched pair, a worker runs the fused device pass
           (``ops.snapshot_fused``, fingerprint elided: commit never reads
           it), encodes the quantized delta, and derives the child's stored
           truth with one fold-extended dequant;
        3. acceptance and test-gating mirror :func:`delta_compression`
           exactly (per-param or whole-model, ``t_thr`` rejection).
        """
        cod = self._codec_obj
        with span("commit.parent", cat="store"):
            parent_lazy = self.load_artifact(parent_ref)
            pairs = [(pk, ck)
                     for pk, ck in lcs_param_matching(parent_lazy, child)]
            pvals = self.materialize_artifact(
                parent_ref, keys=[pk for pk, _ in pairs]).params

        host = self.backend == "ref"

        def process(pair):
            pkey, ckey = pair
            p1 = np.asarray(pvals[pkey])
            p2 = np.asarray(child.params[ckey])
            if p1.size == 0:
                return None
            with span("commit.quantize", cat="store", key=ckey):
                if host:  # numpy twin, bit-identical, no dispatch overhead
                    q, nz, _narrow = host_snapshot(p1, p2, self.eps)
                else:
                    q, nz, _fp, _narrow = ops.snapshot_fused(
                        p1, p2, eps=self.eps, backend=self.backend,
                        with_fingerprint=False)
                    q = np.asarray(q)
            if nz / q.size < self.zero_frac_prefilter:
                return None  # on-device pre-filter: won't compress
            with span("commit.encode", cat="store", key=ckey):
                blob = cod.encode(q)
            if self.per_param and len(blob) >= p2.nbytes:
                return None  # no saving for this tensor
            q32 = q if q.dtype == np.int32 else q.astype(np.int32)
            with span("commit.truth", cat="store", key=ckey):
                recon, state = self._commit_truth(parent_ref, pkey, p1, q32,
                                                  bf16.dtype_name(p2))
            recon = recon.reshape(p2.shape)
            delta = ParamDelta(
                child_key=ckey, parent_key=pkey, blob=blob, codec=self.codec,
                eps=self.eps, shape=tuple(p2.shape),
                dtype=bf16.dtype_name(p2),
                raw_bytes=int(p2.nbytes), qdtype=str(q.dtype))
            with span("commit.hash", cat="store", key=ckey):
                thash = tensor_hash(recon)
            return ckey, delta, recon, thash, state

        # the delta span is the propagation anchor: worker-side
        # quantize/encode/hash spans parent here even though the pool
        # threads never saw this contextvar scope
        with span("commit.delta", cat="store", params=len(pairs)):
            if len(pairs) > 1 and self.io_workers > 1:
                produced = list(self._executor().map(propagate(process),
                                                     pairs))
            else:
                produced = [process(p) for p in pairs]

        candidates: Dict[str, ParamDelta] = {}
        recon_params: Dict[str, np.ndarray] = {}
        hashes: Dict[str, str] = {}
        states: Dict[str, FoldState] = {}
        for item in produced:
            if item is None:
                continue
            ckey, delta, recon, thash, state = item
            candidates[ckey] = delta
            recon_params[ckey] = recon
            hashes[ckey] = thash
            if state is not None:
                states[ckey] = state

        total_raw = child.nbytes()
        delta_raw = sum(d.raw_bytes for d in candidates.values())
        delta_compressed = sum(len(d.blob) for d in candidates.values())
        storage_saving = delta_raw / max(delta_compressed, 1)
        if not candidates or (not self.per_param and storage_saving < 1.0):
            return CompressResult(False, {}, child, {}, total_raw, total_raw)

        m2_prime = child.replace_params(recon_params)
        test_deltas: Dict[str, float] = {}
        for t in tests:
            before = float(t.fn(child))
            after = float(t.fn(m2_prime))
            test_deltas[t.name] = after - before
            if abs(after - before) > self.t_thr:
                return CompressResult(False, {}, child, test_deltas,
                                      total_raw, total_raw)
        compressed_total = (total_raw - delta_raw) + delta_compressed
        return CompressResult(True, candidates, m2_prime, test_deltas,
                              total_raw, compressed_total,
                              param_hashes=hashes, fold_states=states)

    def _commit_truth(self, parent_ref: str, parent_key: str,
                      parent_value: np.ndarray, q32: np.ndarray,
                      dtype: str, eps: Optional[float] = None
                      ) -> Tuple[np.ndarray, Optional[FoldState]]:
        """The child's canonical stored value for a new delta hop, plus its
        resulting open-segment fold state.

        Fold-extends the parent's open segment when eps+dtype allow —
        EXACTLY what checkout computes for the same chain (§10.2) — else
        opens a new segment from the parent's value. Device-backend stores
        dequant through the same kernel checkout uses, so stored hashes
        always match what a later checkout reproduces. ``eps`` defaults to
        the store's configured eps; the step-delta engine passes its
        per-leaf adaptive eps (§15) so segment-extension decisions here
        stay structurally identical to checkout's ``_is_segment_boundary``."""
        if eps is None:
            eps = self.eps
        if self.backend == "ref":
            dequant = host_dequant
        else:
            def dequant(v, q, e_, out_dtype="float32"):
                return np.asarray(ops.dequant_apply(
                    np.asarray(v), q, eps=e_, backend=self.backend,
                    out_dtype=out_dtype))

        if dtype == "float32" and self.fold_enabled:
            fs = self.fold_cache.get((parent_ref, parent_key))
            if fs is None:
                e = self._entry(parent_ref, parent_key)
                if e["kind"] == "delta":  # state evicted: recompute it
                    _, fs = self._materialize_with_state(parent_ref,
                                                         parent_key)
            if fs is not None and fs.eps == eps:
                state = FoldState(
                    seg_base=fs.seg_base,
                    q_open=np.add(fs.q_open, q32.reshape(fs.q_open.shape),
                                  dtype=np.int32),
                    eps=eps)
            else:
                state = FoldState(seg_base=np.asarray(parent_value),
                                  q_open=q32, eps=eps)
            return dequant(state.seg_base, state.q_open, eps), state
        return dequant(parent_value, q32, eps, out_dtype=dtype), None

    # -- step-delta commit engine (DESIGN.md §15) --------------------------------
    def _full_step_entry(self, key: str, value: np.ndarray,
                         parent_ref: Optional[str],
                         parent_manifest: Optional[Dict[str, Any]],
                         lossless: bool = True) -> Dict[str, Any]:
        """Depth-0 entry for one step leaf: chunked above the threshold
        (grid inheritance still dedups unchanged chunks; per-chunk
        quantized deltas only in the lossy tier), else a raw full tensor."""
        if self.chunk_threshold and value.nbytes >= self.chunk_threshold:
            e = self._commit_chunked(key, chunklib.as_source(value),
                                     parent_ref, parent_manifest,
                                     lossless=lossless)
            if e.get("parent_ref"):
                e["d"] = int(parent_manifest.get("depth", 0)) + 1
            return e
        thash = tensor_hash(value)
        self.cas.put_tensor(value, key=thash)
        return {"kind": "full", "tensor": thash, "shape": list(value.shape),
                "dtype": bf16.dtype_name(value), "hash": thash}

    @staticmethod
    def _copy_step_entry(pe: Dict[str, Any], parent_depth: int,
                         copy_objs: List[str]) -> Dict[str, Any]:
        """Verbatim re-reference of the parent's entry for an unchanged
        leaf. The new manifest holds its OWN reference on every object the
        entry owns (mirroring commit-time accounting), so ``copy_objs``
        collects them for one batched incref."""
        e = dict(pe)
        kind = e["kind"]
        if kind == "chunked":
            for item in e["chunks"]:
                k = item.get("c") or item.get("b")
                if k:
                    copy_objs.append(k)
        else:
            copy_objs.append(e["tensor"] if kind == "full" else e["blob"])
        if kind != "full" and "d" not in e:
            e["d"] = (parent_depth if (kind in ("delta", "xdelta")
                                       or e.get("parent_ref")) else 0)
        return e

    @staticmethod
    def _entry_nbytes(pe: Dict[str, Any]) -> int:
        if pe["kind"] == "chunked":
            return int(pe["nbytes"])
        shape = pe.get("shape", ())
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        return n * bf16.np_dtype(pe.get("dtype", "float32")).itemsize

    def commit_step(self, name: str,
                    flat: Dict[str, Optional[np.ndarray]],
                    parent_ref: Optional[str] = None, *,
                    skip: frozenset = frozenset(),
                    tier: str = "exact",
                    model_type: str = "model",
                    metadata: Optional[Dict[str, Any]] = None,
                    graph_json: Optional[str] = None,
                    parent_hint: Optional[Dict[str, np.ndarray]] = None,
                    step_codec: str = "zlib",
                    flush: bool = True) -> str:
        """Training-speed commit of one step's state (DESIGN.md §15).

        ``flat`` maps leaf key -> host array; keys in ``skip`` (fingerprint-
        unchanged since ``parent_ref``) may carry ``None`` and re-reference
        the parent's entry verbatim — no host transfer, no encode, no new
        object. Changed leaves store as:

        * ``tier="exact"``: an ``xdelta`` entry — lossless bitpattern
          subtraction vs the parent's committed truth, byte-plane + zlib-1
          encoded. The child's stored truth IS the live value, so resume is
          bit-identical.
        * ``tier="lossy"``: an int8 ``delta`` entry with per-leaf adaptive
          eps sized so the quantization grid matches the error-feedback
          estimator's (``amax/127``, ``repro_torch.dist.compression``). Deltas
          are taken against the parent's *committed* truth, so quantization
          error never compounds along the chain (implicit error feedback:
          each hop's error is bounded by half its own grid).

        ``parent_hint`` (exact tier only) supplies the parent's committed
        values without a cache probe — the caller's previous live flat is
        exactly that, because exact-tier truth is the live value. Per-leaf
        chain depth (entry field ``d``) is gated by ``max_chain_depth``;
        overlong chains reset to full/chunked entries. A leaf whose bits
        did not change (but was transferred anyway) also degenerates to a
        verbatim copy."""
        if tier not in ("exact", "lossy"):
            raise ValueError(f"unknown commit tier {tier!r}")
        parent_manifest = (self.get_manifest(parent_ref)
                          if parent_ref is not None else None)
        if parent_manifest is None:
            skip = frozenset()
        parent_depth = (int(parent_manifest.get("depth", 0))
                        if parent_manifest else 0)
        if graph_json is None:
            if (parent_manifest is not None
                    and set(flat) == set(parent_manifest["params"])):
                graph_json = parent_manifest["graph"]
            else:
                raise ValueError(
                    "commit_step needs graph_json when the leaf set differs "
                    "from the parent manifest's")
        cod_q = get_codec(step_codec, 1)  # level 1: hot-path default
        xd = get_codec("xd")
        entries: Dict[str, Any] = {}
        truths: Dict[str, np.ndarray] = {}
        states: Dict[str, FoldState] = {}
        copy_objs: List[str] = []
        counts = {"copied": 0, "delta": 0, "xdelta": 0, "full": 0}
        logical = 0

        with span("ckpt.delta", cat="ckpt", model=name, params=len(flat),
                  skipped=len(skip)), self.cas.batch():
            for key, value in flat.items():
                pe = (parent_manifest["params"].get(key)
                      if parent_manifest else None)
                if key in skip and pe is not None:
                    entries[key] = self._copy_step_entry(pe, parent_depth,
                                                         copy_objs)
                    counts["copied"] += 1
                    logical += self._entry_nbytes(pe)
                    continue
                if value is None:
                    raise ValueError(f"leaf {key!r} not in skip but has no "
                                     f"value")
                value = np.ascontiguousarray(value)
                logical += int(value.nbytes)
                pd = None
                if (self.delta_enabled and pe is not None
                        and pe["kind"] != "chunked"
                        and tuple(pe.get("shape", ())) == value.shape
                        and pe.get("dtype") == bf16.dtype_name(value)):
                    pd = int(pe.get("d", parent_depth))
                    if pd + 1 > self.max_chain_depth:
                        pd = None  # per-leaf chain reset
                if pd is None:
                    entries[key] = self._full_step_entry(
                        key, value, parent_ref, parent_manifest,
                        lossless=tier != "lossy")
                    counts["full"] += 1
                    continue
                pv = None
                if parent_hint is not None:
                    pv = parent_hint.get(key)
                if pv is None:
                    pv = self.cache.get((parent_ref, key))
                if pv is None:
                    pv = self.materialize_param(parent_ref, key)
                pv = np.asarray(pv)
                if (pv.shape != value.shape
                        or bf16.dtype_name(pv) != bf16.dtype_name(value)):
                    entries[key] = self._full_step_entry(
                        key, value, parent_ref, parent_manifest,
                        lossless=tier != "lossy")
                    counts["full"] += 1
                    continue
                if tier == "lossy" and value.dtype == np.float32:
                    diff = np.subtract(pv, value, dtype=np.float32)
                    amax = (float(np.max(np.abs(diff)))
                            if diff.size else 0.0)
                    if amax == 0.0:  # bit-identical to parent truth
                        entries[key] = self._copy_step_entry(
                            pe, parent_depth, copy_objs)
                        counts["copied"] += 1
                        continue
                    # grid matched to the EF estimator: quant_scale(eps)
                    # == amax/_Q_LEVELS, so q always narrows to int8
                    eps = ef_eps(amax)
                    q, nz, _narrow = host_snapshot(pv, value, eps)
                    q32 = (q if q.dtype == np.int32
                           else q.astype(np.int32))
                    truth, state = self._commit_truth(
                        parent_ref, key, pv, q32, "float32", eps=eps)
                    truth = np.asarray(truth).reshape(value.shape)
                    ccod = pick_codec(int(nz), q.size, cod_q)
                    blob = ccod.encode(q)
                    if len(blob) >= value.nbytes:
                        entries[key] = self._full_step_entry(
                            key, value, parent_ref, parent_manifest)
                        counts["full"] += 1
                        continue
                    entries[key] = {
                        "kind": "delta", "blob": self.cas.put_bytes(blob),
                        "parent_ref": parent_ref, "parent_key": key,
                        "codec": ccod.name, "eps": eps,
                        "shape": list(value.shape), "dtype": "float32",
                        "qdtype": str(q.dtype),
                        "hash": tensor_hash(truth), "d": pd + 1}
                    truths[key] = truth
                    if state is not None:
                        states[key] = state
                    counts["delta"] += 1
                else:
                    d = bitpattern_delta(value, pv)
                    if not d.any():  # same bits: re-reference, store nothing
                        entries[key] = self._copy_step_entry(
                            pe, parent_depth, copy_objs)
                        counts["copied"] += 1
                        continue
                    blob = xd.encode(d)
                    if len(blob) >= value.nbytes:
                        entries[key] = self._full_step_entry(
                            key, value, parent_ref, parent_manifest)
                        counts["full"] += 1
                        continue
                    entries[key] = {
                        "kind": "xdelta", "blob": self.cas.put_bytes(blob),
                        "parent_ref": parent_ref, "parent_key": key,
                        "codec": "xd", "shape": list(value.shape),
                        "dtype": bf16.dtype_name(value),
                        "qdtype": str(d.dtype),
                        "hash": tensor_hash(value), "d": pd + 1}
                    truths[key] = value
                    counts["xdelta"] += 1

            delta_parents = sorted({e["parent_ref"]
                                    for e in entries.values()
                                    if e.get("parent_ref")})
            with self.cas.batched_refcounts():
                for obj in copy_objs:
                    self.cas.incref(obj)
                for pref in delta_parents:
                    self.cas.incref(pref)
            depth = max((int(e.get("d", 0)) for e in entries.values()),
                        default=0)
            manifest = {
                "name": name,
                "model_type": model_type,
                "metadata": metadata or {},
                "graph": graph_json,
                "params": entries,
                "depth": depth,
                "delta_parents": delta_parents,
            }
            payload = json.dumps(manifest, sort_keys=True,
                                 default=str).encode()
            ref = self.cas.put_bytes(payload, key="m_" + bytes_hash(payload))

        with self._lock:
            self._manifests[ref] = manifest
            self.logical_bytes += logical
            self.io_stats["step_commits"] += 1
            self.io_stats["step_leaves_copied"] += counts["copied"]
            self.io_stats["step_leaves_delta"] += counts["delta"]
            self.io_stats["step_leaves_xdelta"] += counts["xdelta"]
            self.io_stats["step_leaves_full"] += counts["full"]
        self._persist_stats()
        # seed this commit's truth so the NEXT step's parent lookups (and
        # any checkout of this ref) are pure cache hits
        for k, v in truths.items():
            self.cache.put((ref, k), np.asarray(v))
        for k, st in states.items():
            self.fold_cache.put((ref, k), st)
        if parent_ref is not None:
            for k in skip:
                if k in entries:
                    v = self.cache.get((parent_ref, k))
                    if v is not None:
                        self.cache.put((ref, k), v)
        if flush:
            with span("commit.pack_fsync", cat="store"):
                self.cas.flush()  # commit point: index + refcounts durable
        return ref

    # -- chunk engine (DESIGN.md §12) --------------------------------------------
    def _chunk_candidates(self, artifact: ModelArtifact
                          ) -> "Dict[str, Any]":
        """Params of ``artifact`` routed through the chunk layer, as sources.

        Selection is metadata-only (spec/nbytes, no materialization); the
        values are chunk sources — wrappers exposing ``read(offset, size)``
        over raw contiguous bytes (``repro_torch.store.chunks``)."""
        if not self.chunk_threshold:
            return {}
        params = artifact.params
        out: Dict[str, Any] = {}
        for key in params:
            value = params.get(key) if hasattr(params, "get") else None
            if isinstance(params, LazyParams):
                shape, dtype = params.spec_of(key)
                item = bf16.np_dtype(dtype).itemsize
                nb = (int(np.prod(shape, dtype=np.int64) * item) if shape
                      else item)
                if nb < self.chunk_threshold:
                    continue
                value = params[key]  # materializes only >threshold params
            else:
                value = params[key]
                nb = getattr(value, "nbytes", None)
                if not isinstance(nb, (int, np.integer)):
                    nb = int(np.asarray(value).nbytes)
                if nb < self.chunk_threshold:
                    continue
            out[key] = chunklib.as_source(value)
        return out

    def _shard_segments(self, key: str, shape, itemsize: int):
        """Hard chunk-grid boundaries from the mesh sharding spec, or None."""
        if self.chunk_shards <= 1:
            return None
        from repro_torch.dist.sharding import shard_cuts
        return shard_cuts(key, shape, itemsize, self.chunk_shards)

    def _chunk_parent_entry(self, key: str, parent_ref: Optional[str],
                            parent_manifest: Optional[Dict[str, Any]],
                            source) -> Optional[Dict[str, Any]]:
        """The parent's chunked entry for ``key`` when its grid can be
        inherited 1:1 (same dtype and byte length, chain depth allows)."""
        if (parent_ref is None or parent_manifest is None
                or not self.delta_enabled
                or parent_manifest["depth"] >= self.max_chain_depth):
            return None
        pe = parent_manifest["params"].get(key)
        if (pe is None or pe.get("kind") != "chunked"
                or pe["dtype"] != bf16.dtype_name(source.dtype)
                or int(pe["nbytes"]) != int(source.nbytes)):
            return None
        return pe

    def _commit_chunked(self, key: str, source, parent_ref: Optional[str],
                        parent_manifest: Optional[Dict[str, Any]],
                        lossless: bool = False) -> Dict[str, Any]:
        """Stream one large param into chunk objects; return its entry.

        The tensor is processed through a bounded window: chunks are read,
        (optionally) delta-encoded against the parent's corresponding chunk
        and written in batches sized so in-flight bytes stay within
        ``chunk_window_bytes`` — the full tensor never exists in memory.
        The entry's ``hash`` is the stored-truth tensor hash, accumulated
        incrementally in chunk order (bit-identical to ``tensor_hash`` of
        the materialized checkout).

        Grid inheritance: when the parent has a chunked entry of identical
        dtype/length, its grid is reused so chunks align 1:1 and each chunk
        stores as (a) a reference to the parent's identical raw chunk, (b) a
        quantized per-chunk delta blob, (c) a pass-through marker (``p``:
        bit-identical to the parent chunk's truth), or (d) a fresh raw
        ``c_`` object. Without an inheritable grid, content-defined (or
        fixed) boundaries are computed and every chunk stores raw.

        ``lossless`` (the exact checkpoint tier, DESIGN.md §15) disables
        the quantized per-chunk delta path: the inherited grid still
        dedups unchanged chunks by content key, but changed chunks store
        raw bytes so the entry's truth IS the live value bit-for-bit."""
        dtype = bf16.np_dtype(source.dtype)
        shape = tuple(int(d) for d in source.shape)
        nbytes = int(source.nbytes)
        pe = self._chunk_parent_entry(key, parent_ref, parent_manifest,
                                      source)
        parent_chain = None
        if pe is not None:
            cuts = np.cumsum([int(it["n"]) for it in pe["chunks"]]).tolist()
            if not lossless:
                parent_chain = self._chunk_chain(parent_ref, key)
        else:
            cuts = chunklib.cut_points(
                source.read, nbytes, dtype.itemsize,
                min_size=self.chunk_min, avg_size=self.chunk_avg,
                max_size=self.chunk_max, mode=self.chunk_mode,
                segments=self._shard_segments(key, shape, dtype.itemsize))
        spans = chunklib.spans_of(cuts)
        delta_f32 = (parent_chain is not None
                     and bf16.dtype_name(dtype) == "float32")
        cod = self._codec_obj
        hasher = TensorHasher(shape, dtype)
        items: List[Optional[Dict[str, Any]]] = [None] * len(spans)

        def process(idx: int):
            """Worker: returns (tag, meta, payload, truth_bytes)."""
            off, n = spans[idx]
            data = bytes(source.read(off, n))
            ckey = "c_" + bytes_hash(data)
            if delta_f32:
                pitem = pe["chunks"][idx]
                if pitem.get("c") == ckey:
                    return ("c", ckey, data, data)  # identical raw chunk
                pbytes = self._chunk_value(parent_chain, idx)
                if data == pbytes:
                    # identical truth, but the parent chunk has no raw
                    # object of its own — record a pass-through
                    return ("p", None, None, data)
                child = np.frombuffer(data, dtype=np.float32)
                parent = np.frombuffer(pbytes, dtype=np.float32)
                q, nz, _narrow = host_snapshot(parent, child, self.eps)
                # density is free from the snapshot kernel: ultra-sparse
                # chunks (edit stragglers) switch to the sparse codec
                ccod = pick_codec(int(nz), q.size, cod)
                blob = ccod.encode(q)
                if len(blob) < n:
                    truth = host_dequant(parent, q, self.eps).tobytes()
                    if truth == pbytes:
                        return ("p", None, None, truth)
                    return ("b", (str(q.dtype), ccod.name), blob, truth)
            return ("c", ckey, data, data)

        # Bounded fan-out: each in-flight chunk holds ~4x its bytes (child,
        # parent, q, blob), so batches of window/(4*max_chunk) keep peak
        # in-flight memory within the configured window.
        max_len = max(n for _, n in spans)
        batch = max(1, self.chunk_window_bytes // max(1, 4 * max_len))
        use_pool = (self.io_workers > 1 and batch > 1 and len(spans) > 1)
        stream_span = span("commit.chunk_stream", cat="store", key=key,
                           chunks=len(spans), batch=batch)
        with stream_span:
            for lo in range(0, len(spans), batch):
                idxs = list(range(lo, min(len(spans), lo + batch)))
                if use_pool and len(idxs) > 1:
                    results = list(self._executor().map(propagate(process),
                                                        idxs))
                else:
                    results = [process(i) for i in idxs]
                for idx, (tag, meta, payload, truth) in zip(idxs, results):
                    n = spans[idx][1]
                    hasher.update(truth)
                    if tag == "c":
                        had = self.cas.has(meta)
                        self.cas.put_bytes(payload, key=meta)
                        items[idx] = {"c": meta, "n": n}
                        with self._lock:
                            self.io_stats["chunks_written"] += 1
                            if had:
                                self.io_stats["chunks_deduped"] += 1
                            else:
                                self.io_stats["chunk_bytes_written"] += n
                    elif tag == "b":
                        bkey = self.cas.put_bytes(payload)
                        qdtype, codname = meta
                        items[idx] = {"b": bkey, "n": n, "q": qdtype}
                        if codname != self.codec:
                            items[idx]["k"] = codname
                        with self._lock:
                            self.io_stats["chunk_delta_blobs"] += 1
                            self.io_stats["chunk_bytes_written"] += len(payload)
                    else:
                        items[idx] = {"p": 1, "n": n}
                        with self._lock:
                            self.io_stats["chunk_passthrough"] += 1

        entry: Dict[str, Any] = {"kind": "chunked",
                                 "hash": hasher.hexdigest(),
                                 "shape": list(shape),
                                 "dtype": bf16.dtype_name(dtype),
                                 "nbytes": nbytes, "chunks": items}
        if pe is not None and any("b" in it or "p" in it for it in items):
            # at least one chunk is stored relative to the parent: record
            # the chain link (and the decode parameters shared by all blobs)
            entry.update({"parent_ref": parent_ref, "parent_key": key,
                          "eps": self.eps, "codec": self.codec})
        return entry

    def _chunk_chain(self, ref: str, key: str) -> List[Dict[str, Any]]:
        """Chunked entries child-first along parent links (cycle-checked)."""
        chain: List[Dict[str, Any]] = []
        cur_ref, cur_key = ref, key
        seen = set()
        while True:
            if (cur_ref, cur_key) in seen:
                raise RuntimeError(
                    f"chunk chain cycle at {cur_ref!r}:{cur_key!r}")
            seen.add((cur_ref, cur_key))
            e = self._entry(cur_ref, cur_key)
            if e.get("kind") != "chunked":
                raise RuntimeError(
                    f"chunk chain of {ref!r}:{key!r} reaches non-chunked "
                    f"entry at {cur_ref!r}:{cur_key!r} (corrupt manifest)")
            chain.append(e)
            if not e.get("parent_ref"):
                return chain
            cur_ref, cur_key = e["parent_ref"], e["parent_key"]

    def _chunk_value(self, chain: List[Dict[str, Any]], idx: int) -> bytes:
        """Raw truth bytes of chunk ``idx`` of ``chain[0]``'s tensor.

        Walks down the chain until a raw ``c`` item, then applies the
        recorded per-chunk dequant hops back up (``p`` items copy through).
        Chunk reads bypass the mmap pool: checkout of a huge tensor must
        not charge mapped pages to the process RSS high-water mark."""
        level = 0
        hops: List[Tuple[Dict[str, Any], Dict[str, Any]]] = []
        while True:
            e = chain[level]
            item = e["chunks"][idx]
            if "c" in item:
                with span("checkout.read", cat="store"):
                    base = self.cas.get_bytes_nomap(item["c"])
                break
            if "p" in item:
                level += 1
                continue
            hops.append((e, item))
            level += 1
        with self._lock:
            self.io_stats["chunks_read"] += 1
        if not hops:
            return base
        value = np.frombuffer(base, dtype=np.float32)
        for e, item in reversed(hops):
            with span("checkout.read", cat="store"):
                blob = self.cas.get_bytes_nomap(item["b"])
            n = int(item["n"]) // 4
            # per-item ``k`` overrides the entry codec (density-adaptive
            # sparse pick at commit time); absent means the entry default
            with span("checkout.decode", cat="store"):
                q = get_codec(item.get("k", e["codec"])).decode(
                    blob, n, dtype=item.get("q", "int32"))
            with span("checkout.apply", cat="store"):
                value = host_dequant(value, q, float(e["eps"]))
            with self._lock:
                self.io_stats["dequant_calls"] += 1
                self.io_stats["chain_hops"] += 1
        return value.tobytes()

    def _materialize_chunked(self, ref: str, key: str) -> np.ndarray:
        """Decode a chunked param into one preallocated destination array."""
        e = self._entry(ref, key)
        chain = self._chunk_chain(ref, key)
        spans = chunklib.spans_of(
            np.cumsum([int(it["n"]) for it in e["chunks"]]).tolist())
        out = np.empty(tuple(e["shape"]), dtype=bf16.np_dtype(e["dtype"]))
        flat = out.reshape(-1).view(np.uint8)

        def fill(idx: int) -> None:
            off, n = spans[idx]
            flat[off:off + n] = np.frombuffer(
                self._chunk_value(chain, idx), dtype=np.uint8)

        # Fan out only from a non-pool thread (pool workers must never
        # submit back into the shared pool — materialize_artifact already
        # parallelizes across params); writes hit disjoint slices.
        on_pool = threading.current_thread().name.startswith(
            "artifact-store-io")
        if not on_pool and self.io_workers > 1 and len(spans) > 2:
            list(self._executor().map(propagate(fill), range(len(spans))))
        else:
            for i in range(len(spans)):
                fill(i)
        out.flags.writeable = False
        self._count_materialization(out)
        return out

    def stream_param(self, ref: str, key: str):
        """Yield ``(offset, bytes)`` covering one param's raw bytes in order.

        For chunked entries this is the bounded-memory checkout path — one
        chunk's truth is in flight at a time; non-chunked entries yield a
        single span (they are sub-threshold by construction)."""
        e = self._entry(ref, key)
        if e.get("kind") != "chunked":
            v = np.ascontiguousarray(self.materialize_param(ref, key))
            yield 0, v.tobytes()
            return
        chain = self._chunk_chain(ref, key)
        spans = chunklib.spans_of(
            np.cumsum([int(it["n"]) for it in e["chunks"]]).tolist())
        for idx, (off, _n) in enumerate(spans):
            yield off, self._chunk_value(chain, idx)

    def materialize_param_to_file(self, ref: str, key: str,
                                  path: str) -> str:
        """Streaming checkout of one param into a raw little-endian file.

        Returns the tensor hash of the bytes written (accumulated
        incrementally); equal to the manifest entry's ``hash`` iff the
        checkout is bit-identical to the committed truth."""
        e = self._entry(ref, key)
        hasher = TensorHasher(tuple(e["shape"]), e["dtype"])
        with open(path, "wb") as f:
            for _off, data in self.stream_param(ref, key):
                f.write(data)
                hasher.update(data)
        return hasher.hexdigest()

    def chunk_range_objects(self, ref: str, key: str, start: int,
                            end: int) -> List[str]:
        """CAS keys needed to reconstruct bytes [start, end) of a chunked
        param — the shard-scoped fetch set (DESIGN.md §12): a distributed
        consumer asks only for the chunks overlapping its shard."""
        e = self._entry(ref, key)
        if e.get("kind") != "chunked":
            raise ValueError(f"{ref!r}:{key!r} is not chunked")
        chain = self._chunk_chain(ref, key)
        spans = chunklib.spans_of(
            np.cumsum([int(it["n"]) for it in e["chunks"]]).tolist())
        needed: List[str] = []
        for idx, (off, n) in enumerate(spans):
            if off + n <= start or off >= end:
                continue
            level = 0
            while True:
                item = chain[level]["chunks"][idx]
                if "c" in item:
                    needed.append(item["c"])
                    break
                if "b" in item:
                    needed.append(item["b"])
                level += 1
        return needed

    def materialize_param_range(self, ref: str, key: str, start: int,
                                end: int) -> bytes:
        """Truth bytes [start, end) of a chunked param (shard checkout)."""
        e = self._entry(ref, key)
        if e.get("kind") != "chunked":
            v = np.ascontiguousarray(self.materialize_param(ref, key))
            return memoryview(v).cast("B")[start:end].tobytes()
        chain = self._chunk_chain(ref, key)
        spans = chunklib.spans_of(
            np.cumsum([int(it["n"]) for it in e["chunks"]]).tolist())
        out = bytearray(end - start)
        for idx, (off, n) in enumerate(spans):
            if off + n <= start or off >= end:
                continue
            data = self._chunk_value(chain, idx)
            s, t = max(start, off), min(end, off + n)
            out[s - start:t - start] = data[s - off:t - off]
        return bytes(out)

    # -- manifests ----------------------------------------------------------------
    def reload(self) -> None:
        """Pick up commits made by OTHER processes since this store opened.

        Delegates to :meth:`CAS.reload` (re-index packs, tail-scan new
        appends). Tensor/fold/manifest caches are content-addressed, so
        nothing cached can go stale — new refs simply read through."""
        self.cas.reload()

    def get_manifest(self, ref: str) -> Dict[str, Any]:
        with self._lock:
            cached = self._manifests.get(ref)
        if cached is not None:
            return cached
        manifest = json.loads(self.cas.get_bytes(ref))
        with self._lock:
            self._manifests[ref] = manifest
        return manifest

    def _entry(self, ref: str, key: str) -> Dict[str, Any]:
        manifest = self.get_manifest(ref)
        try:
            return manifest["params"][key]
        except KeyError:
            raise KeyError(f"manifest {ref!r} has no param {key!r}")

    # -- chain resolution ---------------------------------------------------------
    def _walk_entries(self, ref: str, key: str):
        """Yield ``(ref, key, entry)`` down one parameter's delta chain.

        The ONE chain-walk loop every resolver shares (plan inspection,
        fold recipes, manifest prefetch). Iterative, cycle-checked via a
        visited set — NOT this store's max_chain_depth: the store may have
        been reopened with a smaller depth knob than the one the chain was
        written with, and that is valid data. Ends after the first
        non-``delta`` entry (``full``, a ``chunked`` chain base, or an
        ``xdelta`` hop — those resolve through their own engines, not this
        walk); callers early-exit by breaking."""
        cur_ref, cur_key = ref, key
        seen = set()
        while True:
            if (cur_ref, cur_key) in seen:
                raise RuntimeError(
                    f"delta chain cycle at {cur_ref!r}:{cur_key!r} "
                    f"(corrupt manifest chain)")
            seen.add((cur_ref, cur_key))
            e = self._entry(cur_ref, cur_key)
            yield cur_ref, cur_key, e
            if e["kind"] != "delta":
                return
            cur_ref, cur_key = e["parent_ref"], e["parent_key"]

    def resolve_chain(self, ref: str, key: str) -> ReconstructionPlan:
        """Walk one parameter's delta chain; emit a flat reconstruction plan.

        Iterative (no recursion) and single-parameter: sibling tensors are
        never touched. The walk stops early at the first chain link already
        materialized in the tensor cache."""
        with self._lock:
            self.io_stats["plans_resolved"] += 1
        hops: List[DeltaHop] = []
        for cur_ref, cur_key, e in self._walk_entries(ref, key):
            if hops and self.cache.contains((cur_ref, cur_key)):
                return ReconstructionPlan("cache", (cur_ref, cur_key),
                                          tuple(reversed(hops)))
            if e["kind"] == "full":
                return ReconstructionPlan("full", e["tensor"],
                                          tuple(reversed(hops)))
            if e["kind"] in ("chunked", "xdelta"):
                # chain base owned by another engine (chunk decode or the
                # lossless bitpattern apply): downstream it behaves like an
                # already-cached value
                return ReconstructionPlan("chunked", (cur_ref, cur_key),
                                          tuple(reversed(hops)))
            hops.append(self._hop_of(e, cur_ref, cur_key))

    def chain_recipe(self, ref: str, key: str
                     ) -> Tuple[str, str, Dict[str, Any], List[DeltaHop]]:
        """Structural chain walk for out-of-store executors (the serving
        pool's derivative-view materialization, DESIGN.md §13).

        Returns ``(terminal_ref, terminal_key, terminal_entry, hops)``:
        the chain base entry (``full`` or ``chunked``) plus every delta hop
        in base->tip order. Unlike :meth:`resolve_chain` this never
        consults the tensor cache — the caller owns its own residency
        story and needs the full structural recipe, not a cache shortcut."""
        hops: List[DeltaHop] = []
        for cur_ref, cur_key, e in self._walk_entries(ref, key):
            if e["kind"] != "delta":
                return cur_ref, cur_key, e, list(reversed(hops))
            hops.append(self._hop_of(e, cur_ref, cur_key))
        raise RuntimeError(f"chain of {ref!r}:{key!r} has no base entry")

    @staticmethod
    def _hop_of(e: Dict[str, Any], ref: str, key: str) -> DeltaHop:
        return DeltaHop(ref=ref, key=key, blob=e["blob"], codec=e["codec"],
                        eps=e["eps"], shape=tuple(e["shape"]),
                        dtype=e["dtype"], qdtype=e.get("qdtype", "int32"))

    @staticmethod
    def _is_segment_boundary(above: DeltaHop, below: Dict[str, Any]) -> bool:
        """True iff hop ``above`` STARTS a new fold segment over entry
        ``below`` (its chain parent). Structural — depends only on manifest
        metadata, never on cache state, so every reader segments a chain
        identically (§10.2)."""
        return (above.dtype != "float32" or below["dtype"] != "float32"
                or float(below["eps"]) != above.eps)

    def _resolve_recipe(self, ref: str, key: str):
        """Chain walk for the folding executor.

        Returns ``(origin, pending)`` where ``pending`` lists hops tip-first
        and ``origin`` is one of ``("tensor", hash)`` — the chain base —
        ``("value", ndarray)`` — a cached link at a segment boundary (safe:
        the hops above it fold independently of how the link was computed) —
        or ``("fold", FoldState)`` — a cached open-segment state the
        remaining hops extend bit-exactly."""
        with self._lock:
            self.io_stats["plans_resolved"] += 1
        pending: List[DeltaHop] = []
        for cur_ref, cur_key, e in self._walk_entries(ref, key):
            if e["kind"] in ("chunked", "xdelta"):
                # chunk-engine or xdelta base for a delta chain built on
                # top of it: materialize it (cached) as a value origin
                v = self.cache.get((cur_ref, cur_key))
                if v is None:
                    v = self.materialize_param(cur_ref, cur_key)
                return ("value", v), pending
            if e["kind"] == "full":
                if pending:
                    v = self.cache.get((cur_ref, cur_key))
                    if v is not None:
                        return ("value", v), pending
                return ("tensor", e["tensor"]), pending
            if pending:
                if self.fold_enabled:
                    fs = self.fold_cache.get((cur_ref, cur_key))
                    if fs is not None:
                        with self._lock:
                            self.io_stats["fold_hits"] += 1
                        return ("fold", fs), pending
                if self._is_segment_boundary(pending[-1], e):
                    v = self.cache.get((cur_ref, cur_key))
                    if v is not None:
                        return ("value", v), pending
            pending.append(self._hop_of(e, cur_ref, cur_key))

    def _dequant(self, value: np.ndarray, q: np.ndarray, eps: float,
                 out_dtype: str) -> np.ndarray:
        """One counted dequant application.

        The pipelined engine uses the numpy host path on the ``"ref"``
        backend (bit-identical to the plain torch version, no dispatch
        overhead); the serial baseline (``pipelined=False``) keeps the
        per-hop ``ops`` dispatch so benchmarks measure the pre-pipeline
        engine faithfully. Device backends always dispatch."""
        if self.pipelined and self.backend == "ref":
            out = host_dequant(value, q, eps, out_dtype=out_dtype)
        else:
            out = np.asarray(ops.dequant_apply(
                np.asarray(value), q, eps=eps, backend=self.backend,
                out_dtype=out_dtype))
        with self._lock:
            self.io_stats["dequant_calls"] += 1
        self._count_materialization(out)
        return out

    def _sum_q(self, qs: List[np.ndarray]) -> np.ndarray:
        """Exact int32 sum of a segment's quantized deltas (narrowed int8
        hops widen on the first accumulation; a cached state's sum is
        never mutated — the first add allocates)."""
        acc = qs[0] if qs[0].dtype == np.int32 else qs[0].astype(np.int32)
        for q in qs[1:]:
            acc = np.add(acc, q.reshape(acc.shape), dtype=np.int32)
        return acc

    def _apply_segment(self, value: np.ndarray, open_qs: List[np.ndarray],
                       eps: float, need_sum: bool
                       ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Close one fold segment: value <- dequant(value, Σ open_qs, eps).

        On device backends a multi-hop segment goes through the fused
        chain-apply kernel (one HBM pass over base + q stack, int32
        reduction in registers) — bit-identical to host sum + dequant. Returns
        ``(value, qsum)``; the sum is only computed when the caller needs
        it for a FoldState (``need_sum``) or the host path uses it. Spanned
        as ``checkout.apply``, with its copies and the host sum."""
        with span("checkout.apply", cat="store"):
            if len(open_qs) > 1 and self.backend != "ref":
                out = np.asarray(ops.chain_apply(
                    np.asarray(value), open_qs, eps=eps, backend=self.backend,
                    out_dtype="float32"))
                with self._lock:
                    self.io_stats["dequant_calls"] += 1
                self._count_materialization(out)
                return out, (self._sum_q(open_qs) if need_sum else None)
            qsum = self._sum_q(open_qs)
            return self._dequant(value, qsum, eps, "float32"), qsum

    def _materialize_with_state(self, ref: str, key: str,
                                plan: Optional[ReconstructionPlan] = None
                                ) -> Tuple[np.ndarray, Optional[FoldState]]:
        """Execute one param's chain, returning (value, open FoldState|None).

        Bypasses the (ref, key) tensor-cache probe — callers that need the
        fold state (commit) must re-derive it even when the value is warm.
        A full-base ``plan`` (from ``resolve_chain``) substitutes for the
        walk; cache-base plans are not segment-aware and are re-resolved."""
        if plan is not None and plan.base_kind == "full":
            origin, pending = ("tensor", plan.base), list(reversed(plan.hops))
        else:
            origin, pending = self._resolve_recipe(ref, key)
        hops = list(reversed(pending))  # base -> tip order
        kind, payload = origin
        open_qs: List[np.ndarray] = []
        open_eps = 0.0
        if kind == "tensor":
            with span("checkout.read", cat="store"):
                value = self.cas.get_tensor(payload)
            self._count_materialization(value)
        elif kind == "value":
            value = payload
        else:  # fold state: its accumulated sum seeds the open segment
            fs: FoldState = payload
            value, open_qs, open_eps = fs.seg_base, [fs.q_open], fs.eps
        for hop in hops:
            with span("checkout.read", cat="store"):
                blob = self.cas.get_view(hop.blob)
            with span("checkout.decode", cat="store"):
                q = decode_q(hop, blob)
            with self._lock:
                self.io_stats["chain_hops"] += 1
            if self.fold_enabled and hop.dtype == "float32":
                if open_qs and hop.eps == open_eps:
                    open_qs.append(q)
                    with self._lock:
                        self.io_stats["hops_folded"] += 1
                else:
                    if open_qs:
                        value, _ = self._apply_segment(value, open_qs,
                                                       open_eps, False)
                    open_qs, open_eps = [q], hop.eps
            else:
                if open_qs:
                    value, _ = self._apply_segment(value, open_qs, open_eps,
                                                   False)
                    open_qs = []
                with span("checkout.apply", cat="store"):
                    value = self._dequant(value, q, hop.eps, hop.dtype
                                          ).reshape(hop.shape)
        state = None
        if open_qs:
            value = np.asarray(value)
            new_value, qsum = self._apply_segment(value, open_qs, open_eps,
                                                  True)
            state = FoldState(seg_base=value, q_open=qsum, eps=open_eps)
            value = new_value
        if hops:
            value = np.asarray(value).reshape(hops[-1].shape)
        return value, state

    def _materialize_xdelta(self, ref: str, key: str,
                            e: Dict[str, Any]) -> np.ndarray:
        """Apply one lossless bitpattern hop: parent truth + stored delta.

        The recursive parent materialization handles mixed chains (xdelta
        over delta over full, etc.) and is bounded by the per-leaf chain
        depth gate at commit time."""
        parent = self.materialize_param(e["parent_ref"], e["parent_key"])
        n = int(np.prod(e["shape"], dtype=np.int64)) if e["shape"] else 1
        qdt = np.dtype(e.get("qdtype", "uint32"))
        # element count of the stored delta, not of the tensor: dtypes
        # whose itemsize has no native unsigned width (complex, …) delta
        # over a byte-wise view, so the blob holds nbytes uint8 elements
        n = n * bf16.np_dtype(e["dtype"]).itemsize // qdt.itemsize
        with span("checkout.read", cat="store"):
            blob = self.cas.get_view(e["blob"])
        with span("checkout.decode", cat="store"):
            d = get_codec(e["codec"]).decode(blob, n, dtype=str(qdt))
        with span("checkout.apply", cat="store"):
            value = bitpattern_apply(parent, d, e["dtype"],
                                     tuple(e["shape"]))
        with self._lock:
            self.io_stats["chain_hops"] += 1
        self._count_materialization(value)
        return value

    def materialize_param(self, ref: str, key: str,
                          plan: Optional[ReconstructionPlan] = None
                          ) -> np.ndarray:
        """Materialize one parameter through the segment-folding executor.

        A full-base ``plan`` (already resolved by ``resolve_chain``) skips
        the second chain walk; cache-base plans are re-resolved — their
        shortcut is not segment-aware."""
        cached = self.cache.get((ref, key))
        if cached is not None:
            return cached
        e = self._entry(ref, key)
        if e["kind"] == "chunked":
            with span("checkout.param", cat="store", key=key,
                      kind="chunked"):
                value = self._materialize_chunked(ref, key)
            self.cache.put((ref, key), value)
            return value
        if e["kind"] == "xdelta":
            with span("checkout.param", cat="store", key=key,
                      kind="xdelta"):
                value = self._materialize_xdelta(ref, key, e)
            self.cache.put((ref, key), value)
            return value
        with span("checkout.param", cat="store", key=key):
            value, state = self._materialize_with_state(ref, key, plan=plan)
        self.cache.put((ref, key), value)
        if state is not None:
            self.fold_cache.put((ref, key), state)
        return value

    def materialize_artifact(self, ref: str,
                             keys: Optional[Sequence[str]] = None,
                             max_workers: Optional[int] = None
                             ) -> ModelArtifact:
        """Batched checkout: materialize all (or ``keys``) params of ``ref``.

        The full-model counterpart of ``materialize_param`` (DESIGN.md
        §10.3): per-param chains share manifest state (prefetched once on
        the calling thread) and fold states, and blob decode + fold fans
        out across a thread pool — LZMA decompression releases the GIL, so
        the batch overlaps codec work the serial loop serializes. Returns a
        NON-lazy artifact; everything lands in the tensor cache, so lazy
        views of the same ref become cache hits."""
        manifest = self.get_manifest(ref)
        want = list(keys if keys is not None else manifest["params"])
        out: Dict[str, np.ndarray] = {}
        misses: List[str] = []
        for k in want:
            v = self.cache.get((ref, k))
            if v is not None:
                out[k] = v
            else:
                misses.append(k)
        if misses:
            with span("store.checkout", cat="store", params=len(misses)):
                # prefetch the manifest chains serially (dict work, no
                # decode): worker threads then walk fully-cached manifests
                for k in misses:
                    for _ in self._walk_entries(ref, k):
                        pass
                workers = min(max_workers or self.io_workers, len(misses))
                one = propagate(lambda k: self.materialize_param(ref, k))
                if workers > 1 and len(misses) > 1:
                    if (max_workers is not None
                            and max_workers != self.io_workers):
                        # explicit sizing (CLI --jobs): a transient pool of
                        # the requested width, not the store's shared default
                        with ThreadPoolExecutor(max_workers=workers) as pool:
                            mapped = list(pool.map(one, misses))
                    else:
                        mapped = list(self._executor().map(one, misses))
                    for k, v in zip(misses, mapped):
                        out[k] = v
                else:
                    for k in misses:
                        out[k] = one(k)
        return ModelArtifact(
            graph=LayerGraph.from_json(manifest["graph"]),
            params={k: out[k] for k in want},
            model_type=manifest.get("model_type", "generic"),
            metadata=manifest.get("metadata", {}),
        )

    def _count_materialization(self, value: np.ndarray) -> None:
        with self._lock:
            self.io_stats["tensors_materialized"] += 1
            self.io_stats["bytes_materialized"] += int(
                np.asarray(value).nbytes)

    def reset_io_stats(self) -> Dict[str, float]:
        # Registry-atomic reset: every key zeroes under ONE group lock, so
        # a concurrent reader can never observe the half-reset view the
        # old per-key mutation loop allowed. The store lock additionally
        # serializes against in-flight `io_stats[k] += n` read-modify-write
        # sequences (which hold it). Returns the pre-reset snapshot.
        with self._lock:
            return self.io_stats.reset()

    # -- load --------------------------------------------------------------------
    def load_artifact(self, ref: str, lazy: bool = True) -> ModelArtifact:
        """Checkout ``ref``. Lazy by default: params materialize on access.

        ``lazy=False`` routes through the batched ``materialize_artifact``
        engine (threaded decode + chain folding)."""
        if not lazy:
            return self.materialize_artifact(ref)
        manifest = self.get_manifest(ref)
        refs = {
            key: ParamRef(store=self, ref=ref, key=key,
                          shape=tuple(e.get("shape", ())),
                          dtype=e.get("dtype", "float32"),
                          hash=e.get("hash") or e.get("tensor"))
            for key, e in manifest["params"].items()
        }
        return ModelArtifact(
            graph=LayerGraph.from_json(manifest["graph"]),
            params=LazyParams(refs),
            model_type=manifest.get("model_type", "generic"),
            metadata=manifest.get("metadata", {}),
        )

    def load_artifact_recursive(self, ref: str,
                                _depth: int = 0) -> ModelArtifact:
        """Pre-plan eager loader (reference implementation).

        Recursively materializes every FULL ancestor artifact to resolve the
        chain — O(full model x chain depth) peak memory. Kept as the
        benchmark baseline for ``benchmarks/bench_compression.py``; all
        production paths go through ``load_artifact``/``materialize_param``.
        Reconstruction follows the same segment-folding semantics (§10.2) —
        the recursion threads each param's open-segment state — so its
        output is bit-identical to the plan engine's."""
        artifact, _ = self._load_recursive_with_states(ref)
        return artifact

    def _load_recursive_with_states(self, ref: str):
        manifest = self.get_manifest(ref)
        params: Dict[str, np.ndarray] = {}
        states: Dict[str, Optional[FoldState]] = {}
        parent_cache: Dict[str, Tuple[ModelArtifact, Dict]] = {}
        for key, e in manifest["params"].items():
            if e["kind"] == "full":
                params[key] = self.cas.get_tensor(e["tensor"])
                states[key] = None
                continue
            if e["kind"] == "chunked":
                params[key] = self._materialize_chunked(ref, key)
                states[key] = None
                continue
            if e["kind"] == "xdelta":
                params[key] = self._materialize_xdelta(ref, key, e)
                states[key] = None
                continue
            pref = e["parent_ref"]
            if pref not in parent_cache:
                parent_cache[pref] = self._load_recursive_with_states(pref)
            parent_art, parent_states = parent_cache[pref]
            pkey = e["parent_key"]
            parent_val = np.asarray(parent_art.params[pkey])
            hop = self._hop_of(e, ref, key)
            q = decode_q(hop, self.cas.get_view(hop.blob))
            ps = parent_states.get(pkey)
            if self.fold_enabled and hop.dtype == "float32":
                if ps is not None and ps.eps == hop.eps:
                    st = FoldState(seg_base=ps.seg_base,
                                   q_open=np.add(ps.q_open, q.reshape(
                                       ps.q_open.shape), dtype=np.int32),
                                   eps=hop.eps)
                else:
                    st = FoldState(seg_base=parent_val, q_open=q,
                                   eps=hop.eps)
                states[key] = st
                params[key] = host_dequant(st.seg_base, st.q_open, st.eps
                                           ).reshape(hop.shape)
            else:
                d = ParamDelta(child_key=key, parent_key=pkey,
                               blob=self.cas.get_bytes(e["blob"]),
                               codec=e["codec"], eps=e["eps"],
                               shape=tuple(e["shape"]), dtype=e["dtype"],
                               raw_bytes=0, qdtype=e.get("qdtype", "int32"))
                params[key] = decompress_param(parent_val, d,
                                               backend=self.backend)
                states[key] = None
        artifact = ModelArtifact(
            graph=LayerGraph.from_json(manifest["graph"]),
            params=params,
            model_type=manifest.get("model_type", "generic"),
            metadata=manifest.get("metadata", {}),
        )
        return artifact, states

    # -- sync/integrity support (DESIGN.md §8) ------------------------------------
    def manifest_closure(self, refs: Sequence[str]
                         ) -> Tuple[Dict[str, Any], List[str]]:
        """Transitive storage dependencies of ``refs`` along delta chains.

        Returns ``(closure, missing)``: ``{manifest_ref: ManifestInfo}`` via
        the shared walk (``repro_torch.store.manifest_walk``) plus the refs that
        could not be read."""
        missing: List[str] = []

        def fetch(keys: Sequence[str]) -> Dict[str, bytes]:
            out: Dict[str, bytes] = {}
            for k in keys:
                try:
                    out[k] = self.cas.get_bytes(k)
                except Exception:
                    pass  # the walk records it as missing
            return out

        closure = walk_manifests(fetch, refs, missing=missing)
        return closure, missing

    def expected_refcounts(self, roots: Sequence[str]) -> Dict[str, int]:
        """Reconstruct exact refcounts from the manifest graph.

        Mirrors commit-time accounting: each manifest holds one reference
        per param entry on its tensor/blob and one per delta parent; each
        occurrence in ``roots`` (a lineage ``artifact_ref``) holds one
        reference on the manifest itself. Only keys *reachable from roots*
        appear — counts for anything else are out of scope."""
        closure, _ = self.manifest_closure(roots)
        counts: Dict[str, int] = {ref: 0 for ref in closure}
        for info in closure.values():
            for k in info.objects:
                counts[k] = counts.get(k, 0) + 1
            for p in info.parents:
                counts[p] = counts.get(p, 0) + 1
        for r in roots:
            if r in closure:
                counts[r] += 1
        return counts

    def rebuild_refcounts(self, roots: Sequence[str]) -> Dict[str, int]:
        """Install exact refcounts for everything reachable from ``roots``.

        The post-transfer step of a sync (DESIGN.md §8.5): imported objects
        arrive with placeholder counts; one rebuild makes the receiving side
        bit-equivalent to having committed the graph locally. Keys NOT
        reachable from ``roots`` are left untouched, so callers owning other
        root sets lose nothing."""
        counts = self.expected_refcounts(roots)
        with self.cas.batched_refcounts():
            for key, count in counts.items():
                if self.cas.has(key):
                    self.cas.refcounts[key] = count
        self.cas.flush()
        return counts

    def import_objects(self, objects) -> int:
        """Raw object ingestion for sync transfers (idempotent per key).

        Keys are trusted as content addresses here; ``fsck`` re-verifies.
        Returns bytes actually written (dedup hits cost nothing). Lands
        through one buffered CAS batch — a pull/clone pays one fsync, not
        one per object."""
        written = 0
        with self.cas.batch():
            for key, data in objects.items():
                if not self.cas.has(key):
                    self.cas.put_bytes(data, key=key)
                    written += len(data)
        self.cas.flush()
        return written

    def export_flat_manifest(self, ref: str, name: Optional[str] = None
                             ) -> Tuple[str, Dict[str, bytes]]:
        """Build a flattened (depth-0) equivalent of ``ref`` *transiently*.

        The shallow-push fallback: when a receiver can't get the delta
        chain, ship materialized tensors instead. Returns ``(flat_ref,
        objects)`` where ``objects`` holds the new manifest payload plus
        every tensor's npy bytes, ready for the wire. Nothing is committed
        into THIS store — a sender must stay refcount-clean after a push
        (committing here would orphan a manifest no lineage node references
        and bump shared-tensor counts into permanent fsck drift). Tensors
        materialize through the batched checkout engine; their serialized
        bytes are all held for transfer, so peak memory is O(model). Plan
        execution is bit-exact with commit-time reconstruction (§10.2), so
        the flattened model is bit-identical to the chained one."""
        manifest = self.get_manifest(ref)
        artifact = self.materialize_artifact(ref)
        entries: Dict[str, Any] = {}
        objects: Dict[str, bytes] = {}
        for key in artifact.params:
            value = np.asarray(artifact.params[key])
            thash = tensor_hash(value)
            objects[thash] = npy_bytes(value)
            entries[key] = {"kind": "full", "tensor": thash,
                            "shape": list(value.shape),
                            "dtype": bf16.dtype_name(value), "hash": thash}
        flat = {
            "name": name or manifest.get("name", "flat"),
            "model_type": manifest.get("model_type", "generic"),
            "metadata": manifest.get("metadata", {}),
            "graph": manifest["graph"],
            "params": entries,
            "depth": 0,
            "delta_parents": [],
        }
        payload = json.dumps(flat, sort_keys=True, default=str).encode()
        flat_ref = "m_" + bytes_hash(payload)
        objects[flat_ref] = payload
        return flat_ref, objects

    def fsck(self, roots: Sequence[str] = ()) -> Dict[str, Any]:
        """CAS integrity pass plus manifest-graph cross-checks.

        Extends :meth:`CAS.fsck` with: ``missing_objects`` (keys the manifest
        closure of ``roots`` references but the CAS lacks) and
        ``refcount_drift`` (``{key: [actual, expected]}``; undercounts risk
        premature collection, overcounts only delay it).

        For chunked params, damage is pinpointed: ``chunk_damage`` maps each
        corrupt/missing chunk object back to ``(ref, param, chunk index)``,
        so a single bad chunk identifies exactly which slice of which tensor
        is lost rather than condemning the whole multi-GB object."""
        report = self.cas.fsck()
        closure, missing_refs = self.manifest_closure(roots)
        expected = self.expected_refcounts(roots)
        # has() treats a refcounted key as present even when its object file
        # is gone (the refcount table is authoritative for liveness, not
        # bytes) — the CAS pass reports those as dangling refs; reachable
        # ones are missing objects from the manifest graph's point of view
        missing = sorted(set(missing_refs)
                         | {k for k in expected if not self.cas.has(k)}
                         | (set(report["dangling_refs"]) & set(expected)))
        drift = {k: [self.cas.refcounts.get(k, 0), v]
                 for k, v in expected.items()
                 if self.cas.has(k) and self.cas.refcounts.get(k, 0) != v}
        bad = set(report["corrupt"]) | set(missing)
        chunk_damage: List[Dict[str, Any]] = []
        if bad:
            for mref in closure:
                try:
                    manifest = self.get_manifest(mref)
                except Exception:
                    continue
                for pkey, e in manifest["params"].items():
                    if e.get("kind") != "chunked":
                        continue
                    for i, item in enumerate(e["chunks"]):
                        k = item.get("c") or item.get("b")
                        if k and k in bad:
                            chunk_damage.append(
                                {"ref": mref, "param": pkey, "chunk": i,
                                 "object": k,
                                 "problem": ("corrupt"
                                             if k in report["corrupt"]
                                             else "missing")})
        report["manifests_reachable"] = len(closure)
        report["missing_objects"] = missing
        report["refcount_drift"] = drift
        report["chunk_damage"] = chunk_damage
        report["ok"] = bool(report["ok"] and not missing and not drift)
        return report

    # -- lifecycle ------------------------------------------------------------------
    def release(self, ref: str) -> None:
        """Drop one reference to a manifest and everything it points at."""
        try:
            manifest = self.get_manifest(ref)
        except Exception:
            return
        with self.cas.batched_refcounts():  # ONE durable write for the lot
            for e in manifest["params"].values():
                if e["kind"] == "chunked":
                    # mirror of commit/parse_manifest accounting: one ref
                    # per chunk object occurrence (pass-throughs own none)
                    for item in e["chunks"]:
                        k = item.get("c") or item.get("b")
                        if k:
                            self.cas.decref(k)
                else:
                    self.cas.decref(e["tensor"] if e["kind"] == "full"
                                    else e["blob"])
            for pref in manifest.get("delta_parents", []):
                self.cas.decref(pref)
            self.cas.decref(ref)
        self.cache.drop_ref(ref)
        self.fold_cache.drop_ref(ref)

    def gc(self) -> int:
        return self.cas.gc()

    def _persist_stats(self) -> None:
        if self._stats_path is None:
            return
        with self._lock:  # concurrent commits share one tmp path
            tmp = self._stats_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"logical_bytes": self.logical_bytes,
                           "truth": ("fold" if self.fold_enabled
                                     else "hopwise")}, f)
            os.replace(tmp, self._stats_path)

    # -- accounting -------------------------------------------------------------------
    def compression_ratio(self) -> float:
        return self.logical_bytes / max(self.cas.physical_bytes(), 1)

    def stats(self) -> Dict[str, Any]:
        return {
            "logical_bytes": self.logical_bytes,
            "physical_bytes": self.cas.physical_bytes(),
            "compression_ratio": self.compression_ratio(),
            "objects": self.cas.object_count(),
            "cache_bytes": self.cache.bytes_used,
            "cache_entries": len(self.cache),
            "cache_hits": self.cache.hits,
            "cache_misses": self.cache.misses,
            "cache_evictions": self.cache.evictions,
            "fold_cache_bytes": self.fold_cache.bytes_used,
            "fold_cache_entries": len(self.fold_cache),
            **self.io_stats.snapshot(),  # one lock: no torn multi-key view
            **self.cas.pack_stats(),
            **self.cas.stats,
        }
