"""Memoized parallel test runner over the lineage graph (DESIGN.md §9.1).

The paper's test-reuse optimization (§4, Table 2): a test result is a pure
function of *(test identity, model content)*, so it is computed once and
persisted as a content-addressed **result ledger** entry in the store's CAS
(key scheme ``t_`` — see :func:`repro_torch.store.cas.ledger_key`).
Re-testing an unchanged model is a single O(1) ledger probe: no manifest
walk, no tensor materialization, no model checkout.

Identity components:

* ``test_hash`` — SHA-256 over the test's name, declared scope, and its
  function's bytecode + constants, so editing a test invalidates its cached
  results while re-importing identical code does not;
* ``manifest_key`` — the node's ``artifact_ref`` (itself a content address
  of the stored model) for store-backed nodes, a hash of the per-parameter
  content hashes for in-memory ones, or — when the test declares a ``scope``
  (param-key prefix) — the hash of just the scoped parameter hashes
  (:func:`repro_torch.diag.transfer.scoped_content_key`), which makes versions
  with a bit-identical tested submodule share one ledger entry (§9.3).

Execution fans out across nodes with a thread pool, and models are checked
out **lazily** (``ArtifactStore.load_artifact`` → :class:`ParamRef` handles):
a test only materializes the tensors it actually touches.

Copied from the reference package's ``repro/diag/runner.py``; only the
imports differ. A test that raises is recorded as a failed result with its
error (``_evaluate``), as in the reference: a gate then quarantines the
node, so callers that must not hide a device error read ``error``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

from repro_torch.common.hashing import bytes_hash
from repro_torch.core.artifact import ModelArtifact
from repro_torch.core.lineage import (LineageGraph, LineageNode,
                                      RegisteredTest, compile_test_pattern)
from repro_torch.store.cas import ledger_key

SCHEMA_VERSION = 1


# ---------------------------------------------------------------------------
# Identity hashing
# ---------------------------------------------------------------------------


def _code_fingerprint(code, parts: List[str]) -> None:
    """Append a process-stable fingerprint of ``code``: bytecode plus
    constants, recursing into nested code objects (comprehensions, lambdas,
    inner defs). ``repr`` of a nested code object embeds its memory address
    and must never reach the hash — that would silently defeat cross-process
    memoization for any test containing a comprehension."""
    parts.append(code.co_code.hex())
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _code_fingerprint(const, parts)
        else:
            parts.append(repr(const))


def test_identity_hash(test: RegisteredTest) -> str:
    """Content identity of a test: name + scope + function code.

    Bytecode plus constants tracks the function's *behavior* across process
    restarts (same source compiles identically on one interpreter); callables
    without ``__code__`` fall back to ``repr`` — stable for named callables,
    conservatively unstable otherwise."""
    parts: List[str] = [test.name, test.scope or ""]
    code = getattr(test.fn, "__code__", None)
    if code is not None:
        _code_fingerprint(code, parts)
    else:
        parts.append(repr(test.fn))
    return bytes_hash("\x00".join(parts).encode())


def manifest_key_for(node: LineageNode, scope: Optional[str] = None) -> str:
    """Content key of the model a test would observe on ``node``.

    Prefers the stored ``artifact_ref`` — the delta-reconstructed model the
    store persists is the version's truth (the in-memory artifact can differ
    by quantization eps). ``scope`` narrows the key to the scoped submodule's
    parameter content (DESIGN.md §9.3)."""
    if scope is not None:
        from repro_torch.diag.transfer import scoped_content_key
        key = scoped_content_key(node, scope)
        if key is not None:
            return key
    if node.artifact_ref is not None:
        return node.artifact_ref
    artifact = node.get_model()
    doc = {"model_type": artifact.model_type,
           "params": sorted(artifact.param_hashes().items())}
    return "mem_" + bytes_hash(json.dumps(doc, sort_keys=True).encode())


# ---------------------------------------------------------------------------
# Results + ledger
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TestResult:
    """One (test, model-content) evaluation — what the ledger stores."""

    test: str
    node: str
    value: Optional[float]
    passed: bool
    cached: bool
    duration_s: float
    error: Optional[str] = None
    transferred: bool = False      # ran via structural test transfer (§9.3)
    key: Optional[str] = None      # ledger key (None for unpersisted runs)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class ResultLedger:
    """Content-addressed, append-only store of test results.

    Backed by the repository CAS when the graph has a store (entries survive
    process restarts and ride along ``fsck``); an in-memory dict otherwise.
    Entries are write-once per (test_hash, manifest_key) — both are content
    addresses, so a recorded result can only be superseded by changing the
    test or the model, which changes the key."""

    def __init__(self, store: Any = None) -> None:
        self.store = store
        self._mem: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._dirty = False

    def key(self, test_hash: str, manifest_key: str) -> str:
        return ledger_key(test_hash, manifest_key)

    def get(self, test_hash: str, manifest_key: str) -> Optional[Dict[str, Any]]:
        key = self.key(test_hash, manifest_key)
        with self._lock:
            if key in self._mem:
                return self._mem[key]
        if self.store is not None and self.store.cas.has(key):
            record = json.loads(self.store.cas.get_bytes(key))
            with self._lock:
                self._mem[key] = record
            return record
        return None

    def put(self, record: Dict[str, Any], force: bool = False) -> str:
        """Record a result. Write-once per key unless ``force`` (a forced
        re-execution supersedes the stored entry in place). Durability is
        batched: pack records hit disk immediately (and are recoverable by
        the tail scan), but the index/refcount flush is deferred to
        :meth:`flush` — one durable write per sweep, not per test."""
        key = self.key(record["test_hash"], record["manifest_key"])
        with self._lock:
            known = key in self._mem
            self._mem[key] = record
        if self.store is not None:
            fresh = not known and not self.store.cas.has(key)
            if fresh or force:
                payload = json.dumps(record, sort_keys=True).encode()
                self.store.cas.put_bytes(payload, key=key, overwrite=force)
                with self._lock:
                    self._dirty = True
        return key

    def flush(self) -> None:
        """Persist CAS index/refcount state for any puts since the last
        flush (called once per runner sweep / gate check)."""
        with self._lock:
            if not self._dirty:
                return
            self._dirty = False
        if self.store is not None:
            self.store.cas.flush()

    def entries(self) -> Iterator[Dict[str, Any]]:
        """Scan every persisted ledger entry (the ``diag history`` query)."""
        seen = set()
        if self.store is not None:
            for key in self.store.cas.keys():
                if not key.startswith("t_"):
                    continue
                seen.add(key)
                try:
                    yield json.loads(self.store.cas.get_bytes(key))
                except Exception:
                    continue  # corrupt entry: fsck's problem, not history's
        with self._lock:
            mem = [(k, r) for k, r in self._mem.items() if k not in seen]
        for _, record in mem:
            yield record


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RunReport:
    """Aggregate of one ``DiagnosticsRunner.run`` invocation."""

    results: Dict[str, Dict[str, TestResult]]
    executed: int
    memo_hits: int
    duration_s: float

    @property
    def total(self) -> int:
        return self.executed + self.memo_hits

    @property
    def cache_hit_ratio(self) -> float:
        return self.memo_hits / self.total if self.total else 0.0

    def values(self) -> Dict[str, Dict[str, float]]:
        """``run_tests``-shaped {node: {test: value}} view (failures omitted)."""
        return {
            node: {t: r.value for t, r in res.items() if r.value is not None}
            for node, res in self.results.items() if res
        }

    def failures(self) -> List[TestResult]:
        return [r for res in self.results.values() for r in res.values()
                if not r.passed]

    def to_json(self) -> Dict[str, Any]:
        return {
            "executed": self.executed,
            "memo_hits": self.memo_hits,
            "cache_hit_ratio": round(self.cache_hit_ratio, 4),
            "duration_s": self.duration_s,
            "results": {node: {t: r.to_json() for t, r in res.items()}
                        for node, res in self.results.items()},
        }


def _evaluate(fn: Callable[[ModelArtifact], Any], artifact: ModelArtifact):
    """Run one test fn; normalize to (value, passed).

    Convention: a bool return is its own verdict; a numeric return passes
    iff finite (NaN/inf = failure, e.g. a poisoned upstream); an exception
    fails with the error recorded."""
    value = fn(artifact)
    if isinstance(value, bool):
        return float(value), value
    v = float(value)
    return v, math.isfinite(v)


class DiagnosticsRunner:
    """Memoized, parallel, lazily-checked-out test execution (DESIGN.md §9.1).

    One runner serves ``run`` sweeps, ``blame`` attribution probes and
    ``TestGate`` checks; they all share the ledger, so e.g. a gate check
    after a sweep costs zero executions."""

    def __init__(self, graph: LineageGraph, max_workers: Optional[int] = None,
                 ledger: Optional[ResultLedger] = None,
                 transfer: bool = False,
                 max_transfer_divergence: float = 0.0,
                 prefetch: bool = False) -> None:
        self.graph = graph
        self.ledger = ledger or ResultLedger(graph.store)
        self.max_workers = max_workers or min(8, (os.cpu_count() or 2))
        self.transfer = transfer
        self.max_transfer_divergence = max_transfer_divergence
        # prefetch=True batch-materializes a node's stored artifact through
        # ArtifactStore.materialize_artifact (chain folding + threaded
        # decode; DESIGN.md §10.3) before its tests run — right for sweeps
        # whose tests read most parameters; leave False for scoped tests,
        # which should only materialize the submodule they touch
        self.prefetch = prefetch
        self.stats = {"executed": 0, "memo_hits": 0, "checkouts": 0,
                      "transferred_runs": 0}
        self._checkout_cache: Dict[str, ModelArtifact] = {}
        self._lock = threading.Lock()

    # -- applicability ---------------------------------------------------------
    def tests_for(self, node: LineageNode) -> List[RegisteredTest]:
        """Registered tests for ``node``, plus structurally transferred ones."""
        tests = list(self.graph.tests_for(node))
        if self.transfer:
            from repro_torch.diag.transfer import transferable_tests
            have = {t.name for t in tests}
            tests += [t for t in transferable_tests(
                self.graph, node, self.max_transfer_divergence)
                if t.name not in have]
        return tests

    def _is_transferred(self, node: LineageNode, test: RegisteredTest) -> bool:
        return not test.applies_to(node)

    # -- checkout --------------------------------------------------------------
    def _checkout(self, node: LineageNode) -> ModelArtifact:
        """Lazy model view for testing: stored truth via ParamRef handles.

        Never caches onto the node (no cross-thread node mutation); repeat
        checkouts within one runner reuse a private per-runner cache, and
        tensor data is shared through the store's TensorCache anyway."""
        with self._lock:
            cached = self._checkout_cache.get(node.name)
        if cached is not None:
            return cached
        if node.artifact_ref is not None and self.graph.store is not None:
            if self.prefetch:
                # batched checkout: whole-model tests hit a warm tensor
                # cache instead of paying one chain walk per parameter
                # inside the test body (the fan-out threads then share it)
                self.graph.store.materialize_artifact(node.artifact_ref)
            artifact = self.graph.store.load_artifact(node.artifact_ref)
        else:
            artifact = node.get_model()
        with self._lock:
            self._checkout_cache[node.name] = artifact
            self.stats["checkouts"] += 1
        return artifact

    # -- execution -------------------------------------------------------------
    def run_one(self, node: LineageNode, test: RegisteredTest,
                force: bool = False,
                identity: Optional[Tuple[str, str]] = None) -> TestResult:
        """Evaluate one (node, test) pair, through the ledger.

        ``identity`` is an optional precomputed ``(test_hash,
        manifest_key)`` — ``run`` passes it so the grouping pass's hashing
        work is not repeated per representative."""
        if identity is not None:
            test_hash, manifest_key = identity
        else:
            test_hash = test_identity_hash(test)
            manifest_key = manifest_key_for(node, scope=test.scope)
        key = self.ledger.key(test_hash, manifest_key)
        if not force:
            record = self.ledger.get(test_hash, manifest_key)
            if record is not None:
                with self._lock:
                    self.stats["memo_hits"] += 1
                return TestResult(
                    test=test.name, node=node.name,
                    value=record.get("value"), passed=record.get("passed", False),
                    cached=True, duration_s=record.get("duration_s", 0.0),
                    error=record.get("error"),
                    transferred=self._is_transferred(node, test), key=key)

        artifact = self._checkout(node)
        t0 = time.perf_counter()
        error: Optional[str] = None
        try:
            value, passed = _evaluate(test.fn, artifact)
        except Exception as exc:
            value, passed, error = None, False, f"{type(exc).__name__}: {exc}"
        duration = time.perf_counter() - t0

        record = {
            "schema": SCHEMA_VERSION,
            "test": test.name, "test_hash": test_hash,
            "manifest_key": manifest_key, "scope": test.scope,
            "node": node.name, "artifact_ref": node.artifact_ref,
            "value": value, "passed": passed, "error": error,
            "duration_s": duration,
        }
        self.ledger.put(record, force=force)
        with self._lock:
            self.stats["executed"] += 1
        return TestResult(test=test.name, node=node.name, value=value,
                          passed=passed, cached=False, duration_s=duration,
                          error=error,
                          transferred=self._is_transferred(node, test),
                          key=key)

    def run(self, nodes: Optional[Sequence[LineageNode]] = None,
            pattern: Optional[str] = None, match: str = "regex",
            tests: Optional[Sequence[RegisteredTest]] = None,
            force: bool = False) -> RunReport:
        """Fan the (node, test) work list out across the thread pool.

        ``nodes`` defaults to the whole graph; ``tests`` overrides the
        registry (still filtered by per-node applicability + transfer);
        ``force`` bypasses ledger reads (results are still recorded)."""
        if nodes is None:
            nodes = list(self.graph.nodes.values())
        matcher = compile_test_pattern(pattern, match)
        work: List = []
        for node in nodes:
            if tests is not None:  # explicit list still honors applicability
                applicable = {t.name for t in self.tests_for(node)}
                cands = [t for t in tests if t.name in applicable]
            else:
                cands = self.tests_for(node)
            for t in cands:
                if matcher(t.name):
                    work.append((node, t))

        # Single-flight: (node, test) pairs that resolve to the same ledger
        # key — e.g. versions whose scoped submodule is bit-identical
        # (§9.3) — execute ONCE; the rest reuse the result as memo hits.
        # Without this a parallel cold sweep races duplicates past the
        # ledger probe and evaluates them redundantly. Identity hashes are
        # computed once here and handed to run_one, never re-derived.
        test_hashes: Dict[int, str] = {}
        keyed: Dict[str, List] = {}
        order: List[str] = []
        identities: Dict[str, Tuple[str, str]] = {}
        for node, t in work:
            th = test_hashes.get(id(t))
            if th is None:
                th = test_hashes[id(t)] = test_identity_hash(t)
            mk = manifest_key_for(node, scope=t.scope)
            k = self.ledger.key(th, mk)
            if k not in keyed:
                keyed[k] = []
                order.append(k)
                identities[k] = (th, mk)
            keyed[k].append((node, t))
        reps = [(keyed[k][0], identities[k]) for k in order]

        results: Dict[str, Dict[str, TestResult]] = {n.name: {} for n in nodes}
        executed_before = self.stats["executed"]
        hits_before = self.stats["memo_hits"]
        t0 = time.perf_counter()
        try:
            if len(reps) <= 1 or self.max_workers == 1:
                done = [self.run_one(n, t, force=force, identity=ident)
                        for (n, t), ident in reps]
            else:
                with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
                    done = list(pool.map(
                        lambda job: self.run_one(job[0][0], job[0][1],
                                                 force=force,
                                                 identity=job[1]),
                        reps))
        finally:
            self.ledger.flush()   # ONE durable index write for the sweep
        for k, res in zip(order, done):
            rep_node, rep_test = keyed[k][0]
            results[rep_node.name][rep_test.name] = res
            for node, test in keyed[k][1:]:
                with self._lock:
                    self.stats["memo_hits"] += 1
                results[node.name][test.name] = dataclasses.replace(
                    res, node=node.name, cached=True,
                    transferred=self._is_transferred(node, test))
        return RunReport(
            results={k: v for k, v in results.items() if v},
            executed=self.stats["executed"] - executed_before,
            memo_hits=self.stats["memo_hits"] - hits_before,
            duration_s=time.perf_counter() - t0)

    # -- history ---------------------------------------------------------------
    def history(self, node_name: str,
                test_name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Recorded results for every version of ``node_name`` (§9.1).

        A ModelHub-style ledger query: walks the node's version chain and
        returns every persisted entry whose node or manifest belongs to it,
        oldest version first."""
        from repro_torch.core.traversal import version_chain
        if node_name in self.graph.nodes:
            chain = [n for n in version_chain(self.graph, node_name)]
        else:
            chain = []
        names = {n.name: i for i, n in enumerate(chain)}
        refs = {n.artifact_ref: i for i, n in enumerate(chain)
                if n.artifact_ref}
        out = []
        for record in self.ledger.entries():
            pos = names.get(record.get("node"),
                            refs.get(record.get("artifact_ref")))
            if pos is None and not chain and record.get("node") == node_name:
                pos = 0
            if pos is None:
                continue
            if test_name is not None and record.get("test") != test_name:
                continue
            out.append({**record, "chain_position": pos})
        out.sort(key=lambda r: (r["chain_position"], r.get("test") or ""))
        return out
