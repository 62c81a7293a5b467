"""Push/pull/clone of lineage subgraphs (DESIGN.md §8).

The sync engine drives a :class:`~repro_torch.remote.transport.Transport` through
the protocol phases:

1. **select** — nodes to ship, all or an ``fnmatch`` filter (``name@v*``);
2. **negotiate** — walk the manifest closure (:mod:`repro_torch.remote.negotiate`),
   ask the receiver what it already ``have``s, and plan the difference.
   Delta entries ship as blobs when the receiver has (or is receiving) the
   chain base; a shallow push whose chain base falls outside the selection
   flattens that manifest to full tensors instead (§8.3);
3. **transfer** — parallel chunked object movement with a resumable journal
   on the receiving side (:mod:`repro_torch.remote.journal`);
4. **reconcile** — a three-way merge of lineage metadata against the
   remote-tracking base state, reusing the paper-§5 conflict classification
   (``conflict`` / ``possible_conflict`` / ``no_conflict``) per node, with
   artifact-level auto-merge of divergent models on pull;
5. **publish** — the merged lineage document replaces the receiver's
   atomically via *optimistic swap* (DESIGN.md §11.3): the publish carries
   the etag of the document the merge was based on, a concurrent pusher
   makes the swap fail (HTTP 409), and the engine re-fetches/re-merges/
   retries. After publish, refcounts are rebuilt from the lineage roots.

The engine is transport-agnostic: ``LocalTransport`` (a directory) and
:class:`repro_torch.remote.http.HttpTransport` (a hub daemon, §11) both satisfy
the same ABC, so push/pull/clone against ``http://`` remotes are the same
code path, byte for byte. Bit-identity across peers always means the
*stored* artifacts (store-loaded params) — in-memory models differ from
their committed form by the delta-quantization eps.

An interrupted transfer leaves both sides consistent: the receiver gains
only content-addressed objects (no lineage pointer moves) plus a journal
file, and the next push/pull of the same want-set resumes from the journal.

Copied from the reference package's ``repro/remote/sync.py``. What differs:

* the functions that open a store themselves (:func:`clone`, and the
  :class:`LocalTransport` that :func:`resolve_transport` builds for a
  directory) take that store's ``backend``: ``None`` means the card and
  ``"ref"`` the host's plain versions, as for every port ``ArtifactStore``;
* the artifact auto-merge of a pull lets the kernel layer's errors
  (:class:`~repro_torch.kernels.build.KernelError`: a kernel that does not
  build or launch, or no card) propagate instead of reporting them as a
  merge conflict;
* :func:`fetch_param_shard` sizes a ``bfloat16`` element through
  :mod:`repro_torch.common.bf16`, since numpy knows no such type here.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common import bf16
from repro_torch.core.lineage import LineageGraph
from repro_torch.kernels.build import KernelError
from repro_torch.obs import span
from repro_torch.core.merge import (CONFLICT, NO_CONFLICT, POSSIBLE_CONFLICT,
                              merge_artifacts)
from repro_torch.remote.journal import (LocalJournalStore, run_journalled_transfer,
                                  transfer_id)
from repro_torch.remote.negotiate import (CHUNK_OBJECTS, closure_keys, needs_flatten,
                                    partition_by_size, plan_transfer,
                                    walk_manifests)
from repro_torch.remote.transport import (LocalTransport, PublishConflict,
                                          Transport)
from repro_torch.store.artifact_store import ArtifactStore

_SEVERITY = {NO_CONFLICT: 0, POSSIBLE_CONFLICT: 1, CONFLICT: 2}

#: bound on the 409 -> re-fetch -> re-merge -> re-publish loop of a push;
#: each retry merges against a strictly newer remote document, so livelock
#: needs a pathological writer hammering the remote faster than we merge
MAX_PUBLISH_ATTEMPTS = 6

#: stored objects at/above this size are fetched as segmented parallel
#: ranged GETs instead of riding the single mget stream; below it the
#: per-request overhead of extra connections outweighs the overlap
RANGE_FLOOR = 4 * 2 ** 20
RANGE_PART = 1 * 2 ** 20
RANGE_WORKERS = 4


def fetch_objects(transport: Transport,
                  keys: Sequence[str]) -> Dict[str, bytes]:
    """Size-aware batch fetch: big objects ride parallel ranged reads.

    Asks the transport for stored sizes first (an optional capability —
    :class:`LocalTransport` answers from the CAS, the hub via
    ``POST /api/objects/sizes``, older peers return nothing) and routes
    every object at/above :data:`RANGE_FLOOR` — in practice chunked
    tensors' ``c_`` payloads — through ``read_object_parallel``; the rest
    move as one mget stream exactly as before. Content addressing verifies
    each reassembled payload when it is imported, so a torn ranged read can
    never land silently."""
    keys = list(keys)
    ranged = getattr(transport, "read_object_parallel", None)
    if ranged is None or not keys:
        return transport.read_objects(keys)
    sizes = transport.object_sizes(keys) or {}
    small, large = partition_by_size(keys, sizes, RANGE_FLOOR)
    out = {k: ranged(k, sizes[k], part_bytes=RANGE_PART,
                     workers=RANGE_WORKERS) for k in large}
    if small:
        out.update(transport.read_objects(small))
    return out


def _is_url(s: str) -> bool:
    return "://" in s


# ---------------------------------------------------------------------------
# Remote configuration + tracking state
# ---------------------------------------------------------------------------


def _remotes_path(repo: str) -> str:
    return os.path.join(repo, "remotes.json")


def remote_list(repo: str) -> Dict[str, str]:
    path = _remotes_path(repo)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)

def _save_remotes(repo: str, remotes: Dict[str, str]) -> None:
    os.makedirs(repo, exist_ok=True)
    tmp = _remotes_path(repo) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(remotes, f, indent=1)
    os.replace(tmp, _remotes_path(repo))


def remote_add(repo: str, name: str, url: str) -> None:
    remotes = remote_list(repo)
    # Directory remotes normalize to absolute paths (stable across cwd
    # changes); http(s) hub urls pass through untouched.
    remotes[name] = url if _is_url(url) else os.path.abspath(url)
    _save_remotes(repo, remotes)


def remote_remove(repo: str, name: str) -> None:
    remotes = remote_list(repo)
    remotes.pop(name, None)
    _save_remotes(repo, remotes)


def _transport_for(url: str, backend: Optional[str] = None) -> Transport:
    """Scheme dispatch: ``http(s)://`` speaks to a hub daemon
    (:class:`~repro_torch.remote.http.HttpTransport`), anything else is a
    filesystem peer, whose store opens with ``backend``."""
    if _is_url(url):
        from repro_torch.remote.http import HttpTransport  # lazy: client-only dep
        return HttpTransport(url)
    return LocalTransport(url, backend=backend)


def resolve_transport(repo: str, name_or_url: str,
                      backend: Optional[str] = None
                      ) -> Tuple[Transport, Optional[str]]:
    """A configured remote name resolves through ``remotes.json`` (and gets
    tracking state); a bare path or ``http(s)://`` url is used directly
    (stateless sync); an already-constructed :class:`Transport` (e.g. a
    :class:`~repro_torch.hub.replica.ReplicaSetTransport`) passes through."""
    if isinstance(name_or_url, Transport):
        return name_or_url, None
    remotes = remote_list(repo)
    if name_or_url in remotes:
        return _transport_for(remotes[name_or_url], backend), name_or_url
    return _transport_for(name_or_url, backend), None


class RemoteState:
    """Remote-tracking state: the merge base for the next sync.

    MGit's analogue of git's remote-tracking refs. The stored document holds
    only *common* nodes — ones both sides have agreed on during a previous
    push or pull — never remote nodes that were merely seen but not
    integrated (those must merge as additions, not read as local deletions).
    ``name=None`` (syncing to a bare path) disables tracking: the base
    degrades to the empty graph and divergence classifies conservatively."""

    def __init__(self, repo: Optional[str], name: Optional[str]) -> None:
        self.path = (os.path.join(repo, "remotes", f"{name}.state.json")
                     if repo and name else None)

    def load(self) -> Optional[Dict]:
        if self.path is None or not os.path.exists(self.path):
            return None
        with open(self.path) as f:
            return json.load(f)

    def save(self, payload: Dict) -> None:
        if self.path is None:
            return
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)


# ---------------------------------------------------------------------------
# Three-way lineage-metadata merge
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NodeMergeOutcome:
    name: str
    status: str                 # merge.py conflict class
    detail: str = ""


@dataclasses.dataclass
class LineageMergeReport:
    status: str                 # worst per-node status
    outcomes: List[NodeMergeOutcome]

    @property
    def conflicts(self) -> List[str]:
        return [o.name for o in self.outcomes if o.status == CONFLICT]

    def to_json(self) -> Dict[str, Any]:
        return {"status": self.status,
                "outcomes": [dataclasses.asdict(o) for o in self.outcomes
                             if o.status != NO_CONFLICT],
                "conflicts": self.conflicts}


def _merge_list(base: List[str], ours: List[str],
                theirs: List[str]) -> List[str]:
    """Three-way merge of an (ordered) name list; deletions propagate."""
    removed = (set(base) - set(ours)) | (set(base) - set(theirs))
    out = [x for x in ours if x not in removed]
    out += [x for x in theirs if x not in set(ours) and x not in removed]
    return out


def _merge_scalar(base, ours, theirs) -> Tuple[Any, bool]:
    """Returns (merged value, both-sides-changed-divergently)."""
    if ours == theirs:
        return ours, False
    if ours == base:
        return theirs, False
    if theirs == base:
        return ours, False
    return ours, True


def _classify_artifact_divergence(store, name: str, base_ref: Optional[str],
                                  ours_ref: str, theirs_ref: str
                                  ) -> Tuple[Optional[str], str, str]:
    """Both sides re-committed a node's model: classify with the paper-§5 decision
    tree (Figure 2) and auto-merge parameters when it allows. Returns
    ``(ref_to_use or None-for-keep-ours, status, detail)``."""
    if store is None or base_ref is None:
        return None, CONFLICT, "divergent model with no common base version"
    try:
        ancestor = store.load_artifact(base_ref)
        ours = store.load_artifact(ours_ref)
        theirs = store.load_artifact(theirs_ref)
        result = merge_artifacts(ancestor, ours, theirs)
    except KernelError:
        raise  # a kernel that failed is not a merge conflict
    except Exception as exc:  # missing objects, shape drift, ...
        return None, CONFLICT, f"could not classify divergence: {exc}"
    if result.status == CONFLICT or result.merged is None:
        return None, CONFLICT, f"parameter merge conflict: {result.detail}"
    merged_ref = store.commit_artifact(name, result.merged,
                                       parent_ref=ours_ref)
    return merged_ref, result.status, f"auto-merged models: {result.detail}"


def _merge_node(name: str, base: Optional[Dict], ours: Optional[Dict],
                theirs: Optional[Dict], store=None
                ) -> Tuple[Optional[Dict], NodeMergeOutcome]:
    """Merge one node's JSON document; None means the node is deleted."""
    if ours is None and theirs is None:
        return None, NodeMergeOutcome(name, NO_CONFLICT, "deleted both sides")
    if ours is None:
        if base is not None and base == theirs:
            return None, NodeMergeOutcome(name, NO_CONFLICT,
                                          "deleted locally")
        if base is None:
            return dict(theirs), NodeMergeOutcome(name, NO_CONFLICT,
                                                  "new from remote")
        return dict(theirs), NodeMergeOutcome(
            name, POSSIBLE_CONFLICT,
            "deleted locally but changed remotely — restored")
    if theirs is None:
        if base is not None and base == ours:
            return None, NodeMergeOutcome(name, NO_CONFLICT,
                                          "deleted remotely")
        if base is None:
            return dict(ours), NodeMergeOutcome(name, NO_CONFLICT,
                                                "local-only node")
        return dict(ours), NodeMergeOutcome(
            name, POSSIBLE_CONFLICT,
            "deleted remotely but changed locally — kept")

    base = base or {}
    merged = dict(ours)
    status, details = NO_CONFLICT, []

    for field in ("parents", "children", "version_parents",
                  "version_children"):
        merged[field] = _merge_list(base.get(field, []), ours.get(field, []),
                                    theirs.get(field, []))

    meta = dict(theirs.get("metadata", {}))
    base_meta = base.get("metadata", {})
    for k, v in ours.get("metadata", {}).items():
        mv, diverged = _merge_scalar(base_meta.get(k), v,
                                     meta.get(k, base_meta.get(k)))
        meta[k] = mv
        if diverged:
            status = max(status, POSSIBLE_CONFLICT, key=_SEVERITY.get)
            details.append(f"metadata key {k!r} diverged (kept local)")
    merged["metadata"] = meta

    for field, on_diverge in (("model_type", CONFLICT),
                              ("creation_fn", POSSIBLE_CONFLICT)):
        value, diverged = _merge_scalar(base.get(field), ours.get(field),
                                        theirs.get(field))
        merged[field] = value
        if diverged:
            status = max(status, on_diverge, key=_SEVERITY.get)
            details.append(f"{field} diverged (kept local)")

    ref, diverged = _merge_scalar(base.get("artifact_ref"),
                                  ours.get("artifact_ref"),
                                  theirs.get("artifact_ref"))
    if diverged:
        new_ref, art_status, detail = _classify_artifact_divergence(
            store, name, base.get("artifact_ref"), ours["artifact_ref"],
            theirs["artifact_ref"])
        ref = new_ref if new_ref is not None else ours.get("artifact_ref")
        status = max(status, art_status, key=_SEVERITY.get)
        details.append(detail)
    merged["artifact_ref"] = ref

    return merged, NodeMergeOutcome(name, status, "; ".join(details))


def merge_lineage(base_payload: Optional[Dict], ours_payload: Dict,
                  theirs_payload: Dict, store=None
                  ) -> Tuple[Dict, LineageMergeReport]:
    """Three-way merge of two lineage documents against a common base.

    Grow-only reconciliation by default: concurrently added nodes and edges
    union; divergent per-node fields classify through the paper-§5 conflict
    classes, keeping the local side on ``conflict``. Adjacency lists are
    pruned to the merged node set, so a filtered (shallow) payload never
    introduces dangling references."""
    def index(payload: Optional[Dict]) -> Dict[str, Dict]:
        return {n["name"]: n for n in (payload or {}).get("nodes", [])}

    base_nodes, ours_nodes, theirs_nodes = (
        index(base_payload), index(ours_payload), index(theirs_payload))
    merged_nodes: Dict[str, Dict] = {}
    outcomes: List[NodeMergeOutcome] = []
    for name in list(ours_nodes) + [n for n in theirs_nodes
                                    if n not in ours_nodes]:
        node, outcome = _merge_node(name, base_nodes.get(name),
                                    ours_nodes.get(name),
                                    theirs_nodes.get(name), store=store)
        if node is not None:
            merged_nodes[name] = node
        outcomes.append(outcome)
    for node in merged_nodes.values():
        for field in ("parents", "children", "version_parents",
                      "version_children"):
            node[field] = [x for x in node.get(field, [])
                           if x in merged_nodes]
    status = max((o.status for o in outcomes), default=NO_CONFLICT,
                 key=_SEVERITY.get)
    return ({"nodes": list(merged_nodes.values())},
            LineageMergeReport(status=status, outcomes=outcomes))


# ---------------------------------------------------------------------------
# Sync operations
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SyncReport:
    direction: str
    selected_nodes: List[str]
    objects_total: int          # closure size after negotiation planning
    objects_transferred: int
    bytes_transferred: int
    chunks_resumed: int = 0
    publish_retries: int = 0    # optimistic-swap 409s absorbed (DESIGN.md §11.3)
    flattened: Dict[str, str] = dataclasses.field(default_factory=dict)
    quarantined_skipped: List[str] = dataclasses.field(default_factory=list)
    # nodes the RECEIVER's quarantine policy refused at publish (§11.3) —
    # distinct from quarantined_skipped, which the sender filtered itself
    quarantine_rejected_by_remote: List[str] = dataclasses.field(
        default_factory=list)
    merge: Optional[LineageMergeReport] = None
    published: bool = True
    # transport-level reliability: a push that limped through
    # 5xx storms or connection resets says so instead of looking clean.
    # Per-endpoint-family dicts come from HttpTransport.retry_stats()
    # deltas over this one sync; LocalTransport syncs report zeros.
    transport_retries: int = 0
    transport_backoff_s: float = 0.0
    transport_terminal_failures: int = 0
    transport_retries_by_family: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    @property
    def dedup_ratio(self) -> float:
        if self.objects_total == 0:
            return 1.0
        return 1.0 - self.objects_transferred / self.objects_total

    def to_json(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out.pop("merge", None)
        out["dedup_ratio"] = round(self.dedup_ratio, 4)
        if self.merge is not None:
            out["merge"] = self.merge.to_json()
        return out


def _select_nodes(payload: Dict, filter: Optional[str]) -> List[Dict]:
    nodes = payload.get("nodes", [])
    if filter is None:
        return nodes
    return [n for n in nodes if fnmatch.fnmatch(n["name"], filter)]


def _scoped(payload: Optional[Dict], filter: Optional[str]) -> Optional[Dict]:
    """Restrict a merge base to the filter scope: a shallow sync must not
    interpret out-of-scope base nodes as deletions on either side."""
    if payload is None or filter is None:
        return payload
    return {"nodes": [n for n in payload.get("nodes", [])
                      if fnmatch.fnmatch(n["name"], filter)]}


def _local_fetch(store):
    def fetch(keys: Sequence[str]) -> Dict[str, bytes]:
        return {k: store.cas.get_bytes(k) for k in keys}
    return fetch


def _extra_first(extra: Dict[str, bytes], store):
    """Reader that serves transient (uncommitted) objects before the CAS."""
    def fetch(keys: Sequence[str]) -> Dict[str, bytes]:
        return {k: extra[k] if k in extra else store.cas.get_bytes(k)
                for k in keys}
    return fetch


class _ImportingFetch:
    """Local-first fetch for pull planning that KEEPS what it pulls.

    Manifests read over the wire during closure negotiation are imported
    into the local store immediately (content-addressed, idempotent), so the
    journalled transfer doesn't fetch the same payloads a second time. The
    counters feed the sync report — these bytes did cross the wire."""

    def __init__(self, store, transport: Transport) -> None:
        self.store = store
        self.transport = transport
        self.imported = 0
        self.imported_bytes = 0

    def __call__(self, keys: Sequence[str]) -> Dict[str, bytes]:
        out, missing = {}, []
        for k in keys:
            if self.store.cas.has(k):
                out[k] = self.store.cas.get_bytes(k)
            else:
                missing.append(k)
        if missing:
            fetched = self.transport.read_objects(missing)
            self.store.import_objects(fetched)
            self.imported += len(fetched)
            self.imported_bytes += sum(len(v) for v in fetched.values())
            out.update(fetched)
        return out


def _retry_snapshot(transport) -> Optional[Dict[str, Any]]:
    fn = getattr(transport, "retry_stats", None)
    return fn() if callable(fn) else None


def _retry_delta(transport, before: Optional[Dict[str, Any]]
                 ) -> Dict[str, Any]:
    """What this sync's transport retried, as SyncReport field values."""
    after = _retry_snapshot(transport)
    if after is None or before is None:
        return {}
    by_family = {
        fam: n - before["retries"].get(fam, 0)
        for fam, n in after["retries"].items()
        if n - before["retries"].get(fam, 0) > 0}
    backoff = (sum(after["backoff_s"].values())
               - sum(before["backoff_s"].values()))
    terminal = (sum(after["terminal_failures"].values())
                - sum(before["terminal_failures"].values()))
    return {"transport_retries": sum(by_family.values()),
            "transport_backoff_s": round(max(backoff, 0.0), 3),
            "transport_terminal_failures": max(terminal, 0),
            "transport_retries_by_family": by_family}


def push(graph: LineageGraph, transport: Transport,
         filter: Optional[str] = None, state: Optional[RemoteState] = None,
         force: bool = False, chunk_size: int = CHUNK_OBJECTS,
         include_quarantined: bool = False) -> SyncReport:
    """Ship the (filtered) lineage subgraph to the remote.

    Phases: select -> negotiate (closure - remote have) -> journalled
    parallel transfer -> three-way merge into the remote lineage -> atomic
    publish + remote refcount rebuild. A lineage-level conflict aborts before
    publish (like a non-fast-forward push) unless ``force``.

    Nodes a test gate quarantined (DESIGN.md §9.4) are excluded from the
    selection unless ``include_quarantined`` — a regressing model version
    must not propagate to collaborators by default. Their manifests still
    ship as storage-only chain dependencies when a pushed descendant's
    delta chain needs them, so everything sent reconstructs."""
    with span("sync.push", cat="remote"):
        return _push(graph, transport, filter, state, force, chunk_size,
                     include_quarantined)


def _push(graph: LineageGraph, transport: Transport,
          filter: Optional[str], state: Optional[RemoteState],
          force: bool, chunk_size: int,
          include_quarantined: bool) -> SyncReport:
    store = graph.store
    if store is None:
        raise ValueError("push requires a store-backed lineage graph")
    state = state or RemoteState(None, None)
    retry_before = _retry_snapshot(transport)
    transport.ensure_repo()

    ours_payload = graph.to_payload()
    selected = _select_nodes(ours_payload, filter)
    quarantined_skipped: List[str] = []
    if not include_quarantined:
        from repro_torch.core.quarantine import is_quarantined
        quarantined_skipped = [n["name"] for n in selected
                               if is_quarantined(n)]
        selected = [n for n in selected if not is_quarantined(n)]
    refs = [n["artifact_ref"] for n in selected if n.get("artifact_ref")]
    closure = walk_manifests(_local_fetch(store), refs)

    with span("sync.negotiate", cat="remote", keys=len(closure)):
        remote_have = transport.have(sorted(closure_keys(closure)))

    # Shallow push: flatten manifests whose delta chain leaves the selection
    # AND is absent on the receiver; prefer the delta form otherwise. The
    # flattened manifests + tensors are built transiently (never committed
    # into the sender's store) and ride to the wire via ``extra_objects``.
    flattened: Dict[str, str] = {}
    extra_objects: Dict[str, bytes] = {}
    if filter is not None and refs:
        selected_refs = set(refs)
        for node in selected:
            ref = node.get("artifact_ref")
            if not ref or ref in remote_have:
                continue
            if needs_flatten(closure, ref, selected_refs, remote_have):
                flat_ref, objs = store.export_flat_manifest(
                    ref, name=node["name"])
                flattened[ref] = flat_ref
                extra_objects.update(objs)
                node["artifact_ref"] = flat_ref
        if flattened:
            refs = [n["artifact_ref"] for n in selected
                    if n.get("artifact_ref")]
            closure = walk_manifests(_extra_first(extra_objects, store), refs)
            with span("sync.negotiate", cat="remote", keys=len(closure),
                      reason="post-flatten"):
                remote_have = transport.have(sorted(closure_keys(closure)))

    plan = plan_transfer(closure, remote_have)
    read_local = _extra_first(extra_objects, store)

    def move_chunk(keys: List[str]) -> int:
        objs = read_local(keys)
        transport.write_objects(objs)
        return sum(len(v) for v in objs.values())

    tid = transfer_id(plan.order, "push")
    with span("sync.transfer", cat="remote", direction="push",
              objects=len(plan.wants)):
        moved, moved_bytes, resumed = run_journalled_transfer(
            transport, tid, plan.order, plan.wants, "push", move_chunk,
            chunk_size)

    theirs_payload = {"nodes": selected}
    # Roles from the REMOTE's point of view: its document is "ours", the
    # pushed subgraph is "theirs". No artifact auto-merge on push — the
    # remote side cannot be mutated beyond publish (classification only).
    # Quarantined nodes are scoped OUT of the merge base exactly like
    # filtered ones: a node pushed earlier and quarantined since must read
    # as "not part of this sync", never as a local deletion — otherwise the
    # push would silently delete it from the remote document.
    base_payload = _scoped(state.load(), filter)
    if quarantined_skipped and base_payload is not None:
        skip = set(quarantined_skipped)
        base_payload = {"nodes": [n for n in base_payload["nodes"]
                                  if n["name"] not in skip]}
    # Optimistic lineage swap (DESIGN.md §11.3): publish conditionally on
    # the etag of the document this merge was computed against. A racing
    # pusher landing in between makes the swap fail (409 over HTTP) —
    # re-fetch the now-newer document, re-merge, retry. Object uploads are
    # NOT repeated: they are content-addressed and already on the remote.
    publish_retries = 0
    published = False
    server_rejected: List[str] = []
    for _attempt in range(MAX_PUBLISH_ATTEMPTS):
        remote_payload, remote_etag = transport.fetch_lineage_versioned()
        remote_payload = remote_payload or {"nodes": []}
        merged, report = merge_lineage(base_payload, remote_payload,
                                       theirs_payload, store=None)
        published = force or report.status != CONFLICT
        if not published:
            break
        if force and report.status == CONFLICT:
            merged_nodes = {n["name"]: n for n in merged["nodes"]}
            for node in selected:
                merged_nodes[node["name"]] = node
            merged = {"nodes": list(merged_nodes.values())}
        try:
            with span("sync.publish", cat="remote"):
                ack = transport.publish_lineage(merged,
                                                expected=remote_etag)
        except PublishConflict:
            publish_retries += 1
            published = False
            continue
        # Nodes the receiver's quarantine policy refused were NOT published
        # — they must stay out of the merge base below, or the next pull
        # would read their absence on the remote as a remote deletion and
        # silently delete the local copy.
        server_rejected = sorted((ack or {}).get("quarantined_rejected", []))
        break
    if published:
        transport.finalize([n["artifact_ref"] for n in merged["nodes"]
                            if n.get("artifact_ref")])
        # Advance the merge base: drop nodes no longer on the remote, then
        # record as newly common ONLY the pushed nodes the remote accepted
        # verbatim — a node the remote-side merge reshaped is not yet agreed.
        # Quarantined names never enter the base (they were not synced), so
        # every later push keeps treating the remote's copy as remote-only
        # content to preserve rather than a deletion to propagate.
        merged_by_name = {n["name"]: n for n in merged["nodes"]}
        skip = set(quarantined_skipped) | set(server_rejected)
        old = state.load() or {"nodes": []}
        base_nodes = {n["name"]: n for n in old["nodes"]
                      if n["name"] in merged_by_name
                      and n["name"] not in skip}
        for node in selected:
            if (node["name"] not in skip
                    and merged_by_name.get(node["name"]) == node):
                base_nodes[node["name"]] = node
        state.save({"nodes": list(base_nodes.values())})

    return SyncReport(direction="push",
                      selected_nodes=[n["name"] for n in selected],
                      objects_total=plan.total, objects_transferred=moved,
                      bytes_transferred=moved_bytes, chunks_resumed=resumed,
                      publish_retries=publish_retries, flattened=flattened,
                      quarantined_skipped=quarantined_skipped,
                      quarantine_rejected_by_remote=server_rejected,
                      merge=report, published=published,
                      **_retry_delta(transport, retry_before))


def pull(graph: LineageGraph, transport: Transport,
         filter: Optional[str] = None, state: Optional[RemoteState] = None,
         chunk_size: int = CHUNK_OBJECTS) -> SyncReport:
    """Fetch the (filtered) remote subgraph and reconcile it into ``graph``.

    A shallow pull (``filter``) brings only the matching nodes into the
    lineage document, but the object transfer still completes their delta
    chains (chain-parent manifests ride along as storage-only objects), so
    every pulled parameter reconstructs. Divergent nodes auto-merge at the
    artifact level when the paper-§5 decision tree allows; ``conflict`` keeps the
    local version and is reported."""
    with span("sync.pull", cat="remote"):
        return _pull(graph, transport, filter, state, chunk_size)


def _pull(graph: LineageGraph, transport: Transport,
          filter: Optional[str], state: Optional[RemoteState],
          chunk_size: int) -> SyncReport:
    store = graph.store
    if store is None:
        raise ValueError("pull requires a store-backed lineage graph")
    state = state or RemoteState(None, None)
    retry_before = _retry_snapshot(transport)
    repo = graph.path or store.cas.root or "."

    remote_payload = transport.fetch_lineage()
    if remote_payload is None:
        remote_payload = {"nodes": []}
    selected = _select_nodes(remote_payload, filter)
    refs = [n["artifact_ref"] for n in selected if n.get("artifact_ref")]
    fetch = _ImportingFetch(store, transport)  # negotiation reads are kept
    with span("sync.negotiate", cat="remote"):
        closure = walk_manifests(fetch, refs)
        local_have = {k for k in closure_keys(closure)
                      if store.cas.has(k)}
        plan = plan_transfer(closure, local_have)

    def move_chunk(keys: List[str]) -> int:
        objs = fetch_objects(transport, keys)
        store.import_objects(objs)
        return sum(len(v) for v in objs.values())

    tid = transfer_id(plan.order, "pull")
    with span("sync.transfer", cat="remote", direction="pull",
              objects=len(plan.wants)):
        moved, moved_bytes, resumed = run_journalled_transfer(
            LocalJournalStore(repo), tid, plan.order, plan.wants, "pull",
            move_chunk, chunk_size)
    moved += fetch.imported
    moved_bytes += fetch.imported_bytes

    merged, report = merge_lineage(_scoped(state.load(), filter),
                                   graph.to_payload(), {"nodes": selected},
                                   store=store)
    graph.replace_nodes(merged)
    store.rebuild_refcounts([n.artifact_ref for n in graph.nodes.values()
                             if n.artifact_ref])
    # Advance the merge base: keep out-of-scope base nodes, replace the
    # in-scope portion with what the remote now says — EXCEPT nodes that
    # conflicted. Those were NOT integrated (local kept), so recording the
    # remote's version as "agreed" would make the next push classify the
    # still-divergent node as fast-forward and silently clobber the remote.
    old = state.load() or {"nodes": []}
    old_by_name = {n["name"]: n for n in old["nodes"]}
    conflicts = set(report.conflicts)
    keep = [n for n in old["nodes"]
            if filter is not None and not fnmatch.fnmatch(n["name"], filter)]
    advanced = []
    for node in selected:
        if node["name"] in conflicts:
            if node["name"] in old_by_name:  # last agreed version, if any
                advanced.append(old_by_name[node["name"]])
        else:
            advanced.append(node)
    state.save({"nodes": keep + advanced})

    return SyncReport(direction="pull",
                      selected_nodes=[n["name"] for n in selected],
                      objects_total=plan.total, objects_transferred=moved,
                      bytes_transferred=moved_bytes, chunks_resumed=resumed,
                      merge=report,
                      **_retry_delta(transport, retry_before))


def clone(url: str, dest: str, filter: Optional[str] = None,
          backend: Optional[str] = None) -> SyncReport:
    """Materialize a remote repo into the fresh directory ``dest``.

    ``url`` is a peer directory or an ``http(s)://`` hub. Sets up
    ``origin`` tracking state so later ``pull``/``push`` three-way merge
    against what was cloned. ``backend`` is that of the stores the clone
    opens (its own, and a directory peer's)."""
    os.makedirs(dest, exist_ok=True)
    if os.path.exists(os.path.join(dest, "lineage.json")):
        raise ValueError(f"destination {dest!r} is already a lineage repo")
    remote_add(dest, "origin", url)
    graph = LineageGraph(path=dest,
                         store=ArtifactStore(root=dest, backend=backend))
    transport, _ = resolve_transport(dest, "origin", backend=backend)
    return pull(graph, transport, filter=filter,
                state=RemoteState(dest, "origin"))


def fetch_param_shard(store, transport: Transport, ref: str, key: str,
                      shard: int, n_shards: int) -> bytes:
    """Pull and materialize one host's axis-0 shard of a stored parameter.

    The shard-granular half of DESIGN.md §12: because commit-time chunk
    grids never straddle the mesh shard boundaries (``shard_cuts`` segments
    are hard cuts), host ``shard`` of ``n_shards`` can fetch exactly the
    chunk objects covering its own rows — for a tensor-parallel consumer
    that is ``1/n_shards`` of the wire bytes per host instead of every host
    pulling the full tensor. Parameters the placement rules replicate (and
    sub-threshold, non-chunked ones) fall back to fetching the whole value.
    Returns the shard's raw little-endian truth bytes."""
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} out of range for {n_shards}")
    from repro_torch.dist.sharding import shard_cuts

    # the manifest chain must be local before chunk refs can be resolved;
    # negotiation-style importing fetch keeps what it pulls
    walk_manifests(_ImportingFetch(store, transport), [ref])
    e = store.get_manifest(ref)["params"][key]
    shape = tuple(int(d) for d in e["shape"])
    itemsize = bf16.np_dtype(e["dtype"]).itemsize
    nbytes = int(e.get("nbytes")
                 or np.prod(shape, dtype=np.int64) * itemsize)
    cuts = shard_cuts(key, shape, itemsize, n_shards)
    bounds = [0] + (cuts or []) + [nbytes]
    if cuts is None:
        start, end = 0, nbytes      # replicated placement: full tensor
    else:
        start, end = bounds[shard], bounds[shard + 1]

    if e["kind"] == "chunked":
        needed = store.chunk_range_objects(ref, key, start, end)
    else:
        # sub-threshold param: walk its per-key chain (full tensor or
        # delta blobs down to the base) — still only this key's objects
        needed, cur = [], ref
        while True:
            ce = store.get_manifest(cur)["params"][key]
            if ce["kind"] == "chunked":
                needed += store.chunk_range_objects(
                    cur, key, 0, int(ce["nbytes"]))
                break
            needed.append(ce["tensor"] if ce["kind"] == "full"
                          else ce["blob"])
            if ce["kind"] != "delta":
                break
            cur = ce["parent_ref"]
    missing = [k for k in dict.fromkeys(needed) if not store.cas.has(k)]
    if missing:
        store.import_objects(fetch_objects(transport, missing))
    return store.materialize_param_range(ref, key, start, end)
