"""Manifest-graph walk: the single source of truth for closure traversal.

Both sides of the sync protocol need the transitive storage dependencies of
a set of manifests — push/pull planning (``repro_torch.remote.negotiate``) and
refcount replay / fsck (``ArtifactStore``). One implementation serves both,
parameterized by a ``fetch`` callable so the walk runs against a local CAS,
a remote transport, or local-first-then-transport. A manifest-schema change
(e.g. a new entry kind) lands here once.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence, Set

Fetch = Callable[[Sequence[str]], Dict[str, bytes]]


@dataclasses.dataclass
class ManifestInfo:
    """One manifest's direct references, as occurrence lists (not sets):
    refcount replay needs multiplicity — a tensor shared by two entries of
    the same manifest was incref'd twice at commit time."""

    objects: List[str]          # tensor / delta-blob keys, one per param entry
    parents: List[str]          # unique delta-parent manifest refs
    depth: int


def parse_manifest(data: bytes) -> ManifestInfo:
    manifest = json.loads(data)
    objects: List[str] = []
    parents_set = set()
    for e in manifest["params"].values():
        kind = e["kind"]
        if kind == "chunked":
            # one occurrence per chunk item that owns an object: raw chunks
            # (``c``) and per-chunk delta blobs (``b``); pass-through items
            # (``p``) reference no object. Listing chunk keys here is what
            # makes have/want negotiation chunk-granular for free.
            for item in e["chunks"]:
                if "c" in item:
                    objects.append(item["c"])
                elif "b" in item:
                    objects.append(item["b"])
            if e.get("parent_ref"):
                parents_set.add(e["parent_ref"])
        else:
            objects.append(e["tensor"] if kind == "full" else e["blob"])
            if kind in ("delta", "xdelta"):
                parents_set.add(e["parent_ref"])
    return ManifestInfo(objects=objects, parents=sorted(parents_set),
                        depth=int(manifest.get("depth", 0)))


def walk_manifests(fetch: Fetch, refs: Sequence[str],
                   missing: Optional[List[str]] = None
                   ) -> Dict[str, ManifestInfo]:
    """BFS the manifest graph from ``refs`` along delta-parent edges.

    ``fetch(keys) -> {key: bytes}`` supplies manifest payloads. Refs the
    fetch omits are appended to ``missing`` (when given) and skipped; with
    ``missing=None`` an absent ref raises ``KeyError`` — transfer planning
    wants the hard failure, fsck wants the report."""
    closure: Dict[str, ManifestInfo] = {}
    skipped: Set[str] = set()
    frontier = [r for r in dict.fromkeys(refs) if r]
    while frontier:
        batch = [r for r in frontier if r not in closure and r not in skipped]
        frontier = []
        if not batch:
            break
        payloads = fetch(batch)
        for ref in batch:
            data = payloads.get(ref)
            if data is None:
                if missing is None:
                    raise KeyError(f"manifest {ref!r} unavailable")
                missing.append(ref)
                skipped.add(ref)
                continue
            info = parse_manifest(data)
            closure[ref] = info
            frontier.extend(p for p in info.parents
                            if p not in closure and p not in skipped)
    return closure


def closure_keys(closure: Dict[str, ManifestInfo]) -> Set[str]:
    """Every CAS key the closure touches: manifests + referenced objects."""
    keys: Set[str] = set(closure)
    for info in closure.values():
        keys.update(info.objects)
    return keys
