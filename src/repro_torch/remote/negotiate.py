"""Have/want object negotiation over manifest closures (DESIGN.md §8.2).

A lineage subgraph is shipped as the *closure* of its manifests: every
manifest, every full-tensor and delta-blob object its entries reference, and
— because delta entries reconstruct against ``(parent_ref, parent_key)`` —
every chain-parent manifest, transitively. The closure traversal itself
lives in :mod:`repro_torch.store.manifest_walk` (shared with the store's refcount
replay and fsck); this module layers the sync-protocol decisions on top.

:func:`plan_transfer` subtracts what the receiver advertised via ``have``
and fixes the deterministic transfer order — data before metadata
(blobs/tensors first, then manifests shallow-chain-first), so an
interrupted transfer never leaves a manifest on the receiver whose payload
objects are guaranteed absent. The *full* ordered closure (``plan.order``)
is what the resumable journal chunks over: it is identical across attempts,
so chunk ids recorded before a crash match on retry (DESIGN.md §8.4).

Delta-chain awareness lives in :func:`chain_refs` + :func:`needs_flatten`:
a filtered (shallow) push prefers shipping delta blobs when the receiver
already has — or is about to receive — the chain base, and falls back to
flattening the manifest to full tensors when the base lies outside the
selection (§8.3).

Keys negotiated here are the CAS schemes of DESIGN.md §3.2: ``m_`` manifest
hashes, bare tensor/blob content hashes, ``c_`` chunk objects, and (when
diagnostics ride along) ``t_`` ledger entries. The derived ``s_`` scoped-
content keys never appear in a closure — they name no stored object. All
object payloads are the *stored* (delta-quantized) artifact form; nothing
in-memory is negotiated.

Chunked entries (DESIGN.md §12) make have/want *chunk-granular* with no
new protocol: ``parse_manifest`` lists each raw-chunk ``c_`` key and
per-chunk delta blob as a closure object, so a receiver that already holds
most of a multi-GB tensor — from an earlier version sharing its grid —
advertises those chunks in ``have`` and only the edited ones cross the
wire. :func:`partition_by_size` is the planner's other half: splitting a
want-set at a byte floor lets the transfer engine route the few huge
objects through segmented parallel range reads while everything else rides
the batched mget stream.

Copied from the reference package's ``repro/remote/negotiate.py``; only the
imports differ.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Sequence, Set, Tuple

from repro_torch.store.manifest_walk import (Fetch, ManifestInfo, closure_keys,
                                       parse_manifest, walk_manifests)

__all__ = [
    "Fetch", "ManifestInfo", "parse_manifest", "walk_manifests",
    "closure_keys", "chunked", "partition_by_size", "chain_refs",
    "needs_flatten", "TransferPlan", "plan_transfer", "CHUNK_OBJECTS",
]

#: objects fetched per negotiation/transfer batch
CHUNK_OBJECTS = 32


def chunked(seq: Sequence[str], n: int = CHUNK_OBJECTS) -> Iterable[List[str]]:
    seq = list(seq)
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


def partition_by_size(keys: Sequence[str], sizes: Mapping[str, int],
                      floor: int) -> Tuple[List[str], List[str]]:
    """Split ``keys`` into ``(small, large)`` at ``floor`` stored bytes.

    Keys with unknown size (absent from ``sizes`` — e.g. the peer predates
    the sizes endpoint) count as small: the mget stream is always correct,
    ranged parallelism is only an optimization. Both halves preserve the
    deterministic plan order."""
    small = [k for k in keys if sizes.get(k, 0) < floor]
    large = [k for k in keys if sizes.get(k, 0) >= floor]
    return small, large


def chain_refs(closure: Dict[str, ManifestInfo], ref: str) -> List[str]:
    """The delta chain above ``ref``: its parent manifests, transitively."""
    out: List[str] = []
    frontier = list(closure[ref].parents)
    seen: Set[str] = set()
    while frontier:
        p = frontier.pop()
        if p in seen:
            continue
        seen.add(p)
        out.append(p)
        if p in closure:
            frontier.extend(closure[p].parents)
    return out


def needs_flatten(closure: Dict[str, ManifestInfo], ref: str,
                  shipped: Set[str], receiver_has: Set[str]) -> bool:
    """True when ``ref``'s delta chain cannot reconstruct on the receiver.

    Ship the delta form when every chain parent is either part of the
    selection (``shipped``) or already on the receiver; otherwise the caller
    must flatten ``ref`` to full tensors (the shallow-push fallback)."""
    return any(p not in shipped and p not in receiver_has
               for p in chain_refs(closure, ref))


@dataclasses.dataclass
class TransferPlan:
    """Negotiated transfer: what to send, in which deterministic order."""

    order: List[str]            # FULL closure in transfer order (stable)
    wants: List[str]            # the subset missing on the receiver
    total: int                  # closure size (for dedup-ratio reporting)

    @property
    def transferred(self) -> int:
        return len(self.wants)

    @property
    def dedup_ratio(self) -> float:
        """Fraction of the closure the negotiation avoided sending."""
        if self.total == 0:
            return 1.0
        return 1.0 - len(self.wants) / self.total


def plan_transfer(closure: Dict[str, ManifestInfo],
                  have: Set[str]) -> TransferPlan:
    """Fix the transfer order and subtract the receiver's ``have`` set.

    Data objects ship before manifests, manifests shallow-chain-first — so a
    crash mid-transfer can strand data objects (harmless: content-addressed,
    refcount-rebuilt later) but never a manifest whose chain is knowably
    incomplete *behind* it in the stream. The order is a pure function of
    the closure, NOT of ``have``, so resumed attempts chunk identically."""
    keys = closure_keys(closure)
    data = sorted(k for k in keys if k not in closure)
    manifests = sorted(closure, key=lambda r: (closure[r].depth, r))
    order = data + manifests
    have = set(have)
    return TransferPlan(order=order,
                        wants=[k for k in order if k not in have],
                        total=len(keys))
