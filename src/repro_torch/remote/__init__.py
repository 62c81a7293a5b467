"""MGit remote sync: push/pull of lineage subgraphs with CAS negotiation.

The collaboration pillar (paper §5, DESIGN.md §8 + §11): a byte-oriented
:class:`Transport` to a peer repository (filesystem ``LocalTransport`` or
network :class:`HttpTransport` against a :mod:`repro_torch.hub` daemon), have/want
object negotiation over manifest closures, resumable journalled transfer,
optimistic lineage swap for concurrent pushers, and a three-way
lineage-metadata merge on pull that reuses the §5 conflict classification.
Everything that crosses a transport is a *stored* artifact object — the
delta-quantized form committed to the CAS, not in-memory params.

Copied from the reference package's ``repro/remote/__init__.py``; only the imports
differ.
"""

from repro_torch.remote.http import HttpTransport, HubUnavailable
from repro_torch.remote.journal import LocalJournalStore, chunk_id, transfer_id
from repro_torch.remote.negotiate import TransferPlan, plan_transfer, walk_manifests
from repro_torch.remote.sync import (LineageMergeReport, NodeMergeOutcome,
                               RemoteState, SyncReport, clone, merge_lineage,
                               pull, push, remote_add, remote_list,
                               remote_remove, resolve_transport)
from repro_torch.remote.transport import (ETAG_ABSENT, LocalTransport,
                                    PublishConflict, Transport, lineage_etag)

__all__ = [
    "Transport", "LocalTransport", "HttpTransport", "HubUnavailable",
    "PublishConflict", "lineage_etag", "ETAG_ABSENT",
    "TransferPlan", "plan_transfer", "walk_manifests",
    "LocalJournalStore", "chunk_id", "transfer_id",
    "SyncReport", "LineageMergeReport", "NodeMergeOutcome", "RemoteState",
    "push", "pull", "clone", "merge_lineage",
    "remote_add", "remote_list", "remote_remove", "resolve_transport",
]
