"""Hub maintenance: orphan GC and pack compaction under live traffic (§16.3).

A shared-CAS hub accumulates two kinds of garbage the per-push ``finalize``
can never touch (``rebuild_refcounts`` only writes keys reachable from the
given roots, by design):

* **orphans** — keys with a positive refcount that no tenant's lineage
  reaches: the residue of deleted repos, superseded publishes, and crashed
  pushes whose transfer landed but whose publish never did;
* **dead pack payload** — bytes in packfiles owned by already-collected
  records, reclaimed by rewriting the pack.

Correctness under concurrency rests on three fences:

1. **Import grace list.** A push's objects are refcounted-but-unreachable
   between its transfer and its publish — exactly an orphan's signature.
   :meth:`HubService.note_imports` stamps every imported key with the
   current maintenance cycle; keys stamped within ``grace`` cycles are
   never candidates. A push therefore only risks collection if it idles
   for more than two full maintenance intervals between transfer end and
   publish — and even then fence 2 must also miss it.
2. **Two-cycle confirmation.** A candidate is only reclaimed if it was
   *already* a candidate in the previous cycle AND is one again now, with
   both root snapshots taken under every tenant's publish lock plus the
   service finalize lock — so a publish that resurrects a candidate
   between cycles is always observed.
3. **Reader leases.** The zero-and-sweep runs ``CAS.gc()`` which, under
   active :meth:`CAS.pin` leases (held by in-flight object GETs and mget
   streams), defers physical reclaim to the last lease release. A reader
   that resolved offsets before the sweep finishes its stream against
   intact bytes; the mget abort-and-retry seam remains as the last-ditch
   defense.

Writers (publish/finalize) stall for the duration of the zero-and-sweep —
refcount surgery and index bookkeeping, no object I/O — which is the
advertised saturation behavior (§16.4): GC pauses writes briefly, never
readers.

Copied from the reference package's ``repro/hub/gc.py``; only the imports
differ.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

from repro_torch.common.faults import kill_point
from repro_torch.obs import span


@contextlib.contextmanager
def _all_publish_locks(service):
    """Every tenant's publish lock + the finalize lock, in one canonical
    order (finalize first, then tenants sorted by name) so maintenance can
    never deadlock against a publish/finalize pair."""
    with service._repos_lock:
        apps = [service._repos[n] for n in sorted(service._repos)]
    with contextlib.ExitStack() as stack:
        stack.enter_context(service._finalize_lock)
        for app in apps:
            stack.enter_context(app._publish_lock)
        yield


def orphan_candidates(service, grace: int = 1) -> set:
    """Refcounted keys unreachable from every tenant's roots, minus the
    import grace list. Caller must hold the publish/finalize locks for the
    snapshot to be race-free against concurrent publishes."""
    store = service.store
    reachable = set(store.expected_refcounts(service.all_roots()))
    recent = service.recent_import_keys(grace=grace)
    with store.cas._lock:
        counted = [k for k, c in store.cas.refcounts.items() if c > 0]
    return {k for k in counted if k not in reachable and k not in recent}


def run_gc(service, confirm_cycles: int = 2,
           grace: int = 1) -> Dict[str, Any]:
    """One maintenance cycle: confirm + reclaim orphans, sweep rc==0 keys.

    Returns a report with candidate/confirmed counts and bytes reclaimed
    (bytes deferred to an active reader lease count as reclaimed — they are
    committed and unlinked at the last pin release). ``confirm_cycles=1``
    skips the two-cycle fence and ``grace=0`` the import grace list —
    offline use only (``mgit hub gc`` on a dir with no live traffic).
    With the defaults, garbage created at cycle N is reclaimed at cycle
    N+3 at the latest: protected through N+1 (grace), candidate at N+2,
    confirmed at N+3."""
    store = service.store
    with service.gc_lock, span("hub.gc", cat="hub"):
        service.gc_cycle += 1
        cycle = service.gc_cycle
        with _all_publish_locks(service):
            cands = orphan_candidates(service, grace=grace)
            if confirm_cycles <= 1:
                confirmed = set(cands)
            else:
                confirmed = cands & service.prev_orphans
            kill_point("hub.gc.pre_zero")
            if confirmed:
                with store.cas.batched_refcounts():
                    for k in confirmed:
                        store.cas.refcounts[k] = 0
            # sweep inside the lock scope: a publish racing the sweep could
            # otherwise re-reference a key between our zeroing and the CAS
            # removing its bytes
            reclaimed = store.cas.gc()
            # the confirmation ledger only advances once the sweep commits —
            # a crash anywhere above leaves the previous cycle's candidate
            # set intact instead of resetting the two-cycle clock
            service.prev_orphans = cands - confirmed
        deferred = store.cas.deferred_dead_bytes()
        report = {
            "cycle": cycle,
            "candidates": len(cands),
            "confirmed_orphans": len(confirmed),
            "reclaimed_bytes": reclaimed,
            "deferred_bytes": deferred,
            "gc_epoch": store.cas.gc_epoch,
        }
        service.default.count(gc_runs=1, gc_bytes_reclaimed=reclaimed)
        return report


def run_compaction(service) -> Dict[str, Any]:
    """Rewrite packs carrying dead payload (aggressive: any dead bytes).

    Skipped while reader leases are active — compaction relocates live
    records between packs, and although POSIX keeps unlinked pack files
    readable through existing mmaps, an in-flight mget's size preflight
    must not see index entries move under it. The caller (maintenance
    loop / CLI) simply retries next cycle."""
    store = service.store
    with service.gc_lock, span("hub.compact", cat="hub"):
        before = store.cas.pack_stats()
        did = store.cas.compact(aggressive=True)
        after = store.cas.pack_stats()
        report = {
            "ran": did,
            "packs_before": before["packs"],
            "packs_after": after["packs"],
            "dead_bytes_before": before["pack_dead_bytes"],
            "dead_bytes_after": after["pack_dead_bytes"],
        }
        if did:
            service.default.count(compactions=1)
        return report
