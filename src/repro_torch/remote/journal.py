"""Resumable transfer journal (DESIGN.md §8.4).

A transfer is split into fixed-size chunks of CAS keys, taken over the
*full* negotiated closure in its deterministic transfer order — so chunk
boundaries and ids are identical across attempts. The *receiving* side
persists a journal document ``{"done": [chunk_id...], "total": N}`` after
every completed chunk; the transfer id is a content hash of the closure, so
a resumed push/pull maps onto the same journal, inherits its progress
record, and retires it on completion.

Because every object is content-addressed, the journal is a *progress* and
*diagnosis* structure, not a correctness one: skipping is decided by the
have/want negotiation (the receiver's actual contents), done markers only
corroborate it, and a crashed transfer leaves only idempotently
re-writable objects plus a journal file that ``fsck`` reports as an
in-flight transfer. Consistency comes from ordering — the lineage document
publishes only after the last chunk lands and is the single commit point
of a sync.

:class:`LocalJournalStore` persists journals for the pull direction (where
the receiver is the local repo); for push the journal methods live on the
:class:`~repro_torch.remote.transport.Transport` — over HTTP they become the
hub's ``/api/journal`` endpoints (DESIGN.md §11.4), so an interrupted
network push resumes against the same closure-keyed journal id exactly
like a local one. Chunks carry stored CAS objects only (``m_``/tensor/
blob/``t_`` keys, §3.2) — journal state never references live models.

Copied from the reference package's ``repro/remote/journal.py``; only the
imports differ.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.common.hashing import bytes_hash
from repro_torch.obs import propagate, span
from repro_torch.remote.negotiate import chunked

#: parallel chunk workers per transfer
TRANSFER_WORKERS = 4


def transfer_id(keys: Sequence[str], direction: str) -> str:
    """Stable id for a transfer. Key it on the *closure* (the full negotiated
    object set), not the want-list: a resumed attempt has a smaller want-list
    (objects that landed before the crash negotiate away) but must map onto
    the same journal to inherit and eventually clear it."""
    return bytes_hash(("\n".join(sorted(keys)) + "|" + direction).encode())[:16]


def chunk_id(keys: Sequence[str]) -> str:
    return bytes_hash("\n".join(keys).encode())[:16]


class LocalJournalStore:
    """Journal persistence in a local repo (``<repo>/transfers/``)."""

    def __init__(self, root: str) -> None:
        self.root = os.path.join(root, "transfers")

    def _path(self, tid: str) -> str:
        return os.path.join(self.root, f"{tid}.json")

    def journal_load(self, tid: str) -> Optional[Dict]:
        if not os.path.exists(self._path(tid)):
            return None
        with open(self._path(tid)) as f:
            return json.load(f)

    def journal_write(self, tid: str, payload: Dict) -> None:
        os.makedirs(self.root, exist_ok=True)
        tmp = self._path(tid) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._path(tid))

    def journal_clear(self, tid: str) -> None:
        if os.path.exists(self._path(tid)):
            os.remove(self._path(tid))

    def journal_list(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(f[:-5] for f in os.listdir(self.root)
                      if f.endswith(".json"))


def run_journalled_transfer(journal_store, tid: str, order: Sequence[str],
                            wants: Sequence[str], direction: str,
                            move_chunk: Callable[[List[str]], int],
                            chunk_size: int,
                            workers: int = TRANSFER_WORKERS,
                            ) -> Tuple[int, int, int]:
    """Move ``wants`` in parallel journalled chunks under journal id ``tid``.

    Chunk boundaries and ids are taken over ``order`` — the FULL negotiated
    closure in its deterministic transfer order — not over ``wants``: a
    resumed attempt has a smaller want-list (landed objects negotiate away),
    but identical chunking, so chunk ids recorded before a crash still match
    and those chunks are skipped without touching the wire. Within a chunk,
    only the keys still in ``wants`` move.

    The want-list stays authoritative over the journal: a chunk whose keys
    the receiver still misses is (re-)moved even if marked done — a journal
    can go stale (receiver gc, tampering), and skipping on its word alone
    would lose data. A done marker earns ``chunks_resumed`` credit only when
    the negotiation confirms its objects all landed.

    ``move_chunk(keys) -> bytes_moved`` performs one batch in either
    direction. Chunks run on a thread pool; the journal is updated from the
    coordinating thread after each completion (no concurrent journal writes).
    Returns ``(objects_moved, bytes_moved, chunks_resumed)``;
    ``chunks_resumed`` objects moved in an earlier attempt and are NOT
    re-counted."""
    want_set = set(wants)
    if not want_set:
        # nothing to move — but a journal left by a crashed attempt whose
        # objects all landed is now complete: retire it
        journal_store.journal_clear(tid)
        return 0, 0, 0
    journal = journal_store.journal_load(tid) or {"done": [], "total": 0}
    done = set(journal.get("done", []))
    pending = []
    resumed = 0
    for c in chunked(order, chunk_size):
        cid = chunk_id(c)
        keys = [k for k in c if k in want_set]
        if keys:
            pending.append((cid, keys))
        elif cid in done:
            resumed += 1
    moved_objects = 0
    moved_bytes = 0
    first_error: Optional[BaseException] = None

    def traced_move(cid, keys):
        with span("journal.chunk", cat="remote", chunk=cid,
                  objects=len(keys)):
            return move_chunk(keys)

    # propagate(): worker threads never saw the caller's contextvars, so
    # without the wrap the per-chunk spans would float parentless instead
    # of nesting under the surrounding push/pull transfer span
    moved = propagate(traced_move)
    with cf.ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        futures = {ex.submit(moved, cid, keys): (cid, keys)
                   for cid, keys in pending}
        for fut in cf.as_completed(futures):
            cid, keys = futures[fut]
            try:
                moved_bytes += fut.result()
            except BaseException as exc:
                # Keep draining: chunks that DID land must reach the journal
                # so the resumed transfer skips them.
                first_error = first_error or exc
                continue
            moved_objects += len(keys)
            done.add(cid)
            journal_store.journal_write(
                tid, {"done": sorted(done), "total": resumed + len(pending),
                      "direction": direction})
    if first_error is not None:
        raise first_error
    journal_store.journal_clear(tid)
    return moved_objects, moved_bytes, resumed
