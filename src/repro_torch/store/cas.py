"""Content-addressable store with refcounting + packfiles (paper §4; DESIGN.md §3.2).

Objects (tensors, delta blobs, manifests) are keyed by SHA-256 — writing the
same content twice costs nothing, which is exactly how parameters shared
across lineage-graph models are stored once.

Key schemes (DESIGN.md §3.2, §9.1, §9.3 — ``fsck`` verifies each):

* ``m_<bytes_hash>`` — manifests, hash of the JSON payload;
* ``<tensor_hash>`` — full tensors, hash over (shape, dtype, raw bytes),
  NOT over the serialized npy stream (re-deriving needs a decode). A
  bfloat16 tensor (the host's bf16 carrier, ``common/bf16.py``) is stored
  as ``np.save`` stores an ``ml_dtypes`` one, descr ``'<V2'``, and a ``V2``
  payload reads back as the carrier: ``put_tensor`` refuses any other
  2-byte void;
* ``<bytes_hash>`` — delta blobs and raw objects, hash of the stored bytes;
* ``t_<bytes_hash(test_hash NUL manifest_key)>`` — diagnostics ledger
  entries, keyed by the *lookup pair* (embedded in the payload) so results
  probe in O(1); the only scheme where ``put_bytes(overwrite=True)`` may
  legally change bytes under a key;
* ``s_<bytes_hash>`` — scoped content keys (``diag/transfer.py``): the hash
  of a submodule's parameter *hashes*, used as the ledger's manifest_key
  for scope-declared tests. Derived, never stored as an object itself;
* ``c_<bytes_hash>`` — tensor chunks (DESIGN.md §12): raw little-endian
  element bytes of one content-defined chunk of a large tensor, hash of
  exactly the stored bytes. No container framing, so ranged/zero-copy
  reads serve chunk payloads directly.

The loose/packed placement split is keyed on one constant:
``DEFAULT_PACK_THRESHOLD`` (256 KiB). Objects at or above it get a loose
file (mmap-able, ranged-readable); smaller ones append into packs. Every
layer (bare ``CAS()``, ``ArtifactStore``) shares this default — it used to
drift (4096 here vs 256 KiB above), which silently changed placement for
anyone instantiating a bare CAS.

What is stored is always the *stored form* of an artifact: committing
delta-quantizes against the parent, so the persisted model differs from the
in-memory one that was committed by up to the quantization eps. Every
consumer that needs bit-level truth (sync bit-identity checks, fsck,
diagnostics memoization) must compare store-loaded artifacts, never the
live Python objects they came from.

Two placement tiers, mirroring git's loose-object/packfile split:

* **loose**: objects >= ``pack_threshold`` bytes get one file each under
  ``objects/`` (atomic tmp + rename);
* **packed**: small objects (delta blobs, manifests) append into
  ``packs/pack-<n>.pack`` as self-describing records
  ``[keylen u16][key][datalen u32][data]`` with an in-memory offset index.
  The index is persisted as JSON beside the refcounts, and because records
  are self-describing any appended-but-unindexed tail is recovered by a
  bounded scan on reopen — a crash can never orphan a packed object.

``physical_bytes()`` / ``object_count()`` are O(1) counters maintained on
every mutation (the directory scans they replaced were O(n) per call).
Refcounts persist on ``incref``/``decref`` so a crash between a decref and
the next ``gc()`` can neither leak nor double-free objects.

Throughput paths (DESIGN.md §10):

* writes inside a :meth:`batch` context share one append handle per pack
  and fsync once when the outermost batch exits (the commit point) instead
  of reopening the pack file per record;
* reads are backed by a pooled-``mmap`` view cache — ``get_view`` returns a
  zero-copy ``memoryview`` into the mapped pack/loose file and
  ``get_tensor`` decodes npy payloads with ``np.frombuffer`` straight off
  the map (no intermediate ``bytes``). Pack files are append-only and pack
  ids are never reused, so a view can only go stale by the file *growing*,
  which a remap-on-demand check handles; files unlinked by gc/compaction
  stay readable through any live mapping (POSIX semantics).
"""

from __future__ import annotations

import contextlib
import io
import json
import mmap
import os
import struct
import threading
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.common import bf16
from repro_torch.common.faults import kill_point
from repro_torch.common.hashing import bytes_hash, tensor_hash

_REC_HEAD = struct.Struct("<HI")  # (keylen, datalen)
_MMAP_POOL_MAX = 64  # mapped files kept open; evicted maps stay valid for
                     # outstanding views (the arrays keep the mmap alive)

# Loose/packed placement boundary, shared by CAS and ArtifactStore (see the
# key-scheme docstring above).
DEFAULT_PACK_THRESHOLD = 256 * 2 ** 10


def _tensor_from_npy_view(view: memoryview) -> Optional[np.ndarray]:
    """Decode an npy stream as a zero-copy array over ``view``.

    Returns a read-only array aliasing the view's buffer, or None when the
    payload needs the copying loader (Fortran order / unsupported header).
    Read-only is load-bearing: the buffer may be a shared mmap of a pack
    file — writes through an aliasing array would corrupt the store."""
    buf = io.BytesIO(bytes(view[:512]))  # header only; payload stays mapped
    try:
        version = np.lib.format.read_magic(buf)
        np.lib.format._check_version(version)
        shape, fortran, dtype = np.lib.format._read_array_header(buf, version)
    except Exception:
        return None
    if fortran or dtype.hasobject:
        return None
    offset = buf.tell()
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if offset + count * dtype.itemsize > len(view):
        return None
    arr = np.frombuffer(view, dtype=dtype, count=count, offset=offset)
    arr = _bf16_of_void(arr.reshape(shape))
    arr.flags.writeable = False
    return arr


def _is_void2(arr: np.ndarray) -> bool:
    """Whether ``arr`` is an unstructured 2-byte void array."""
    return (arr.dtype.kind == "V" and arr.dtype.itemsize == 2
            and arr.dtype.names is None)


def _bf16_of_void(arr: np.ndarray) -> np.ndarray:
    """A ``V2`` array (the npy form of bfloat16, ``'<V2'`` or ``'|V2'``)
    as the bf16 carrier; any other array as it is."""
    return bf16.carry(arr) if _is_void2(arr) else arr


def npy_bytes(arr: np.ndarray) -> bytes:
    """``arr`` serialized as ``np.save`` writes it; the bf16 carrier as
    ``np.save`` writes an ``ml_dtypes`` bfloat16 array (descr ``'<V2'``)."""
    if bf16.is_bf16(arr):
        return bf16.npy_header(arr.shape) + np.ascontiguousarray(arr).tobytes()
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def ledger_key(test_hash: str, manifest_key: str) -> str:
    """Key scheme for diagnostics result-ledger entries (DESIGN.md §9.1).

    ``"t_" + bytes_hash(test_hash NUL manifest_key)`` — derived from the
    *lookup pair*, not the payload, so a memoized runner can probe for a
    recorded result in O(1) without an index. The payload embeds both
    components, which is how ``fsck`` re-derives and verifies the key."""
    return "t_" + bytes_hash(f"{test_hash}\x00{manifest_key}".encode())


class CAS:
    def __init__(self, root: Optional[str] = None,
                 pack_threshold: int = DEFAULT_PACK_THRESHOLD,
                 pack_max_bytes: int = 64 * 2**20,
                 mmap_pool_max: Optional[int] = None) -> None:
        self.root = root
        self.pack_threshold = pack_threshold
        self.pack_max_bytes = pack_max_bytes
        self._mmap_pool_max = (_MMAP_POOL_MAX if mmap_pool_max is None
                               else max(1, int(mmap_pool_max)))
        self._mem: Dict[str, bytes] = {}
        self.refcounts: Dict[str, int] = {}
        self._lock = threading.RLock()
        self._defer_persist = 0
        self.stats = {"puts": 0, "gets": 0, "dedup_hits": 0, "bytes_written": 0,
                      "bytes_deduped": 0, "zero_copy_gets": 0, "fsyncs": 0}
        # pack state: key -> (pack_id, offset, length); offsets point at data
        self._pack_index: Dict[str, Tuple[int, int, int]] = {}
        self._pack_sizes: Dict[int, int] = {}   # pack_id -> bytes on disk
        self._pack_dead: Dict[int, int] = {}    # pack_id -> dead payload bytes
        self._next_pack = 0
        # O(1) accounting counters
        self._object_count = 0
        self._physical_bytes = 0
        # batched-write state: open append handles, live only inside batch()
        self._batch_depth = 0
        self._batch_handles: Dict[int, Any] = {}
        # pooled mmap views keyed by file path -> (mmap, mapped_size)
        self._mmap_pool: "OrderedDict[str, Tuple[mmap.mmap, int]]" = OrderedDict()
        # reader leases (DESIGN.md §16.2): while pins are held, gc() performs
        # logical deletes only — physical reclaim and pack compaction are
        # deferred until the last pin releases, so an in-flight ranged read
        # or mget stream can never observe a reclaimed object.
        self._pins = 0
        self._deferred_dead: Dict[str, int] = {}   # key -> payload bytes
        self._gc_epoch = 0
        if root is not None:
            os.makedirs(os.path.join(root, "objects"), exist_ok=True)
            os.makedirs(os.path.join(root, "packs"), exist_ok=True)
            rc = os.path.join(root, "refcounts.json")
            if os.path.exists(rc):
                with open(rc) as f:
                    self.refcounts = json.load(f)
            self._load_pack_index()
            self._rebuild_counters()

    # -- layout ----------------------------------------------------------------
    def _obj_path(self, key: str) -> str:
        return os.path.join(self.root, "objects", key)

    def _pack_path(self, pack_id: int) -> str:
        return os.path.join(self.root, "packs", f"pack-{pack_id:06d}.pack")

    def _index_path(self) -> str:
        return os.path.join(self.root, "packs", "pack-index.json")

    # -- pack index persistence / recovery --------------------------------------
    def _load_pack_index(self, truncate_torn: bool = True) -> None:
        if os.path.exists(self._index_path()):
            with open(self._index_path()) as f:
                payload = json.load(f)
            self._pack_index = {k: tuple(v)
                                for k, v in payload["entries"].items()}
            self._pack_sizes = {int(k): v
                                for k, v in payload["pack_sizes"].items()}
            self._pack_dead = {int(k): v
                               for k, v in payload.get("dead", {}).items()}
            self._next_pack = payload.get("next_pack", 0)
        # Recover records appended after the last index write (or ever, if the
        # index file is gone): scan each pack's unindexed tail.
        for fname in sorted(os.listdir(os.path.join(self.root, "packs"))):
            if not fname.endswith(".pack"):
                continue
            pid = int(fname.rsplit("-", 1)[1].split(".")[0])
            # keep appending to the newest pack (rotation happens on write
            # when it fills) — bumping past it would leak one stub pack per
            # process lifetime
            self._next_pack = max(self._next_pack, pid)
            path = self._pack_path(pid)
            actual = os.path.getsize(path)
            indexed = self._pack_sizes.get(pid, 0)
            if actual > indexed:
                self._scan_pack_tail(pid, indexed, actual,
                                     truncate_torn=truncate_torn)
        self._sweep_orphan_packs()

    def _scan_pack_tail(self, pack_id: int, start: int, end: int,
                        truncate_torn: bool = True) -> None:
        with open(self._pack_path(pack_id), "rb") as f:
            f.seek(start)
            pos = start
            while pos + _REC_HEAD.size <= end:
                head = f.read(_REC_HEAD.size)
                if len(head) < _REC_HEAD.size:
                    break
                klen, dlen = _REC_HEAD.unpack(head)
                if pos + _REC_HEAD.size + klen + dlen > end:
                    break  # torn tail record from a crash mid-append: ignore
                key = f.read(klen).decode("utf-8", "replace")
                data_off = pos + _REC_HEAD.size + klen
                f.seek(dlen, os.SEEK_CUR)
                # Last-wins: tail records are strictly newer than anything
                # in the persisted index (they were appended after its last
                # flush), and within/across tails the scan order is
                # chronological — so an overwrite-in-place record (ledger
                # ``t_`` scheme) recovered here must supersede the stale
                # entry, whose bytes become dead payload. Content-addressed
                # keys are unaffected (identical bytes either way).
                old = self._pack_index.get(key)
                if old is not None:
                    self._pack_dead[old[0]] = (self._pack_dead.get(old[0], 0)
                                               + old[2])
                self._pack_index[key] = (pack_id, data_off, dlen)
                pos = data_off + dlen
            self._pack_sizes[pack_id] = pos
        if pos < end and truncate_torn:
            # torn record from a crash mid-append — drop it so later appends
            # land exactly at the indexed offset (a read-only reload instead
            # leaves it alone: the writer may still be mid-append)
            with open(self._pack_path(pack_id), "r+b") as f:
                f.truncate(pos)

    def _persist_pack_index(self) -> None:
        if self.root is None:
            return
        payload = {"entries": {k: list(v) for k, v in self._pack_index.items()},
                   "pack_sizes": {str(k): v for k, v in self._pack_sizes.items()},
                   "dead": {str(k): v for k, v in self._pack_dead.items()},
                   "next_pack": self._next_pack}
        tmp = self._index_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._index_path())

    def _rebuild_counters(self) -> None:
        """One O(n) pass at open; every later query is O(1)."""
        objdir = os.path.join(self.root, "objects")
        loose = [f for f in os.listdir(objdir) if not f.endswith(".tmp")]
        self._object_count = len(loose) + len(self._pack_index)
        self._physical_bytes = sum(
            os.path.getsize(os.path.join(objdir, f)) for f in loose)
        self._physical_bytes += sum(self._pack_sizes.values())

    # -- raw object interface ------------------------------------------------
    def has(self, key: str) -> bool:
        if self.root is None:
            return key in self._mem
        return (key in self._pack_index or key in self.refcounts
                or os.path.exists(self._obj_path(key)))

    def _write_loose(self, key: str, data: bytes) -> None:
        path = self._obj_path(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            # fsync BEFORE the rename: os.replace is atomic for the name but
            # not for the bytes — without this a crash can publish a
            # truncated object under its final (content-addressed!) key
            f.flush()
            os.fsync(f.fileno())
            self.stats["fsyncs"] += 1
        os.replace(tmp, path)
        # the rename swapped the inode: a pooled map of the old file would
        # serve stale bytes (matters for overwrite-in-place, e.g. a forced
        # diag ledger re-record whose payload crossed the pack threshold)
        with self._lock:
            self._mmap_pool.pop(path, None)
        self._physical_bytes += len(data)

    def _pack_handle(self, pid: int):
        """Append handle for ``pid``, cached for the duration of a batch."""
        f = self._batch_handles.get(pid)
        if f is None:
            f = self._batch_handles[pid] = open(self._pack_path(pid), "ab")
        return f

    def _write_packed(self, key: str, data: bytes) -> None:
        pid = self._next_pack
        size = self._pack_sizes.get(pid, 0)
        if size and size >= self.pack_max_bytes:
            pid = self._next_pack = self._next_pack + 1
            size = 0
        kb = key.encode()
        record = _REC_HEAD.pack(len(kb), len(data)) + kb + data
        if self._batch_depth > 0:
            f = self._pack_handle(pid)
            f.write(record)
            f.flush()  # reach the OS so concurrent readers/mmaps see it;
            # durability still waits for the single fsync at batch exit
        else:
            with open(self._pack_path(pid), "ab") as f:
                f.write(record)
        self._pack_index[key] = (pid, size + _REC_HEAD.size + len(kb),
                                 len(data))
        self._pack_sizes[pid] = size + len(record)
        self._physical_bytes += len(record)

    @contextlib.contextmanager
    def batch(self):
        """Buffered-append window: packed writes share one handle per pack
        and are fsynced ONCE when the outermost batch exits (the commit
        point). Without it every packed record pays an open/close — the
        dominant syscall cost of a many-object commit. Loose objects keep
        their own per-file fsync (they are published by rename and must be
        durable *before* the name exists). Reentrant and thread-shared:
        EVERY batch exit fsyncs the open handles — each exiting commit is a
        durability point even while other batches overlap — and the last
        exit also closes them."""
        with self._lock:
            self._batch_depth += 1
        try:
            yield self
        finally:
            with self._lock:
                self._batch_depth -= 1
                for f in self._batch_handles.values():
                    f.flush()
                    os.fsync(f.fileno())
                    self.stats["fsyncs"] += 1
                if self._batch_depth == 0:
                    for f in self._batch_handles.values():
                        f.close()
                    self._batch_handles.clear()

    def write_batch(self, items: Iterable[Tuple[str, bytes]]) -> List[str]:
        """Land many objects through one buffered batch; returns their keys."""
        with self.batch():
            return [self.put_bytes(data, key=key) for key, data in items]

    def put_bytes(self, data: bytes, key: Optional[str] = None,
                  overwrite: bool = False) -> str:
        """Store ``data`` under ``key`` (its content hash by default).

        ``overwrite=True`` replaces an existing object's bytes in place —
        same key, same refcount, old packed record marked dead for
        compaction. Only meaningful for the ledger scheme (``t_``), whose
        keys derive from the lookup pair rather than the payload; content-
        hashed objects can never legitimately change under their key."""
        key = key or bytes_hash(data)
        with self._lock:
            self.stats["puts"] += 1
            if self.has(key):
                if not overwrite:
                    self.stats["dedup_hits"] += 1
                    self.stats["bytes_deduped"] += len(data)
                    self.refcounts[key] = self.refcounts.get(key, 0) + 1
                    return key
                if self.root is None:
                    old = self._mem.get(key)
                    if old is not None:
                        self._physical_bytes -= len(old)
                    self._mem[key] = data
                    self._physical_bytes += len(data)
                elif key in self._pack_index:
                    pid, _, length = self._pack_index[key]
                    self._pack_dead[pid] = self._pack_dead.get(pid, 0) + length
                    self._write_packed(key, data)
                else:
                    path = self._obj_path(key)
                    if os.path.exists(path):
                        self._physical_bytes -= os.path.getsize(path)
                    self._write_loose(key, data)
                self.stats["bytes_written"] += len(data)
                return key
            if self.root is None:
                self._mem[key] = data
                self._physical_bytes += len(data)
            elif len(data) < self.pack_threshold:
                self._write_packed(key, data)
            else:
                self._write_loose(key, data)
            self._object_count += 1
            self.stats["bytes_written"] += len(data)
            self.refcounts[key] = self.refcounts.get(key, 0) + 1
            return key

    # -- pooled mmap views -------------------------------------------------------
    def _map_file(self, path: str, need_end: int) -> Optional[mmap.mmap]:
        """Shared read-only map of ``path`` covering at least ``need_end``.

        Maps are pooled (LRU) and remapped when the file has grown past the
        mapped size — pack files are append-only, so stale maps are only
        ever too *short*, never wrong. Returns None when the file cannot be
        mapped (missing, empty) — callers fall back to plain reads."""
        with self._lock:
            entry = self._mmap_pool.get(path)
            if entry is not None and entry[1] >= need_end:
                self._mmap_pool.move_to_end(path)
                return entry[0]
            try:
                with open(path, "rb") as f:
                    size = os.fstat(f.fileno()).st_size
                    if size < need_end or size == 0:
                        return None
                    mm = mmap.mmap(f.fileno(), size, access=mmap.ACCESS_READ)
            except (OSError, ValueError):
                return None
            # dropping an evicted/replaced map only releases OUR reference;
            # arrays holding views keep the mapping alive until they die
            self._mmap_pool[path] = (mm, size)
            self._mmap_pool.move_to_end(path)
            while len(self._mmap_pool) > self._mmap_pool_max:
                self._mmap_pool.popitem(last=False)
            return mm

    def get_view(self, key: str) -> memoryview:
        """Zero-copy read: a ``memoryview`` over the object's stored bytes.

        Backed by the pooled mmap for on-disk objects; raises ``KeyError``
        for missing keys (same contract as :meth:`get_bytes`)."""
        self.stats["gets"] += 1
        if self.root is None:
            try:
                return memoryview(self._mem[key])
            except KeyError:
                raise KeyError(f"no object {key!r} in CAS")
        entry = self._pack_index.get(key)
        if entry is not None:
            pid, off, length = entry
            mm = self._map_file(self._pack_path(pid), off + length)
            if mm is not None:
                self.stats["zero_copy_gets"] += 1
                return memoryview(mm)[off:off + length]
            return memoryview(self._read_packed(pid, off, length))
        path = self._obj_path(key)
        size = os.path.getsize(path) if os.path.exists(path) else 0
        mm = self._map_file(path, size) if size else None
        if mm is not None:
            self.stats["zero_copy_gets"] += 1
            return memoryview(mm)
        return memoryview(self._read_loose(key))

    def iter_views(self, keys: Iterable[str]):
        """Streaming multi-get: yield ``(key, view)`` pairs lazily.

        The hub's multi-object pack streaming (DESIGN.md §11.2) sits on
        this — each view is produced only when the consumer is ready to
        write it out, so serving an arbitrarily large object batch holds at
        most one object's view at a time (and usually zero copies: views
        come off the pooled mmap). Raises ``KeyError`` at the position of
        the first missing key, same contract as :meth:`get_view`."""
        for key in keys:
            yield key, self.get_view(key)

    def _read_packed(self, pid: int, off: int, length: int) -> bytes:
        with open(self._pack_path(pid), "rb") as f:
            f.seek(off)
            return f.read(length)

    def _read_loose(self, key: str) -> bytes:
        try:
            with open(self._obj_path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            # normalize the miss path: a missing object is a KeyError no
            # matter which placement tier it would have lived in
            raise KeyError(f"no object {key!r} in CAS")

    def get_bytes(self, key: str) -> bytes:
        """Object bytes (owned copy). Served off the pooled mmap when the
        file is mapped — repeated small reads skip the open/read/close
        syscall triple that dominates deep-chain checkouts."""
        self.stats["gets"] += 1
        if self.root is None:
            try:
                return self._mem[key]
            except KeyError:
                raise KeyError(f"no object {key!r} in CAS")
        entry = self._pack_index.get(key)
        if entry is not None:
            pid, off, length = entry
            mm = self._map_file(self._pack_path(pid), off + length)
            if mm is not None:
                return mm[off:off + length]
            return self._read_packed(pid, off, length)
        path = self._obj_path(key)
        try:
            size = os.path.getsize(path)
        except OSError:
            raise KeyError(f"no object {key!r} in CAS")
        mm = self._map_file(path, size) if size else None
        if mm is not None:
            return mm[:size]
        return self._read_loose(key)

    def get_bytes_nomap(self, key: str) -> bytes:
        """Object bytes via plain ``read()``, bypassing the mmap pool.

        The chunk streaming paths (DESIGN.md §12) use this: mapped pages are
        charged to the process RSS high-water mark, so a bounded-memory
        checkout of a multi-GB tensor must not page its chunks through
        long-lived maps. Plain reads copy through the kernel page cache,
        which is reclaimable and not part of ``ru_maxrss``."""
        self.stats["gets"] += 1
        if self.root is None:
            try:
                return self._mem[key]
            except KeyError:
                raise KeyError(f"no object {key!r} in CAS")
        entry = self._pack_index.get(key)
        if entry is not None:
            pid, off, length = entry
            return self._read_packed(pid, off, length)
        return self._read_loose(key)

    def size(self, key: str) -> int:
        if self.root is None:
            return len(self._mem[key])
        entry = self._pack_index.get(key)
        if entry is not None:
            return entry[2]
        return os.path.getsize(self._obj_path(key))

    # -- tensors ---------------------------------------------------------------
    def put_tensor(self, arr: np.ndarray, key: Optional[str] = None) -> str:
        """Store a tensor (npy-serialized); key is its content hash.

        A 2-byte void array other than an ``ml_dtypes`` bfloat16 one is
        refused: a ``V2`` payload reads back as bfloat16, so it would come
        back under another dtype than its key's."""
        arr = np.asarray(arr)
        if _is_void2(arr) and arr.dtype.name != bf16.NAME:
            raise TypeError(
                f"cannot store a {arr.dtype.str} array: a 2-byte void payload "
                f"reads back as bfloat16; store bf16 as the carrier "
                f"(repro_torch.common.bf16.carry)")
        key = key or tensor_hash(arr)
        if self.has(key):  # avoid serializing at all on a dedup hit
            with self._lock:
                self.stats["puts"] += 1
                self.stats["dedup_hits"] += 1
                self.stats["bytes_deduped"] += arr.nbytes
                self.refcounts[key] = self.refcounts.get(key, 0) + 1
            return key
        return self.put_bytes(npy_bytes(arr), key=key)

    def get_tensor(self, key: str) -> np.ndarray:
        """Decode a stored npy payload, zero-copy where possible.

        The returned array aliases the pooled mmap (read-only,
        ``np.frombuffer`` over the payload view) — no intermediate ``bytes``
        object, no memcpy. Falls back to a copying ``np.load`` for payloads
        frombuffer can't express (Fortran order, object dtypes, odd
        headers)."""
        view = self.get_view(key)
        try:
            arr = _tensor_from_npy_view(view)
            if arr is not None:
                return arr
        except Exception:
            pass
        return _bf16_of_void(np.load(io.BytesIO(bytes(view)),
                                     allow_pickle=False))

    # -- refcounting / GC --------------------------------------------------------
    def incref(self, key: str) -> None:
        with self._lock:
            self.refcounts[key] = self.refcounts.get(key, 0) + 1
            self._persist_refcounts()

    def decref(self, key: str) -> None:
        with self._lock:
            if key not in self.refcounts:
                return
            # clamp at zero: a double-release must not push the count negative
            # (a later incref would then resurrect a still-dead object)
            self.refcounts[key] = max(0, self.refcounts[key] - 1)
            self._persist_refcounts()

    @contextlib.contextmanager
    def batched_refcounts(self):
        """Coalesce refcount persistence across a multi-incref/decref
        operation (e.g. releasing a whole manifest) into ONE durable write at
        exit — otherwise every call rewrites refcounts.json, O(objects) each."""
        with self._lock:
            self._defer_persist += 1
        try:
            yield
        finally:
            with self._lock:
                self._defer_persist -= 1
                self._persist_refcounts()

    @contextlib.contextmanager
    def pin(self):
        """Reader lease (DESIGN.md §16.2).

        While any pin is held, :meth:`gc` only *logically* deletes dead
        objects (drops their refcount entries) — their bytes stay readable
        in packs/loose files, and pack compaction is deferred — so a reader
        that resolved keys before gc ran can finish its ranged reads/mget
        stream against a consistent store. The last pin release performs
        the deferred physical reclaim, re-checking refcounts first: a key
        re-put and re-referenced during the deferral window (resurrection)
        is kept."""
        with self._lock:
            self._pins += 1
        try:
            yield
        finally:
            with self._lock:
                self._pins -= 1
                if self._pins == 0 and self._deferred_dead:
                    self._reclaim_deferred_locked()

    @property
    def pins(self) -> int:
        with self._lock:
            return self._pins

    @property
    def gc_epoch(self) -> int:
        """Monotonic counter bumped by every :meth:`gc` call. Readers that
        snapshot it before resolving keys can detect a concurrent gc and
        abort-and-retry instead of trusting stale offsets."""
        with self._lock:
            return self._gc_epoch

    def deferred_dead_bytes(self) -> int:
        """Bytes logically dead but physically retained for active pins."""
        with self._lock:
            return sum(self._deferred_dead.values())

    def _object_size_locked(self, key: str) -> int:
        if self.root is None:
            return len(self._mem.get(key, b""))
        ent = self._pack_index.get(key)
        if ent is not None:
            return ent[2]
        p = self._obj_path(key)
        return os.path.getsize(p) if os.path.exists(p) else 0

    def _reclaim_one_locked(self, key: str) -> int:
        """Physically remove one object; returns payload bytes reclaimed."""
        if self.root is None:
            blob = self._mem.pop(key, None)
            if blob is None:
                return 0
            self._physical_bytes -= len(blob)
            self._object_count -= 1
            return len(blob)
        if key in self._pack_index:
            pid, _, length = self._pack_index.pop(key)
            self._pack_dead[pid] = self._pack_dead.get(pid, 0) + length
            self._object_count -= 1
            return length
        p = self._obj_path(key)
        if os.path.exists(p):
            n = os.path.getsize(p)
            self._physical_bytes -= n
            self._object_count -= 1
            os.remove(p)
            return n
        return 0

    def _reclaim_deferred_locked(self) -> int:
        reclaimed = 0
        for k in list(self._deferred_dead):
            self._deferred_dead.pop(k)
            if self.refcounts.get(k, 0) > 0:
                continue  # resurrected during the deferral window
            reclaimed += self._reclaim_one_locked(k)
        self._compact_packs()
        self._persist_refcounts()
        self._persist_pack_index()
        return reclaimed

    def gc(self) -> int:
        """Delete unreferenced objects; returns bytes reclaimed.

        Under active :meth:`pin` leases the dead set is removed from the
        refcount table immediately (unreachable to new readers that consult
        refcounts) but physical removal is deferred to the last pin release;
        the returned byte count includes deferred bytes — they are committed
        for reclaim and cannot be resurrected except by an explicit re-put."""
        reclaimed = 0
        with self._lock:
            kill_point("cas.gc.pre_reclaim")
            dead = [k for k, c in self.refcounts.items() if c <= 0]
            pinned = self._pins > 0
            for k in dead:
                del self.refcounts[k]
                if pinned:
                    size = self._object_size_locked(k)
                    self._deferred_dead[k] = size
                    reclaimed += size
                else:
                    reclaimed += self._reclaim_one_locked(k)
            if not pinned:
                self._compact_packs()
            self._gc_epoch += 1
            self._persist_refcounts()
            self._persist_pack_index()
        return reclaimed

    def compact(self, aggressive: bool = False) -> bool:
        """Explicit pack compaction (the hub maintenance entry point).

        ``aggressive=True`` rewrites every pack carrying ANY dead payload,
        not just those past the half-dead threshold. Refuses (returns
        False) while reader leases are pinned: compaction moves index
        entries between packs, and an in-flight mget preflight must see a
        stable index — the caller retries after the leases drain."""
        with self._lock:
            if self._pins > 0:
                return False
            self._compact_packs(aggressive=aggressive)
            self._persist_refcounts()
            self._persist_pack_index()
            return True

    def _compact_packs(self, aggressive: bool = False) -> None:
        """Rewrite packs whose dead payload exceeds half their size.

        Crash-safe ordering: live records are COPIED into the active pack and
        the index persisted BEFORE the old pack file is unlinked — a crash at
        any point leaves either the old locations (index not yet persisted)
        or the new ones plus an orphan pack, which ``_sweep_orphan_packs``
        removes on the next open. Live data is never the only copy at risk."""
        if self.root is None:
            return
        for pid, dead_bytes in list(self._pack_dead.items()):
            size = self._pack_sizes.get(pid, 0)
            if dead_bytes <= 0 or (not aggressive and dead_bytes * 2 < size):
                continue
            live = {k: e for k, e in self._pack_index.items() if e[0] == pid}
            path = self._pack_path(pid)
            if live:
                if self._next_pack == pid:
                    self._next_pack = pid + 1  # never copy into the victim
                with open(path, "rb") as f:
                    blobs = {}
                    for k, (_, off, length) in live.items():
                        f.seek(off)
                        blobs[k] = f.read(length)
                for k in live:
                    del self._pack_index[k]
                for k, blob in blobs.items():
                    self._write_packed(k, blob)
            self._pack_dead.pop(pid, None)
            # persist with the victim still fully accounted (so a crash here
            # cannot resurrect its dead records via a tail scan)...
            self._persist_pack_index()
            # ...then unlink and drop it from the books
            stale = self._batch_handles.pop(pid, None)
            if stale is not None:
                stale.close()
            self._mmap_pool.pop(path, None)  # live views keep the map alive
            if os.path.exists(path):
                os.remove(path)
            self._physical_bytes -= size
            self._pack_sizes.pop(pid, None)

    def _sweep_orphan_packs(self) -> None:
        """Remove fully-superseded packs left by a crash mid-compaction."""
        referenced = {e[0] for e in self._pack_index.values()}
        for pid in list(self._pack_sizes):
            if pid in referenced or pid == self._next_pack:
                continue
            path = self._pack_path(pid)
            size = self._pack_sizes[pid]
            if os.path.exists(path):
                os.remove(path)
            self._physical_bytes -= size
            self._pack_sizes.pop(pid, None)
            self._pack_dead.pop(pid, None)

    def _persist_refcounts(self) -> None:
        if self.root is None or self._defer_persist > 0:
            return
        tmp = os.path.join(self.root, "refcounts.json.tmp")
        with open(tmp, "w") as f:
            json.dump(self.refcounts, f)
        os.replace(tmp, os.path.join(self.root, "refcounts.json"))

    def flush(self) -> None:
        """Persist refcounts + pack index (called by stores at commit points)."""
        with self._lock:
            self._persist_refcounts()
            self._persist_pack_index()

    def reload(self) -> None:
        """Pick up objects appended by OTHER processes since open.

        Long-running readers (the serve daemon watching for publishes) see
        a snapshot of the pack index from open time; a writer process that
        commits afterwards appends records this instance has never indexed.
        Re-reading refcounts + the persisted index and tail-scanning the
        packs — exactly the open-time recovery pass — makes them visible.
        Read-only: torn tail records (a writer mid-append) are skipped,
        never truncated, and pooled mmaps remap on demand as packs grow."""
        if self.root is None:
            return
        with self._lock:
            rc = os.path.join(self.root, "refcounts.json")
            if os.path.exists(rc):
                with open(rc) as f:
                    self.refcounts = json.load(f)
            self._load_pack_index(truncate_torn=False)
            self._rebuild_counters()

    # -- integrity ----------------------------------------------------------------
    def keys(self) -> List[str]:
        """Every live object key (loose + packed, or in-memory)."""
        with self._lock:
            if self.root is None:
                return list(self._mem)
            objdir = os.path.join(self.root, "objects")
            loose = [f for f in os.listdir(objdir) if not f.endswith(".tmp")]
            return sorted(set(self._pack_index) | set(loose))

    def _verify_key(self, key: str, data: bytes) -> bool:
        """Check ``data`` reproduces its content-address ``key``.

        Five key schemes exist (DESIGN.md §3.2, §9.1, §12): manifests are
        ``"m_" + bytes_hash(payload)``; chunks are ``"c_" + bytes_hash(raw
        chunk bytes)``; diagnostics ledger entries are
        ``"t_" + bytes_hash(test_hash NUL manifest_key)`` re-derived from
        the payload's embedded pair; delta blobs and raw objects are
        ``bytes_hash(data)``; tensors are ``tensor_hash(arr)`` — a hash over
        (shape, dtype, raw bytes), NOT over the serialized npy stream — so
        tensor keys need a decode round-trip to re-derive."""
        if key.startswith("m_"):
            return bytes_hash(data) == key[2:]
        if key.startswith("c_"):
            return bytes_hash(data) == key[2:]
        if key.startswith("t_"):
            try:
                obj = json.loads(data)
                return ledger_key(obj["test_hash"], obj["manifest_key"]) == key
            except Exception:
                return False
        if bytes_hash(data) == key:
            return True
        try:
            arr = _bf16_of_void(np.load(io.BytesIO(data), allow_pickle=False))
            return tensor_hash(arr) == key
        except Exception:
            return False

    def fsck(self) -> Dict[str, Any]:
        """Integrity pass: re-hash every object, cross-check refcounts.

        Reports ``corrupt`` objects (stored bytes no longer reproduce their
        key — bit rot or a torn write), ``dangling_refs`` (refcounted keys
        with no object behind them: these would crash on access) and
        ``untracked`` objects (present but unknown to the refcount table:
        unreachable until re-put, collected by nothing). Store-level drift
        against the manifest graph is layered on top by
        :meth:`repro_torch.store.artifact_store.ArtifactStore.fsck`."""
        with self._lock:
            present = self.keys()
            corrupt: List[str] = []
            for key in present:
                try:
                    data = self.get_bytes(key)
                except Exception:
                    corrupt.append(key)
                    continue
                if not self._verify_key(key, data):
                    corrupt.append(key)
            present_set = set(present)
            dangling = sorted(k for k, c in self.refcounts.items()
                              if c > 0 and k not in present_set)
            # keys logically gc'd but physically retained for an active pin
            # are accounted-for, not untracked drift
            untracked = sorted(k for k in present_set
                               if k not in self.refcounts
                               and k not in self._deferred_dead)
            return {
                "objects_checked": len(present),
                "corrupt": corrupt,
                "dangling_refs": dangling,
                "untracked": untracked,
                "ok": not corrupt and not dangling,
            }

    # -- accounting ---------------------------------------------------------------
    def physical_bytes(self) -> int:
        """Total bytes on disk (or in memory) — O(1) counter."""
        return self._physical_bytes

    def object_count(self) -> int:
        """Live objects (loose + packed) — O(1) counter."""
        if self.root is None:
            return len(self._mem)
        return self._object_count

    def pack_stats(self) -> Dict[str, int]:
        return {
            "packs": len(self._pack_sizes),
            "packed_objects": len(self._pack_index),
            "packed_bytes": sum(self._pack_sizes.values()),
            "pack_dead_bytes": sum(self._pack_dead.values()),
        }
