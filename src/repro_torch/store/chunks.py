"""Content-defined chunking for large tensors (DESIGN.md §12).

Tensors at or above ``ArtifactStore.chunk_threshold`` are split into chunks
that become first-class CAS objects under the ``c_<sha256(bytes)>`` key
scheme. Boundaries come from a Gear-style rolling hash — a windowed hash of
the last ``WINDOW`` bytes, cut where ``hash & mask == 0`` — so a localized
edit only moves boundaries inside its own neighborhood and every other chunk
keeps its key (content-defined dedup, the XetHub/FastCDC idea). A fixed-grid
mode (``mode="fixed"``) exists as a deterministic fallback and as the shape
the RSS-budget CI smoke uses.

Two properties matter for the layers above:

* **Element alignment.** Every cut is snapped down to a multiple of the
  dtype itemsize, so each chunk decodes as a whole number of elements and
  per-chunk delta quantization (``store/delta.py``) never straddles a cut.
* **Segment confinement.** ``cut_points`` accepts hard segment boundaries
  (from ``dist/sharding.py`` shard splits); chunks never cross a segment,
  so each host of a sharded consumer can pull exactly its shard's chunks.

The pure-python byte loop of classic FastCDC is far too slow for GB-scale
tensors, so the rolling hash is vectorized: with window W=8 the Gear hash of
position ``i`` is ``G0[b[i]] ^ G1[b[i-1]] ^ ... ^ G7[b[i-7]]`` — eight
shifted table lookups XOR'd as numpy u64 arrays, processed in bounded
sub-blocks so the temporaries never exceed a few MB.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common.bf16 import np_dtype

# Chunking defaults. Threshold chosen so ordinary layer tensors (a few MB)
# keep the PR-4 whole-tensor fold path; only genuinely large params pay the
# per-chunk manifest overhead.
DEFAULT_CHUNK_THRESHOLD = 8 * 2 ** 20    # params >= this are chunked
DEFAULT_MIN_CHUNK = 256 * 2 ** 10
DEFAULT_AVG_CHUNK = 1 * 2 ** 20          # must be a power of two (hash mask)
DEFAULT_MAX_CHUNK = 4 * 2 ** 20
DEFAULT_WINDOW_BYTES = 64 * 2 ** 20      # commit/checkout in-flight budget

WINDOW = 8                               # rolling-hash window, bytes
_SCAN_BLOCK = 4 * 2 ** 20                # sub-block for vectorized hashing

# 8 independent 256-entry u64 tables from a fixed-seed PRNG: boundary
# positions are a pure function of content, stable across processes/versions.
_GEAR = np.random.default_rng(0x4D476974).integers(
    0, 2 ** 64, size=(WINDOW, 256), dtype=np.uint64)


def _window_hash(block: np.ndarray) -> np.ndarray:
    """Gear window hash for each position i >= WINDOW-1 of a u8 block."""
    n = block.size
    h = _GEAR[0][block[WINDOW - 1:]]
    for j in range(1, WINDOW):
        h ^= _GEAR[j][block[WINDOW - 1 - j:n - j]]
    return h


def _candidates(data: memoryview, mask: int) -> np.ndarray:
    """Positions p where the windowed hash over bytes [p-7, p] hits the mask.

    A cut at p means "chunk ends after byte p" (exclusive offset p+1).
    Processes the buffer in sub-blocks with a WINDOW-1 byte overlap so the
    u64 temporaries stay bounded regardless of input size.
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    n = buf.size
    if n < WINDOW:
        return np.empty(0, dtype=np.int64)
    out: List[np.ndarray] = []
    mask64 = np.uint64(mask)
    start = 0
    while start < n - WINDOW + 1:
        stop = min(n, start + _SCAN_BLOCK)
        block = buf[start:stop]
        if block.size < WINDOW:
            break
        hits = np.flatnonzero((_window_hash(block) & mask64) == 0)
        if hits.size:
            out.append(hits.astype(np.int64) + start + WINDOW - 1)
        start = stop - (WINDOW - 1)
    if not out:
        return np.empty(0, dtype=np.int64)
    return np.concatenate(out)


def _next_cut(data, min_size: int, max_size: int, itemsize: int,
              mask: int) -> int:
    """Length of the next chunk given a ``max_size``-byte lookahead window.

    FastCDC-style greedy selection: the first boundary candidate whose
    snapped offset lands in [min_size, max_size], else a forced cut at
    max_size. Offsets snap down to itemsize multiples so chunks hold whole
    elements.
    """
    def snap(off: int) -> int:
        return (off // itemsize) * itemsize

    for c in _candidates(memoryview(data), mask):
        cut = snap(int(c) + 1)
        if cut < min_size:
            continue
        if cut > max_size:
            break
        return cut
    return max(itemsize, snap(max_size))


def cut_points(read: Callable[[int, int], bytes], length: int, itemsize: int,
               *, min_size: int = DEFAULT_MIN_CHUNK,
               avg_size: int = DEFAULT_AVG_CHUNK,
               max_size: int = DEFAULT_MAX_CHUNK,
               mode: str = "cdc",
               segments: Optional[Sequence[int]] = None) -> List[int]:
    """Exclusive chunk-end offsets for a byte stream of ``length`` bytes.

    ``read(offset, size)`` supplies bytes on demand — the stream is scanned
    in bounded windows, never held whole. ``segments`` lists hard interior
    boundaries (ascending, itemsize-aligned); they are always cut points and
    chunking restarts at each, so no chunk crosses a shard boundary.
    Returns offsets ending with ``length``.
    """
    if itemsize <= 0:
        itemsize = 1
    min_size = max(itemsize, (min_size // itemsize) * itemsize or itemsize)
    max_size = max(min_size + itemsize, (max_size // itemsize) * itemsize)
    mask = max(1, int(avg_size)) - 1  # power-of-two avg → uniform hit rate

    bounds = [0]
    if segments:
        bounds.extend(int(s) for s in segments if 0 < int(s) < length)
    bounds.append(length)
    bounds = sorted(set(bounds))

    cuts: List[int] = []
    for seg_start, seg_end in zip(bounds[:-1], bounds[1:]):
        seg_len = seg_end - seg_start
        pos = 0
        # One lookahead window of at most max_size bytes per cut decision:
        # boundary selection never needs to see past pos+max_size, so the
        # stream is scanned in bounded pieces regardless of tensor size.
        while seg_len - pos > max_size:
            if mode == "fixed":
                # deterministic grid at the configured average size; the
                # tail chunk absorbs the remainder (up to max_size)
                cut = max(min_size, (avg_size // itemsize) * itemsize)
            else:
                data = read(seg_start + pos, max_size)
                cut = _next_cut(data, min_size, max_size, itemsize, mask)
            if seg_len - (pos + cut) < itemsize:
                break
            pos += cut
            cuts.append(seg_start + pos)
        cuts.append(seg_end)
    if not cuts or cuts[-1] != length:
        cuts.append(length)
    return sorted(set(c for c in cuts if 0 < c <= length))


def spans_of(cuts: Sequence[int]) -> List[Tuple[int, int]]:
    """(offset, length) pairs from exclusive cut offsets."""
    out = []
    prev = 0
    for c in cuts:
        out.append((prev, c - prev))
        prev = c
    return out


# ---------------------------------------------------------------------------
# Chunk sources: anything exposing shape/dtype plus random-access raw bytes.
# The commit engine never materializes more than its window of these.


class ArraySource:
    """Chunk-source view over an in-memory ndarray."""

    def __init__(self, arr: np.ndarray) -> None:
        self._arr = np.ascontiguousarray(arr)
        self._mv = memoryview(self._arr).cast("B")
        self.shape = tuple(int(d) for d in self._arr.shape)
        self.dtype = np.dtype(self._arr.dtype)
        self.nbytes = int(self._arr.nbytes)

    def read(self, offset: int, size: int) -> memoryview:
        return self._mv[offset:offset + size]


class FileSource:
    """Chunk source backed by raw little-endian bytes in a file (pread-based,
    no mmap — keeps page-cache pressure out of the process RSS budget)."""

    def __init__(self, path: str, shape: Sequence[int], dtype,
                 offset: int = 0) -> None:
        self.path = str(path)
        self.shape = tuple(int(d) for d in shape)
        self.dtype = np_dtype(dtype)
        self.nbytes = int(np.prod(self.shape, dtype=np.int64)
                          * self.dtype.itemsize) if self.shape else \
            self.dtype.itemsize
        self._base = int(offset)
        self._fd = os.open(self.path, os.O_RDONLY)

    def read(self, offset: int, size: int) -> bytes:
        parts = []
        pos = self._base + offset
        remaining = size
        while remaining > 0:
            b = os.pread(self._fd, remaining, pos)
            if not b:
                raise IOError(f"short read from {self.path} at {pos}")
            parts.append(b)
            pos += len(b)
            remaining -= len(b)
        return b"".join(parts) if len(parts) != 1 else parts[0]

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass


class FnSource:
    """Procedural chunk source: ``fn(offset, size) -> bytes``. Lets the CI
    smoke commit a ~1 GB-logical tensor that never exists in memory."""

    def __init__(self, fn: Callable[[int, int], bytes],
                 shape: Sequence[int], dtype) -> None:
        self._fn = fn
        self.shape = tuple(int(d) for d in shape)
        self.dtype = np_dtype(dtype)
        self.nbytes = int(np.prod(self.shape, dtype=np.int64)
                          * self.dtype.itemsize) if self.shape else \
            self.dtype.itemsize

    def read(self, offset: int, size: int) -> bytes:
        return self._fn(offset, size)


def as_source(value):
    """Normalize a param value into a chunk source, or None if it already
    is one (has shape/dtype/read)."""
    if hasattr(value, "read") and hasattr(value, "shape") \
            and hasattr(value, "dtype"):
        return value
    return ArraySource(np.asarray(value))


def is_chunk_source(value) -> bool:
    return hasattr(value, "read") and hasattr(value, "shape") \
        and hasattr(value, "dtype") and not isinstance(value, np.ndarray)
