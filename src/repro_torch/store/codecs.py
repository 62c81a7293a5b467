"""Lossless codecs for quantized deltas (paper §4: RLE, LZMA, ...).

All codecs share one interface: ``encode(int32 ndarray) -> bytes`` and
``decode(bytes, n) -> int32 ndarray``. Quantized deltas of similar models are
dominated by zero runs, so RLE is fast/mediocre and LZMA is slow/strong —
exactly the paper's tradeoff (Table 4). ``sparse`` is a beyond-paper codec
(index+value pairs + zlib) that wins when density drops below ~5%.
"""

from __future__ import annotations

import lzma
import struct
import zlib
from typing import Dict

import numpy as np

from repro_torch.common.bf16 import np_dtype


class Codec:
    """Codecs are dtype-aware: the quantized delta may arrive as int8 (the
    fused snapshot kernel narrows when every value fits; §Perf-C) or int32."""

    name = "none"

    def encode(self, arr: np.ndarray) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes, n: int, dtype: str = "int32") -> np.ndarray:
        raise NotImplementedError


class RawCodec(Codec):
    name = "raw"

    def encode(self, arr: np.ndarray) -> bytes:
        return np.ascontiguousarray(arr).tobytes()

    def decode(self, data: bytes, n: int, dtype: str = "int32") -> np.ndarray:
        return np.frombuffer(data, dtype=np.dtype(dtype), count=n).copy()


class RLECodec(Codec):
    """Vectorized run-length encoding: header n_runs + values + runs(uint32)."""

    name = "rle"

    def encode(self, arr: np.ndarray) -> bytes:
        flat = np.ascontiguousarray(arr).ravel()
        if flat.size == 0:
            return struct.pack("<I", 0)
        boundaries = np.flatnonzero(np.diff(flat)) + 1
        starts = np.concatenate(([0], boundaries))
        ends = np.concatenate((boundaries, [flat.size]))
        values = flat[starts]
        runs = (ends - starts).astype(np.uint32)
        return struct.pack("<I", values.size) + values.tobytes() + runs.tobytes()

    def decode(self, data: bytes, n: int, dtype: str = "int32") -> np.ndarray:
        (k,) = struct.unpack("<I", data[:4])
        if n == 0 or k == 0:
            return np.zeros(n, dtype=np.dtype(dtype))
        item = np.dtype(dtype).itemsize
        values = np.frombuffer(data[4:4 + k * item], dtype=np.dtype(dtype))
        runs = np.frombuffer(data[4 + k * item:4 + k * item + 4 * k],
                             dtype=np.uint32)
        return np.repeat(values, runs.astype(np.int64))


class LZMACodec(Codec):
    """LZMA over raw bytes. preset=1 keeps runtime sane on large models
    with only a small ratio loss vs the default preset (see bench_compression)."""

    name = "lzma"

    def __init__(self, preset: int = 1) -> None:
        self.preset = preset

    def encode(self, arr: np.ndarray) -> bytes:
        return lzma.compress(np.ascontiguousarray(arr).tobytes(),
                             preset=self.preset)

    def decode(self, data: bytes, n: int, dtype: str = "int32") -> np.ndarray:
        return np.frombuffer(lzma.decompress(data), dtype=np.dtype(dtype),
                             count=n).copy()


class ZlibCodec(Codec):
    name = "zlib"

    def __init__(self, level: int = 6) -> None:
        self.level = level

    def encode(self, arr: np.ndarray) -> bytes:
        return zlib.compress(np.ascontiguousarray(arr).tobytes(), self.level)

    def decode(self, data: bytes, n: int, dtype: str = "int32") -> np.ndarray:
        return np.frombuffer(zlib.decompress(data), dtype=np.dtype(dtype),
                             count=n).copy()


class SparseCodec(Codec):
    """Beyond-paper: store (index-delta varint-ish uint32, value int32) of
    nonzeros, then zlib. Wins over RLE/LZMA below ~5% density."""

    name = "sparse"

    def encode(self, arr: np.ndarray) -> bytes:
        flat = np.ascontiguousarray(arr).ravel()
        idx = np.flatnonzero(flat).astype(np.uint32)
        vals = flat[idx]
        idx_delta = np.diff(idx, prepend=np.uint32(0)).astype(np.uint32)
        payload = struct.pack("<I", idx.size) + idx_delta.tobytes() + vals.tobytes()
        return zlib.compress(payload, 6)

    def decode(self, data: bytes, n: int, dtype: str = "int32") -> np.ndarray:
        dt = np.dtype(dtype)
        payload = zlib.decompress(data)
        (k,) = struct.unpack("<I", payload[:4])
        idx_delta = np.frombuffer(payload[4:4 + 4 * k], dtype=np.uint32)
        vals = np.frombuffer(payload[4 + 4 * k:4 + 4 * k + dt.itemsize * k],
                             dtype=dt)
        out = np.zeros(n, dtype=dt)
        out[np.cumsum(idx_delta.astype(np.int64))] = vals
        return out


class BytePlaneCodec(Codec):
    """Byte-plane shuffle + zlib for *lossless* bitpattern deltas (§15).

    The step-delta engine stores exact-tier hops as the elementwise
    difference of the raw bit patterns (mod 2^width, see
    :func:`bitpattern_delta`). Between consecutive optimizer steps most
    elements change only in their low-order mantissa bytes, so grouping
    byte position k of every element into one contiguous plane puts the
    all-zero sign/exponent planes next to each other and lets a cheap
    zlib level-1 pass erase them. Level 1 keeps the encode on the training
    hot path (~step time budget); the container is self-describing so
    readers don't care."""

    name = "xd"

    def __init__(self, level: int = 1) -> None:
        self.level = level

    def encode(self, arr: np.ndarray) -> bytes:
        a = np.ascontiguousarray(arr)
        item = a.dtype.itemsize
        planes = a.view(np.uint8).reshape(-1, item).T
        return zlib.compress(np.ascontiguousarray(planes).tobytes(), self.level)

    def decode(self, data: bytes, n: int, dtype: str = "uint32") -> np.ndarray:
        dt = np.dtype(dtype)
        planes = np.frombuffer(zlib.decompress(data), dtype=np.uint8)
        planes = planes.reshape(dt.itemsize, n)
        return np.ascontiguousarray(planes.T).reshape(-1).view(dt)


def _bitwidth_dtype(itemsize: int) -> np.dtype:
    return {8: np.dtype(np.uint64), 4: np.dtype(np.uint32),
            2: np.dtype(np.uint16)}.get(itemsize, np.dtype(np.uint8))


def bitpattern_delta(child: np.ndarray, parent: np.ndarray) -> np.ndarray:
    """Lossless delta: raw-bits subtraction mod 2^width, elementwise.

    Works for any dtype (floats are viewed as unsigned ints of the same
    width; odd itemsizes fall back to a byte-wise view). The inverse is
    :func:`bitpattern_apply`; ``child == apply(parent, delta)`` holds
    bit-for-bit, which is what makes the exact checkpoint tier resumable
    with no drift."""
    c = np.ascontiguousarray(child)
    p = np.ascontiguousarray(parent)
    ud = _bitwidth_dtype(c.dtype.itemsize)
    cv = c.view(ud).ravel() if ud.itemsize == c.dtype.itemsize else c.view(np.uint8).ravel()
    pv = p.view(ud).ravel() if ud.itemsize == p.dtype.itemsize else p.view(np.uint8).ravel()
    return cv - pv  # unsigned wraparound is the point


def bitpattern_apply(parent: np.ndarray, delta: np.ndarray,
                     dtype: str, shape) -> np.ndarray:
    """Inverse of :func:`bitpattern_delta`: reconstruct the child exactly
    (``bfloat16`` as the host's bf16 carrier)."""
    dt = np_dtype(dtype)
    p = np.ascontiguousarray(parent)
    ud = delta.dtype
    pv = p.view(ud).ravel() if ud.itemsize == dt.itemsize else p.view(np.uint8).ravel()
    child = (pv + delta).view(np.uint8).reshape(-1)
    return child.view(dt).reshape(shape)


CODECS: Dict[str, Codec] = {
    "raw": RawCodec(),
    "rle": RLECodec(),
    "lzma": LZMACodec(),
    "lzma6": LZMACodec(preset=6),
    "zlib": ZlibCodec(),
    "sparse": SparseCodec(),
    "xd": BytePlaneCodec(),
}

#: nonzero density below which ``sparse`` reliably beats the run-based
#: codecs on quantized deltas (bench_compression's crossover, with margin)
SPARSE_DENSITY = 0.05


def pick_codec(nonzeros: int, n: int, default: Codec) -> Codec:
    """Density-adaptive codec choice for one quantized delta.

    Chunk-level delta encoding (DESIGN.md §12) makes density wildly
    non-uniform *within* one tensor: chunks near a localized edit are dense
    while the rest of the touched chunks carry a handful of stragglers. The
    nonzero count comes out of the snapshot kernel for free, so each blob
    can pick ``sparse`` below the crossover instead of paying the whole-
    tensor compromise codec. Whole-tensor delta blobs keep ``default``
    unconditionally — their density already informed the store-level codec
    configuration."""
    if n > 0 and nonzeros / n < SPARSE_DENSITY:
        return CODECS["sparse"]
    return default

_TUNED: Dict[tuple, Codec] = {}


def get_codec(name: str, preset: int = None) -> Codec:
    """Codec by name, optionally tuned.

    ``preset`` selects the LZMA preset (0 fastest … 9 strongest) or the
    zlib level. Decoding is container-self-describing for both, so the
    manifest only records the codec *name* — readers never need to know the
    preset the writer used. Tuned instances are cached (codec objects are
    stateless)."""
    if preset is None:
        return CODECS[name]
    key = (name, preset)
    if key not in _TUNED:
        if name == "lzma":
            _TUNED[key] = LZMACodec(preset=preset)
        elif name == "zlib":
            _TUNED[key] = ZlibCodec(level=preset)
        else:
            _TUNED[key] = CODECS[name]  # preset is a no-op for this codec
    return _TUNED[key]
