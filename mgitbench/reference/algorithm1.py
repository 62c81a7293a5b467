"""MGit's Algorithm 1 with the store's fold semantics, in plain NumPy.

The store (DESIGN.md §10.2) keeps a derivative's leaf as a quantized delta
against its parent's stored value:

    scale = f32(2 * log1p(eps))
    q     = floor(f32(f32(parent - child) / scale) + 0.5)      (int32)

and defines the stored value ("truth") of a float32 leaf by folding the
deltas of a chain that starts at a full tensor:

    truth = f32(base - f32(f32(q_1 + ... + q_k) * scale))

each operation rounded once in f32. A bfloat16 leaf opens no fold: each hop
widens the parent's stored bf16 value to f32, subtracts f32(q) * scale and
rounds to bf16 (nearest, ties to even). A leaf is kept as a delta when its
delta saves bytes, which every leaf of a finetune-like derivative does, and
a chain is at most ``max_chain_depth`` deep. A leaf is kept as its delta
when the delta saves bytes: when the LZMA stream (preset 0, the store's
default) of its quantized delta, int8 when every value fits and int32
otherwise, is shorter than the leaf's own bytes; else the leaf is kept
whole and its stored value is the derivative's own. The reference encodes
the deltas of leaves under ``SMALL_LEAF_BYTES`` to decide; a larger leaf of
a finetune-like derivative always saves, and is taken as a delta.

bfloat16 values travel as their bits in uint16 arrays.
"""

from __future__ import annotations

import lzma
import math
from typing import Dict, Optional

import numpy as np

EPS = 1e-4              # the store's documented default
MAX_CHAIN_DEPTH = 8
LZMA_PRESET = 0
SMALL_LEAF_BYTES = 1 << 16


def quant_scale(eps: float = EPS) -> np.float32:
    return np.float32(2.0 * math.log1p(eps))


def widen_bf16(bits: np.ndarray) -> np.ndarray:
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def narrow_bf16(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bits, nearest with ties to even; NaN stays NaN."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    rounded = ((u.astype(np.uint64) + 0x7FFF + ((u >> 16) & 1)) >> 16
               ).astype(np.uint16)
    quiet = (((u >> 16) & 0x8000) | 0x7FC0).astype(np.uint16)
    return np.where(nan, quiet, rounded)


def quantize(parent: np.ndarray, child: np.ndarray, scale: np.float32
             ) -> np.ndarray:
    d = np.subtract(parent, child, dtype=np.float32)
    return np.floor(d / scale + np.float32(0.5)).astype(np.int32)


def saves(q: np.ndarray, leaf_bytes: int) -> bool:
    """Whether the store keeps a leaf of ``leaf_bytes`` as this delta."""
    if leaf_bytes >= SMALL_LEAF_BYTES:
        return True
    q8 = np.clip(q, -127, 127)
    stream = q8.astype(np.int8) if np.array_equal(q8, q) else q
    blob = lzma.compress(stream.tobytes(), preset=LZMA_PRESET)
    return len(blob) < leaf_bytes


def dequant(value: np.ndarray, q: np.ndarray, scale: np.float32
            ) -> np.ndarray:
    return np.subtract(value, q.astype(np.float32) * scale, dtype=np.float32)


class Leaf:
    """One leaf's stored value, and its open fold (f32) if any."""

    __slots__ = ("value", "seg_base", "qsum")

    def __init__(self, value, seg_base=None, qsum=None):
        self.value, self.seg_base, self.qsum = value, seg_base, qsum


class Lineage:
    """Stored values of every committed version, worked out from the
    versions' own weights (float32 arrays, or bf16 bits as uint16)."""

    def __init__(self, eps: float = EPS, precision: Optional[str] = None):
        """``precision`` computes the stored values one step lower than
        the store does ("bfloat16" rounds each f32 result to bf16,
        "float8_e4m3" each bf16 result to fp8 e4m3): the control, which
        the comparison has to reject."""
        self.scale = quant_scale(eps)
        self.precision = precision
        self.versions: Dict[str, Dict[str, Leaf]] = {}
        self.depth: Dict[str, int] = {}

    def _lower(self, x: np.ndarray) -> np.ndarray:
        if self.precision == "bfloat16":
            return widen_bf16(narrow_bf16(x))
        if self.precision == "float8_e4m3":
            return fp8_e4m3(x)
        return x

    def commit_base(self, name: str, weights: Dict[str, np.ndarray]) -> None:
        self.versions[name] = {k: Leaf(np.array(v)) for k, v in
                               weights.items()}
        self.depth[name] = 0

    def commit(self, name: str, parent: str,
               weights: Dict[str, np.ndarray]) -> None:
        depth = self.depth[parent] + 1
        if depth > MAX_CHAIN_DEPTH:
            raise ValueError("a chain past max_chain_depth is stored whole; "
                             "the traffic keeps chains shorter")
        out = {}
        for key, child in weights.items():
            p = self.versions[parent][key]
            if child.dtype == np.uint16:          # bfloat16: hop by hop
                pv = widen_bf16(p.value)
                q = quantize(pv, widen_bf16(child), self.scale)
                if not saves(q, child.nbytes):
                    out[key] = Leaf(np.array(child))
                    continue
                v = self._lower(dequant(pv, q, self.scale))
                out[key] = Leaf(narrow_bf16(v))
                continue
            q = quantize(p.value, child, self.scale)
            if not saves(q, child.nbytes):
                out[key] = Leaf(np.array(child))
                continue
            if p.seg_base is not None:           # extend the open fold
                base = p.seg_base
                qsum = np.add(p.qsum, q, dtype=np.int32)
            else:
                base, qsum = p.value, q
            out[key] = Leaf(self._lower(dequant(base, qsum, self.scale)),
                            base, qsum)
        self.versions[name] = out
        self.depth[name] = depth

    def stored(self, name: str, key: str) -> np.ndarray:
        return self.versions[name][key].value


def fp8_e4m3(x: np.ndarray) -> np.ndarray:
    """float32 rounded to float8 e4m3 (3 mantissa bits, nearest even),
    saturating at 448, as float32."""
    x = np.asarray(x, np.float32)
    m, e = np.frexp(x)                        # x = m * 2**e, 0.5 <= |m| < 1
    e = np.maximum(e, -5)                     # subnormals below 2**-6
    step = np.ldexp(np.float32(1.0), e - 4)   # 3 mantissa bits
    r = np.round(x / step) * step
    return np.clip(r, -448.0, 448.0).astype(np.float32)


def mismatches(got: np.ndarray, want: np.ndarray) -> int:
    """Elements whose bits differ (NaNs compare by bits too); a wrong
    shape counts every element."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype.itemsize != want.dtype.itemsize:
        return int(max(got.size, want.size))
    view = {2: np.uint16, 4: np.uint32}[want.dtype.itemsize]
    return int(np.count_nonzero(got.view(view) != want.view(view)))
