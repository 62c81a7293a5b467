"""Plain PyTorch versions of the storage-path kernels.

They define what the CUDA kernels in this package compute, and they are
what a kernel wrapper runs when it is handed CPU tensors. Every function
here equals the reference package's ``backend="ref"`` oracle bit for bit:

* quantize divides by the f32 scale (a true division, as the CPU oracle
  and the numpy twins do), then adds 0.5 and floors;
* dequantize multiplies and subtracts as two separately rounded f32
  operations, never one fused multiply-add;
* a bf16 result is rounded from f32 by :func:`to_bfloat16` (nearest, ties
  to even, a NaN to the quiet NaN of its sign), bit for bit with
  ``jnp.astype(bfloat16)``; torch's own ``.to(torch.bfloat16)`` rounds
  numbers the same way but gives every NaN the bits ``0xFFFF`` on the CPU.

The scale is a 0-dim f32 tensor on the operand's device, not a Python
float: PyTorch's CUDA division by a host scalar multiplies by its
reciprocal instead, which differs from the oracle on large deltas.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import bf16

_TORCH_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8,
}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name (the
    host's bf16 carrier, ``common/bf16.py``, is ``torch.bfloat16``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = bf16.dtype_name(dtype)
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"no torch dtype for {dtype!r}") from None


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``float32``, never ``torch.float32``)."""
    return str(dtype).removeprefix("torch.")


# Quantization scale for error bound eps (paper §4): Δq = floor(Δp / (2·log1p(eps)) + 0.5)
def quant_scale(eps: float) -> float:
    return 2.0 * float(np.log1p(eps))


def scale_tensor(eps: float, device) -> torch.Tensor:
    """``quant_scale(eps)`` rounded once to f32, as a 0-dim tensor on ``device``."""
    return torch.tensor(np.float32(quant_scale(eps)), dtype=torch.float32,
                        device=device)


def delta_quantize_ref(p1: torch.Tensor, p2: torch.Tensor, eps: float = 1e-4):
    """Quantized delta between parent p1 and child p2 (paper Algorithm 1).

    Returns (q int32 tensor, zero count as a 0-dim int64 tensor: a tensor
    may hold more than 2^31 elements).
    Computation is in float32 regardless of input dtype so bf16 checkpoints
    quantize identically to f32 ones.
    """
    d = p1.to(torch.float32) - p2.to(torch.float32)
    q = torch.floor(d / scale_tensor(eps, d.device) + 0.5).to(torch.int32)
    return q, torch.sum(q == 0, dtype=torch.int64)


def tile_zero_counts(q: torch.Tensor, tile: int) -> torch.Tensor:
    """Zeros of flat ``q`` in each run of ``tile`` elements, as a
    (⌈n / tile⌉,) int32 tensor; the last run may be short."""
    flat = (q.reshape(-1) == 0).to(torch.int32)
    n = flat.shape[0]
    padded = torch.zeros(-(-n // tile) * tile, dtype=torch.int32,
                         device=q.device)
    padded[:n] = flat
    return padded.reshape(-1, tile).sum(dim=1, dtype=torch.int32)


def to_bfloat16(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to bfloat16 as ``jnp.astype`` and the CUDA kernels
    round it: to nearest, ties to even; a NaN to ``0x7FC0`` or ``0xFFC0``."""
    u = x.to(torch.float32).contiguous().view(torch.int32)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    num = torch.where(nan, torch.zeros_like(u), u)
    r = ((num + (0x7FFF + ((num >> 16) & 1))) >> 16) & 0xFFFF
    r = torch.where(nan, ((u >> 16) & 0x8000) | 0x7FC0, r)
    return (r - ((r & 0x8000) << 1)).to(torch.int16).view(torch.bfloat16)


def narrow(x: torch.Tensor, dtype) -> torch.Tensor:
    """f32 ``x`` rounded once to ``dtype`` (bfloat16 by :func:`to_bfloat16`)."""
    dtype = torch_dtype(dtype)
    if dtype == torch.bfloat16:
        return to_bfloat16(x)
    return x.to(dtype)


def dequant_apply_ref(p1: torch.Tensor, q: torch.Tensor, eps: float = 1e-4,
                      out_dtype=None) -> torch.Tensor:
    """Reconstruct the child: p2' = p1 - dequantize(q)."""
    step = q.to(torch.float32) * scale_tensor(eps, p1.device)
    out = p1.to(torch.float32) - step
    return narrow(out, out_dtype if out_dtype is not None else p1.dtype)


def snapshot_fused_ref(p1: torch.Tensor, p2: torch.Tensor, eps: float = 1e-4):
    """Quantize, narrow to int8, and count zeros and overflows in one call.

    Returns (q8 int8, zero count, overflow count); the counts are 0-dim
    int64 tensors. An overflow count above 0 means some q did not fit int8
    and the caller must fall back to the int32 ``delta_quantize_ref``.
    """
    q32, zeros = delta_quantize_ref(p1, p2, eps)
    q8 = torch.clamp(q32, -127, 127).to(torch.int8)
    overflow = torch.sum(q32 != q8.to(torch.int32), dtype=torch.int64)
    return q8, zeros, overflow


def chain_apply_ref(base: torch.Tensor, qs: torch.Tensor,
                    eps: float = 1e-4) -> torch.Tensor:
    """``base - sum_k(qs) * scale`` in f32; ``qs`` is a (k, *base.shape) stack."""
    total = torch.sum(qs.to(torch.int32), dim=0, dtype=torch.int32)
    step = total.to(torch.float32) * scale_tensor(eps, base.device)
    return base.to(torch.float32) - step


# -- fingerprint -------------------------------------------------------------
# Order-sensitive 2x32-bit mixing hash: each element is mixed with its global
# position, partial sums wrap mod 2^32. torch has no full uint32 arithmetic,
# so the u32 values live in int64 tensors, masked to 32 bits after every
# step; shifts of non-negative int64 values are logical shifts.
FP_C1 = 0x9E3779B1  # golden-ratio constant
FP_C2 = 0x85EBCA77
FP_C3 = 0xC2B2AE3D
_M32 = 0xFFFFFFFF


def _mulmod32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for 0 <= a, c < 2^32 without int64 overflow."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix(bits: torch.Tensor, idx: torch.Tensor):
    x = _mulmod32(bits, FP_C1) ^ _mulmod32(idx, FP_C2)
    x = _mulmod32(x, FP_C3)
    h1 = x ^ (x >> 15)
    y = _mulmod32((bits + idx) & _M32, FP_C2)
    h2 = y ^ (y >> 13)
    return h1, h2


def bits_u32(x: torch.Tensor) -> torch.Tensor:
    """The flat canonical u32 bit pattern of ``x``, held in an int64 tensor."""
    flat = x.reshape(-1)
    if flat.dtype == torch.float32 or flat.dtype == torch.int32:
        return flat.view(torch.int32).to(torch.int64) & _M32
    if flat.dtype in (torch.bfloat16, torch.float16):
        return flat.view(torch.int16).to(torch.int64) & 0xFFFF
    return flat.to(torch.float32).view(torch.int32).to(torch.int64) & _M32


def fingerprint_ref(x: torch.Tensor) -> torch.Tensor:
    """64-bit content fingerprint as a (2,) int64 tensor [h1, h2], each < 2^32."""
    return fingerprint_bits(bits_u32(x))


def fingerprint_bits(bits: torch.Tensor) -> torch.Tensor:
    """:func:`fingerprint_ref` of a flat u32 bit pattern held in int64."""
    idx = torch.arange(bits.shape[0], dtype=torch.int64, device=bits.device)
    h1, h2 = _mix(bits, idx)
    return torch.stack([h1.sum() & _M32, h2.sum() & _M32])


LANE_COLS = 1024


def padded_length(n: int) -> int:
    """The element count the reference hashes for an ``n``-element tensor:
    its bits zero-padded to (rows, 1024) with rows a multiple of 8."""
    rows = -(-n // LANE_COLS)
    return -(-rows // 8) * 8 * LANE_COLS


def fingerprint_padded(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``ops.fingerprint`` pair, unsalted: ``fingerprint_ref``
    of ``x``'s bits zero-padded to :func:`padded_length`. Padding elements
    have bits 0 but a non-zero index, so they still add to the hash."""
    bits = bits_u32(x)
    padded = torch.zeros(padded_length(bits.shape[0]), dtype=torch.int64,
                         device=bits.device)
    padded[:bits.shape[0]] = bits
    return fingerprint_bits(padded)
