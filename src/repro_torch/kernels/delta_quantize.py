"""Wrappers of the CUDA kernels for Algorithm 1's lossy step.

``delta_quantize_flat`` replaces the TPU kernel
``repro/kernels/delta_quantize.py::delta_quantize_2d`` and
``dequant_apply_flat`` replaces ``dequant_apply_2d`` of the same file;
the kernels are in ``csrc/delta_quantize.cu``. Both are elementwise and
bound by device-memory bandwidth (12 bytes per element each in f32, 8 in
f16 or bf16). They take float32, float16 or bfloat16 operands and widen
them to f32 in the kernel, as the TPU kernels do; dequant rounds its f32
result once to the output type (bf16 as ``ref.to_bfloat16`` rounds it).

Each wrapper takes tensors of any shape, treats them as flat, and returns
results of the input's shape. On CPU tensors it runs the plain version
from ``ref.py``; on CUDA tensors it launches its kernel or raises. Its
``launches`` attribute counts kernel launches, and ``launches_by_dtype``
counts them by operand types (``"bfloat16"``, ``"float32+bfloat16"``;
for dequant ``"bfloat16->bfloat16"``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (delta_quantize_ref, dequant_apply_ref,
                                     quant_scale, tile_zero_counts,
                                     torch_dtype)

# the kernels' operand type codes (csrc/delta_quantize.cu)
_TYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_FLOATS = tuple(_TYPE_CODES)


def _operands(*dtypes: torch.dtype) -> str:
    """The key of a launch in ``launches_by_dtype``: the operand dtype's
    name, or the names joined by "+" when they differ."""
    names = [str(d).removeprefix("torch.") for d in dtypes]
    return names[0] if len(set(names)) == 1 else "+".join(names)


def delta_quantize_flat(p1: torch.Tensor, p2: torch.Tensor, eps: float = 1e-4,
                        tile: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q = floor((f32 p1 - f32 p2) / scale + 0.5) as int32, and its zero
    count: a 0-dim int64 tensor, or with ``tile`` the (⌈n / tile⌉,) int32
    counts of each run of ``tile`` flat elements (a multiple of 256). The
    kernel counts in 64 bits, so ``p1`` may hold more than 2^31 elements; a
    tile's count fits 32 bits whenever ``tile`` does."""
    if p1.shape != p2.shape:
        raise ValueError(f"shapes differ: {tuple(p1.shape)} vs {tuple(p2.shape)}")
    if tile is not None and (tile <= 0 or tile % 256):
        raise ValueError(f"tile {tile} is not a positive multiple of 256")
    if not build.on_card(p1, p2):
        q, zeros = delta_quantize_ref(p1, p2, eps)
        return q, zeros if tile is None else tile_zero_counts(q, tile)
    build.require_dtype(p1.dtype, _FLOATS, "p1")
    build.require_dtype(p2.dtype, _FLOATS, "p2")
    n = p1.numel()
    q = torch.empty(p1.shape, dtype=torch.int32, device=p1.device)
    counters = 1 if tile is None else -(-n // tile)
    zeros = torch.zeros(counters, dtype=torch.int64, device=p1.device)
    if n:
        build.launch("delta_quantize", "mgit_delta_quantize", p1.device,
                     p1.data_ptr(), _TYPE_CODES[p1.dtype], p2.data_ptr(),
                     _TYPE_CODES[p2.dtype], q.data_ptr(), zeros.data_ptr(), n,
                     n if tile is None else tile,
                     float(np.float32(quant_scale(eps))))
        build.count_launch(delta_quantize_flat,
                           _operands(p1.dtype, p2.dtype))
    return q, zeros[0] if tile is None else zeros.to(torch.int32)


delta_quantize_flat.launches = 0
delta_quantize_flat.launches_by_dtype = {}


def dequant_apply_flat(p1: torch.Tensor, q: torch.Tensor, eps: float = 1e-4,
                       out_dtype=None) -> torch.Tensor:
    """f32 p1 - f32(q) * scale, with q int32, rounded once to ``out_dtype``
    (float32, float16 or bfloat16; default p1's dtype)."""
    if p1.shape != q.shape:
        raise ValueError(f"shapes differ: {tuple(p1.shape)} vs {tuple(q.shape)}")
    dtype = p1.dtype if out_dtype is None else torch_dtype(out_dtype)
    if not build.on_card(p1, q):
        return dequant_apply_ref(p1, q, eps, out_dtype=dtype)
    build.require_dtype(p1.dtype, _FLOATS, "p1")
    build.require_dtype(q.dtype, (torch.int32,), "q")
    build.require_dtype(dtype, _FLOATS, "out_dtype")
    out = torch.empty(p1.shape, dtype=dtype, device=p1.device)
    if out.numel():
        build.launch("delta_quantize", "mgit_dequant_apply", p1.device,
                     p1.data_ptr(), _TYPE_CODES[p1.dtype], q.data_ptr(),
                     out.data_ptr(), _TYPE_CODES[dtype], out.numel(),
                     float(np.float32(quant_scale(eps))))
        build.count_launch(dequant_apply_flat,
                           f"{_operands(p1.dtype)}->{_operands(dtype)}")
    return out


dequant_apply_flat.launches = 0
dequant_apply_flat.launches_by_dtype = {}

__all__ = ["delta_quantize_flat", "dequant_apply_flat"]
