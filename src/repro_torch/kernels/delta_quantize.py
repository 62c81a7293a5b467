"""Wrappers of the CUDA kernels for Algorithm 1's lossy step.

``delta_quantize_flat`` replaces the TPU kernel
``repro/kernels/delta_quantize.py::delta_quantize_2d`` and
``dequant_apply_flat`` replaces ``dequant_apply_2d`` of the same file;
the kernels are in ``csrc/delta_quantize.cu``. Both are elementwise and
bound by device-memory bandwidth (12 bytes per element each).

Each wrapper takes tensors of any shape, treats them as flat, and returns
results of the input's shape. On CPU tensors it runs the plain version
from ``ref.py``; on CUDA tensors it launches its kernel or raises. Its
``launches`` attribute counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (delta_quantize_ref, dequant_apply_ref,
                                     quant_scale)


def delta_quantize_flat(p1: torch.Tensor, p2: torch.Tensor, eps: float = 1e-4
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q = floor((p1 - p2) / scale + 0.5) as int32, and its zero count as a
    0-dim int32 tensor."""
    if p1.shape != p2.shape:
        raise ValueError(f"shapes differ: {tuple(p1.shape)} vs {tuple(p2.shape)}")
    if not build.on_card(p1, p2):
        return delta_quantize_ref(p1, p2, eps)
    build.require_dtype(p1, torch.float32, "p1")
    build.require_dtype(p2, torch.float32, "p2")
    q = torch.empty(p1.shape, dtype=torch.int32, device=p1.device)
    zeros = torch.zeros((), dtype=torch.int32, device=p1.device)
    if q.numel():
        build.launch("delta_quantize", "mgit_delta_quantize", p1.device,
                     p1.data_ptr(), p2.data_ptr(), q.data_ptr(),
                     zeros.data_ptr(), q.numel(),
                     float(np.float32(quant_scale(eps))))
        build.count_launch(delta_quantize_flat)
    return q, zeros


delta_quantize_flat.launches = 0


def dequant_apply_flat(p1: torch.Tensor, q: torch.Tensor, eps: float = 1e-4
                       ) -> torch.Tensor:
    """f32 p1 - f32(q) * scale, with q int32."""
    if p1.shape != q.shape:
        raise ValueError(f"shapes differ: {tuple(p1.shape)} vs {tuple(q.shape)}")
    if not build.on_card(p1, q):
        return dequant_apply_ref(p1, q, eps, out_dtype=torch.float32)
    build.require_dtype(p1, torch.float32, "p1")
    build.require_dtype(q, torch.int32, "q")
    out = torch.empty(p1.shape, dtype=torch.float32, device=p1.device)
    if out.numel():
        build.launch("delta_quantize", "mgit_dequant_apply", p1.device,
                     p1.data_ptr(), q.data_ptr(), out.data_ptr(), out.numel(),
                     float(np.float32(quant_scale(eps))))
        build.count_launch(dequant_apply_flat)
    return out


dequant_apply_flat.launches = 0

__all__ = ["delta_quantize_flat", "dequant_apply_flat"]
