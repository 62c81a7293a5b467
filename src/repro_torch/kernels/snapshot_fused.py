"""Wrapper of the CUDA kernel for the commit's fused snapshot pass.

``snapshot_fused_flat`` replaces the TPU kernel
``repro/kernels/snapshot_fused.py::snapshot_fused_2d``; the kernel is in
``csrc/snapshot_fused.cu``. One read of each input produces the int8 delta,
its zero count and its overflow count: 9 bytes per element, bound by
device-memory bandwidth. The counts are 64-bit, so an operand may hold
more than 2^31 elements. The TPU kernel's fingerprint partial, which its
wrapper always discarded, is not computed.

On CPU tensors the wrapper runs the plain version from ``ref.py``; on CUDA
tensors it launches its kernel or raises. Its ``launches`` attribute counts
kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import quant_scale, snapshot_fused_ref


def snapshot_fused_flat(p1: torch.Tensor, p2: torch.Tensor, eps: float = 1e-4
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q8 int8 of p1's shape, zero count, overflow count); the counts are
    0-dim int64 tensors. q8 is only meaningful when the overflow count is 0."""
    if p1.shape != p2.shape:
        raise ValueError(f"shapes differ: {tuple(p1.shape)} vs {tuple(p2.shape)}")
    if not build.on_card(p1, p2):
        return snapshot_fused_ref(p1, p2, eps)
    build.require_dtype(p1.dtype, (torch.float32,), "p1")
    build.require_dtype(p2.dtype, (torch.float32,), "p2")
    q8 = torch.empty(p1.shape, dtype=torch.int8, device=p1.device)
    counts = torch.zeros(2, dtype=torch.int64, device=p1.device)
    if q8.numel():
        build.launch("snapshot_fused", "mgit_snapshot_fused", p1.device,
                     p1.data_ptr(), p2.data_ptr(), q8.data_ptr(),
                     counts.data_ptr(), q8.numel(),
                     float(np.float32(quant_scale(eps))))
        build.count_launch(snapshot_fused_flat)
    return q8, counts[0], counts[1]


snapshot_fused_flat.launches = 0

__all__ = ["snapshot_fused_flat"]
