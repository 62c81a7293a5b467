"""Wrapper of the CUDA kernel for folded checkout of a delta chain.

``chain_apply_flat`` replaces the TPU kernel
``repro/kernels/chain_apply.py::chain_apply_2d``; the kernel is in
``csrc/chain_apply.cu``. It computes ``base - (q_1 + ... + q_k) * scale``
in one pass (8 + 4k bytes per element, bound by device-memory bandwidth),
bit-identical to one host dequant of the exact int32 sum.

On CPU tensors the wrapper runs the plain version from ``ref.py``; on CUDA
tensors it launches its kernel or raises. Its ``launches`` attribute counts
kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import chain_apply_ref, quant_scale


def chain_apply_flat(base: torch.Tensor, qs: torch.Tensor, eps: float = 1e-4
                     ) -> torch.Tensor:
    """f32 ``base - sum_k(qs) * scale``; ``qs`` is a (k, *base.shape) int32 stack."""
    if qs.dim() < 1 or qs.shape[1:] != base.shape:
        raise ValueError(f"qs {tuple(qs.shape)} is not a stack of "
                         f"{tuple(base.shape)} deltas")
    if not build.on_card(base, qs):
        return chain_apply_ref(base, qs, eps)
    build.require_dtype(base.dtype, (torch.float32,), "base")
    build.require_dtype(qs.dtype, (torch.int32,), "qs")
    out = torch.empty(base.shape, dtype=torch.float32, device=base.device)
    if out.numel():
        build.launch("chain_apply", "mgit_chain_apply", base.device,
                     base.data_ptr(), qs.data_ptr(), out.data_ptr(),
                     out.numel(), qs.shape[0],
                     float(np.float32(quant_scale(eps))))
        build.count_launch(chain_apply_flat)
    return out


chain_apply_flat.launches = 0

__all__ = ["chain_apply_flat"]
