"""Wrapper of the CUDA kernel for a tensor's content fingerprint.

``fingerprint_flat`` replaces the TPU kernel
``repro/kernels/fingerprint.py::fingerprint_2d``; the kernel is in
``csrc/fingerprint.cu``. It hashes the tensor's canonical bits in place
(u32 for f32/int32, u16 zero-extended for bf16/f16, other dtypes cast to
f32 on the device first) over the reference's zero-padded extent
(``ref.padded_length``) without materializing the padding, and only the
(h1, h2) pair leaves the device. It reads 2 or 4 bytes per element, so it
is bound by device-memory bandwidth.

On CPU tensors the wrapper runs the plain version ``ref.fingerprint_padded``;
on CUDA tensors it launches its kernel or raises. Its ``launches`` attribute
counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fingerprint_padded, padded_length


def _raw_bits(x: torch.Tensor):
    """(flat bit view, bytes per element) of ``x`` as the kernel reads it."""
    flat = x.reshape(-1)
    if flat.dtype in (torch.float32, torch.int32):
        return flat.view(torch.int32), 4
    if flat.dtype in (torch.bfloat16, torch.float16):
        return flat.view(torch.int16), 2
    return flat.to(torch.float32).view(torch.int32), 4


def fingerprint_flat(x: torch.Tensor) -> torch.Tensor:
    """The unsalted fingerprint pair of ``x``: a (2,) int64 tensor [h1, h2]
    on ``x``'s device, each in [0, 2^32)."""
    if not build.on_card(x):
        return fingerprint_padded(x)
    bits, elem_bytes = _raw_bits(x)
    out = torch.empty(2, dtype=torch.int64, device=x.device)
    n = bits.numel()
    build.launch("fingerprint", "mgit_fingerprint", x.device,
                 bits.data_ptr(), elem_bytes, n, padded_length(n),
                 out.data_ptr())
    if n:
        build.count_launch(fingerprint_flat)
    return out


fingerprint_flat.launches = 0

__all__ = ["fingerprint_flat"]
