"""Public entry points of the storage-path kernels.

This is the one place where the store's host arrays meet the device. Each
function takes numpy arrays (or torch tensors), moves them to the
backend's device, calls the kernel wrapper there, and returns numpy
arrays on the host. The signatures and return values are the reference
package's (``repro/kernels/ops.py``).

Backends:

* ``"cuda"``, the default: the hand-written CUDA kernels on the card.
  :func:`default_backend` raises when there is no card, so nothing falls
  back to the CPU unless the caller asked for it;
* ``"ref"``: the plain torch versions on the CPU (``ref.py``).

The reference pads every tensor to (rows, 1024) TPU tiles; the CUDA kernels
work on flat tensors with a masked tail, so zero counts need no padding
correction, and per-tile zero counts add the padding on the host.
``fingerprint`` hashes the reference's padded extent, because its hash
depends on it, but its kernel never materializes the padding.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.common import bf16
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.chain_apply import chain_apply_flat
from repro_torch.kernels.delta_quantize import (delta_quantize_flat,
                                                dequant_apply_flat)
from repro_torch.kernels.fingerprint import fingerprint_flat
from repro_torch.kernels.snapshot_fused import snapshot_fused_flat

_DEVICES = {"cuda": "cuda", "ref": "cpu"}


def default_backend() -> str:
    """``"cuda"``; raises when PyTorch sees no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the storage kernels run on the card; pass "
            "backend='ref' to ask for the plain torch versions on the CPU")
    return "cuda"


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """A model's device: the card unless the caller names another.

    ``None`` and a bare ``"cuda"`` mean the current CUDA device and raise
    when there is no card."""
    if device is None:
        default_backend()   # raises when there is no card
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        default_backend()
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _device(backend: Optional[str]) -> torch.device:
    backend = backend or default_backend()
    try:
        dev = torch.device(_DEVICES[backend])
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{sorted(_DEVICES)}") from None
    if dev.type == "cuda":
        default_backend()   # raises when there is no card
    return dev


def _to(x, device: torch.device) -> torch.Tensor:
    """``x`` as a contiguous tensor on ``device``. Read-only numpy arrays
    (CAS views) are copied first: torch cannot wrap them. A bf16 carrier
    (``common/bf16.py``) becomes a ``torch.bfloat16`` tensor."""
    if not isinstance(x, torch.Tensor):
        x = bf16.to_torch(x)
    return x.to(device).contiguous()


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array on the host; bfloat16 as the bf16 carrier."""
    if t.dtype == torch.bfloat16:
        return bf16.from_torch(t)
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# delta quantize / dequantize
# ---------------------------------------------------------------------------

def _tiling(n: int):
    """(tile, padding) of the reference's layout of ``n`` flat elements:
    (rows, 1024) with rows = ⌈n / 1024⌉ rounded up to a multiple of 8, cut
    into tiles of block_rows x 1024, block_rows the first of 256, 128, 64,
    32, 16, 8 that divides rows (``repro/kernels/ops.py::_to_2d``,
    ``_block_rows``). The padding always lies in the last tile."""
    padded = _ref.padded_length(n)
    rows = padded // _ref.LANE_COLS
    block_rows = next(c for c in (256, 128, 64, 32, 16, 8) if rows % c == 0)
    return block_rows * _ref.LANE_COLS, padded - n


def delta_quantize(p1, p2, eps: float = 1e-4, backend: Optional[str] = None,
                   return_block_zeros: bool = False):
    """Quantized delta q = floor((p1-p2)/scale + 0.5) (paper Algorithm 1).

    Returns (q int32 array shaped like p1, n_zero int) — optionally also the
    zero count of each tile of the reference's (rows, 1024) layout, its
    zero padding included, as the reference's kernel reduces them (None on
    ``"ref"``, as in the reference).
    """
    backend = backend or default_backend()
    dev = _device(backend)
    a, b = _to(p1, dev), _to(p2, dev)
    if not return_block_zeros or backend == "ref":
        q, zeros = delta_quantize_flat(a, b, eps)
        nz = int(zeros)
        return (to_host(q), nz, None) if return_block_zeros else (to_host(q), nz)
    tile, pad = _tiling(a.numel())
    q, tiles = delta_quantize_flat(a, b, eps, tile=tile)
    blocks = to_host(tiles)
    nz = int(blocks.sum())
    blocks[-1:] += pad
    return to_host(q), nz, blocks


def dequant_apply(p1, q, eps: float = 1e-4, out_dtype=None,
                  backend: Optional[str] = None):
    """Reconstruct the child parameter: p2' = p1 - q*scale, rounded once
    to ``out_dtype`` (default p1's dtype)."""
    dev = _device(backend)
    return to_host(dequant_apply_flat(_to(p1, dev), _to(q, dev).to(torch.int32),
                                      eps, out_dtype=out_dtype))


def chain_apply(base, qs, eps: float = 1e-4, out_dtype=None,
                backend: Optional[str] = None):
    """Fused delta-chain application: ``base - sum(qs) * scale`` (§10.2).

    ``qs`` is a sequence of quantized deltas (int8/int32) from one same-eps
    chain segment; they are widened into one int32 stack on the device.
    Bit-identical to summing on the host and calling ``dequant_apply``
    once — int32 sums are exact, and the final multiply+subtract is the
    same correctly-rounded f32 op either way."""
    dev = _device(backend)
    b = _to(base, dev)
    stack = torch.stack([_to(q, dev).to(torch.int32).reshape(b.shape)
                         for q in qs])
    out = chain_apply_flat(b.to(torch.float32), stack, eps)
    return to_host(_ref.narrow(out, out_dtype if out_dtype is not None
                               else b.dtype))


def snapshot_fused(p1, p2, eps: float = 1e-4, backend: Optional[str] = None,
                   with_fingerprint: bool = True):
    """One-pass checkpoint snapshot: (q int8|int32, n_zero, fingerprint, narrow).

    Narrows q to int8 when every value fits; tensors with overflow fall back
    to the int32 ``delta_quantize`` on the operands in their own dtype
    (`narrow=False`). The fused pass takes f32 casts, as the reference's
    does. ``with_fingerprint=
    False`` elides the fingerprint (returned as None) — the commit pipeline
    keys objects by SHA-256 and never reads it.
    """
    dev = _device(backend)
    t1, t2 = _to(p1, dev), _to(p2, dev)
    fp = fingerprint(t2, backend=backend) if with_fingerprint else None
    q8, zeros, overflow = snapshot_fused_flat(t1.to(torch.float32),
                                              t2.to(torch.float32), eps)
    if int(overflow) > 0:
        # as in the reference, the fallback quantizes the operands as given
        q, nz = delta_quantize_flat(t1, t2, eps)
        return to_host(q), int(nz), fp, False
    return to_host(q8), int(zeros), fp, True


# ---------------------------------------------------------------------------
# fingerprint
# ---------------------------------------------------------------------------

def fingerprint(x, backend: Optional[str] = None) -> int:
    """64-bit content fingerprint (python int). Includes shape/dtype salt so
    reshaped or recast tensors don't alias (mirrors SHA-256 keying in the CAS).

    A tensor already on the backend's device is hashed where it lies; only
    the (h1, h2) pair comes back to the host. The salt is Python's
    ``hash`` of a tuple, so compare fingerprints within one process only."""
    t = _to(x, _device(backend))
    h1, h2 = fingerprint_flat(t).tolist()
    salt = hash((tuple(t.shape), _ref.dtype_name(t.dtype))) & 0xFFFFFFFF
    return ((h1 ^ salt) << 32) | h2


__all__ = ["delta_quantize", "dequant_apply", "chain_apply", "snapshot_fused",
           "fingerprint", "default_backend", "resolve_device"]
