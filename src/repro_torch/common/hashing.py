"""Content hashing for parameter tensors.

Durable keys are SHA-256 over (raw bytes, shape, dtype) — exactly the paper's
content-based hashing scheme (§4). The device-side fast path (position-mixed
fingerprint, see ``repro_torch.kernels.ref.fingerprint_ref``) only *nominates*
duplicate candidates; this module is the source of truth.
"""

from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.common.bf16 import dtype_name


def tensor_hash(x) -> str:
    """SHA-256 content hash of a tensor (value + shape + dtype).

    The dtype enters by its numpy name, so a bf16 carrier hashes as
    ``bfloat16``, as the reference's ``ml_dtypes`` arrays do."""
    arr = np.asarray(x)
    h = hashlib.sha256()
    h.update(str(arr.shape).encode())
    h.update(dtype_name(arr).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


class TensorHasher:
    """Incremental :func:`tensor_hash` over a tensor's raw bytes.

    Feeding the contiguous byte stream chunk-by-chunk yields the SAME digest
    as ``tensor_hash`` over the materialized array — the hash runs over
    ``str(shape) + str(dtype) + raw bytes``, none of which needs the whole
    tensor in memory. This is what lets the chunked commit/checkout engine
    derive and verify content identity of multi-GB tensors under a bounded
    window (DESIGN.md §12)."""

    def __init__(self, shape, dtype) -> None:
        self._h = hashlib.sha256()
        self._h.update(str(tuple(int(d) for d in shape)).encode())
        self._h.update(dtype_name(dtype).encode())

    def update(self, data) -> None:
        self._h.update(data)

    def hexdigest(self) -> str:
        return self._h.hexdigest()


def bytes_hash(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()
