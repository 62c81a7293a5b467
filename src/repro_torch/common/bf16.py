"""bfloat16 on the host without ``ml_dtypes``.

numpy has no bfloat16 of its own, so this package holds a bf16 tensor on
the host as its raw bits: a ``uint16`` array whose dtype carries the
metadata ``{"logical": "bfloat16"}`` (:data:`DTYPE`, "the carrier"). numpy
keeps a dtype's metadata through views, reshapes, slices, copies and
``np.frombuffer``, so the carrier survives the store's plumbing, and a
genuine ``uint16`` array (no metadata) stays a ``uint16``.

Everywhere a dtype's name is observable, the carrier's is ``bfloat16``,
as ``ml_dtypes`` names it in the reference package: manifests, content
hashes (:func:`dtype_name`), delta signatures, and the npy header, which
is ``'<V2'`` byte for byte as ``np.save`` writes an ``ml_dtypes`` array
(:func:`npy_header`). A ``V2`` npy payload reads back as the carrier.

Arithmetic never runs on the bits: :func:`widen` gives the exact f32
values, :func:`narrow` rounds f32 back to bf16 (round to nearest even; a
NaN becomes the quiet NaN of its sign, ``0x7FC0`` / ``0xFFC0``), bit for
bit with ``jnp.astype(bfloat16)`` and ``ml_dtypes``. :func:`to_torch`
turns any host array into a tensor (the carrier into ``torch.bfloat16``)
and :func:`from_torch` takes a ``torch.bfloat16`` tensor's bits back.
"""

from __future__ import annotations

import numpy as np
import torch

NAME = "bfloat16"
DTYPE = np.dtype(np.uint16, metadata={"logical": NAME})


def is_bf16(x) -> bool:
    """Whether ``x`` (an array, a dtype or a dtype name) is the carrier."""
    if isinstance(x, str):
        return x == NAME
    dtype = x if isinstance(x, np.dtype) else getattr(x, "dtype", None)
    return (isinstance(dtype, np.dtype) and dtype.metadata is not None
            and dtype.metadata.get("logical") == NAME)


def dtype_name(x) -> str:
    """The numpy name of the dtype of ``x`` (an array, a dtype or a name):
    ``bfloat16`` for the carrier, ``str(dtype)`` otherwise."""
    if is_bf16(x):
        return NAME
    if isinstance(x, np.ndarray):
        return str(x.dtype)
    try:
        return str(np.dtype(x))
    except TypeError:
        return str(np.asarray(x).dtype)


def np_dtype(x) -> np.dtype:
    """The host dtype of a dtype or its name: :data:`DTYPE` for
    ``bfloat16``."""
    return DTYPE if is_bf16(x) else np.dtype(x)


def carry(bits) -> np.ndarray:
    """A view of 16-bit raw bits (uint16, int16 or ``V2``) as the carrier."""
    return np.asarray(bits).view(DTYPE)


def widen(x) -> np.ndarray:
    """``x`` as float32: exact for the carrier (its bits shifted into the
    high half), ``np.asarray(x, float32)`` for anything else."""
    if is_bf16(x):
        bits = np.asarray(x).view(np.uint16)
        return (bits.astype(np.uint32) << 16).view(np.float32)
    return np.asarray(x, dtype=np.float32)


def narrow(x) -> np.ndarray:
    """float32 ``x`` rounded to bf16 (nearest, ties to even), as the
    carrier."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    rounded = (u + (0x7FFF + ((u >> 16) & 1))) >> 16   # wraps only for NaNs
    quiet = ((u >> 16) & 0x8000) | 0x7FC0
    return np.where(nan, quiet, rounded).astype(np.uint16).view(DTYPE)


def to_torch(x, copy: bool = False) -> torch.Tensor:
    """An array as a CPU tensor of its own dtype and shape, the carrier as
    ``torch.bfloat16``. It shares the array's memory unless ``copy``, or
    unless the array is read-only or not C-contiguous: then it is copied
    first (torch cannot wrap such a buffer)."""
    a = np.asarray(x)
    if copy or not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a, order="C")       # keeps a 0-dim array 0-dim
    if is_bf16(a):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_torch(t: torch.Tensor) -> np.ndarray:
    """A ``torch.bfloat16`` tensor's bits as the carrier, on the host."""
    return carry(t.detach().cpu().contiguous().view(torch.int16).numpy())


def npy_header(shape) -> bytes:
    """The npy header ``np.save`` writes for a C-ordered ``ml_dtypes``
    bfloat16 array of ``shape``: descr ``'<V2'``."""
    import io
    buf = io.BytesIO()
    header = {"descr": "<V2", "fortran_order": False,
              "shape": tuple(int(d) for d in shape)}
    try:
        np.lib.format.write_array_header_1_0(buf, header)
    except ValueError:   # a header past 64 KiB needs format 2.0
        buf = io.BytesIO()
        np.lib.format.write_array_header_2_0(buf, header)
    return buf.getvalue()


__all__ = ["NAME", "DTYPE", "is_bf16", "dtype_name", "np_dtype", "carry",
           "widen", "narrow", "to_torch", "from_torch", "npy_header"]
