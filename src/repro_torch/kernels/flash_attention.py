"""Forward flash attention: the wrapper of its CUDA kernel and its plain version.

``flash_attention`` replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention``; the kernel is in
``csrc/flash_attention.cu``. The layout is the reference's: q (B, Hq, Sq,
hd), k and v (B, Hkv, Skv, hd), with query head ``h`` reading KV head
``h // (Hq // Hkv)``; the result has q's shape and dtype, accumulated in
f32. Query and key positions both count from 0, so causal, sliding-window
(``q - k < window``) and prefix-LM (``k < prefix_len`` is visible under a
causal mask) masks are the reference's. Scores are scaled by ``hd **
-0.5``, or by ``scale`` where the caller gives one.

The kernel runs on Hopper's tensor cores through ``wgmma``: bf16 and f16
directly (P rounded to the input's type for the second product), f32 as
three TF32 passes (3xTF32), with k and v tiles loaded by TMA into
a ring in shared memory. A block owns 64 query rows (128 for f32 at head
dim 64) and walks the 64-key tiles (32-key for f32 above head dim 128)
some of them can see. It is instantiated at head dims 64, 128 and 256 and
takes any multiple of 8 up to 256; the wrapper pads any other head dim
with zeros. Above 256 it raises.

The kernel computes what ``flash_attention_ref`` (the reference's dense
f32 oracle) computes. It does not copy the Pallas kernel's block skip,
which ignores ``prefix_len`` and so drops key blocks a prefix makes
visible once the prefix reaches past a query block.

On CPU tensors the wrapper runs ``flash_attention_ref``; on CUDA tensors
it launches its kernel or raises; on ``meta`` tensors (the dry run of
``repro_torch.launch``) it computes nothing and its FLOPs are counted
from the shapes. Its ``launches`` attribute counts kernel launches, and
``launches_by_dtype`` counts them by q's dtype.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256
# where a larger head dim waits (ROADMAP.md, queue 1, item 3)
WIDER_HEADS_ITEM = "flash attention above head dim 256"
HEAD_DIM_MULTIPLE = 8   # the kernel's TMA rows are whole 16-byte units
# the largest operand the wrapper launches the kernel on: its checks on the
# card stay below it (unlike the storage kernels'). A larger one raises.
MAX_ELEMENTS = 2**31 - 1
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# H100 SXM peaks (NVIDIA's data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12   # and f16
TF32_OPS_PER_S = 495e12
TF32_PASSES = 3   # 3xTF32: small*big + big*small + big*big


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Hq, Sq, hd) and k, v (B, Hkv, Skv, "
                         f"hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, Sq, hd = q.shape
    Bk, Hkv, Skv, hdk = k.shape
    if Bk != B or hdk != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"pair: batch and head_dim must match and Hq be a "
                         f"multiple of Hkv")
    if Sq and not Skv:
        raise ValueError("queries with no keys to attend")
    if window > 0 and Sq > Skv:
        raise ValueError(f"window {window} with {Sq} queries over {Skv} keys: "
                         f"a query row could see no key")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        prefix_len: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Dense f32 softmax attention, the reference's oracle."""
    _, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    G = Hq // Hkv
    kf = torch.repeat_interleave(k, G, dim=1).to(torch.float32)
    vf = torch.repeat_interleave(v, G, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32)
                     * (hd ** -0.5 if scale is None else scale), kf)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok = k_pos <= q_pos
        if prefix_len > 0:
            ok = ok | (k_pos < prefix_len)
    if window > 0:
        ok = ok & (q_pos - k_pos < window)
    s = torch.where(ok[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def kernel_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v as the kernel takes them: the head dim padded with zeros to
    a multiple of ``HEAD_DIM_MULTIPLE`` and every base 16-byte aligned (a
    TMA map's requirement). Zero columns add nothing to q @ k and come out
    as zero columns of the result, which the wrapper cuts off."""
    pad = -q.shape[-1] % HEAD_DIM_MULTIPLE
    out = []
    for t in (q, k, v):
        if pad:
            t = torch.nn.functional.pad(t, (0, pad))
        elif t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    prefix_len: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k, v: (B, Hkv, Skv, hd) -> (B, Hq, Sq, hd).

    ``scale`` multiplies the scores in place of ``hd ** -0.5``.
    ``meta`` operands (a dry run) go through the operator
    ``torch.ops.mgit.flash_attention``, which only gives the result's
    shape (so it takes no scale) and has ``flops`` registered as its count
    for ``torch.utils.flop_counter``. CUDA operands launch the kernel
    directly, without the dispatcher's cost per call; the operator's CUDA
    implementation is the same launch, and its CPU one the plain
    version."""
    _check(q, k, v, window)
    if q.is_meta and k.is_meta and v.is_meta:
        return torch.ops.mgit.flash_attention(q, k, v, causal, window,
                                              prefix_len)
    if not build.on_card(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len, scale=scale)
    return _launch(q, k, v, causal, window, prefix_len, scale)


def _launch(q, k, v, causal, window, prefix_len, scale=None):
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v are {q.dtype}, {k.dtype}, {v.dtype}: the "
                        f"kernel takes float32, bfloat16 or float16, all "
                        f"one dtype")
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: the kernel takes at most "
                         f"{MAX_HEAD_DIM} (ROADMAP item "
                         f"'{WIDER_HEADS_ITEM}')")
    for t in (q, k, v):
        if t.numel() > MAX_ELEMENTS:
            raise ValueError(f"{t.numel()} elements: the kernel takes at "
                             f"most {MAX_ELEMENTS}")
    kq, kk, kv = kernel_operands(q, k, v)
    out = torch.empty_like(kq)
    if out.numel():
        build.launch("flash_attention", "mgit_flash_attention", q.device,
                     kq.data_ptr(), kk.data_ptr(), kv.data_ptr(),
                     out.data_ptr(), B, Hq, Hkv, Sq, Skv, kq.shape[-1],
                     int(causal), int(window), int(prefix_len),
                     float(hd ** -0.5 if scale is None else scale),
                     _DTYPE_CODES[q.dtype])
        build.count_launch(flash_attention,
                           str(q.dtype).removeprefix("torch."))
    return out if kq.shape[-1] == hd else out[..., :hd].contiguous()


@torch.library.custom_op("mgit::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, prefix_len: int) -> torch.Tensor:
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               prefix_len=prefix_len)


_flash_op.register_kernel("cuda", _launch)


@_flash_op.register_fake
def _flash_shape(q, k, v, causal, window, prefix_len):
    return torch.empty_like(q)


flash_attention.launches = 0
flash_attention.launches_by_dtype = {}


def visible_pairs(Sq: int, Skv: int, *, causal: bool = True, window: int = 0,
                  prefix_len: int = 0) -> int:
    """The (query, key) pairs the mask leaves visible, counted row by row
    in O(Sq): row ``i`` sees the keys from ``i - window + 1`` (or 0) up to
    ``i`` under a causal mask, or up to ``prefix_len - 1`` when that is
    further, or up to the last key without one."""
    i = np.arange(Sq, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    if causal:
        hi = np.maximum(np.minimum(i, Skv - 1), min(prefix_len, Skv) - 1)
    else:
        hi = np.full_like(i, Skv - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


@register_flop_formula(torch.ops.mgit.flash_attention)
def _flash_op_flops(q_shape, k_shape, v_shape, causal, window, prefix_len,
                    out_shape=None, **kwargs) -> int:
    """``flops`` of one call, from the operands' shapes."""
    B, Hq, Sq, hd = q_shape
    return 4 * B * Hq * hd * visible_pairs(Sq, k_shape[2], causal=causal,
                                           window=window,
                                           prefix_len=prefix_len)


def flops(B: int, Hq: int, Sq: int, Skv: int, hd: int, *, causal: bool = True,
          window: int = 0, prefix_len: int = 0) -> int:
    """Floating-point operations of the two products over the (query, key)
    pairs the mask leaves visible: 4 * hd per pair (a multiply and an add
    in each of q @ k and p @ v). It builds the whole mask: the oracle of
    ``visible_pairs``, which the dry run and ``roofline`` count with."""
    q_pos = torch.arange(Sq)[:, None]
    k_pos = torch.arange(Skv)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        ok = (k_pos <= q_pos) | (k_pos < prefix_len)
    if window > 0:
        ok = ok & (q_pos - k_pos < window)
    return 4 * B * Hq * hd * int(ok.sum())


def roofline(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, hd: int,
             dtype: torch.dtype, *, causal: bool = True, window: int = 0,
             prefix_len: int = 0):
    """(ms, "bytes" or "operations"): the least time an H100 SXM could take
    for one call, and which of the two bounds it.

    Bytes: q, k, v read once and out written once at the dtype's width,
    over the device memory rate. Operations: ``flops`` over the visible
    pairs, at the dense bf16 (and f16) tensor-core rate for bf16 and f16,
    and as three TF32
    passes at the TF32 rate for f32 (the cheapest tensor-core route that
    keeps f32's 2e-5 tolerance, the kernel's)."""
    ops = 4 * B * Hq * hd * visible_pairs(Sq, Skv, causal=causal,
                                          window=window,
                                          prefix_len=prefix_len)
    if dtype in (torch.bfloat16, torch.float16):
        ops_s = ops / BF16_OPS_PER_S
    elif dtype == torch.float32:
        ops_s = TF32_PASSES * ops / TF32_OPS_PER_S
    else:
        raise TypeError(f"no bound for {dtype}: the kernel takes float32, "
                        f"bfloat16 or float16")
    item = torch.empty((), dtype=dtype).element_size()
    bytes_s = (2 * B * Hq * Sq + 2 * B * Hkv * Skv) * hd * item \
        / HBM_BYTES_PER_S
    return max(bytes_s, ops_s) * 1e3, (
        "bytes" if bytes_s >= ops_s else "operations")


def hbm_bytes(B, Hq, Hkv, Sq, Skv, hd, dtype_bytes=2, qc=512):
    """The reference kernel's HBM traffic contract (per its BlockSpecs): q
    and out once, k and v once per q block of ``qc`` rows. It describes the
    Pallas kernel, not this one; ``roofline`` gives this kernel's bound."""
    n_q = max(Sq // min(qc, Sq), 1)
    q_out = 2 * B * Hq * Sq * hd * dtype_bytes
    kv = 2 * B * Hkv * Skv * hd * dtype_bytes * n_q
    return q_out + kv


__all__ = ["flash_attention", "flash_attention_ref", "flops", "hbm_bytes",
           "kernel_operands", "roofline", "visible_pairs", "NEG_INF"]
