"""Forward flash attention: the wrapper of its CUDA kernel and its plain version.

``flash_attention`` replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention``; the kernel is in
``csrc/flash_attention.cu``. The layout is the reference's: q (B, Hq, Sq,
hd), k and v (B, Hkv, Skv, hd), with query head ``h`` reading KV head
``h // (Hq // Hkv)``; the result has q's shape and dtype, accumulated in
f32. Query and key positions both count from 0, so causal, sliding-window
(``q - k < window``) and prefix-LM (``k < prefix_len`` is visible under a
causal mask) masks are the reference's.

The kernel computes what ``flash_attention_ref`` (the reference's dense
f32 oracle) computes. It does not copy the Pallas kernel's block skip,
which ignores ``prefix_len`` and so drops key blocks a prefix makes
visible once the prefix reaches past a query block.

On CPU tensors the wrapper runs ``flash_attention_ref``; on CUDA tensors
it launches its kernel or raises. Its ``launches`` attribute counts
kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
                        prefix_len: int = 0) -> torch.Tensor:
    """Dense f32 softmax attention, the reference's oracle."""
    _, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    G = Hq // Hkv
    kf = torch.repeat_interleave(k, G, dim=1).to(torch.float32)
    vf = torch.repeat_interleave(v, G, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32) * hd ** -0.5, kf)
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    prefix_len: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k, v: (B, Hkv, Skv, hd) -> (B, Hq, Sq, hd)."""
    _check(q, k, v, window)
    if not build.on_card(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   prefix_len=prefix_len)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v are {q.dtype}, {k.dtype}, {v.dtype}: the "
                        f"kernel takes float32 or bfloat16, all one dtype")
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: the kernel takes at most "
                         f"{MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if out.numel():
        build.launch("flash_attention", "mgit_flash_attention", q.device,
                     q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B, Hq, Hkv, Sq, Skv, hd, int(causal), int(window),
                     int(prefix_len), float(hd ** -0.5),
                     _DTYPE_CODES[q.dtype])
        build.count_launch(flash_attention)
    return out


flash_attention.launches = 0


def flops(B: int, Hq: int, Sq: int, Skv: int, hd: int, *, causal: bool = True,
          window: int = 0, prefix_len: int = 0) -> int:
    """Floating-point operations of the two products over the (query, key)
    pairs the mask leaves visible: 4 * hd per pair (a multiply and an add
    in each of q @ k and p @ v)."""
    q_pos = torch.arange(Sq)[:, None]
    k_pos = torch.arange(Skv)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        ok = (k_pos <= q_pos) | (k_pos < prefix_len)
    if window > 0:
        ok = ok & (q_pos - k_pos < window)
    return 4 * B * Hq * hd * int(ok.sum())


def hbm_bytes(B, Hq, Hkv, Sq, Skv, hd, dtype_bytes=2, qc=512):
    """The reference kernel's HBM traffic contract (per its BlockSpecs): q
    and out once, k and v once per q block. This kernel's q block is 64."""
    n_q = max(Sq // min(qc, Sq), 1)
    q_out = 2 * B * Hq * Sq * hd * dtype_bytes
    kv = 2 * B * Hkv * Skv * hd * dtype_bytes * n_q
    return q_out + kv


__all__ = ["flash_attention", "flash_attention_ref", "flops", "hbm_bytes",
           "NEG_INF"]
