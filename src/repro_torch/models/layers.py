"""Shared layer numerics: norms, RoPE, attention, MLP and MoE.

The math is the reference package's ``repro/models/layers.py``, in plain
torch ops. Conventions kept from it:

* ``rmsnorm`` scales by ``1 + w`` (weights initialise to zero);
* ``rope`` rotates the two halves of the head dimension, not interleaved
  pairs;
* training attention scales ``q`` before the product and runs the same
  double-chunked online softmax as ``chunked_attention``, over blocks of
  ``cfg.attn_chunk`` queries and keys;
* the GELU MLP uses the tanh approximation, ``jax.nn.gelu``'s default.

With a decode cache, ``attention_layer`` writes the new keys and values
into it and attends as the reference does: a prefill (S > 1) runs causal
attention over the prompt itself through ``kernels.flash_attention`` (the
CUDA kernel on the card, its plain version on the CPU), which computes the
reference's ``chunked_attention`` function; a decode step attends over the
cache with ``decode_attention``. With ``xa`` it is cross-attention (K/V
from ``xa``, no RoPE, no causal mask) in plain torch, as the reference
computes it.

``moe`` is the reference's dropped-token top-K MoE with one block of
tokens (the reference's block count is 1 without a device mesh): routing
in f32, per-expert capacity, a scatter into capacity slots and the mirror
gather, and the shared expert. Its expert products are ``torch.einsum``,
as the reference leaves them to XLA outside any Pallas kernel. With
``cfg.dropless`` it is ``moe_dropless`` instead: every choice is
computed, over only the rows routed to the experts held here
(``cfg.held_experts``), as grouped products (``grouped_mm``).

Granite's attention (``cfg.nope``: no rotary positions;
``cfg.attention_multiplier``: the softmax scale in place of
``head_dim ** -0.5``) runs through the same functions.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.dist.sharding import shard
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.to(torch.float32))).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=x.device), exponent)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int,
               prefix_len: int, causal: bool) -> torch.Tensor:
    """(Sq, C) additive bias: 0 where attendable, NEG_INF elsewhere."""
    q = q_pos[:, None]
    k = kv_pos[None, :]
    if causal:
        ok = k <= q
        if prefix_len > 0:  # prefix-LM: bidirectional over the prefix
            ok = ok | (k < prefix_len)
    else:
        ok = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                        device=q_pos.device)
    if window > 0:
        ok = ok & (q - k < window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _fit(n: int, c: int) -> int:
    """The largest divisor of ``n`` that is at most ``c`` (exact tiling)."""
    c = min(c, n)
    while n % c:
        c -= 1
    return c


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cfg: ModelConfig, *, causal: bool = True,
                      q_offset: int = 0, kv_offset: int = 0,
                      prefix_len: int = 0) -> torch.Tensor:
    """Memory-efficient attention, the reference's online softmax.

    q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd). Returns (B, Sq, Hq, hd).
    Query blocks and KV blocks of ``cfg.attn_chunk`` (the largest divisor
    at most that) are walked in loops; score tiles run in the model dtype
    when it is bf16, and the softmax statistics and output accumulator in
    f32."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = cfg.attention_multiplier or hd ** -0.5
    qc = _fit(Sq, cfg.attn_chunk)
    kc = _fit(Skv, cfg.attn_chunk)
    n_q, n_k = Sq // qc, Skv // kc
    cdt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    dev = q.device

    q = q.reshape(B, n_q, qc, Hkv, G, hd).to(cdt) * torch.tensor(
        scale, dtype=cdt, device=dev)
    k = k.reshape(B, n_k, kc, Hkv, hd)
    v = v.reshape(B, n_k, kc, Hkv, hd)

    blocks = []
    for qi in range(n_q):
        q_blk = q[:, qi]                      # (B, qc, Hkv, G, hd)
        q_pos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((B, qc, Hkv, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, qc, Hkv, G), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, qc, Hkv, G, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(n_k):
            k_blk = k[:, ki].to(cdt)
            v_blk = v[:, ki].to(cdt)
            kv_pos = kv_offset + ki * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bqhgd,bchd->bqhgc", q_blk, k_blk)
            bias = _mask_bias(q_pos, kv_pos, cfg.window, prefix_len, causal)
            s = s + bias[None, :, None, None, :].to(cdt)
            m_new = torch.maximum(m, torch.amax(s, dim=-1).to(torch.float32))
            p = torch.exp(s.to(torch.float32) - m_new[..., None]).to(cdt)
            alpha = torch.exp(m - m_new)
            l = l * alpha + torch.sum(p, dim=-1, dtype=torch.float32)
            # products of the cdt values, summed in f32 (the reference's
            # preferred_element_type)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqhgc,bchd->bqhgd", p.to(torch.float32),
                v_blk.to(torch.float32))
            m = m_new
        blocks.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(blocks, dim=1)          # (B, n_q, qc, Hkv, G, hd)
    return out.reshape(B, Sq, Hq, hd)


def _write_cache(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                 v: torch.Tensor, cache_pos: int, ring: bool) -> None:
    """Write this call's keys and values into ``cache`` in place.

    A linear cache takes them at ``cache_pos``; a ring buffer (sliding
    window) at ``cache_pos % Sc``. A prefill that overflows a ring keeps
    only its last ``Sc`` keys, rotated so position p lands in slot p % Sc.
    The reference's ``dynamic_update_slice`` silently clamps a write that
    runs past the end of the buffer to end at its last slot; here that
    write raises ``ValueError``."""
    Sc = cache["k"].shape[1]
    S = k.shape[1]
    if ring and S >= Sc:
        shift = (cache_pos + S) % Sc
        cache["k"].copy_(torch.roll(k[:, -Sc:], shift, dims=1))
        cache["v"].copy_(torch.roll(v[:, -Sc:], shift, dims=1))
        return
    start = cache_pos % Sc if ring else cache_pos
    if start < 0 or start + S > Sc:
        raise ValueError(f"cache write of {S} positions at slot {start} runs "
                         f"past the cache's {Sc} slots")
    cache["k"][:, start:start + S] = k
    cache["v"][:, start:start + S] = v


def attention_layer(x: torch.Tensor, p: Dict, cfg: ModelConfig, *,
                    positions: torch.Tensor, causal: bool = True,
                    prefix_len: int = 0,
                    xa: Optional[torch.Tensor] = None,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    cache_pos: int = 0, return_kv: bool = False):
    """Attention sublayer: proj -> rope -> (cache) -> attention -> out.

    ``xa`` switches to cross-attention (K/V from xa, no RoPE, no causal
    mask). ``cache``: {"k", "v"} ring or linear buffers (B, Sc, Hkv, hd)
    for decode, written IN PLACE at the integer write index ``cache_pos``
    (the reference returns new buffers instead). Returns the output, or
    (output, (k, v)) with ``return_kv``."""
    B, S, D = x.shape
    hd = cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    src = xa if xa is not None else x
    q = shard(torch.einsum("bsd,dh->bsh", x, p["wq"]),
              ("pod", "data"), None, "model").reshape(B, S, Hq, hd)
    k = shard(torch.einsum("bsd,dh->bsh", src, p["wk"]),
              ("pod", "data"), None, "model").reshape(B, src.shape[1], Hkv,
                                                     hd)
    v = shard(torch.einsum("bsd,dh->bsh", src, p["wv"]),
              ("pod", "data"), None, "model").reshape(B, src.shape[1], Hkv,
                                                     hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if xa is None and not cfg.nope:  # self-attention: rotary positions
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = chunked_attention(q, k, v, cfg, causal=causal and xa is None,
                                prefix_len=prefix_len)
    else:
        cache_pos = int(cache_pos)
        ring = cfg.window > 0
        _write_cache(cache, k, v, cache_pos, ring)
        if S > 1:
            # prefill: causal attention over the prompt itself; the cache
            # is only written, not attended. The scale is passed only
            # where the configuration sets one.
            scale = ({"scale": cfg.attention_multiplier}
                     if cfg.attention_multiplier else {})
            out = flash_attention(
                q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), causal=True,
                window=cfg.window, prefix_len=prefix_len,
                **scale).transpose(1, 2)
        else:
            Sc = cache["k"].shape[1]
            kv_len = min(cache_pos + S, Sc) if ring else cache_pos + S
            out = decode_attention(q, cache["k"], cache["v"], cfg,
                                   kv_len=kv_len, ring=ring,
                                   cache_pos=cache_pos)
    out = shard(out.reshape(B, S, Hq * hd), ("pod", "data"), None, "model")
    out = torch.einsum("bsh,hd->bsd", out.to(x.dtype), p["wo"])
    out = shard(out, ("pod", "data"), None, None)
    return (out, (k, v)) if return_kv else out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cfg: ModelConfig, *, kv_len: int, ring: bool = False,
                     cache_pos: int = 0) -> torch.Tensor:
    """Single-token (or short Sq) attention against a cache.

    q: (B, Sq, Hq, hd); k, v: (B, Skv, Hkv, hd). Slots written in the last
    ``kv_len`` steps are attended: in a ring buffer those whose age
    ``(cache_pos - slot) % Skv`` is below ``kv_len``, in a linear cache
    the first ``kv_len``."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    q = q.reshape(B, Sq, Hkv, G, hd).to(torch.float32) * (
        cfg.attention_multiplier or hd ** -0.5)
    s = torch.einsum("bqhgd,bchd->bqhgc", q, k.to(torch.float32))
    slot = torch.arange(Skv, device=q.device)
    valid = ((cache_pos - slot) % Skv < kv_len) if ring else slot < kv_len
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    s = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgc,bchd->bqhgd", s, v.to(torch.float32))
    return out.reshape(B, Sq, Hq, hd)


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

def mlp(x: torch.Tensor, p: Dict, cfg: ModelConfig,
        prefix: str = "w") -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p[f"{prefix}_gate"])
        h = torch.einsum("bsd,df->bsf", x, p[f"{prefix}_in"])
        h = F.silu(g) * h
    else:
        h = torch.einsum("bsd,df->bsf", x, p[f"{prefix}_in"])
        h = F.gelu(h, approximate="tanh")
    h = shard(h, ("pod", "data"), None, "model")
    return torch.einsum("bsf,fd->bsd", h, p[f"{prefix}_out"])


def top_k(logits: torch.Tensor, k: int):
    """``jax.lax.top_k``: the ``k`` largest values along the last axis and
    their indices, ties broken towards the lower index (``torch.topk``
    leaves tie order to the implementation; a stable sort does not)."""
    values, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def choose(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """Router logits (T, E) of tokens xt (T, D) in f32, each token's top-K
    experts ``sel`` and the softmax over those K logits, ``weights``."""
    logits = torch.einsum("td,de->te", xt.to(torch.float32),
                          router.to(torch.float32))
    weights, sel = top_k(logits, cfg.experts_per_token)   # (T, K)
    return logits, sel, torch.softmax(weights, dim=-1)


def route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """The MoE's routing of tokens xt (T, D), in f32: router logits (T,
    E), each token's top-K experts ``sel`` and softmaxed ``weights`` (T,
    K), each choice's slot ``pos`` in its expert's queue, ``keep`` (pos <
    capacity C) and C. A token's k-th choice takes the next slot of its
    expert in the token-major (T * K) order."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.experts_per_token
    C = min(max(int(cfg.capacity_factor * T * K / E), 1), T)
    logits, sel, weights = choose(xt, router, cfg)
    onehot = F.one_hot(sel, E).to(torch.float32)          # (T, K, E)
    pos = (torch.cumsum(onehot.reshape(T * K, E), dim=0).reshape(T, K, E)
           - onehot)
    pos = torch.einsum("tke,tke->tk", pos, onehot).to(torch.int64)
    return logits, sel, weights, pos, pos < C, C


def moe(x: torch.Tensor, p: Dict, cfg: ModelConfig) -> torch.Tensor:
    """Dropped-token top-K MoE with capacity, scatter/gather dispatch.

    The reference's ``moe`` with one block of tokens: T = B * S tokens,
    capacity ``C = max(int(capacity_factor * T * K / E), 1)`` clipped to
    T (``route``). A choice past C drops (weight 0) to a sentinel slot,
    whose gather reads 0."""
    if cfg.dropless:
        return moe_dropless(x, p, cfg)
    if cfg.held_experts != cfg.n_experts:
        raise ValueError(f"{cfg.held_experts} of {cfg.n_experts} experts "
                         f"held: a share of the experts routes dropless")
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, D)
    _, sel, weights, pos, keep, C = route(xt, p["router"], cfg)
    weights = torch.where(keep, weights, torch.zeros_like(weights))

    # destination slots; overflow goes to the sentinel slot E * C
    dest = torch.where(keep, sel * C + pos,
                       torch.full_like(pos, E * C)).reshape(T * K)
    src = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    ex_in = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    ex_in[dest] = src
    ex_in = ex_in[:E * C].reshape(E, C, D)

    if cfg.mlp_type == "swiglu":
        g = torch.einsum("ecd,edf->ecf", ex_in, p["w_gate"])
        h = torch.einsum("ecd,edf->ecf", ex_in, p["w_in"])
        h = F.silu(g) * h
    else:
        h = F.gelu(torch.einsum("ecd,edf->ecf", ex_in, p["w_in"]),
                   approximate="tanh")
    ex_out = torch.einsum("ecf,efd->ecd", h, p["w_out"])   # (E, C, D)

    ex_out = torch.cat([ex_out.reshape(E * C, D),
                        torch.zeros((1, D), dtype=ex_out.dtype,
                                    device=ex_out.device)])
    gathered = ex_out[dest].reshape(T, K, D)
    out = torch.einsum("tkd,tk->td", gathered, weights.to(x.dtype))

    if cfg.n_shared_experts > 0:
        out = out + mlp(x, p, cfg, prefix="shared_w").reshape(T, D)
    return out.reshape(B, S, D)


def grouped_mm(rows: torch.Tensor, weights: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """Grouped product, one launch for all groups: rows (R, K), weights
    (G, K, N), ``offsets`` (G,) int32 on the rows' device, the end of each
    group's rows (group g is rows ``offsets[g - 1]`` up to ``offsets[g]``,
    from 0). Returns (R, N); rows past ``offsets[-1]`` are computed by no
    group and their values are undefined. Every grouped product of the MoE
    goes through here."""
    return torch._grouped_mm(rows, weights, offs=offsets)


def moe_dropless(x: torch.Tensor, p: Dict, cfg: ModelConfig
                 ) -> torch.Tensor:
    """Top-K MoE without capacity, over the experts held here.

    Routes each of the T = B * S tokens over all ``n_experts``
    (``choose``); of the T * K choices, those of experts ``0 ..
    held_experts - 1`` are ordered by expert (a stable sort: token order
    within an expert) ahead of the rest, with each expert's end offset
    found on the device, so nothing waits for the host. Gate, up and down
    are one ``grouped_mm`` each over those rows alone; each choice's
    result, back in (token, choice) order, is weighted by its softmax
    weight, and a choice of an expert held elsewhere adds nothing. The
    shared expert is added once.

    Traced (``repro_torch.obs``): spans ``moe.route`` and ``moe.experts``;
    counts ``moe.choices`` (T * K) and ``moe.local_rows``, the rows the
    grouped products compute, added on the device only while tracing and
    read when the counts are read. Experts are SwiGLUs (the one dropless
    configuration, granite's)."""
    if cfg.mlp_type != "swiglu":
        raise ValueError(f"mlp_type {cfg.mlp_type!r}: dropless experts are "
                         f"SwiGLUs")
    B, S, D = x.shape
    K, E = cfg.experts_per_token, cfg.held_experts
    T = B * S
    xt = x.reshape(T, D)
    with obs.span("moe.route", cat="model"):
        _, sel, weights = choose(xt, p["router"], cfg)
        local = sel < E
        key, order = torch.sort(torch.where(local, sel, E).reshape(T * K),
                                stable=True)
        offsets = torch.searchsorted(
            key, torch.arange(E, device=x.device), right=True
        ).to(torch.int32)
        rows = xt[order // K]                       # local rows first
    obs.count("moe.choices", T * K)
    if obs.is_enabled():
        obs.count("moe.local_rows", offsets[-1].to(torch.int64))
    with obs.span("moe.experts", cat="model"):
        h = F.silu(grouped_mm(rows, p["w_gate"], offsets)) * grouped_mm(
            rows, p["w_in"], offsets)
        y = grouped_mm(h, p["w_out"], offsets)
        back = torch.empty_like(order).scatter_(
            0, order, torch.arange(T * K, device=x.device))
        y = torch.where(local[..., None], y[back].reshape(T, K, D),
                        torch.zeros((), dtype=y.dtype, device=y.device))
        out = torch.einsum("tk,tkd->td", weights.to(x.dtype), y)
        if cfg.n_shared_experts > 0:
            out = out + mlp(x, p, cfg, prefix="shared_w").reshape(T, D)
    return out.reshape(B, S, D)


__all__ = ["NEG_INF", "rmsnorm", "rope", "chunked_attention",
           "attention_layer", "decode_attention", "mlp", "moe", "route",
           "top_k", "choose", "grouped_mm", "moe_dropless"]
