"""Mamba2 / SSD (state-space duality) layer: chunked scan + O(1) decode.

The reference package's ``repro/models/ssm.py`` in plain torch. Train and
prefill use the SSD chunked algorithm (quadratic attention-like math
inside chunks of ``Q`` tokens, a linear recurrence across chunks); decode
keeps a constant-size (H, N, P) state per layer.

The reference writes its three-operand contractions as one ``einsum``
each. Here each is two products taken in turn, so that no (B, nc, Q, Q,
H, P) intermediate is built: at mamba2-780m's prefill of 8 x 512 tokens
that tensor would take about 13 GB in f32. The scan over chunks is a loop.

Parameter layout per layer (stacked over L in the model):
  in_proj: (D, 2*d_inner + 2*G*N + H)   [z | x | B | C | dt]
  conv_w : (K, d_inner + 2*G*N)         depthwise causal conv
  conv_b : (d_inner + 2*G*N,)           its bias, with cfg.ssm_conv_bias
  A_log, dt_bias, D: (H,)               float32 in every model dtype
  norm   : (d_inner,)  gated RMSNorm before out_proj
  out_proj: (d_inner, D)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import shard
from repro_torch.models.config import ModelConfig

G = 1  # B/C groups (mamba2 default: single group broadcast over heads)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_in = cfg.d_inner
    N = cfg.ssm_state
    H = cfg.n_ssm_heads
    return torch.split(zxbcdt, [d_in, d_in, G * N, G * N, H], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 cache: Optional[torch.Tensor] = None,
                 b: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B,S,Cd), w: (K,Cd), bias b: (Cd,) or
    None. Returns (y, new_cache)."""
    K = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = cache
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, Cd)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    if b is not None:
        y = y + b
    new_cache = xp[:, -(K - 1):] if K > 1 else pad
    return y, new_cache


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """SSD over chunks. xh: (B,S,H,P); dt: (B,S,H); A: (H,) (negative);
    Bm, Cm: (B,S,N) (group broadcast over heads). Returns (y, final_state)."""
    Bb, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    while S % Q:  # largest divisor <= requested chunk (exact tiling)
        Q -= 1
    nc = S // Q

    xd = (xh * dt[..., None]).reshape(Bb, nc, Q, H, P)
    dA = (dt * A).reshape(Bb, nc, Q, H)                     # (B,nc,Q,H) <= 0
    cs = torch.cumsum(dA, dim=2)                            # within-chunk cumsum
    Bc = Bm.reshape(Bb, nc, Q, N)
    Cc = Cm.reshape(Bb, nc, Q, N)

    # intra-chunk (quadratic in Q): L[i,j] = exp(cs_i - cs_j) for i >= j
    rel = cs[:, :, :, None, :] - cs[:, :, None, :, :]       # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    rel = torch.where(mask[None, None, :, :, None], rel,
                      torch.full_like(rel, -1e30))          # mask pre-exp
    L = torch.exp(rel)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)        # (B,nc,Q,Q)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * L, xd)

    # chunk-final states: S_c = sum_j exp(cs_Q - cs_j) B_j x_j^T
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)         # (B,nc,Q,H)
    S_c = torch.einsum("bcjn,bcjhp->bchnp", Bc,
                       decay_to_end[..., None] * xd)

    # inter-chunk linear recurrence over nc
    chunk_decay = torch.exp(cs[:, :, -1, :])                # (B,nc,H)
    state = (torch.zeros((Bb, H, N, P), dtype=torch.float32, device=xh.device)
             if init_state is None else init_state.to(torch.float32))
    prev = []
    for c in range(nc):
        prev.append(state)                                  # state BEFORE chunk
        state = (state * chunk_decay[:, c].to(torch.float32)[..., None, None]
                 + S_c[:, c].to(torch.float32))
    prev_states = torch.stack(prev, dim=1)                  # (B,nc,H,N,P)

    # inter-chunk contribution: C_i . (decay_i * state_prev)
    decay_in = torch.exp(cs)                                # (B,nc,Q,H)
    y_inter = (torch.einsum("bcin,bchnp->bcihp", Cc,
                            prev_states.to(Cc.dtype))
               * decay_in[..., None])
    y = (y_intra + y_inter).reshape(Bb, S, H, P)
    return y, state


def ssm_layer(x: torch.Tensor, p: Dict, cfg: ModelConfig,
              cache: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full Mamba2 block. cache={"state": (B,H,N,P), "conv": (B,K-1,Cd)}.

    Returns (out, new_cache): a new state and conv window, as the
    reference does; the model writes them into its stacked cache."""
    Bb, S, D = x.shape
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    zxbcdt = torch.einsum("bsd,dk->bsk", x, p["in_proj"])
    z, xs, Bm, Cm, dt = _split_proj(cfg, zxbcdt)

    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"],
                                      cache["conv"] if cache else None,
                                      p.get("conv_b"))
    conv_out = F.silu(conv_out)
    xs = conv_out[..., :cfg.d_inner]
    Bm = conv_out[..., cfg.d_inner:cfg.d_inner + G * N]
    Cm = conv_out[..., cfg.d_inner + G * N:]

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])         # (B,S,H)
    A = -torch.exp(p["A_log"].to(torch.float32))                  # (H,)
    xh = xs.reshape(Bb, S, H, P)
    xh = shard(xh, ("pod", "data"), None, "model", None)

    f32 = torch.float32
    if cache is None:
        y, _ = ssd_chunked(xh.to(f32), dt, A, Bm.to(f32), Cm.to(f32),
                           cfg.ssm_chunk)
        new_cache = None
    elif S > 1:
        # prefill: chunked SSD over the whole prompt (not the recurrent
        # per-token scan), carrying the state in and out of the cache
        y, final_state = ssd_chunked(xh.to(f32), dt, A, Bm.to(f32),
                                     Cm.to(f32), cfg.ssm_chunk,
                                     init_state=cache["state"])
        new_cache = {"state": final_state, "conv": new_conv}
    else:
        # O(1) recurrent decode: per-step state update
        state = cache["state"].to(f32)
        ys = []
        for t in range(S):
            xh_t, dt_t = xh[:, t].to(f32), dt[:, t]
            B_t, C_t = Bm[:, t].to(f32), Cm[:, t].to(f32)
            dA = torch.exp(dt_t * A)                              # (B,H)
            dBx = torch.einsum("bh,bn,bhp->bhnp", dt_t, B_t, xh_t)
            state = state * dA[..., None, None] + dBx
            ys.append(torch.einsum("bn,bhnp->bhp", C_t, state))
        y = torch.stack(ys, dim=1)                                # (B,S,H,P)
        new_cache = {"state": state, "conv": new_conv}

    y = y + xh.to(f32) * p["D"][None, None, :, None]
    y = y.reshape(Bb, S, cfg.d_inner).to(x.dtype)
    y = y * F.silu(z)
    # gated RMSNorm (mamba2 places a norm before out_proj)
    var = torch.mean(torch.square(y.to(f32)), dim=-1, keepdim=True)
    y = (y.to(f32) * torch.rsqrt(var + cfg.norm_eps)
         * (1.0 + p["norm"])).to(x.dtype)
    out = torch.einsum("bsk,kd->bsd", y, p["out_proj"])
    return shard(out, ("pod", "data"), None, None), new_cache


__all__ = ["ssd_chunked", "ssm_layer"]
