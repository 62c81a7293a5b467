"""The dense decoder: attention and an MLP in every layer.

Reference (plain torch, float32): a pre-norm (RMSNorm scaled by 1 + w),
causal softmax attention with rotary positions over the two halves of
each head, and a tanh-GELU or SwiGLU MLP.
"""

import math

import torch
import torch.nn.functional as F

KERNELS = ("flash_attention",)
UNIFORM = ()


def head_dim(m: dict) -> int:
    return m["head_dim"] or m["d_model"] // m["n_heads"]


def layer_specs(m: dict) -> dict:
    L, D, dt = m["n_layers"], m["d_model"], m["dtype"]
    hd, Hq, Hkv, F_ = head_dim(m), m["n_heads"], m["n_kv_heads"], m["d_ff"]
    s = {"layers/attn/wq": ((L, D, Hq * hd), dt),
         "layers/attn/wk": ((L, D, Hkv * hd), dt),
         "layers/attn/wv": ((L, D, Hkv * hd), dt),
         "layers/attn/wo": ((L, Hq * hd, D), dt),
         "layers/mlp/w_in": ((L, D, F_), dt),
         "layers/mlp/w_out": ((L, F_, D), dt),
         "layers/ln1": ((L, D), dt),
         "layers/ln2": ((L, D), dt)}
    if m.get("mlp_type", "swiglu") == "swiglu":
        s["layers/mlp/w_gate"] = ((L, D, F_), dt)
    return s


def init(leaf: str, normal, uniform, std: float):
    return std * normal


def token_ops(m: dict) -> int:
    """Matrix products of one token through every layer (attention
    projections and the MLP), without attention scores."""
    D, hd = m["d_model"], head_dim(m)
    Hq, Hkv = m["n_heads"], m["n_kv_heads"]
    attn = D * (Hq + 2 * Hkv) * hd + Hq * hd * D
    mlp = (3 if m.get("mlp_type", "swiglu") == "swiglu" else 2) * D * m["d_ff"]
    return 2 * m["n_layers"] * (attn + mlp)


def context_ops(m: dict, tokens: int) -> int:
    """Attention scores and values of ``tokens`` causal tokens: token t
    sees t + 1 keys, 4 * hd operations a (query, key) pair and head."""
    pairs = tokens * (tokens + 1) // 2
    return 4 * m["n_layers"] * m["n_heads"] * head_dim(m) * pairs


def rope(m: dict, x, pos):
    half = x.shape[-1] // 2
    freqs = 1.0 / m.get("rope_theta", 10000.0) ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos[:, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def layer(model, x, i):
    m, p = model.m, model.p
    B, T, D = x.shape
    hd, Hq, Hkv = head_dim(m), m["n_heads"], m["n_kv_heads"]
    h = model.rmsnorm(x, p["layers/ln1"][i])
    q, k, v = (model.mm("btd,dh->bth", h, p[f"layers/attn/{w}"][i])
               .view(B, T, n, hd)
               for w, n in (("wq", Hq), ("wk", Hkv), ("wv", Hkv)))
    pos = torch.arange(T, device=x.device)
    q, k = rope(m, q, pos), rope(m, k, pos)
    k = k.repeat_interleave(Hq // Hkv, dim=2)
    v = v.repeat_interleave(Hq // Hkv, dim=2)
    s = model.mm("bqhd,bkhd->bhqk", q * hd ** -0.5, k)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    a = model.mm("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    x = x + model.mm("bth,hd->btd", a.reshape(B, T, Hq * hd),
                     p["layers/attn/wo"][i])
    h = model.rmsnorm(x, p["layers/ln2"][i])
    u = model.mm("btd,df->btf", h, p["layers/mlp/w_in"][i])
    if "layers/mlp/w_gate" in p:
        gate = model.mm("btd,df->btf", h, p["layers/mlp/w_gate"][i])
        u = F.silu(gate) * u
    else:
        u = 0.5 * u * (1.0 + torch.tanh(
            math.sqrt(2.0 / math.pi) * (u + 0.044715 * u ** 3)))
    return x + model.mm("btf,fd->btd", u, p["layers/mlp/w_out"][i])
