"""Granite-4.0-H (``granitemoehybrid``): Mamba2 and attention in periods,
with a dropless mixture of experts after every mixer.

Reference (plain torch, float32), from the published configuration and
its model's equations. Layer i of the stack is sublayer
j = i % ``attn_period`` of group g = i // ``attn_period``:

* a pre-norm (RMSNorm scaled by 1 + w), then the mixer: at j =
  ``attn_offset`` causal softmax attention with grouped K/V heads, no
  positional encoding, and scores scaled by ``attention_multiplier``;
  elsewhere the Mamba2 block of ``families/ssm.py`` (in_proj into
  z | x | B | C | dt, a causal depthwise convolution with a bias and SiLU,
  the exact recurrence of ``ssm.scan``, D x, the RMSNorm of y * SiLU(z),
  out_proj); its output times ``residual_multiplier`` is added;
* a pre-norm, then the MoE: router logits over all ``n_experts``, each
  token's ``experts_per_token`` largest, a softmax over those; each
  expert held here (0 .. ``n_local_experts`` - 1) runs its SwiGLU over
  the tokens that chose it, weighted; the shared SwiGLU expert (width
  ``shared_d_ff``) over every token; the sum times ``residual_multiplier``
  is added. Experts held elsewhere add nothing, as in the program (the
  configuration's share of a deployment).

Departures, at the benchmark's conventions (the configuration's
``assumed`` says the same):

* ``reference/model.py`` multiplies the embedding by sqrt(d_model); layer
  0 rescales it by ``embedding_multiplier`` / sqrt(d_model), so the stack
  sees the embedding times ``embedding_multiplier``;
* the logits are not divided by ``logits_scaling``: an exact power-of-two
  scale changes no greedy token, and the check's gaps stay in undivided
  units;
* layers past the last whole period are not run, as the program's layout
  holds whole groups only.

The layout is the program's: ``groups/...`` leaves stacked over (groups,
sublayers of a kind).
"""

import math

import torch
import torch.nn.functional as F

from mgitbench.families import ssm

KERNELS = ("flash_attention",)
UNIFORM = ssm.UNIFORM
Q_BLOCK = 1024      # query rows of the reference's attention at a time
# the embedding's standard deviation: with Granite's embedding multiplier
# of 12 and the head tied to the embedding, a N(0, 0.02) embedding puts the
# input token's own logit about 12 standard deviations of the others above
# them, so a random-weight model copies its input and no precision flips a
# token (the fp8 control read a gap of 0 on the card); at 0.004 it does not
EMBED_STD = 0.004


def init(leaf: str, normal, uniform, std: float):
    """As ``ssm.init``, but the embedding N(0, ``EMBED_STD``)."""
    if leaf == "tok":
        return EMBED_STD * normal
    return ssm.init(leaf, normal, uniform, std)


def counts(m: dict):
    """(groups, Mamba2 sublayers a group, sublayers a group): every
    sublayer has a MoE, one in each group is attention."""
    period = m["attn_period"]
    return m["n_layers"] // period, period - 1, period


def held(m: dict) -> int:
    return m.get("n_local_experts") or m["n_experts"]


def head_dim(m: dict) -> int:
    return m["head_dim"] or m["d_model"] // m["n_heads"]


def layer_specs(m: dict) -> dict:
    D, dt = m["d_model"], m["dtype"]
    ng, n_ssm, period = counts(m)
    N, d_in, H, K = ssm.sizes(m)
    hd, Hq, Hkv = head_dim(m), m["n_heads"], m["n_kv_heads"]
    E, F_, Fs = held(m), m["d_ff"], m["shared_d_ff"]
    a, s, e = (ng,), (ng, n_ssm), (ng, period)
    return {"groups/attn/wq": (a + (D, Hq * hd), dt),
            "groups/attn/wk": (a + (D, Hkv * hd), dt),
            "groups/attn/wv": (a + (D, Hkv * hd), dt),
            "groups/attn/wo": (a + (Hq * hd, D), dt),
            "groups/ssm/in_proj": (s + (D, 2 * d_in + 2 * N + H), dt),
            "groups/ssm/conv_w": (s + (K, d_in + 2 * N), dt),
            "groups/ssm/conv_b": (s + (d_in + 2 * N,), dt),
            "groups/ssm/A_log": (s + (H,), "float32"),
            "groups/ssm/dt_bias": (s + (H,), "float32"),
            "groups/ssm/D": (s + (H,), "float32"),
            "groups/ssm/norm": (s + (d_in,), dt),
            "groups/ssm/out_proj": (s + (d_in, D), dt),
            "groups/moe/router": (e + (D, m["n_experts"]), dt),
            "groups/moe/w_gate": (e + (E, D, F_), dt),
            "groups/moe/w_in": (e + (E, D, F_), dt),
            "groups/moe/w_out": (e + (E, F_, D), dt),
            "groups/moe/shared_w_gate": (e + (D, Fs), dt),
            "groups/moe/shared_w_in": (e + (D, Fs), dt),
            "groups/moe/shared_w_out": (e + (Fs, D), dt),
            "groups/ln1": (e + (D,), dt),
            "groups/ln2": (e + (D,), dt)}


def token_ops(m: dict) -> int:
    """One token through the stack: each Mamba2 sublayer as
    ``ssm.token_ops`` counts one layer, the attention projections, and in
    every sublayer the router, the routed experts at their expected share
    here (``experts_per_token`` x held / ``n_experts`` SwiGLUs) and the
    shared expert."""
    D = m["d_model"]
    ng, n_ssm, period = counts(m)
    hd, Hq, Hkv = head_dim(m), m["n_heads"], m["n_kv_heads"]
    mamba = ssm.token_ops(dict(m, n_layers=1))
    attn = 2 * (D * (Hq + 2 * Hkv) * hd + Hq * hd * D)
    routed = m["experts_per_token"] * held(m) / m["n_experts"]
    moe = 2 * D * m["n_experts"] + round(
        6 * D * (routed * m["d_ff"] + m["shared_d_ff"]))
    return ng * (n_ssm * mamba + attn + period * moe)


def context_ops(m: dict, tokens: int) -> int:
    """Attention scores and values of ``tokens`` causal tokens in each
    group's attention sublayer: 4 * hd operations a (query, key) pair."""
    ng, _, _ = counts(m)
    pairs = tokens * (tokens + 1) // 2
    return 4 * ng * m["n_heads"] * head_dim(m) * pairs


def layer(model, x, i):
    m, p = model.m, model.p
    g, j = divmod(i, m["attn_period"])
    if i == 0:
        x = x * (m["embedding_multiplier"] / math.sqrt(m["d_model"]))
    if g >= counts(m)[0]:
        return x
    r = m["residual_multiplier"]
    h = model.rmsnorm(x, p["groups/ln1"][g, j])
    off = m["attn_offset"]
    if j == off:
        out = attention(model, h, g)
    else:
        out = mamba(model, h, g, j - (j > off))
    x = x + r * out
    h = model.rmsnorm(x, p["groups/ln2"][g, j])
    return x + r * experts(model, h, g, j)


def attention(model, h, g):
    m, p = model.m, model.p
    B, T, D = h.shape
    hd, Hq, Hkv = head_dim(m), m["n_heads"], m["n_kv_heads"]
    q, k, v = (model.mm("btd,dh->bth", h, p[f"groups/attn/{w}"][g])
               .view(B, T, n, hd)
               for w, n in (("wq", Hq), ("wk", Hkv), ("wv", Hkv)))
    k = k.repeat_interleave(Hq // Hkv, dim=2)
    v = v.repeat_interleave(Hq // Hkv, dim=2)
    q = q * m["attention_multiplier"]
    out = []
    for q0 in range(0, T, Q_BLOCK):
        qb = q[:, q0:q0 + Q_BLOCK]
        s = model.mm("bqhd,bkhd->bhqk", qb, k)
        seen = (torch.arange(T, device=h.device)[None, :]
                <= torch.arange(q0, q0 + qb.shape[1],
                                device=h.device)[:, None])
        s = s.masked_fill(~seen, float("-inf"))
        out.append(model.mm("bhqk,bkhd->bqhd", torch.softmax(s, -1), v))
    a = torch.cat(out, 1).reshape(B, T, Hq * hd)
    return model.mm("bth,hd->btd", a, p["groups/attn/wo"][g])


def mamba(model, h, g, k):
    m, p = model.m, model.p
    B, T, D = h.shape
    N, d_in, H, K = ssm.sizes(m)
    P = m["ssm_head_dim"]
    w = {n.rsplit("/", 1)[-1]: v[g, k] for n, v in p.items()
         if n.startswith("groups/ssm/")}
    zxbcdt = model.mm("btd,dk->btk", h, w["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * N, H], -1)
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(xp[:, j:j + T] * w["conv_w"][j] for j in range(K))
    xs, Bm, Cm = torch.split(F.silu(conv + w["conv_b"]), [d_in, N, N], -1)
    dt = F.softplus(dt + w["dt_bias"])                   # (B, T, H)
    A = -torch.exp(w["A_log"])                           # (H,)
    xh = xs.reshape(B, T, H, P)
    y = ssm.scan(model, xh, dt, A, Bm, Cm) + xh * w["D"][:, None]
    y = y.reshape(B, T, d_in) * F.silu(z)
    y = model.rmsnorm(y, w["norm"])
    return model.mm("btk,kd->btd", y, w["out_proj"])


def experts(model, h, g, j):
    m, p = model.m, model.p
    B, T, D = h.shape
    w = {n.rsplit("/", 1)[-1]: v[g, j] for n, v in p.items()
         if n.startswith("groups/moe/")}
    xt = h.reshape(B * T, D)
    logits = model.mm("td,de->te", xt, w["router"])
    top, sel = torch.topk(logits, m["experts_per_token"], dim=-1)
    gate = torch.softmax(top, -1)

    def swiglu(x, wg, wi, wo):
        u = F.silu(model.mm("td,df->tf", x, wg)) * model.mm("td,df->tf",
                                                            x, wi)
        return model.mm("tf,fd->td", u, wo)

    out = swiglu(xt, w["shared_w_gate"], w["shared_w_in"],
                 w["shared_w_out"])
    for e in range(held(m)):
        t, c = torch.nonzero(sel == e, as_tuple=True)
        if t.numel():
            y = swiglu(xt[t], w["w_gate"][e], w["w_in"][e], w["w_out"][e])
            out.index_add_(0, t, gate[t, c, None] * y)
    return out.reshape(B, T, D)
