"""Mamba2 (arXiv:2405.21060): a state-space block in every layer.

Reference (plain torch, float32): a pre-norm, in_proj into
z | x | B | C | dt, a causal depthwise convolution and SiLU over x | B | C,
dt = softplus(dt + dt_bias), A = -exp(A_log), the recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t + D x_t,
y * SiLU(z) under an RMSNorm scaled by 1 + w, and out_proj. The
recurrence is evaluated exactly in blocks of ``SCAN_BLOCK`` tokens (its
closed form inside a block).
"""

import math

import torch
import torch.nn.functional as F

KERNELS = ()
# leaves kept in float32 in every model dtype (the port's convention),
# drawn from a uniform: mamba_ssm's Mamba2 init
UNIFORM = ("A_log", "dt_bias", "D")
SCAN_BLOCK = 128


def sizes(m: dict):
    """(N, d_inner, H, K): state, inner width, heads, convolution width."""
    d_in = m["ssm_expand"] * m["d_model"]
    return (m["ssm_state"], d_in, d_in // m["ssm_head_dim"],
            m.get("ssm_conv_width", 4))


def layer_specs(m: dict) -> dict:
    L, D, dt = m["n_layers"], m["d_model"], m["dtype"]
    N, d_in, H, K = sizes(m)
    return {"layers/ssm/in_proj": ((L, D, 2 * d_in + 2 * N + H), dt),
            "layers/ssm/conv_w": ((L, K, d_in + 2 * N), dt),
            "layers/ssm/A_log": ((L, H), "float32"),
            "layers/ssm/dt_bias": ((L, H), "float32"),
            "layers/ssm/D": ((L, H), "float32"),
            "layers/ssm/norm": ((L, d_in), dt),
            "layers/ssm/out_proj": ((L, d_in, D), dt),
            "layers/ln1": ((L, D), dt)}


def init(leaf: str, normal, uniform, std: float):
    """A_log = log(U(1, 16)); dt_bias = softplus^-1(dt), dt log-uniform in
    [1e-3, 1e-1]; D = 1 + N(0, std); the rest N(0, std)."""
    if leaf == "A_log":
        return torch.log(1.0 + 15.0 * uniform)
    if leaf == "dt_bias":
        dtv = torch.exp(math.log(1e-3) + uniform * math.log(100.0))
        return dtv + torch.log(-torch.expm1(-dtv))
    if leaf == "D":
        return 1.0 + std * normal
    return std * normal


def token_ops(m: dict) -> int:
    """One token through every layer: in_proj, the depthwise convolution,
    the recurrence (state update and read-out, 4 * d_inner * N) and
    out_proj."""
    D = m["d_model"]
    N, d_in, H, K = sizes(m)
    in_proj = D * (2 * d_in + 2 * N + H)
    conv = K * (d_in + 2 * N)
    return m["n_layers"] * (2 * in_proj + 2 * conv + 4 * d_in * N
                            + 2 * d_in * D)


def context_ops(m: dict, tokens: int) -> int:
    return 0


def layer(model, x, i):
    m, p = model.m, model.p
    B, T, D = x.shape
    N, d_in, H, K = sizes(m)
    P = m["ssm_head_dim"]
    w = {k.rsplit("/", 1)[-1]: v[i] for k, v in p.items()
         if k.startswith("layers/ssm/")}
    h = model.rmsnorm(x, p["layers/ln1"][i])
    zxbcdt = model.mm("btd,dk->btk", h, w["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * N, H], -1)
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(xp[:, j:j + T] * w["conv_w"][j] for j in range(K))
    xs, Bm, Cm = torch.split(F.silu(conv), [d_in, N, N], -1)
    dt = F.softplus(dt + w["dt_bias"])                   # (B, T, H)
    A = -torch.exp(w["A_log"])                           # (H,)
    xh = xs.reshape(B, T, H, P)
    y = scan(model, xh, dt, A, Bm, Cm) + xh * w["D"][:, None]
    y = y.reshape(B, T, d_in) * F.silu(z)
    y = model.rmsnorm(y, w["norm"])
    return x + model.mm("btk,kd->btd", y, w["out_proj"])


def scan(model, xh, dt, A, Bm, Cm):
    """y_t = C_t . h_t for h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    exactly, a block of tokens at a time."""
    B, T, H, P = xh.shape
    N = Bm.shape[-1]
    h = xh.new_zeros(B, H, P, N)
    out = []
    for t0 in range(0, T, SCAN_BLOCK):
        sl = slice(t0, min(t0 + SCAN_BLOCK, T))
        a = dt[:, sl] * A                                # (B, c, H)
        cum = torch.cumsum(a, 1)
        c = a.shape[1]
        rel = cum[:, :, None, :] - cum[:, None, :, :]    # (B, t, s, H)
        keep = torch.ones(c, c, dtype=torch.bool, device=xh.device).tril()
        decay = torch.exp(rel.masked_fill(~keep[None, :, :, None],
                                          float("-inf")))
        g = model.mm("btn,bsn->bts", Cm[:, sl], Bm[:, sl])
        wts = decay * g[..., None] * dt[:, None, sl, :]  # (B, t, s, H)
        y = model.mm("btsh,bshp->bthp", wts, xh[:, sl])
        y = y + model.mm("btn,bhpn->bthp", Cm[:, sl], h) \
            * torch.exp(cum)[..., None]
        tail = torch.exp(cum[:, -1:, :] - cum) * dt[:, sl]   # (B, s, H)
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + model.mm(
            "bshp,bsn->bhpn", xh[:, sl] * tail[..., None], Bm[:, sl])
        out.append(y)
    return torch.cat(out, 1)
