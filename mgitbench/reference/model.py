"""A language model in plain torch, float32.

Written from the published equations, at the port's conventions (the
configuration file's ``assumed`` says where they depart from the source):
the token embedding times sqrt(d_model), the layers of the model's family
(``mgitbench/families/<family>.py``: ``layer``), a final RMSNorm scaled by
1 + w, and the output head (tied to the embedding where the configuration
says so).

Every product runs in float32 with TF32 off, unless ``lower`` names the
precision of the control: "tf32" or "bfloat16" round both operands of
every product to that precision first, "float8_e4m3" rounds them to fp8
e4m3 with one scale per tensor. Products still accumulate in float32.

Weights are the flat {path: tensor} dict of ``mgitbench.weights``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from mgitbench.families import family


def round_to(x: torch.Tensor, lower: Optional[str]) -> torch.Tensor:
    if lower is None:
        return x
    if lower == "tf32":           # 10 mantissa bits, nearest even
        u = x.contiguous().view(torch.int32)
        u = (u + 0xFFF + ((u >> 13) & 1)) & ~0x1FFF
        return u.view(torch.float32)
    if lower == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    if lower == "float8_e4m3":
        s = torch.clamp(x.abs().amax(), min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    raise ValueError(f"unknown precision {lower!r}")


class Model:
    def __init__(self, m: dict, params: Dict[str, torch.Tensor],
                 lower: Optional[str] = None):
        self.m = m
        self.p = {k: v.to(torch.float32) for k, v in params.items()}
        self.lower = lower

    def mm(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, round_to(a, self.lower),
                            round_to(b, self.lower))

    def rmsnorm(self, x, w):
        eps = self.m.get("norm_eps", 1e-6)
        return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
            * (1.0 + w)

    def logits(self, tokens: torch.Tensor, first: int) -> torch.Tensor:
        """(B, T - first, V) logits at positions ``first`` .. T - 1."""
        with _no_tf32():
            m, p = self.m, self.p
            x = p["embed/tok"][tokens] * math.sqrt(m["d_model"])
            layer = family(m).layer
            for i in range(m["n_layers"]):
                x = layer(self, x, i)
            x = self.rmsnorm(x[:, first:], p["final_norm"])
            head = (p["embed/tok"].T if m.get("tie_embeddings")
                    else p["lm_head"])
            return self.mm("bsd,dv->bsv", x, head)


class _no_tf32:
    """Float32 products stay float32 inside the reference."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False


def served_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor
                ) -> torch.Tensor:
    """How far below the reference's best logit each served token's
    reference logit lies: (B, n) for ref_logits (B, n, V), tokens (B, n)."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tokens[..., None].long())[..., 0]
    return best - got
