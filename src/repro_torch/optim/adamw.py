"""AdamW, line for line as the reference package's ``repro/optim/adamw.py``.

Moments are float32 whatever the parameters' dtype; the update runs in
float32 and casts back. The arithmetic is the reference's, not
``torch.optim.AdamW``'s: the bias corrections divide ``m`` and ``v``
separately, ``eps`` is added to ``sqrt(v / b2c)``, the weight decay joins
the step before the learning rate scales it, the learning rate follows
:func:`schedule` (linear warmup, cosine decay), and gradients are clipped
by their global norm. Every function is functional: it returns new
tensors and updates nothing in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.common.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


class OptState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def init(params) -> OptState:
    first = leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return OptState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=first.device))


def state_regime(key: str) -> str:
    """Storage regime of one flattened train-state leaf (DESIGN.md §15).

    ``moment2`` (AdamW nu) is stored in the log domain in the lossy
    checkpoint tier; ``moment1`` (mu) and ``params`` take the standard
    sparse-delta path. Keys follow ``flatten_state``'s layout:
    ``opt/mu/...``, ``opt/nu/...``, ``params/...``."""
    if key.startswith("opt/nu/"):
        return "moment2"
    if key.startswith("opt/mu/"):
        return "moment1"
    return "params"


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in leaves(tree)))


def update(cfg: AdamWConfig, grads, state: OptState, params):
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    count = state.count + 1
    gnorm = global_norm(grads)
    # a tensor numerator: PyTorch computes ``float / tensor`` as a
    # reciprocal times the float, which rounds differently
    clip = torch.tensor(cfg.grad_clip, dtype=torch.float32,
                        device=gnorm.device)
    scale = (torch.clamp(clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.to(torch.float32)
    b2c = 1 - cfg.b2 ** count.to(torch.float32)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        step = step + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype), m, v

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        leaves(grads), leaves(state.mu), leaves(state.nu), leaves(params))]
    new_p = unflatten(grads, [o[0] for o in out])
    new_m = unflatten(grads, [o[1] for o in out])
    new_v = unflatten(grads, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(new_m, new_v, count), metrics
