"""train_step / loss: next-token LM objective with microbatched grad accumulation.

TrainState is a plain dict (checkpoint-friendly via ``repro_torch.store``):
  {"params": <nested model params>, "opt": OptState, "step": int32 0-dim,
   ["err": error-feedback tree when gradient compression is on]}

The arithmetic is the reference package's ``repro/train/step.py``;
autograd gives the gradients. A step is functional: it returns a new
state and updates no tensor of the old one in place, so a checkpoint
snapshot of the old state stays valid.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch.common.tree import leaves, tree_map, unflatten
from repro_torch.dist import compression
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import _nested, forward, init_params
from repro_torch.optim import adamw


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL. logits: (B, S, V)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(lse - label_logit)


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits = forward(cfg, params, batch)
        tokens = batch["tokens"].to(torch.int64)
        return cross_entropy(logits[:, :-1], tokens[:, 1:])
    return loss_fn


def init_state(cfg: ModelConfig, seed: int = 0, compress_grads: bool = False,
               device: Union[str, torch.device] = "cpu") -> Dict[str, Any]:
    """A fresh train state on ``device``, with parameters drawn from a
    ``torch.Generator`` seeded with ``seed`` on that device."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    params = _nested(init_params(cfg, gen))
    state = {"params": params, "opt": adamw.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if compress_grads:
        state["err"] = compression.init_error_state(params)
    return state


def _value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)`` by autograd; ``params``
    are neither modified nor left with ``.grad``."""
    flat = leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), unflatten(params, list(grads))


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    n_microbatches: int = 1, compress_grads: bool = False):
    """Build train_step(state, batch) -> (state, metrics).

    Microbatching loops over ``n_microbatches`` slices of the global batch
    and accumulates fp32 gradients — peak activation memory scales with
    the microbatch, not the global batch. Gradient compression (int8 +
    error feedback) models the cross-pod reduction (dist/compression.py).
    """
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    loss_fn = make_loss_fn(cfg)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]

        if n_microbatches == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses = []
            for i in range(n_microbatches):
                mb = {k: v.reshape((n_microbatches, v.shape[0]
                                    // n_microbatches) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                l, g = _value_and_grad(loss_fn, params, mb)
                grads = tree_map(lambda a, x: a + x.to(torch.float32),
                                 grads, g)
                losses.append(l)
            grads = tree_map(lambda g: g / n_microbatches, grads)
            loss = torch.mean(torch.stack(losses))

        new_state = dict(state)
        if compress_grads:
            grads, new_err = compression.compress_gradients(grads,
                                                            state["err"])
            new_state["err"] = new_err

        new_params, new_opt, metrics = adamw.update(opt_cfg, grads,
                                                    state["opt"], params)
        new_state.update(params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        metrics["loss"] = loss
        return new_state, metrics

    return train_step
