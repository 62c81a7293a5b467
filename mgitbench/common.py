"""Shared pieces of the generators: the port's model configuration, host
copies of weights, and the card's kernels built before a window."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch


def port_config(model: dict):
    """The port's ``ModelConfig`` of a configuration file's ``model``."""
    from repro_torch.models.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in model.items() if k in names})


def host_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host: float32 as float32, bfloat16 as its bits in a
    uint16 array (the reference's form)."""
    if t.dtype == torch.bfloat16:
        return t.detach().view(torch.int16).cpu().numpy().view(np.uint16)
    return t.detach().cpu().numpy()


def host_weights(flat: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: host_bits(v) for k, v in flat.items()}


def build_kernels(run, names) -> None:
    """Build (or find built) the CUDA kernels ``names`` and load them, so
    that no build or first load falls inside the window."""
    if run.device != "cuda":
        return
    from repro_torch.kernels import build
    build.build(list(names))
    for name in names:
        build.library(name)
