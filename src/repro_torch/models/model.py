"""Parameter templates and initialisation (dense family).

``param_shapes`` gives the same flat ``{path: shape}`` as the reference
package's ``repro/models/model.py::param_shapes`` for the dense family, and
``init_params`` draws the same distributions (``_init_one``'s scaling)
from a ``torch.Generator``. The two packages' random streams differ, so
tests that need equal weights make them with numpy and carry them across
with ``repro_torch.convert``. The forward pass and the other families
arrive with the models and training slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.ref import torch_dtype
from repro_torch.models.config import ModelConfig

MODELS_ITEM = "models and training slice"
_NORM_LEAVES = ("ln1", "ln2", "ln_cross", "final_norm", "enc_final_norm",
                "norm", "q_norm", "k_norm")


def _attn_shapes(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Tuple]:
    hd = cfg.resolved_head_dim
    s = {
        "wq": lead + (cfg.d_model, cfg.n_heads * hd),
        "wk": lead + (cfg.d_model, cfg.n_kv_heads * hd),
        "wv": lead + (cfg.d_model, cfg.n_kv_heads * hd),
        "wo": lead + (cfg.n_heads * hd, cfg.d_model),
    }
    if cfg.qk_norm:
        s["q_norm"] = lead + (hd,)
        s["k_norm"] = lead + (hd,)
    return s


def _mlp_shapes(cfg: ModelConfig, lead: Tuple[int, ...], prefix: str = "w"
                ) -> Dict[str, Tuple]:
    s = {f"{prefix}_in": lead + (cfg.d_model, cfg.d_ff),
         f"{prefix}_out": lead + (cfg.d_ff, cfg.d_model)}
    if cfg.mlp_type == "swiglu":
        s[f"{prefix}_gate"] = lead + (cfg.d_model, cfg.d_ff)
    return s


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple]:
    """Flat {path: shape} for the whole model (dense family)."""
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"family {cfg.family!r}: only dense models are ported so far "
            f"(ROADMAP item '{MODELS_ITEM}')")
    L = cfg.n_layers
    shapes: Dict[str, Tuple] = {"embed/tok": (cfg.vocab_size, cfg.d_model)}
    for k, v in _attn_shapes(cfg, (L,)).items():
        shapes[f"layers/attn/{k}"] = v
    for k, v in _mlp_shapes(cfg, (L,)).items():
        shapes[f"layers/mlp/{k}"] = v
    shapes["layers/ln1"] = (L, cfg.d_model)
    shapes["layers/ln2"] = (L, cfg.d_model)
    shapes["final_norm"] = (cfg.d_model,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_size)
    return shapes


def _init_one(path: str, shape: Tuple, cfg: ModelConfig,
              generator: torch.Generator) -> torch.Tensor:
    dtype = torch_dtype(cfg.dtype)
    if path.rsplit("/", 1)[-1] in _NORM_LEAVES:
        return torch.zeros(shape, dtype=dtype,
                           device=generator.device)  # 1+w convention
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 1.0 / np.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * scale).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator
                ) -> Dict[str, torch.Tensor]:
    """Random parameters as a flat ``{path: tensor}`` in sorted path order,
    drawn from ``generator`` on its device."""
    return {p: _init_one(p, s, cfg, generator)
            for p, s in sorted(param_shapes(cfg).items())}
