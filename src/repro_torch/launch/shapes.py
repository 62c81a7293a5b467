"""The arch × shape cells of a dry run and their inputs as ``meta`` tensors.

The counterpart of the reference package's ``repro/launch/shapes.py``, on
one card: no mesh and no shardings. Cells, as in the reference:

  train_4k     seq 4096,    global batch 256, 16 microbatches -> train step
  prefill_32k  seq 32768,   batch 32    -> prefill
  decode_32k   seq 32768,   batch 128   -> one decode step (1 token, a
                                           cache of seq slots)
  long_500k    seq 524288,  batch 1     -> one decode step; sub-quadratic
                                           archs only (``cfg.subquadratic``)

``input_specs`` returns every input of a cell as ``torch.device("meta")``
tensors: shapes and dtypes, no allocation, so a full-size config runs on
any host. The ``_sharded`` names are kept for a reader comparing the two
files; here they shard nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.tree import tree_map
from repro_torch.models.config import ModelConfig, get_config
from repro_torch.models.model import cache_structs, param_structs
from repro_torch.optim.adamw import OptState

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int
    # microbatches for train cells (the activation-memory knob)
    microbatches: int = 1


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256, microbatches=16),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

DEC_LEN_CAP = 4096   # enc-dec: decoder stream capped (DESIGN.md §5)
CROSS_LEN = 4096     # enc-dec decode: encoder memory length


def cell_supported(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, ("full quadratic attention — long-context decode "
                       "skipped (DESIGN.md §5)")
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_structs(cfg: ModelConfig, cell: ShapeCell,
                  mesh=None) -> Dict[str, torch.Tensor]:
    """Model inputs of a train or prefill cell: frames (encdec/audio) or
    patches (vlm) in f32 and int32 tokens."""
    B, S = cell.batch, cell.seq
    out: Dict[str, torch.Tensor] = {}
    if cfg.family in ("encdec", "audio"):
        out["frames"] = _meta((B, S, cfg.d_model), torch.float32)
        out["tokens"] = _meta((B, min(S, DEC_LEN_CAP)), torch.int32)
    elif cfg.family == "vlm":
        out["patches"] = _meta((B, cfg.n_prefix_tokens, cfg.d_model),
                               torch.float32)
        out["tokens"] = _meta((B, S - cfg.n_prefix_tokens), torch.int32)
    else:
        out["tokens"] = _meta((B, S), torch.int32)
    return out


def cache_structs_sharded(cfg: ModelConfig, cell: ShapeCell, mesh=None):
    """A decode cell's cache of ``cell.seq`` slots (an encoder-decoder's
    with ``CROSS_LEN`` cross slots)."""
    enc_len = CROSS_LEN if cfg.family in ("encdec", "audio") else 0
    return cache_structs(cfg, cell.batch, cell.seq, enc_len)


def params_structs_sharded(cfg: ModelConfig, mesh=None):
    return param_structs(cfg)


def state_structs_sharded(cfg: ModelConfig, mesh=None,
                          compress_grads: bool = False) -> Dict[str, Any]:
    """The train state: parameters, f32 AdamW moments, an int32 step
    count, and the f32 error-feedback tree under ``compress_grads``."""
    params = params_structs_sharded(cfg)
    f32 = lambda p: _meta(p.shape, torch.float32)   # noqa: E731
    state = {
        "params": params,
        "opt": OptState(mu=tree_map(f32, params), nu=tree_map(f32, params),
                        count=_meta((), torch.int32)),
        "step": _meta((), torch.int32),
    }
    if compress_grads:
        state["err"] = tree_map(f32, params)
    return state


def decode_token_structs(cfg: ModelConfig, cell: ShapeCell, mesh=None):
    """(token (B, 1) int32, position 0-dim int32). The port's
    ``decode_step`` takes the position as a Python int; the dry run gives
    it the cell's last slot."""
    return _meta((cell.batch, 1), torch.int32), _meta((), torch.int32)


def input_specs(arch: str, shape: str, cfg: Optional[ModelConfig] = None
                ) -> Dict[str, Any]:
    """Every input of one (arch × shape) cell as meta tensors."""
    return cell_inputs(cfg or get_config(arch), SHAPES[shape], arch)


def cell_inputs(cfg: ModelConfig, cell: ShapeCell, arch: str = ""
                ) -> Dict[str, Any]:
    """``input_specs`` of any cell, such as a named one at another batch."""
    ok, why = cell_supported(cfg, cell)
    if not ok:
        raise ValueError(f"{arch or cfg.name} x {cell.name} unsupported: "
                         f"{why}")
    if cell.kind == "train":
        return {"state": state_structs_sharded(cfg),
                "batch": batch_structs(cfg, cell)}
    if cell.kind == "prefill":
        return {"params": params_structs_sharded(cfg),
                "batch": batch_structs(cfg, cell)}
    token, pos = decode_token_structs(cfg, cell)
    return {"params": params_structs_sharded(cfg),
            "cache": cache_structs_sharded(cfg, cell),
            "token": token, "pos": pos}
