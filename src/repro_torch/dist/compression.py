"""Gradient compression for the cross-pod reduction (int8 + error feedback).

Gradients crossing the slow link between pods are quantized to int8 with
one fp32 scale per tensor; the quantization residual is carried forward in
an error state so the long-run average of the dequantized stream is
unbiased (EF-SGD). The train step folds it in. The arithmetic is the
reference package's ``repro/dist/compression.py``; every division is by a
0-dim tensor on the operand's device, a true f32 division on the CPU and
on the card alike.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.common.tree import leaves, tree_map, unflatten

_Q_LEVELS = 127.0


def init_error_state(params: Any) -> Any:
    """Zeroed fp32 error-feedback tree matching ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _compress_leaf(g: torch.Tensor, err: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    c = g.to(torch.float32) + err
    levels = torch.tensor(_Q_LEVELS, dtype=torch.float32, device=c.device)
    scale = torch.clamp(torch.max(torch.abs(c)), min=1e-30) / levels
    q = torch.clamp(torch.round(c / scale), -_Q_LEVELS, _Q_LEVELS).to(
        torch.int8)
    deq = q.to(torch.float32) * scale
    return deq.to(g.dtype), c - deq


def compress_gradients(grads: Any, err: Any) -> Tuple[Any, Any]:
    """Quantize ``grads`` to int8 wire format and immediately dequantize.

    Returns ``(dequantized_grads, new_error_state)``. The dequantized values
    are what the optimizer consumes (they model what arrives after the
    compressed all-reduce); the residual goes back into the error state.
    """
    outs = [_compress_leaf(g, e) for g, e in zip(leaves(grads), leaves(err))]
    return (unflatten(grads, [d for d, _ in outs]),
            unflatten(grads, [e for _, e in outs]))


def compressed_bytes(grads: Any) -> int:
    """Wire bytes for one compressed reduction: 1 byte/element + 4-byte scale
    per tensor."""
    ls = leaves(grads)
    return sum(int(np.prod(tuple(leaf.shape))) for leaf in ls) + 4 * len(ls)


def ef_eps(amax: float) -> float:
    """Checkpoint-tier bridge to this module's int8 estimator (§15).

    The lossy step-delta commit sizes its per-leaf quantization grid to
    match what one error-feedback round would use for the same update:
    ``quant_scale(eps) == amax / _Q_LEVELS`` (``quant_scale`` is
    ``2*log1p(eps)``, so eps inverts through expm1). With the grid matched,
    every quantized step-delta narrows to int8 and its per-hop error is
    bounded by half the EF grid."""
    return max(float(np.expm1((amax / _Q_LEVELS) / 2.0)), 1e-12)
