"""Batched serving: prefill + greedy decode over the unified model API.

The reference package's ``repro/serve/engine.py`` with the same left-
aligned ragged-batch contract, for every model family. The engine's params
live on one device: the card unless the caller names another
(``device="cpu"`` runs the plain versions on the host). Prefill runs
self-attention through the flash-attention kernel on the card; decode
steps update the cache in place.

A batch's ``patches`` (vlm) and ``frames`` (encdec/audio) go to prefill
with its tokens. A vlm's prompt ends at position ``n_prefix_tokens + S -
1``, so its decode starts there plus one. The reference's engine starts
every family at ``S``, which overwrites a vlm's last prompt slots and
rotates its tokens at the wrong positions (pinned in
``tests/test_torch_serve.py``).

Traced (``repro_torch.obs``), ``generate`` opens ``engine.generate``, one
``engine.prefill`` and one ``engine.decode_step`` per decoded token, and
counts the prefill's slots (B x S, ``engine.prefill_slots``) against its
real prompt tokens (``engine.prompt_tokens``); reading the lengths for
that count waits for the device once, before the request's first launch,
and only while tracing is on.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch import obs
from repro_torch.common import bf16
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, prefill


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, batch):
        return prefill(cfg, params, batch, max_len=max_len)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, token (B,1), pos) -> (next_token, logits, cache')."""

    def serve_step(params, cache, token, pos):
        logits, new_cache = decode_step(cfg, params, token, cache, pos)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, logits, new_cache

    return serve_step


def _tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor (arrays copied; the bf16 carrier as bfloat16)."""
    if not isinstance(x, torch.Tensor):
        x = bf16.to_torch(x, copy=True)
    return x if device is None else x.to(device)


def batch_lengths(batch: Dict[str, Any]) -> Optional[torch.Tensor]:
    """Per-sequence prompt lengths from ``lengths`` (B,) or ``mask`` (B, S).

    Returns ``None`` when neither is present (the batch is declared
    unpadded). Lengths are clamped to [1, S]: an empty prompt still
    occupies one slot so the decode recursion has a defined position."""
    tokens = _tensor(batch["tokens"])
    if "lengths" in batch:
        lengths = _tensor(batch["lengths"], tokens.device).to(torch.int32)
    elif "mask" in batch:
        lengths = torch.sum(_tensor(batch["mask"], tokens.device) > 0,
                            dim=-1).to(torch.int32)
    else:
        return None
    return torch.clamp(lengths, 1, tokens.shape[1])


def prompt_tokens(batch: Dict[str, Any], width: int) -> int:
    """The real prompt tokens of a (B, ``width``) batch: its clamped
    lengths summed, read on the host, so a device tensor waits once."""
    if "lengths" in batch:
        lengths = _tensor(batch["lengths"]).cpu()
    elif "mask" in batch:
        lengths = torch.sum(_tensor(batch["mask"]).cpu() > 0, dim=-1)
    else:
        return len(batch["tokens"]) * width
    return int(torch.clamp(lengths, 1, width).sum())


def left_align(tokens, lengths, pad_id: int = 0) -> torch.Tensor:
    """Shift each row right so its last real token sits in the last column.

    The decode cache is positional: prefill writes prompt K/V at physical
    slots ``[0, S)`` and the next token lands at slot ``S`` for the whole
    batch. Right-padded ragged rows break that — their true last token is
    at ``lengths[i] - 1``, so last-column logits belong to padding. Left-
    aligning restores one shared layout: every row ends at column
    ``S - 1``, and the shared position counter is uniformly correct."""
    tokens = _tensor(tokens)
    lengths = _tensor(lengths, tokens.device)
    B, S = tokens.shape
    src = (torch.arange(S, device=tokens.device)[None, :]
           - (S - lengths.to(torch.int64))[:, None])
    gathered = torch.gather(tokens, 1, torch.clamp(src, 0, S - 1))
    return torch.where(src >= 0, gathered,
                       torch.full_like(gathered, pad_id))


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


class ServeEngine:
    """Minimal batched engine: prefill once, then greedy decode N tokens.

    Ragged batches are declared via ``batch["lengths"]`` (B,) or a 0/1
    ``batch["mask"]`` (B, S) and are normalized by **left-alignment**
    (the standard decoder-only padding side): per-sequence last-token
    logits become the physical last column and one shared decode position
    serves the whole batch. Contract: a row of length L generated inside a
    ragged width-S batch is identical to generating that row alone at the
    same width — and a full-width row is identical to the unpadded run.
    (Left pads are attended like any prefix token — the model stack has no
    padding mask — so left-padded rows approximate, rather than replicate,
    their unpadded runs; positions index physical cache slots.)

    ``params`` is the nested tree (``convert.to_params``), of tensors or
    numpy arrays; the engine puts it on ``device`` once. ``device=None``
    means the card and raises when there is none.
    """

    def __init__(self, cfg: ModelConfig, params, max_len: int,
                 device: Union[None, str, torch.device] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.max_len = max_len
        self._prefill = make_prefill_step(cfg, max_len)
        self._step = make_serve_step(cfg)

    def generate(self, batch: Dict[str, Any], n_tokens: int) -> torch.Tensor:
        """Greedy-decode ``n_tokens`` tokens; returns (B, n_tokens) int32 on
        the engine's device.

        ``n_tokens=0`` returns an empty (B, 0) tensor without touching the
        model; ``n_tokens=1`` is exactly one prefill and no decode steps."""
        tokens = _tensor(batch["tokens"], self.device)
        B, S = tokens.shape
        if n_tokens <= 0:
            return torch.zeros((B, 0), dtype=torch.int32, device=self.device)
        with obs.span("engine.generate", cat="serve", batch=B, width=S):
            if obs.is_enabled():
                obs.count("engine.prefill_slots", B * S)
                obs.count("engine.prompt_tokens", prompt_tokens(batch, S))
            lengths = batch_lengths({**batch, "tokens": tokens})
            if lengths is not None:
                tokens = left_align(tokens, lengths)
            inputs = {k: _tensor(v, self.device) for k, v in batch.items()
                      if k in ("patches", "frames")}
            with torch.inference_mode():
                with obs.span("engine.prefill", cat="serve"):
                    last_logits, cache = self._prefill(
                        self.params, {**inputs, "tokens": tokens})
                token = torch.argmax(last_logits, dim=-1).to(
                    torch.int32)[:, None]
                # every row's prompt now ends at physical slot S - 1 (after
                # a vlm's visual prefix), so the first decoded token lands
                # at the next slot for the whole batch
                pos = S + (self.cfg.n_prefix_tokens
                           if self.cfg.family == "vlm" else 0)
                out = [token]
                for _ in range(n_tokens - 1):
                    with obs.span("engine.decode_step", cat="serve"):
                        token, _, cache = self._step(self.params, cache,
                                                     token, pos)
                    pos += 1
                    out.append(token)
                return torch.cat(out, dim=1)
