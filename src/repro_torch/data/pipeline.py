"""Synthetic data pipeline: deterministic, resumable, on one device.

Batches are generated per step on the host from a counter-based numpy RNG
(seed ^ step), exactly as the reference package's
``repro/data/pipeline.py`` does, so both packages see identical batches
and resuming from checkpoint step N reproduces the stream with no saved
iterator state. ``_place`` moves a batch to the pipeline's device.
Modality frontends are stubs: audio/vision inputs are precomputed
frame/patch embeddings.
"""

from __future__ import annotations

from typing import Dict, Iterator, Union

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


class SyntheticPipeline:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 1234, start_step: int = 0,
                 device: Union[str, torch.device] = "cpu") -> None:
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.step = start_step
        self.device = torch.device(device)

    # -- deterministic per-step generation ------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng((self.seed << 20) ^ step)

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        out: Dict[str, np.ndarray] = {}
        if cfg.family in ("encdec", "audio"):
            out["frames"] = rng.standard_normal(
                (self.batch, self.seq, cfg.d_model), dtype=np.float32)
            dec_len = min(self.seq, 4096)
            out["tokens"] = rng.integers(
                0, cfg.vocab_size, (self.batch, dec_len), dtype=np.int32)
        elif cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (self.batch, cfg.n_prefix_tokens, cfg.d_model),
                dtype=np.float32)
            out["tokens"] = rng.integers(
                0, cfg.vocab_size, (self.batch, self.seq - cfg.n_prefix_tokens),
                dtype=np.int32)
        else:
            out["tokens"] = rng.integers(
                0, cfg.vocab_size, (self.batch, self.seq), dtype=np.int32)
        return out

    def _place(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch as tensors on the pipeline's device; token ids become
        int64, torch's index dtype."""
        placed = {}
        for k, v in batch.items():
            t = torch.from_numpy(v)
            if k == "tokens":
                t = t.to(torch.int64)
            placed[k] = t.to(self.device)
        return placed

    # -- iterator protocol ------------------------------------------------------
    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = self._place(self.host_batch(self.step))
        self.step += 1
        return b

    # -- resumability -------------------------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: Dict[str, int]) -> None:
        self.step = state["step"]
        self.seed = state["seed"]
