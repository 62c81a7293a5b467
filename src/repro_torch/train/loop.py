"""Fault-tolerant training loop: MGit-versioned checkpoints, restart, stragglers.

The Trainer wires together the synthetic pipeline, the train step, the
CheckpointManager (every checkpoint is an MGit version node; restart
resumes from the latest committed one) and the straggler monitor, on one
device. ``device=None`` means the card and raises when there is none;
``device="cpu"`` runs the whole loop on the host, and its checkpoint
store then uses the numpy twins (``backend="ref"``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.data import SyntheticPipeline
from repro_torch.ft import ElasticRestart, StepTimer, StragglerPolicy
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.store.checkpoint import CheckpointManager
from repro_torch.train.step import init_state, make_train_step


class Trainer:
    def __init__(self, cfg: ModelConfig, *, batch: int = 8, seq: int = 128,
                 opt_cfg: Optional[adamw.AdamWConfig] = None,
                 n_microbatches: int = 1, compress_grads: bool = False,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 50, seed: int = 0,
                 on_metrics: Optional[Callable[[int, Dict], None]] = None,
                 commit_every: Optional[int] = None,
                 lossy_tier: bool = False, keyframe_every: int = 8,
                 device: Union[None, str, torch.device] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # ``commit_every`` is the continuous-checkpointing cadence knob
        # (DESIGN.md §15) — it overrides the legacy checkpoint_every name
        self.checkpoint_every = (commit_every if commit_every is not None
                                 else checkpoint_every)
        self.on_metrics = on_metrics
        self.pipeline = SyntheticPipeline(cfg, batch=batch, seq=seq,
                                          seed=seed, device=self.device)
        self.train_step = make_train_step(
            cfg, opt_cfg, n_microbatches=n_microbatches,
            compress_grads=compress_grads)
        self.state = init_state(cfg, seed, compress_grads=compress_grads,
                                device=self.device)
        self.timer = StepTimer()
        self.ckpt: Optional[CheckpointManager] = None
        self.start_step = 0
        if checkpoint_dir is not None:
            self.ckpt = CheckpointManager(
                checkpoint_dir, model_name=cfg.name,
                tier="lossy" if lossy_tier else "exact",
                keyframe_every=keyframe_every,
                backend="ref" if self.device.type == "cpu" else None)
            latest = self.ckpt.latest_step()
            if latest is not None:  # crash restart: resume from last commit
                # the lossy tier may resolve to the nearest exact ancestor,
                # so resume from the step restore actually returned
                self.state, restored = self.ckpt.restore(step=latest,
                                                         template=self.state)
                self.start_step = restored
                self.pipeline.step = restored
        # straggler escalation bottoms out in evict + elastic restart from
        # the last committed version (ft/straggler.py) when versioning is on
        self.elastic = ElasticRestart(self) if self.ckpt is not None else None
        self.policy = StragglerPolicy(evict_fn=self.elastic)

    def run(self, n_steps: int) -> Dict[str, list]:
        """Train ``n_steps`` steps from ``start_step``, as the reference's
        ``run`` does: ``run`` leaves ``start_step`` where it was, and a
        restart, ``ElasticRestart`` or the caller moves it. Returns the loss and the seconds of each step (host clock,
        ending in the loss's copy to the host, which waits for the device)."""
        history: Dict[str, list] = {"loss": [], "step_time": []}
        for step in range(self.start_step, self.start_step + n_steps):
            batch = self.pipeline._place(self.pipeline.host_batch(step))
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(self.state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            history["loss"].append(loss)
            history["step_time"].append(dt)
            event = self.timer.record(step, dt)
            if event is not None:
                self.policy.on_event(event)
            if self.ckpt is not None and (step + 1) % self.checkpoint_every == 0:
                self.ckpt.save(step + 1, self.state)  # async, MGit-versioned
            if self.on_metrics is not None:
                self.on_metrics(step, {"loss": loss, "step_time": dt, **{
                    k: float(v) for k, v in metrics.items() if k != "loss"}})
        if self.ckpt is not None:
            self.ckpt.wait()
        return history
