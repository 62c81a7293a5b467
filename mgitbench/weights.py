"""Weights and derivatives made from the seed, on the device.

``param_specs`` is a frozen copy of the port's parameter layout
(``repro_torch.models.model.param_shapes``; each family's layers in
``families/<family>.py``): the flat path of each leaf, its shape, and its
dtype. The program takes its weights in this layout; the plain reference
reads them by the same paths. ``tests/test_mgitbench_reference.py`` holds
the copy against the port.

A base is drawn in one generator call for all its Gaussian leaves (and one
for the state-space constants); a derivative adds one Gaussian delta drawn
in one call over all leaves, scaled by ``delta_rms_share`` of each leaf's
RMS in the base, with the embedding and the first ``frozen_layers`` layers
left unchanged in every ``freeze_every``-th derivative (index 0, then every
``freeze_every``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from mgitbench.families import family

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
Spec = Tuple[Tuple[int, ...], str]


def derive_seed(seed: int, *parts: int) -> int:
    """A 63-bit generator seed for one purpose of one run's ``seed``."""
    words = np.random.SeedSequence([int(seed), *map(int, parts)]
                                   ).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def param_specs(m: dict) -> Dict[str, Spec]:
    """{path: (shape, dtype)} of the model's leaves, in sorted order: the
    embedding, the final norm and an untied head, and the layers of its
    family."""
    D, V, dt = m["d_model"], m["vocab_size"], m["dtype"]
    s: Dict[str, Spec] = {"embed/tok": ((V, D), dt),
                          "final_norm": ((D,), dt)}
    s.update(family(m).layer_specs(m))
    if not m.get("tie_embeddings", False):
        s["lm_head"] = ((D, V), dt)
    return dict(sorted(s.items()))


def numel(shape) -> int:
    return int(math.prod(shape))


def _split(flat: torch.Tensor, specs: Dict[str, Spec]):
    out, at = {}, 0
    for path, (shape, _) in specs.items():
        n = numel(shape)
        out[path] = flat[at:at + n].view(shape)
        at += n
    return out


class Weights:
    """Base and derivatives of one configuration for one run's seed."""

    def __init__(self, config: dict, seed: int, device):
        self.m = config["model"]
        self.d = config["derivative"]
        self.seed = int(seed)
        self.device = torch.device(device)
        self.specs = param_specs(self.m)
        self._rms = None

    def base(self) -> Dict[str, torch.Tensor]:
        g = generator(derive_seed(self.seed, 1), self.device)
        total = sum(numel(sh) for sh, _ in self.specs.values())
        flat = torch.randn(total, generator=g, device=self.device)
        views = _split(flat, self.specs)
        fam = family(self.m)
        special = [p for p in self.specs if p.rsplit("/", 1)[-1]
                   in fam.UNIFORM]
        u = torch.rand(sum(numel(self.specs[p][0]) for p in special),
                       generator=g, device=self.device, dtype=torch.float64)
        u = _split(u, {p: self.specs[p] for p in special})
        out = {}
        std = float(self.m.get("init_std", 0.02))
        for path, (shape, dt) in self.specs.items():
            v = fam.init(path.rsplit("/", 1)[-1], views[path], u.get(path),
                         std)
            out[path] = v.to(DTYPES[dt])
        del flat
        self._rms = {p: torch.sqrt(torch.mean(torch.square(v.float())))
                     for p, v in out.items()}
        return out

    def frozen(self, index: int) -> bool:
        return index % int(self.d["freeze_every"]) == 0

    def derive(self, parent: Dict[str, torch.Tensor], index: int
               ) -> Dict[str, torch.Tensor]:
        """Derivative ``index`` of ``parent``: parent + a seeded delta."""
        if self._rms is None:
            raise RuntimeError("make the base first: deltas scale by its RMS")
        g = generator(derive_seed(self.seed, 2, index), self.device)
        total = sum(numel(sh) for sh, _ in self.specs.values())
        delta = _split(torch.randn(total, generator=g, device=self.device),
                       self.specs)
        share = float(self.d["delta_rms_share"])
        cut = int(self.d["frozen_layers"]) if self.frozen(index) else 0
        out = {}
        for path, (shape, dt) in self.specs.items():
            dv = delta[path] * (share * self._rms[path])
            if cut and path == "embed/tok":
                dv = torch.zeros_like(dv)
            elif cut and path.startswith("layers/"):
                dv[:cut] = 0.0
            out[path] = (parent[path].float() + dv).to(DTYPES[dt])
        return out


def nested(flat: Dict[str, torch.Tensor]) -> dict:
    """The nested tree of a flat {path: tensor} dict."""
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree
