"""End to end: train a ~100M-class LM, finetune task derivatives,
version everything through MGit, then push an upstream update through the
lineage with run_update_cascade (paper Figure 4 workflow).

The PyTorch/CUDA port's run of ``examples/finetune_cascade.py``: training
and the store's kernels run on the card unless ``--device cpu`` runs them
on the host. The default reduced size takes seconds; pass --full for the
paper-bert (110M) config.

    PYTHONPATH=src python examples/torch/finetune_cascade.py [--steps 50] [--full]
"""

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.convert import to_artifact, to_params
from repro_torch.core import (CreationFunction, LineageGraph,
                              register_creation_type, run_update_cascade)
from repro_torch.data import SyntheticPipeline
from repro_torch.models import get_config
from repro_torch.optim import adamw
from repro_torch.store import ArtifactStore
from repro_torch.store.checkpoint import flatten_state
from repro_torch.train.step import init_state, make_train_step


def train(cfg, params, seed, steps, device, batch=8, seq=64):
    state = {"params": params, "opt": adamw.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    step_fn = make_train_step(cfg)
    pipe = SyntheticPipeline(cfg, batch=batch, seq=seq, seed=seed,
                             device=device)
    loss = None
    for _ in range(steps):
        state, metrics = step_fn(state, next(pipe))
        loss = float(metrics["loss"])
    return state["params"], loss


def artifact(cfg, params):
    return to_artifact(flatten_state(params), cfg.name)


def config(arch, reduced):
    cfg = get_config(arch)
    return dataclasses.replace(cfg.reduced(), remat="none") if reduced else cfg


@register_creation_type("cascade-finetune")
class Finetune(CreationFunction):
    """cr: re-finetune from (new) parent with this task's data seed."""

    def __call__(self, parents):
        cfg = config(self.config["arch"], self.config.get("reduced"))
        device = self.config["device"]
        params = to_params(parents[0].get_model().params, device)
        tuned, loss = train(cfg, params, seed=self.config["seed"],
                            steps=self.config["steps"], device=device)
        print(f"    [cr] finetuned task seed={self.config['seed']} "
              f"loss={loss:.3f}")
        return artifact(cfg, tuned)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--tasks", type=int, default=3)
    ap.add_argument("--full", action="store_true",
                    help="use paper-bert (110M params) instead of the reduced config")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: training and the store's kernels on the card "
                         "(raises without one); cpu: on the host")
    args = ap.parse_args(argv)

    arch = "paper-bert" if args.full else "paper-bert-small"
    cfg = config(arch, not args.full)

    tmp = tempfile.mkdtemp(prefix="mgit-cascade-")
    store = ArtifactStore(root=tmp, codec="lzma",
                          backend="ref" if args.device == "cpu" else None)
    g = LineageGraph(path=tmp, store=store)

    print(f"[1/4] pretraining base ({arch})…")
    init = init_state(cfg, 0, device=args.device)["params"]
    base, loss = train(cfg, init, seed=1, steps=args.steps, device=args.device)
    print(f"      base loss={loss:.3f}")
    g.add_node(artifact(cfg, base), "base")

    print(f"[2/4] finetuning {args.tasks} task models…")
    for t in range(args.tasks):
        cr = Finetune(arch=arch, seed=100 + t, steps=max(args.steps // 3, 5),
                      reduced=not args.full, device=args.device)
        g.add_edge("base", f"task{t}")
        g.add_node(cr([g.nodes["base"]]), f"task{t}", cr=cr)

    s = store.stats()
    print(f"      storage ratio={s['compression_ratio']:.2f}x "
          f"({s['logical_bytes']/1e6:.0f}MB logical → "
          f"{s['physical_bytes']/1e6:.0f}MB physical)")

    print("[3/4] upstream update: continued-pretraining the base…")
    base2, loss2 = train(cfg, base, seed=2, steps=max(args.steps // 2, 5),
                         device=args.device)
    g.add_node(artifact(cfg, base2), "base@v2", model_type=cfg.name)
    print(f"      base@v2 loss={loss2:.3f}")

    print("[4/4] run_update_cascade(base -> base@v2)…")
    created = run_update_cascade(g, "base", "base@v2")
    print(f"      rebuilt: {created}")
    print("\nlineage graph:")
    print(g.log())
    s = store.stats()
    print(f"\nfinal storage: ratio={s['compression_ratio']:.2f}x, "
          f"objects={s['objects']}, dedup_hits={s['dedup_hits']}")


if __name__ == "__main__":
    main()
