"""Federated-learning controller using MGit lineage (paper §2, graph G3).

Each round: sample clients, train locally on disjoint data shards, average
into a new global model. Every client model and every global round is a
lineage node; the whole history is stored delta-compressed.

The PyTorch/CUDA port's run of ``examples/federated.py``: training and the
store's kernels run on the card unless ``--device cpu`` runs them on the
host.

    PYTHONPATH=src python examples/torch/federated.py [--rounds 3] [--clients 4]
"""

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.convert import to_artifact, to_params
from repro_torch.core import LineageGraph
from repro_torch.data import SyntheticPipeline
from repro_torch.models import get_config
from repro_torch.models.model import flat_paths
from repro_torch.optim import adamw
from repro_torch.store import ArtifactStore
from repro_torch.store.checkpoint import flatten_state
from repro_torch.train.step import init_state, make_train_step


def local_train(cfg, params, seed, device, steps=8):
    state = {"params": params, "opt": adamw.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    step_fn = make_train_step(cfg)
    pipe = SyntheticPipeline(cfg, batch=4, seq=32, seed=seed,
                             device=device)  # client shard
    for _ in range(steps):
        state, metrics = step_fn(state, next(pipe))
    return state["params"], float(metrics["loss"])


def fed_average(params_list, device):
    flats = [flat_paths(p) for p in params_list]
    return to_params({k: sum(f[k].to(torch.float32) for f in flats)
                      / len(flats) for k in flats[0]}, device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--sample", type=int, default=3, help="clients per round")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: training and the store's kernels on the card "
                         "(raises without one); cpu: on the host")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config("paper-bert-small").reduced(),
                              remat="none")
    tmp = tempfile.mkdtemp(prefix="mgit-fl-")
    store = ArtifactStore(root=tmp, codec="lzma",
                          backend="ref" if args.device == "cpu" else None)
    g = LineageGraph(path=tmp, store=store)

    def artifact(params):
        return to_artifact(flatten_state(params), cfg.name)

    global_params = init_state(cfg, 0, device=args.device)["params"]
    g.add_node(artifact(global_params), "global_r0")

    for r in range(1, args.rounds + 1):
        sampled = [(r * 7 + c) % args.clients for c in range(args.sample)]
        print(f"round {r}: clients {sorted(set(sampled))}")
        locals_ = []
        for c in sorted(set(sampled)):
            params, loss = local_train(cfg, global_params, 1000 * r + c,
                                       args.device)
            name = f"client{c}_r{r}"
            # controller registers each client model in the lineage graph
            g.add_edge(f"global_r{r - 1}", name)
            g.add_node(artifact(params), name)
            locals_.append(params)
            print(f"  {name}: loss={loss:.3f}")
        global_params = fed_average(locals_, args.device)
        gname = f"global_r{r}"
        for c in sorted(set(sampled)):
            g.add_edge(f"client{c}_r{r}", gname)
        g.add_node(artifact(global_params), gname)

    s = store.stats()
    print(f"\n{len(g)} models stored, ratio={s['compression_ratio']:.2f}x "
          f"({s['logical_bytes']/1e6:.0f}MB → {s['physical_bytes']/1e6:.0f}MB)")
    print("\nlineage graph:")
    print(g.log())


if __name__ == "__main__":
    main()
