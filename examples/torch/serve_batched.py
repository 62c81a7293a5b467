"""Serve a small model with batched requests: prefill + greedy decode.

The PyTorch/CUDA port's run of ``examples/serve_batched.py``: prefill goes
through the flash-attention kernel on the card unless ``--device cpu``
runs the plain versions on the host.

    PYTHONPATH=src python examples/torch/serve_batched.py [--device cpu]
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.convert import to_params
from repro_torch.models import get_config, init_params
from repro_torch.serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the model on the card (raises without one); "
                         "cpu: on the host")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), remat="none")
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = to_params(init_params(cfg, gen), args.device)
    engine = ServeEngine(cfg, params, max_len=128, device=args.device)

    prompts = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32),
                                     generator=prompts, dtype=torch.int32)}
    t0 = time.perf_counter()
    out = engine.generate(batch, n_tokens=16).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"generated {out.shape} tokens for {out.shape[0]} requests "
          f"in {dt:.2f}s ({out.size / dt:.0f} tok/s on "
          f"{args.device.upper()})")
    print(out)


if __name__ == "__main__":
    main()
