"""The serving generator: requests to derivatives at a fixed rate.

Set-up makes the base and ``derivatives`` finetune-like derivatives of it
on the device, one ``ServeEngine`` each, and runs one request at each
batch width the mix uses. In the window requests arrive at ``rate_per_s``,
evenly spaced (an open loop: an arrival does not wait for earlier
requests). One server takes them in the order they arrive and runs each
through ``ServeEngine.generate``; when it has nothing to do it waits for
the next arrival. A request's latency runs from its arrival to when its
tokens are on the host, so it includes its wait in the queue. Requests
that arrived in the window are served to the end, for at most ``drain_s``
seconds past its close; one not served by then has failed.

A request is ``sequences`` prompts of lengths drawn log-uniformly from
``prompt_min`` to ``prompt_max``, padded to the next multiple of
``width_multiple`` and declared ragged through ``lengths``, and asks for
``generated`` greedy tokens. The request shapes are a pool of
``pool_requests`` drawn once from ``shape_seed``, the same for every seed;
a run's seed orders the pool (each pass anew), picks each request's
derivative (Zipf with exponent ``zipf_s``) and draws its tokens.

After the window a sample of ``check_requests`` completed requests, drawn
from the seed with the one of most tokens in it, is run through the plain
reference (``reference/model.py``) over each left-padded prompt with its
served tokens; the widest gap by which a served token's logit lies below
the reference's best is compared with the configuration's limit. A
control run (``--control 1``) puts, before that check, the tokens that
the reference one precision lower puts first in the engine's place.
"""

from __future__ import annotations

import gc
import math
import time
from typing import List

import numpy as np

from mgitbench import common, formulas
from mgitbench.families import family
from mgitbench.harness import Run, Window
from mgitbench.reference.model import Model, served_gaps
from mgitbench.weights import Weights, derive_seed, generator, nested


def request_pool(t: dict) -> List[np.ndarray]:
    """The fixed pool of request shapes: each an array of prompt lengths."""
    rng = np.random.default_rng(int(t["shape_seed"]))
    lo, hi = math.log(t["prompt_min"]), math.log(t["prompt_max"])
    return [np.floor(np.exp(rng.uniform(lo, hi, t["sequences"]))
                     ).astype(np.int64).clip(t["prompt_min"], t["prompt_max"])
            for _ in range(int(t["pool_requests"]))]


def width(t: dict, lengths: np.ndarray) -> int:
    m = int(t["width_multiple"])
    return int(-(-int(lengths.max()) // m) * m)


def zipf(n: int, s: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** s
    return p / p.sum()


class Stream:
    """The run's requests in order: shape, derivative, and token seed."""

    def __init__(self, t: dict, seed: int):
        self.t = t
        self.pool = request_pool(t)
        self.rng = np.random.default_rng(derive_seed(seed, 4))
        self.seed = seed
        self.p = zipf(int(t["derivatives"]), float(t["zipf_s"]))
        self.order: List[int] = []
        self.k = 0

    def next(self) -> dict:
        if not self.order:
            self.order = list(self.rng.permutation(len(self.pool)))
        lengths = self.pool[self.order.pop()]
        req = {"k": self.k, "lengths": lengths,
               "width": width(self.t, lengths),
               "derivative": int(self.rng.choice(len(self.p), p=self.p))}
        self.k += 1
        return req


def tokens_of(run: Run, req: dict):
    """The request's (right-padded) prompt tokens, made on the device from
    the source's vocabulary (the configuration's own ``vocab_size``; the
    model's may be padded past it)."""
    import torch
    g = generator(derive_seed(run.seed, 5, req["k"]), run.device)
    return torch.randint(1, run.config["vocab_size"],
                         (len(req["lengths"]), req["width"]), generator=g,
                         device=run.device, dtype=torch.int64)


# host spans around the engine's steps, which label a traced run's idle gaps
TIMED = (("repro_torch.serve.engine", "prefill", "engine.prefill"),
         ("repro_torch.serve.engine", "decode_step", "engine.decode_step"))


def drive(run: Run, t_start: float) -> None:
    import torch
    from repro_torch.serve.engine import ServeEngine

    t, m = run.traffic, run.model
    n_gen = int(t["generated"])
    common.build_kernels(run, family(m).KERNELS)
    cfg = common.port_config(m)
    weights = Weights(run.config, run.seed, run.device)
    base = weights.base()
    pool = request_pool(t)
    max_width = max(width(t, lengths) for lengths in pool)
    engines = []
    for i in range(int(t["derivatives"])):
        engines.append(ServeEngine(cfg, nested(weights.derive(base, i)),
                                   max_len=max_width + n_gen,
                                   device=run.device))
    del base
    for w in sorted({width(t, lengths) for lengths in pool}):
        lengths = np.full(int(t["sequences"]), w)
        req = {"k": 2**40 + w, "lengths": lengths, "width": w, "derivative": 0}
        engines[0].generate({"tokens": tokens_of(run, req),
                             "lengths": torch.as_tensor(lengths,
                                                        device=run.device)},
                            n_gen).cpu()
    if run.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_start

    stream = Stream(t, run.seed)
    rate = float(t["rate_per_s"])
    done = []
    with Window(run, TIMED) as win:
        arrivals = [win.t0 + k / rate
                    for k in range(int(math.ceil(run.seconds * rate)))]
        cut = win.deadline + float(t["drain_s"])
        for due in arrivals:
            now = time.perf_counter()
            if now >= cut:
                run.failed += 1
                continue
            if now < due:
                with win.span("serve.waiting_for_arrival"):
                    time.sleep(due - now)
            req = stream.next()
            run.attempted += 1
            start = time.perf_counter()
            with win.span("serve.request"):
                out = engines[req["derivative"]].generate(
                    {"tokens": tokens_of(run, req),
                     "lengths": torch.as_tensor(req["lengths"],
                                                device=run.device)},
                    n_gen).cpu()
            req.update(sent=due, start=start, finished=time.perf_counter(),
                       served=out.numpy())
            done.append(req)
    for req in done:
        lengths = req["lengths"]
        req["real_tokens"] = int(lengths.sum())
        req["generated_tokens"] = len(lengths) * n_gen
        req["ops"] = sum(formulas.sequence_ops(m, int(n), n_gen)
                         for n in lengths)
    run.records = {"requests": done}
    if run.device == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del engines
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    if run.control:
        answer_by_control(run, sample(run, done))
    check(run, done)


def sample(run: Run, done: List[dict]) -> List[dict]:
    n = min(int(run.traffic["check_requests"]), len(done))
    longest = max(range(len(done)), key=lambda i: done[i]["real_tokens"])
    rng = np.random.default_rng(derive_seed(run.seed, 6))
    rest = [i for i in rng.permutation(len(done)) if i != longest]
    return [done[i] for i in sorted([longest] + rest[:n - 1])]


def control_precision(run: Run) -> str:
    return "tf32" if run.model["dtype"] == "float32" else "float8_e4m3"


def by_derivative(run: Run, picked: List[dict], lower=None):
    """(reference model of each derivative the requests use, its
    requests), one derivative at a time."""
    weights = Weights(run.config, run.seed, run.device)
    base = weights.base()
    for d in sorted({r["derivative"] for r in picked}):
        params = weights.derive(base, d)
        model = Model(run.model, params, lower)
        del params
        yield model, [r for r in picked if r["derivative"] == d]
        del model


def served_context(run: Run, req: dict):
    """The request's left-padded prompts with the tokens before each
    answer position (its served tokens but the last), where its logits
    start, and the answer tokens to judge. The control's answers are
    judged after the engine's tokens, the context it was read over."""
    import torch
    rows = prompt_rows(run, req)
    before = torch.as_tensor(req.get("context", req["served"]),
                             device=run.device)
    tok = torch.as_tensor(req["served"], device=run.device)
    return torch.cat([rows, before[:, :-1].long()], 1), rows.shape[1] - 1, tok


def answer_by_control(run: Run, picked: List[dict]) -> None:
    """The control in the engine's place: at each served position of each
    sampled request, over the same prompts and served tokens, the answer
    becomes the token that the reference one precision lower puts first."""
    import torch
    for low, reqs in by_derivative(run, picked, control_precision(run)):
        for req in reqs:
            full, first, _ = served_context(run, req)
            with torch.no_grad():
                top = low.logits(full, first).argmax(-1)
            req["context"] = req["served"]
            req["served"] = top.cpu().numpy()


def check(run: Run, done: List[dict]) -> None:
    """The widest gap of a served token below the reference's best logit,
    over a sample of completed requests."""
    import torch
    worst = 0.0
    served = 0
    for ref, reqs in by_derivative(run, sample(run, done)):
        for req in reqs:
            full, first, tok = served_context(run, req)
            with torch.no_grad():
                logits = ref.logits(full, first)
                worst = max(worst, float(served_gaps(logits, tok).max()))
            served += tok.numel()
            del logits
    run.check("logit_gap", worst, float(run.config["check"]["logit_gap"]))
    run.records["tokens_compared"] = [{"n": served}]


def prompt_rows(run: Run, req: dict):
    """Each prompt left-aligned in the request's width, pads of token 0 in
    front: the rows the engine serves."""
    import torch
    tokens = tokens_of(run, req)
    B, S = tokens.shape
    rows = torch.zeros_like(tokens)
    for i, n in enumerate(req["lengths"]):
        rows[i, S - int(n):] = tokens[i, :int(n)]
    return rows
