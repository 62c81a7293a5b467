"""Training of every non-dense family in the port against the reference.

At each config's ``reduced()`` size in f32 (attention chunks of 64, SSM
chunks of 32), the reference's initial state is carried across with
``repro_torch.convert.state_from_reference`` and both packages take two
train steps on the same numpy batches (frames for the audio model,
patches for the vlm). Products sum in another order in the two
frameworks, so the bits differ: each step's loss is held within 5e-6
absolute and every parameter within 1e-6 absolute after the two steps,
three to four times the largest differences seen (1.4e-6 in the loss of
llama4-scout-17b-16e, 2.7e-7 in its parameters).

``cfg.remat`` changes what a train step keeps for its backward pass,
never its numbers: the three modes give bit-identical gradients. A
checkpointed ``Trainer`` of each non-dense family resumes bit for bit on
the CPU.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data import SyntheticPipeline as RefPipeline
from repro.models import get_config as ref_get_config
from repro.store.checkpoint import flatten_state as ref_flatten
from repro.train.step import init_state as ref_init_state
from repro.train.step import make_train_step as ref_make_train_step

from repro_torch.common.tree import leaves
from repro_torch.convert import state_from_reference
from repro_torch.data import SyntheticPipeline
from repro_torch.models import get_config
from repro_torch.models.model import _nested, init_params
from repro_torch.store import flatten_state
from repro_torch.train import Trainer, make_train_step
from repro_torch.train.step import _value_and_grad, make_loss_fn

BATCH, SEQ = 2, 16
LOSS_TOL = 5e-6
PARAM_TOL = 1e-6
FAMILIES = ["seamless-m4t-large-v2", "mamba2-780m", "llama4-scout-17b-16e",
            "mixtral-8x7b", "jamba-1.5-large-398b", "paligemma-3b",
            "starcoder2-15b"]
# one config of each family that is not dense
NON_DENSE = ["mixtral-8x7b", "mamba2-780m", "jamba-1.5-large-398b",
             "seamless-m4t-large-v2", "paligemma-3b"]


def _configs(name, **overrides):
    return (ref_get_config(name).reduced(**overrides),
            get_config(name).reduced(**overrides))


@pytest.mark.parametrize("name", FAMILIES)
def test_two_train_steps_match_reference(name):
    rcfg, cfg = _configs(name)
    assert cfg.family == rcfg.family and cfg.dtype == "float32"
    ref_state = ref_init_state(rcfg, 0)
    state = state_from_reference(jax.tree_util.tree_map(np.asarray,
                                                        ref_state))
    ref_step = jax.jit(ref_make_train_step(rcfg))
    step = make_train_step(cfg)
    pipe = RefPipeline(rcfg, batch=BATCH, seq=SEQ, seed=0)
    port_pipe = SyntheticPipeline(cfg, BATCH, SEQ, seed=0)
    for i in range(2):
        batch = pipe.host_batch(i)
        ref_state, ref_metrics = ref_step(ref_state, batch)
        state, metrics = step(state, port_pipe._place(batch))
        assert abs(float(metrics["loss"])
                   - float(ref_metrics["loss"])) <= LOSS_TOL
    ref_flat, flat = ref_flatten(ref_state), flatten_state(state)
    assert list(flat) == list(ref_flat)
    worst = max(float(np.abs(np.asarray(flat[k], np.float64) - v).max())
                for k, v in ref_flat.items() if k.startswith("params/"))
    assert worst <= PARAM_TOL
    assert int(state["step"]) == 2


@pytest.mark.parametrize("name", ["qwen3-0.6b"] + NON_DENSE)
def test_remat_modes_give_bit_identical_gradients(name):
    """``none`` keeps every activation, ``full`` recomputes each layer in
    the backward pass, ``dots`` keeps the products without batch
    dimensions: the same loss and gradients, bit for bit."""
    _, base = _configs(name)
    params = _nested(init_params(base, torch.Generator().manual_seed(0)))
    batch = SyntheticPipeline(base, BATCH, SEQ, seed=1)._place(
        SyntheticPipeline(base, BATCH, SEQ, seed=1).host_batch(0))
    got = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        loss, grads = _value_and_grad(make_loss_fn(cfg), params, batch)
        got[remat] = [loss] + leaves(grads)
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(got["none"],
                                                     got[remat]))


def test_unknown_remat_raises():
    _, cfg = _configs("qwen3-0.6b")
    cfg = dataclasses.replace(cfg, remat="some")
    params = _nested(init_params(cfg, torch.Generator().manual_seed(0)))
    pipe = SyntheticPipeline(cfg, BATCH, SEQ)
    with pytest.raises(ValueError, match="unknown remat"):
        _value_and_grad(make_loss_fn(cfg), params,
                        pipe._place(pipe.host_batch(0)))


@pytest.mark.parametrize("name", NON_DENSE)
def test_trainer_resumes_bit_identical(name, tmp_path):
    """4 steps committing every 2, a fresh Trainer on the directory
    resumes at step 4 with the live state, and 2 more steps equal an
    uninterrupted run of 6."""
    _, cfg = _configs(name)

    def trainer(**kw):
        return Trainer(cfg, batch=BATCH, seq=SEQ, device="cpu", **kw)

    first = trainer(checkpoint_dir=str(tmp_path), commit_every=2)
    first.run(4)
    live = flatten_state(first.state)
    again = trainer(checkpoint_dir=str(tmp_path), commit_every=2)
    assert again.start_step == 4
    resumed = flatten_state(again.state)
    assert list(resumed) == list(live)
    assert all(live[k].tobytes() == resumed[k].tobytes() for k in live)
    again.run(2)
    solo = trainer()
    solo.run(6)
    a, b = flatten_state(again.state), flatten_state(solo.state)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
