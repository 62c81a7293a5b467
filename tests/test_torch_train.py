"""The port's training slice against the reference package, on the CPU.

paper-bert-small cut to 2 layers, sequence 16: the reference's initial
state is carried across with ``repro_torch.convert.state_from_reference``
and both packages see the same numpy batches. The forward logits agree
within 2e-5 (the f32 tolerance of the reference tests), the loss of each
of three train steps within 1e-5 relative and the parameters within 1e-5
absolute, with gradient compression off and on (matrix products sum in
another order, so the bits differ). The port's Trainer then resumes a
checkpointed run bit for bit, its elastic restart restores the last
commit, and with no card it refuses to start.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.data import SyntheticPipeline as RefPipeline
from repro.models import get_config as ref_get_config
from repro.models.model import forward as ref_forward
from repro.store.checkpoint import flatten_state as ref_flatten
from repro.train.step import init_state as ref_init_state
from repro.train.step import make_train_step as ref_make_train_step

from repro_torch.convert import state_from_reference
from repro_torch.data import SyntheticPipeline
from repro_torch.ft import StragglerEvent
from repro_torch.models import forward, get_config
from repro_torch.models.layers import chunked_attention
from repro_torch.store import ArtifactStore, CheckpointManager, flatten_state
from repro_torch.train import Trainer, make_train_step

BATCH, SEQ = 2, 16


def _configs(**overrides):
    cut = dict(n_layers=2, **overrides)
    return (dataclasses.replace(ref_get_config("paper-bert-small"), **cut),
            dataclasses.replace(get_config("paper-bert-small"), **cut))


def _port_state(ref_state):
    return state_from_reference(jax.tree_util.tree_map(np.asarray, ref_state))


def test_pipeline_batches_equal_reference():
    rcfg, cfg = _configs()
    ref = RefPipeline(rcfg, batch=BATCH, seq=SEQ, seed=3)
    port = SyntheticPipeline(cfg, batch=BATCH, seq=SEQ, seed=3)
    for step in (0, 1, 7):
        a, b = ref.host_batch(step), port.host_batch(step)
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    placed = next(port)
    assert placed["tokens"].dtype == torch.int64 and port.step == 1


@pytest.mark.parametrize("attn_chunk", [1024, 4])
def test_forward_logits_match_reference(attn_chunk):
    """attn_chunk 4 walks 4 x 4 query/key blocks of the online softmax."""
    rcfg, cfg = _configs(attn_chunk=attn_chunk)
    ref_state = ref_init_state(rcfg, 0)
    batch = RefPipeline(rcfg, batch=BATCH, seq=SEQ, seed=0).host_batch(0)
    ref_logits = np.asarray(ref_forward(rcfg, ref_state["params"], batch))
    port_params = _port_state(ref_state)["params"]
    logits = forward(cfg, port_params,
                     SyntheticPipeline(cfg, BATCH, SEQ)._place(batch))
    assert logits.shape == (BATCH, SEQ, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=2e-5,
                               rtol=2e-5)


def test_chunked_attention_matches_plain_softmax():
    _, cfg = _configs(attn_chunk=4, n_heads=4, n_kv_heads=2)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 12, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 12, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 12, 2, 8)).astype(np.float32))
    out = chunked_attention(q, k, v, cfg)       # 3 x 3 blocks, GQA
    kk, vv = k.repeat_interleave(2, dim=2), v.repeat_interleave(2, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(8)
    s = s.masked_fill(~torch.ones(12, 12, dtype=torch.bool).tril(),
                      float("-inf"))
    plain = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=2e-6)


@pytest.mark.parametrize("n_microbatches", [1, 2])
@pytest.mark.parametrize("compress", [False, True])
def test_three_train_steps_match_reference(compress, n_microbatches):
    rcfg, cfg = _configs()
    ref_state = ref_init_state(rcfg, 0, compress_grads=compress)
    state = _port_state(ref_state)
    ref_step = jax.jit(ref_make_train_step(rcfg, n_microbatches=n_microbatches,
                                           compress_grads=compress))
    step = make_train_step(cfg, n_microbatches=n_microbatches,
                           compress_grads=compress)
    pipe = RefPipeline(rcfg, batch=BATCH, seq=SEQ, seed=0)
    port_pipe = SyntheticPipeline(cfg, BATCH, SEQ, seed=0)
    before = flatten_state(state)
    for i in range(3):
        batch = pipe.host_batch(i)
        ref_state, ref_metrics = ref_step(ref_state, batch)
        state, metrics = step(state, port_pipe._place(batch))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(ref_metrics["loss"]), rtol=1e-5)
    ref_flat, flat = ref_flatten(ref_state), flatten_state(state)
    assert list(flat) == list(ref_flat)
    for k, v in ref_flat.items():
        if k.startswith("params/"):
            np.testing.assert_allclose(flat[k], v, atol=1e-5, rtol=0)
    assert int(state["step"]) == 3 and int(state["opt"].count) == 3
    # the step is functional: the state it started from is untouched
    assert all(before[k].tobytes() == v.tobytes()
               for k, v in flatten_state(_port_state(
                   ref_init_state(rcfg, 0, compress_grads=compress))).items())


def _trainer(tmp_path, **kw):
    _, cfg = _configs()
    return Trainer(cfg, batch=BATCH, seq=SEQ, checkpoint_dir=str(tmp_path),
                   commit_every=2, device="cpu", **kw)


def test_trainer_resumes_bit_identical_after_restart(tmp_path):
    tr = _trainer(tmp_path)
    assert tr.ckpt.store.backend == "ref"
    hist = tr.run(4)
    assert len(hist["loss"]) == 4 and np.isfinite(hist["loss"]).all()
    live = flatten_state(tr.state)
    # "restart": a fresh trainer on the same directory resumes at step 4
    tr2 = _trainer(tmp_path)
    assert tr2.start_step == 4 and tr2.pipeline.step == 4
    resumed = flatten_state(tr2.state)
    assert list(resumed) == list(live)
    assert all(live[k].tobytes() == resumed[k].tobytes() for k in live)
    # and two more steps give what an uninterrupted run gives
    tr2.run(2)
    _, cfg = _configs()
    solo = Trainer(cfg, batch=BATCH, seq=SEQ, device="cpu")
    solo.run(6)
    a, b = flatten_state(tr2.state), flatten_state(solo.state)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)


def test_run_starts_at_start_step_as_the_reference_does(tmp_path):
    """``run`` leaves ``start_step`` alone, as the reference's does; a
    caller that moves it between two runs of 2 steps commits and trains
    exactly as one run of 4 (each run waits for its commits, so none
    coalesces), here through a manager with a whole-tensor store."""
    split = _trainer(tmp_path / "split")
    store = ArtifactStore(root=str(tmp_path / "split"), backend="ref",
                          t_thr=float("inf"), chunk_threshold=0)
    split.ckpt = CheckpointManager(str(tmp_path / "split"),
                                   model_name=split.cfg.name, store=store)
    whole = _trainer(tmp_path / "whole")
    losses = split.run(2)["loss"]
    assert split.start_step == 0
    split.start_step = 2
    losses += split.run(2)["loss"]
    assert losses == whole.run(4)["loss"]
    assert whole.start_step == 0
    a, b = flatten_state(split.state), flatten_state(whole.state)
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
    assert sorted(split.ckpt._steps()) == sorted(whole.ckpt._steps()) == [2, 4]


def test_elastic_restart_restores_last_commit(tmp_path):
    tr = _trainer(tmp_path)
    tr.run(3)                       # commits step 2; step 3 is live only
    committed = flatten_state(tr.ckpt.restore(step=2, template=tr.state)[0])
    tr.elastic(StragglerEvent(step=3, duration=9.0, mean=1.0, ratio=9.0))
    assert tr.elastic.restarts == [{"event_step": 3, "restored_step": 2}]
    assert tr.start_step == 2 and tr.pipeline.step == 2
    now = flatten_state(tr.state)
    assert all(committed[k].tobytes() == now[k].tobytes() for k in now)
    assert all(t.device.type == "cpu"
               for t in tr.state["params"]["layers"]["attn"].values())


def test_trainer_without_card_raises():
    assert not torch.cuda.is_available()
    _, cfg = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, batch=BATCH, seq=SEQ)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, batch=BATCH, seq=SEQ, device="cuda")
