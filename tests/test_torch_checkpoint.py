"""The port's continuous checkpointing against the reference package, on the CPU.

The same train states, made with numpy from a seed, go through the
reference's and the port's AdamW, flattening and ``CheckpointManager``:
AdamW within 1e-6 relative (the same f32 arithmetic in another order),
and everything the store writes exactly — manifest refs step by step and
the set of CAS keys, in the exact and the lossy tier, through a coalesced
async pair and a rollback re-commit. Restores are bit-identical across
packages, each package restores the other's directory, and a kill between
the manifest and the lineage write rolls back with a clean ``fsck``.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import compression as ref_compression
from repro.optim import adamw as ref_adamw
from repro.store.checkpoint import CKPT_STATS as REF_CKPT_STATS
from repro.store.checkpoint import CheckpointManager as RefManager
from repro.store.checkpoint import flatten_state as ref_flatten
from repro.train.step import init_state as ref_init_state

from repro_torch.common.tree import leaves
from repro_torch.convert import state_from_reference
from repro_torch.dist import compression
from repro_torch.models import get_config
from repro_torch.optim import adamw
from repro_torch.store import CKPT_STATS, CheckpointManager, flatten_state
from repro_torch.train.step import init_state

N = 96   # 96*96 f32 = 36 KiB; the "big" leaves are 64*300 f32 = 75 KiB


def _state(seed=0, step=0):
    """A small AdamW train state: two leaves above the 64 KiB fingerprint
    threshold and a few below it, as a nested numpy state."""
    rng = np.random.default_rng(seed)

    def tree(scale=1.0, positive=False):
        big = rng.standard_normal((64, 300)).astype(np.float32) * scale
        small = rng.standard_normal((N, N)).astype(np.float32) * scale
        norm = rng.standard_normal((N,)).astype(np.float32) * scale
        if positive:
            big, small, norm = np.abs(big), np.abs(small), np.abs(norm)
        return {"embed": {"tok": big}, "layers": {"w": small, "ln": norm}}

    params = tree()
    return {"params": params,
            "opt": ref_adamw.OptState(mu=tree(1e-3), nu=tree(1e-4, True),
                                      count=np.asarray(step, np.int32)),
            "step": np.asarray(step, np.int32)}


def _perturb(state, seed, scale=1e-3, keep=("params", "opt")):
    """The next state: float leaves under the ``keep`` prefixes move by
    sparse noise, counters advance by one."""
    rng = np.random.default_rng(seed)

    def bump(path, x):
        key = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                       for p in path)
        if x.dtype != np.float32:
            return x + 1
        if not key.startswith(keep):
            return x
        noise = rng.normal(scale=scale, size=x.shape) * (
            rng.random(x.shape) < 0.3)
        out = (x + noise).astype(np.float32)
        return np.abs(out) if key.startswith("opt/nu") else out
    return jax.tree_util.tree_map_with_path(bump, state)


def _port(state):
    return state_from_reference(state)


# ---------------------------------------------------------------------------
# AdamW, compression and flattening
# ---------------------------------------------------------------------------


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(3)
    params = {"a": {"w": rng.normal(size=(33, 17)).astype(np.float32)},
              "b": rng.normal(size=(40,)).astype(np.float32)}
    cfg = ref_adamw.AdamWConfig(warmup_steps=2, total_steps=6, grad_clip=1.0)
    pcfg = adamw.AdamWConfig(warmup_steps=2, total_steps=6, grad_clip=1.0)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = ref_adamw.init(rp)
    pp = _port(params)
    ps = adamw.init(pp)
    for i in range(5):   # warmup, cosine decay and clipping all reached
        grads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * (0.05 + i)).astype(
                np.float32), params)
        rp, rs, rm = ref_adamw.update(
            cfg, jax.tree_util.tree_map(jnp.asarray, grads), rs, rp)
        pp, ps, pm = adamw.update(pcfg, _port(grads), ps, pp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-6)
        # relative to each leaf's largest value: the global norm sums in
        # another order, and the clip scale's last-bit difference is
        # amplified elementwise where b1*m and (1-b1)*g nearly cancel
        for ref_tree, port_tree in ((rp, pp), (rs.mu, ps.mu), (rs.nu, ps.nu)):
            for a, b in zip(jax.tree_util.tree_leaves(ref_tree),
                            leaves(port_tree)):
                a = np.asarray(a)
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-6,
                                           atol=1e-6 * float(np.abs(a).max()))
        assert int(ps.count) == int(rs.count) == i + 1


@pytest.mark.parametrize("key", ["opt/nu/layers/attn/wq", "opt/mu/embed/tok",
                                 "params/lm_head", "opt/count", "step",
                                 "err/layers/w", "opt/nu"])
def test_state_regime_matches_reference(key):
    assert adamw.state_regime(key) == ref_adamw.state_regime(key)


@pytest.mark.parametrize("amax", [0.0, 1e-9, 3e-4, 0.25, 17.0])
def test_ef_eps_matches_reference_exactly(amax):
    assert compression.ef_eps(amax) == ref_compression.ef_eps(amax)


def test_compress_gradients_matches_reference():
    rng = np.random.default_rng(4)
    g = {"a": rng.normal(size=(64, 33)).astype(np.float32),
         "b": (rng.normal(size=(7,)) * 1e-3).astype(np.float32)}
    e = {"a": (rng.normal(size=(64, 33)) * 1e-3).astype(np.float32),
         "b": np.zeros(7, np.float32)}
    rd, re = ref_compression.compress_gradients(
        jax.tree_util.tree_map(jnp.asarray, g),
        jax.tree_util.tree_map(jnp.asarray, e))
    pd, pe = compression.compress_gradients(_port(g), _port(e))
    for k in g:
        np.testing.assert_array_equal(pd[k].numpy(), np.asarray(rd[k]))
        np.testing.assert_array_equal(pe[k].numpy(), np.asarray(re[k]))
    assert (compression.compressed_bytes(_port(g))
            == ref_compression.compressed_bytes(g))


@pytest.mark.parametrize("compress", [False, True])
def test_flatten_state_keys_and_order_match_reference(compress):
    """Manifest key order is part of the manifest hash: the port's
    flattening must give the reference's paths, order, shapes and dtypes,
    both for a converted reference state and for its own init_state."""
    import dataclasses

    from repro.models import get_config as ref_get_config
    cfg = dataclasses.replace(get_config("paper-bert-small").reduced(),
                              n_layers=2)
    rcfg = dataclasses.replace(ref_get_config("paper-bert-small").reduced(),
                               n_layers=2)
    ref_state = ref_init_state(rcfg, 0, compress_grads=compress)
    ref_flat = ref_flatten(ref_state)
    port_flat = flatten_state(_port(jax.tree_util.tree_map(np.asarray,
                                                           ref_state)))
    own_flat = flatten_state(init_state(cfg, 0, compress_grads=compress))
    assert list(port_flat) == list(ref_flat) == list(own_flat)
    assert "opt/count" in ref_flat and "opt/mu/layers/attn/wq" in ref_flat
    for k, v in ref_flat.items():
        for other in (port_flat[k], own_flat[k]):
            assert other.shape == v.shape and other.dtype == v.dtype, k
        np.testing.assert_array_equal(port_flat[k], v)
    assert ref_flat["step"].shape == () and ref_flat["step"].dtype == np.int32


# ---------------------------------------------------------------------------
# manager parity: the same save sequence through both packages
# ---------------------------------------------------------------------------


def _refs(cm):
    return {n: cm.lineage.nodes[n].artifact_ref for n in sorted(cm.lineage.nodes)
            if cm.lineage.nodes[n].artifact_ref}


class _Gate:
    """Holds the first commit of a manager in flight until released, so the
    next two async saves deterministically coalesce behind it."""

    def __init__(self, cm):
        self.cm, self.real = cm, cm._commit
        self.entered, self.release = threading.Event(), threading.Event()
        cm._commit = self

    def __call__(self, *args, **kwargs):
        if not self.entered.is_set():
            self.entered.set()
            assert self.release.wait(timeout=60)
        return self.real(*args, **kwargs)

    def restore(self):
        self.cm._commit = self.real


def _drive(cm, states, to_state):
    """The save sequence both packages get. Returns {label: refs}."""
    out = {}
    for i in range(4):                    # blocking commits
        cm.save(i, to_state(states[i]), blocking=True)
        out[f"blocking{i}"] = _refs(cm)
    gate = _Gate(cm)                      # in flight: 4; pending: 5, then 6
    cm.save(4, to_state(states[4]), blocking=False)
    assert gate.entered.wait(timeout=60)
    cm.save(5, to_state(states[5]), blocking=False)
    cm.save(6, to_state(states[6]), blocking=False)
    gate.release.set()
    cm.wait()
    gate.restore()
    out["coalesced"] = _refs(cm)
    assert "m/step5" not in cm.lineage.nodes   # 5 merged into 6
    # rollback: restore an earlier step, then re-commit step 5 and 6
    _, start = cm.restore(step=2)
    out["restored"] = start
    cm.save(5, to_state(states[7]), blocking=True)
    cm.save(6, to_state(states[8]), blocking=True)
    out["recommit"] = _refs(cm)
    return out


def _states():
    """Nine states: some steps change only the params (the opt leaves are
    then skipped by fingerprint), the rest change everything."""
    states = [_state(0)]
    for i in range(1, 9):
        keep = ("params",) if i in (2, 5) else ("params", "opt")
        states.append(_perturb(states[-1], seed=i, keep=keep))
    return states


@pytest.mark.parametrize("tier", ["exact", "lossy"])
def test_managers_commit_same_manifests_and_objects(tmp_path, tier):
    states = _states()
    kw = dict(model_name="m", tier=tier, keyframe_every=3)
    ref_cm = RefManager(str(tmp_path / "ref"), **kw)
    port_cm = CheckpointManager(str(tmp_path / "port"), backend="ref", **kw)
    ref_skipped = -int(REF_CKPT_STATS["leaves_skipped"])
    ref_out = _drive(ref_cm, states, lambda s: s)
    ref_skipped += int(REF_CKPT_STATS["leaves_skipped"])
    port_skipped = -int(CKPT_STATS["leaves_skipped"])
    port_out = _drive(port_cm, states, _port)
    port_skipped += int(CKPT_STATS["leaves_skipped"])
    assert port_out == ref_out
    # both skipped the same unchanged big opt leaves (states 2 and 5)
    assert port_skipped == ref_skipped > 0
    assert sorted(port_cm.store.cas.keys()) == sorted(ref_cm.store.cas.keys())
    lossy = {bool((port_cm.store.get_manifest(r).get("metadata") or {})
                  .get("lossy")) for r in _refs(port_cm).values()}
    assert lossy == ({False, True} if tier == "lossy" else {False})
    kinds = {e["kind"] for r in _refs(port_cm).values()
             for e in port_cm.store.get_manifest(r)["params"].values()}
    assert "xdelta" in kinds       # exact commits, keyframes included
    assert ("delta" in kinds) == (tier == "lossy")
    roots = list(_refs(port_cm).values())
    assert port_cm.store.fsck(roots)["ok"]
    ref_cm.close()
    port_cm.close()


@pytest.mark.parametrize("tier", ["exact", "lossy"])
def test_restore_matches_reference_bit_for_bit(tmp_path, tier):
    states = _states()[:5]
    kw = dict(model_name="m", tier=tier, keyframe_every=3, async_save=False)
    ref_cm = RefManager(str(tmp_path / "ref"), **kw)
    port_cm = CheckpointManager(str(tmp_path / "port"), backend="ref", **kw)
    for i, s in enumerate(states):
        ref_cm.save(i, s)
        port_cm.save(i, _port(s))
    for step in range(5):
        ref_flat, ref_step = ref_cm.restore(step=step, allow_lossy=True)
        template = _port(states[0])
        port_state, port_step = port_cm.restore(step=step, template=template,
                                                allow_lossy=True)
        assert port_step == ref_step == step
        port_flat = flatten_state(port_state)
        assert list(port_flat) == list(ref_flatten(states[0]))
        for k, v in ref_flat.items():
            v = np.asarray(v).reshape(port_flat[k].shape)
            assert v.dtype == port_flat[k].dtype
            assert v.tobytes() == port_flat[k].tobytes(), (step, k)
        if tier == "exact":    # and the exact tier gives back the live state
            live = ref_flatten(states[step])
            assert all(live[k].tobytes() == port_flat[k].tobytes()
                       for k in live)
    # every leaf comes back as a tensor in the template's dtype and shape
    restored, _ = port_cm.restore(template=_port(states[0]))
    assert isinstance(restored["opt"], adamw.OptState)
    assert restored["step"].dtype == torch.int32 and restored["step"].dim() == 0


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_restores_the_others_directory(tmp_path, writer):
    states = _states()[:4]
    root = str(tmp_path / "ckpt")
    if writer == "port":
        cm = CheckpointManager(root, model_name="m", backend="ref",
                               async_save=False)
        for i, s in enumerate(states):
            cm.save(i, _port(s))
        reader = RefManager(root, model_name="m", async_save=False)
        flat, step = reader.restore(verify=True)
        roots = list(_refs(reader).values())
    else:
        cm = RefManager(root, model_name="m", async_save=False)
        for i, s in enumerate(states):
            cm.save(i, s)
        reader = CheckpointManager(root, model_name="m", backend="ref",
                                   async_save=False)
        state, step = reader.restore(verify=True, template=_port(states[0]))
        flat = flatten_state(state)
        roots = list(_refs(reader).values())
    assert step == 3
    live = ref_flatten(states[3])
    for k, v in live.items():
        assert np.asarray(flat[k]).reshape(v.shape).tobytes() == v.tobytes()
    assert RefManager(root, model_name="m").store.fsck(roots)["ok"]
    assert CheckpointManager(root, model_name="m",
                             backend="ref").store.fsck(roots)["ok"]


def test_crash_between_manifest_and_lineage_rolls_back(tmp_path):
    """A kill between the manifest landing and the lineage write: a fresh
    manager rolls the orphan back, resumes the previous step, fsck is
    clean, and the step commits again."""
    root = str(tmp_path)
    cm = CheckpointManager(root, model_name="m", backend="ref",
                           async_save=False)
    cm.save(1, _port(_state(1)), blocking=True)

    def killed(*a, **k):
        raise OSError("simulated kill mid-commit")

    cm.lineage.save = killed
    with pytest.raises(OSError):
        cm.save(2, _port(_state(2)), blocking=True)
    assert os.path.exists(os.path.join(root, "ckpt_journal.json"))

    before = int(CKPT_STATS["journal_rollbacks"])
    cm2 = CheckpointManager(root, model_name="m", backend="ref",
                            async_save=False)
    assert int(CKPT_STATS["journal_rollbacks"]) - before == 1
    assert not os.path.exists(os.path.join(root, "ckpt_journal.json"))
    assert cm2.latest_step() == 1
    restored, step = cm2.restore(template=_port(_state()))
    assert step == 1
    live = ref_flatten(_state(1))
    assert all(v.tobytes() == flatten_state(restored)[k].tobytes()
               for k, v in live.items())
    roots = list(_refs(cm2).values())
    assert cm2.store.fsck(roots)["ok"]
    # the reference's manager sees the same clean, rolled-back directory
    assert RefManager(root, model_name="m").latest_step() == 1
    cm2.save(2, _port(_state(2)), blocking=True)
    assert cm2.latest_step() == 2


def test_async_error_surfaces_on_next_save(tmp_path):
    cm = CheckpointManager(str(tmp_path), model_name="m", backend="ref")

    def boom(*a, **k):
        raise RuntimeError("injected commit failure")

    cm._commit = boom
    cm.save(0, _port(_state(0)))
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        cm.wait()
    assert cm._last_fps == {} and cm._prev_flat is None


def test_snapshot_copies_host_leaves(tmp_path):
    """A saved CPU state may be overwritten in place right after save():
    the commit still stores the values at save time."""
    cm = CheckpointManager(str(tmp_path), model_name="m", backend="ref")
    state = _port(_state(0))
    gate = _Gate(cm)
    cm.save(0, state)
    assert gate.entered.wait(timeout=60)
    expected = flatten_state(state)
    for leaf in (state["params"]["embed"]["tok"], state["opt"].mu["layers"]["w"]):
        leaf.add_(1.0)
    gate.release.set()
    cm.wait()
    gate.restore()
    flat, _ = cm.restore()
    for k, v in expected.items():
        assert np.asarray(flat[k]).reshape(v.shape).tobytes() == v.tobytes()


def test_restore_places_leaves_on_the_template_device(tmp_path):
    cm = CheckpointManager(str(tmp_path), model_name="m", backend="ref",
                           async_save=False)
    cm.save(0, _port(_state(0)))
    template = _port(_state(5))
    template["params"]["layers"]["w"] = template["params"]["layers"]["w"].to(
        "meta")
    restored, _ = cm.restore_sharded(template)
    assert restored["params"]["layers"]["w"].device.type == "meta"
    assert restored["params"]["embed"]["tok"].device.type == "cpu"
    with pytest.raises(KeyError):
        cm.restore(template={"other": torch.zeros(2)})
