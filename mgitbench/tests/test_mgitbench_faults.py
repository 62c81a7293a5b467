"""Each fault a cell can have, planted under the timed path, makes the
run's ``correct`` come out false; the unbroken run comes out true."""

import numpy as np
import pytest
import torch

from tiny import drive, tiny_run

LINEAGE = ["paper-bert-f32.lineage", "mamba2-780m-bf16-l8.lineage"]
SERVE = ["paper-bert-f32.classify", "mamba2-780m-bf16.longdoc"]


@pytest.mark.parametrize("cell", LINEAGE + SERVE)
def test_sound_run_is_correct(cell):
    run = drive(tiny_run(cell))
    assert run.correct, run.checks
    assert run.attempted > 0


@pytest.mark.parametrize("cell", LINEAGE)
def test_lineage_answer_altered(cell, monkeypatch):
    from repro_torch.store import ArtifactStore
    real = ArtifactStore.materialize_artifact

    def altered(self, ref, *a, **k):
        art = real(self, ref, *a, **k)
        key = sorted(art.params)[-1]
        v = np.array(art.params[key])
        flat = v.reshape(-1).view(np.uint16 if v.itemsize == 2 else np.uint32)
        flat[0] ^= 1
        art.params[key] = v
        return art

    monkeypatch.setattr(ArtifactStore, "materialize_artifact", altered)
    run = drive(tiny_run(cell))
    assert not run.correct
    assert run.checks["checkout_bits_differing"]["value"] > 0


@pytest.mark.parametrize("cell", LINEAGE)
def test_lineage_state_unchanged(cell, monkeypatch):
    """A commit whose quantize step returns a zero delta: the version is
    stored as its parent, unchanged."""
    from repro_torch.store import artifact_store
    real = artifact_store.host_snapshot

    def unchanged(p1, p2, eps):
        q, nz, narrow = real(p1, p1, eps)
        return q, nz, narrow

    monkeypatch.setattr(artifact_store, "host_snapshot", unchanged)
    run = drive(tiny_run(cell))
    assert not run.correct


@pytest.mark.parametrize("cell", LINEAGE)
def test_lineage_half_left_out(cell, monkeypatch):
    from repro_torch.store import ArtifactStore
    real = ArtifactStore.materialize_artifact

    def half(self, ref, keys=None, **k):
        art = real(self, ref, keys, **k)
        if keys is not None:        # the commit's read of its parent
            return art
        keys = sorted(art.params)
        art.params = {k: art.params[k] for k in keys[: len(keys) // 2]}
        return art

    monkeypatch.setattr(ArtifactStore, "materialize_artifact", half)
    run = drive(tiny_run(cell))
    assert not run.correct


@pytest.mark.parametrize("cell", SERVE)
def test_serve_token_altered(cell, monkeypatch):
    from repro_torch.serve.engine import ServeEngine
    real = ServeEngine.generate

    def altered(self, batch, n_tokens):
        out = real(self, batch, n_tokens).clone()
        out[0, -1] = (out[0, -1] + 1) % self.cfg.vocab_size
        return out

    monkeypatch.setattr(ServeEngine, "generate", altered)
    run = drive(tiny_run(cell))
    assert not run.correct
    assert run.checks["logit_gap"]["value"] > run.checks["logit_gap"]["limit"]


@pytest.mark.parametrize("cell", SERVE)
def test_serve_half_left_out(cell, monkeypatch):
    """The engine runs half of each batch; the other rows come back as
    token 0."""
    from repro_torch.serve.engine import ServeEngine
    real = ServeEngine.generate

    def half(self, batch, n_tokens):
        B = batch["tokens"].shape[0]
        part = {k: v[: B // 2] for k, v in batch.items()}
        out = real(self, part, n_tokens)
        return torch.cat([out, torch.zeros_like(out)[: B - B // 2]])

    monkeypatch.setattr(ServeEngine, "generate", half)
    run = drive(tiny_run(cell))
    assert not run.correct


def test_serve_decode_state_unchanged(monkeypatch):
    """Decode steps that leave the recurrent state as prefill left it. At
    this size a tied output head makes every token repeat the one before,
    state or no state, so the test model has a head of its own, and
    weights of std 0.1 give its logits the spread of the full model's."""
    from repro_torch.models import model
    real = model._ssm_step

    def stale(h, sp, cfg, state=None, conv=None):
        if state is None or h.shape[1] > 1:
            return real(h, sp, cfg, state, conv)
        keep = state.clone(), conv.clone()
        out = real(h, sp, cfg, state, conv)
        state.copy_(keep[0])
        conv.copy_(keep[1])
        return out

    untied = {"tie_embeddings": False, "init_std": 0.1}
    sound = drive(tiny_run("mamba2-780m-bf16.longdoc", generated=4,
                           model_kw=untied))
    assert sound.correct
    monkeypatch.setattr(model, "_ssm_step", stale)
    run = drive(tiny_run("mamba2-780m-bf16.longdoc", generated=4,
                         model_kw=untied))
    assert not run.correct
