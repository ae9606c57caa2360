"""The harness's look for a card skipped, the rest of a run driven with the
timed path broken underneath: ``correct`` comes out false for each fault
the cell can have (one card: no exchange between chips to leave out;
training answers nothing one by one, but a gathered row can be paired
wrong)."""

from __future__ import annotations

import pytest
import torch

from portbench.tests import tiny

TRAIN = ("lsmdc_train", "podslice_train")


def _unchanged(monkeypatch):
    from crossclr_tpu_torch.training import Trainer

    monkeypatch.setattr(Trainer, "apply_grads",
                        lambda self, state, grads: {"grad_norm": torch.zeros(())})


def _half_batch(monkeypatch):
    from crossclr_tpu_torch.training import Trainer

    original = Trainer.step_loss

    def half(self, model, v_emb, t_emb, *rest):
        n = v_emb.shape[0] // 2
        return original(self, model, v_emb[:n], t_emb[:n],
                        *(None if r is None else r[:n] for r in rest))

    monkeypatch.setattr(Trainer, "step_loss", half)


def _pairs_mixed(monkeypatch):
    """Each gathered batch's text rows shifted by one against its video."""
    from crossclr_tpu_torch.data import DevicePrefetcher

    original = DevicePrefetcher.__next__

    def mixed(self):
        chunk = original(self)
        return {**chunk, "text": chunk["text"].roll(1, dims=1)}

    monkeypatch.setattr(DevicePrefetcher, "__next__", mixed)


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _pairs_mixed],
                         ids=["state_unchanged", "half_batch", "pairs_mixed"])
def test_training_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    result = tiny.run(name)
    assert result["correct"] is False, result["checks"]
    if fault is _pairs_mixed:
        assert result["checks"]["pair_faults"]["value"] > 0


def test_frozen_queries_and_keys_are_not_correct(monkeypatch):
    """Attention's dq and dk left at nought in the transformer towers."""
    from crossclr_tpu_torch.models import encoders

    original = encoders.flash_attention

    def frozen(q, k, v, *args, **kw):
        return original(q.detach(), k.detach(), v, *args, **kw)

    monkeypatch.setattr(encoders, "flash_attention", frozen)
    result = tiny.run("lsmdc_train")
    assert result["correct"] is False, result["checks"]
