"""The port's GradCache two-pass step (``TrainConfig.embedding_chunk``)
against the JAX trainer's, against the port's own one-pass step, and its
dropout masks.

Both trainers start from the same Flax parameters (moved into the port by
``utils.params.state_dict_from_flax``) and take the same numpy batches of
the podslice towers narrowed to inputs 24 / 20, hidden 32, embed 16
(``configs/podslice_32k.json``: MLP towers, ``crossclr_intra_fused`` at a
static τ), batch 64 in chunks of 16.

Tolerances: ``tests/test_torch_train.py``'s ``FP32`` (loss and gradient
norm rtol 1e-5, parameters atol 2e-5) and ``BF16`` (loss atol 5e-2,
parameters atol 2e-3) against the JAX trainer.  Against the port's one
pass step the two-pass gradients come from the same arithmetic summed in
another order (chunked products, then a sum over chunks): every gradient
within 1e-5 of its largest entry, the loss within rtol 1e-6.  Pass 3
re-encodes each chunk with pass 1's dropout masks: its embeddings equal
pass 1's bit for bit.
"""

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.data import SyntheticPairs, epoch_batches
from crossclr_tpu_torch.models.encoders import DualEncoder, TowerConfig
from crossclr_tpu_torch.training import TrainConfig, Trainer
from crossclr_tpu_torch.utils.params import state_dict_from_flax

FP32 = dict(loss_rtol=1e-5, loss_atol=0.0, param_atol=2e-5)
BF16 = dict(loss_rtol=0.0, loss_atol=5e-2, param_atol=2e-3)
BASE = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20, temperature=0.1)
BATCH, CHUNK, STEPS = 64, 16, 3
GRAD_BOUND = 1e-5  # two-pass vs one-pass: max |error| / max |gradient|


def _tower(cls, dtype, input_dim):
    return cls(kind="mlp", input_dim=input_dim, embed_dim=16, hidden_dim=32,
               dtype=dtype)


def _batches(n=STEPS, seed=0):
    data = SyntheticPairs(num_pairs=BATCH * n, video_dim=24, text_dim=20, seed=seed)
    return list(epoch_batches(data, BATCH))


def _port_trainer(dtype=torch.float32, **cfg):
    return Trainer(_tower(TowerConfig, dtype, 24), _tower(TowerConfig, dtype, 20),
                   TrainConfig(**{**BASE, **cfg}), device="cpu")


CASES = [
    ("crossclr_intra_fused", "float32", {}),
    ("crossclr_intra_fused", "bfloat16", {}),
    ("crossclr_intra", "float32", dict(learnable_temperature=True,
                                       learning_rate=1e-2)),
]


@pytest.mark.parametrize("loss,dtype,extra", CASES)
def test_two_pass_matches_the_jax_trainer(loss, dtype, extra):
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.models import TowerConfig as JTowerConfig
    from crossclr_tpu.training import TrainConfig as JTrainConfig
    from crossclr_tpu.training import Trainer as JTrainer

    cfg = {**BASE, "loss": loss, "embedding_chunk": CHUNK, **extra}
    jdt, tdt, tol = {"float32": (jnp.float32, torch.float32, FP32),
                     "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}[dtype]
    batches = _batches()
    jt = JTrainer(_tower(JTowerConfig, jdt, 24), _tower(JTowerConfig, jdt, 20),
                  JTrainConfig(**cfg))
    jstate = jt.init_state(batches[0]["video"], batches[0]["text"])
    pt = _port_trainer(tdt, **cfg)
    module = DualEncoder(pt.video_cfg, pt.text_cfg)
    pstate = pt.init_state(state_dict_from_flax(jax.device_get(jstate.params), module))
    passes = []
    orig = pt.encode_chunks
    pt.encode_chunks = lambda *a: passes.append(1) or orig(*a)
    for batch in batches:
        jstate, jm = jt.train_step(jstate, batch)
        pstate, pm = pt.train_step(pstate, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                       rtol=tol["loss_rtol"], atol=tol["loss_atol"],
                                       err_msg=key)
    assert len(passes) == STEPS  # every step took the two-pass path
    if cfg.get("learnable_temperature"):
        assert float(pstate.model.logit_scale.detach()) != 0.0
    want = state_dict_from_flax(jax.device_get(jstate.params), module)
    got = pstate.model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].float().numpy(), want[k].float().numpy(),
                                   rtol=0, atol=tol["param_atol"], err_msg=k)


@pytest.mark.parametrize("loss,extra", [
    ("crossclr_intra_fused", {}),
    ("crossclr", {}),
    ("crossclr_intra", dict(learnable_temperature=True)),
])
def test_two_pass_gradients_equal_the_one_pass_step(loss, extra):
    """The gradient of every parameter, ``logit_scale`` under a learnable
    τ included (pass 2's direct gradient), and the loss: the two-pass step
    is the one-pass step's function (``tests/test_training.py``'s
    ``test_embedding_chunk_matches_plain_step``)."""
    plain = _port_trainer(loss=loss, **extra)
    chunked = _port_trainer(loss=loss, embedding_chunk=CHUNK, **extra)
    state_p, state_c = plain.init_state(), chunked.init_state()
    if extra:  # move logit_scale off 0 so its gradient is not special
        for state in (state_p, state_c):
            state.model.logit_scale.data.fill_(0.3)
    batch = _batches(1, seed=3)[0]
    loss_p, emb_p, grads_p = plain.value_and_grad(state_p, plain.step_inputs(batch))
    loss_c, emb_c, grads_c = chunked.value_and_grad(state_c, chunked.step_inputs(batch))
    np.testing.assert_allclose(float(loss_c.detach()), float(loss_p.detach()),
                               rtol=1e-6)
    for a, c in zip(emb_c, emb_p):
        torch.testing.assert_close(a, c.detach(), rtol=1e-6, atol=1e-6)
    assert grads_c.keys() == grads_p.keys()
    for name, g in grads_p.items():
        err = (grads_c[name] - g).abs().max().item()
        assert err <= GRAD_BOUND * max(g.abs().max().item(), 1e-30), (name, err)
    if extra:
        assert grads_p["logit_scale"].abs().item() > 0
    else:
        assert float(grads_c["logit_scale"]) == 0.0


def test_pass_three_redraws_the_dropout_masks_of_pass_one():
    """Flash-attention transformer towers with dropout 0.1: pass 3's
    embeddings of each chunk equal pass 1's bit for bit (the chunk index is
    folded into the dropout seed, as the JAX step folds it into its key),
    and the chunks draw different masks."""
    tower = dict(kind="transformer", embed_dim=16, hidden_dim=24, num_layers=1,
                 num_heads=2, attention="flash", dropout=0.1, dtype=torch.float32)
    trainer = Trainer(TowerConfig(input_dim=12, max_seq_len=8, **tower),
                      TowerConfig(input_dim=10, max_seq_len=6, **tower),
                      TrainConfig(**BASE, loss="crossclr_intra_fused",
                                  embedding_chunk=4), device="cpu")
    data = SyntheticPairs(num_pairs=16, video_dim=12, text_dim=10,
                          video_seq_len=8, text_seq_len=6, variable_lengths=True,
                          seed=1)
    batch = next(iter(epoch_batches(data, 16)))
    state = trainer.init_state()
    calls = []
    state.model.register_forward_hook(
        lambda module, args, out: calls.append(
            (torch.is_grad_enabled(), tuple(x.detach().clone() for x in out))))
    _, metrics = trainer.train_step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert [grad for grad, _ in calls] == [False] * 4 + [True] * 4
    pass1, pass3 = [out for _, out in calls[:4]], [out for _, out in calls[4:]]
    for first, again in zip(pass1, pass3):
        for a, b in zip(first, again):
            assert torch.equal(a, b)
    # the same rows under another chunk's seed draw other masks
    rows = tuple(None if x is None else x[:4] for x in trainer.step_inputs(batch))
    state.step = 0  # the step the hook saw
    with torch.no_grad():
        other = trainer.step_model(state, chunk=1)(*rows)
    assert not torch.equal(other[0], pass1[0][0])


def test_chunk_must_divide_the_batch_and_a_large_chunk_runs_one_pass():
    batch = _batches(1)[0]
    with pytest.raises(ValueError, match="does not divide"):
        trainer = _port_trainer(embedding_chunk=24)
        trainer.train_step(trainer.init_state(), batch)
    plain = _port_trainer()
    state_p, m_p = plain.train_step(plain.init_state(), batch)
    for chunk in (BATCH, 2 * BATCH):
        trainer = _port_trainer(embedding_chunk=chunk)
        trainer.encode_chunks = None  # the two-pass path would call it
        state, m = trainer.train_step(trainer.init_state(), batch)
        assert float(m["loss"]) == float(m_p["loss"])
        for k, p in state.model.state_dict().items():
            assert torch.equal(p, state_p.model.state_dict()[k]), k


@pytest.mark.parametrize("chunk,want", [(None, False), (16, True), (BATCH, False),
                                        (2 * BATCH, False)])
def test_two_pass_predicate(chunk, want):
    """``Trainer.two_pass`` is the gate ``value_and_grad`` and the profiler's
    split both take: a chunk set and below the batch."""
    assert _port_trainer(embedding_chunk=chunk).two_pass(BATCH) is want


@pytest.mark.parametrize("loss,learnable,budget,want", [
    ("crossclr_intra_fused", False, None, "sym"),
    ("crossclr_intra_fused", True, None, "dual"),
    ("crossclr_intra_fused", False, 1024, "per_direction"),
    ("crossclr_intra_fused", True, 1024, "dual"),
    ("crossclr_fused", False, None, "sym"),
    ("crossclr_fused", True, None, "dual"),
    ("crossclr_intra", False, None, None),
])
def test_loss_route_names_the_pair_the_step_runs(monkeypatch, loss, learnable,
                                                  budget, want):
    """``loss_route`` (which ``profile_train`` reports) names the pair a
    train step's loss launches; ``budget`` shrinks the per-direction
    boundary so a small batch crosses it."""
    from crossclr_tpu_torch.ops import fused_crossclr as fc
    from crossclr_tpu_torch.ops import fused_dual as fd
    from crossclr_tpu_torch.training import loss_route

    if budget is not None:
        monkeypatch.setattr(fc, "_MAX_COL_ACC_BYTES", budget)
    launched = []
    for mod, name, pair in ((fd, "sym_fwd", "sym"), (fd, "dual_fwd", "dual"),
                            (fc, "lse_fwd", "per_direction")):
        def spy(*args, _orig=getattr(mod, name), _pair=pair):
            launched.append(_pair)
            return _orig(*args)

        monkeypatch.setattr(mod, name, spy)
    trainer = _port_trainer(loss=loss, learnable_temperature=learnable)
    trainer.train_step(trainer.init_state(), _batches(1)[0])
    assert loss_route(trainer.cfg, BATCH, 16) == want
    assert sorted(set(launched)) == ([] if want is None else [want])
