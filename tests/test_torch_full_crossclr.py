"""The port's full CrossCLR loss (pruning and connectivity-weighted
positives) against the JAX package's.

``losses.functional`` (the connectivity functions and ``cross_clr``),
``losses.criterion.CrossCLR`` and the trainer's weighting diagnostic on
the same numpy inputs as ``crossclr_tpu``; the cases of
``tests/test_weighting.py``'s unit section; and 5 trainer steps of
``crossclr`` and ``crossclr_fused`` (learnable τ, ragged transformer
towers of width 32) against the JAX trainer from the same Flax
parameters.

Tolerances (the JAX tests'): values atol = rtol = 2e-5 (fp32 sums in
another order); gradients, dτ included, rtol 2e-4 and atol 2e-5; keep
masks exactly; trainer steps as ``tests/test_torch_train_transformer.py``
holds them (loss and gradient norm rtol 1e-5, parameters atol 2e-5, a
key bias at lr × steps).  jax is imported inside the tests that need it.
"""

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.data import SyntheticPairs, epoch_batches
from crossclr_tpu_torch.losses import criterion as C
from crossclr_tpu_torch.losses import functional as F
from crossclr_tpu_torch.models.encoders import DualEncoder, TowerConfig
from crossclr_tpu_torch.training import TrainConfig, Trainer
from crossclr_tpu_torch.utils.params import state_dict_from_flax
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=err_msg)


# --------------------------------------------------------------------------
# connectivity and weights
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape,masked", [((48, 12), False), ((48, 5, 12), False),
                                          ((48, 5, 12), True)])
def test_connectivity_scores_match_jax(shape, masked):
    import jax.numpy as jnp

    from crossclr_tpu.losses import functional as JF

    (x,) = _arrays(0, shape)
    mask = None
    if masked:
        lengths = np.random.default_rng(1).integers(1, shape[1] + 1, shape[0])
        mask = (np.arange(shape[1])[None, :] < lengths[:, None]).astype(np.float32)
    pooled = F.masked_mean_pool(torch.from_numpy(x),
                                None if mask is None else torch.from_numpy(mask))
    jpooled = JF.masked_mean_pool(jnp.asarray(x),
                                  None if mask is None else jnp.asarray(mask))
    _close(pooled.numpy(), jpooled, RTOL, ATOL)
    _close(F.pooled_unit_inputs(pooled).numpy(), JF.pooled_unit_inputs(jpooled),
           RTOL, ATOL)
    _close(F.connectivity_scores(pooled).numpy(), JF.connectivity_scores(jpooled),
           RTOL, ATOL)


def test_pooled_unit_inputs_carry_no_gradient():
    x = torch.randn(8, 4, 6, requires_grad=True)
    assert not F.pooled_unit_inputs(x).requires_grad
    assert not F.connectivity_scores(x).requires_grad


@pytest.mark.parametrize("prune,weight_norm,tw", [
    (0.0, "raw", 0.0035), (0.1, "raw", 0.0035), (0.1, "standardized", 1.0),
    (0.25, "raw", 0.5)])
def test_keep_and_weights_match_jax(prune, weight_norm, tw):
    import jax.numpy as jnp

    from crossclr_tpu.losses import functional as JF

    conn = _arrays(2, (64,))[0] * 0.01
    kw = dict(prune_percent=prune, weight_temperature=tw, weight_norm=weight_norm)
    keep, w = F.connectivity_keep_and_weights(torch.from_numpy(conn), **kw)
    jkeep, jw = JF.connectivity_keep_and_weights(jnp.asarray(conn), **kw)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    _close(w.numpy(), jw, RTOL, ATOL)
    _close(F.weight_effective_fraction(w).item(), JF.weight_effective_fraction(jw),
           RTOL, ATOL)


@pytest.mark.parametrize("prune", [0.1, 0.5, 0.75])
def test_ties_at_the_quantile_are_kept(prune):
    """Repeated scores at the quantile: ``conn <= q`` keeps every tie, as
    the JAX package does (both quantiles interpolate linearly)."""
    import jax.numpy as jnp

    from crossclr_tpu.losses import functional as JF

    conn = np.repeat(np.float32([0.1, 0.2, 0.3, 0.4]), [3, 5, 4, 4])
    np.random.default_rng(3).shuffle(conn)
    kw = dict(prune_percent=prune, weight_temperature=1.0)
    keep, _ = F.connectivity_keep_and_weights(torch.from_numpy(conn), **kw)
    jkeep, _ = JF.connectivity_keep_and_weights(jnp.asarray(conn), **kw)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    q = float(torch.quantile(torch.from_numpy(conn), 1.0 - prune))
    assert keep.sum().item() == int((conn <= q).sum())
    assert bool(keep[torch.from_numpy(conn) == q].all())


# the unit cases of tests/test_weighting.py


def test_standardized_weights_are_scale_invariant():
    conn = torch.from_numpy(np.random.default_rng(0).standard_normal(128) * 0.01)
    kw = dict(prune_percent=0.1, weight_temperature=1.0, weight_norm="standardized")
    _, w1 = F.connectivity_keep_and_weights(conn, **kw)
    _, w2 = F.connectivity_keep_and_weights(conn * 1000.0 + 5.0, **kw)
    np.testing.assert_allclose(w1.numpy(), w2.numpy(), rtol=1e-5)
    _, r1 = F.connectivity_keep_and_weights(conn, prune_percent=0.1,
                                            weight_temperature=1.0)
    _, r2 = F.connectivity_keep_and_weights(conn * 1000.0, prune_percent=0.1,
                                            weight_temperature=1.0)
    assert F.weight_effective_fraction(r1).item() > 0.9  # near-flat
    assert F.weight_effective_fraction(r2).item() < 0.2  # degenerate


def test_raw_paper_tau_degenerates_on_wide_spread():
    conn = torch.linspace(-0.3, 0.3, 256)
    _, w_raw = F.connectivity_keep_and_weights(conn, prune_percent=0.1,
                                               weight_temperature=0.0035)
    _, w_std = F.connectivity_keep_and_weights(conn, prune_percent=0.1,
                                               weight_temperature=1.0,
                                               weight_norm="standardized")
    assert F.weight_effective_fraction(w_raw).item() < 0.02
    assert F.weight_effective_fraction(w_std).item() > 0.3


def test_effective_fraction_bounds():
    assert F.weight_effective_fraction(torch.ones(64)).item() == pytest.approx(1.0)
    one_hot = torch.zeros(64)
    one_hot[3] = 64.0
    assert F.weight_effective_fraction(one_hot).item() == pytest.approx(1 / 64)


def test_weights_stay_mean_one_under_both_norms():
    conn = torch.from_numpy(np.random.default_rng(1).standard_normal(96))
    for norm, wt in (("raw", 0.5), ("standardized", 1.0)):
        _, w = F.connectivity_keep_and_weights(conn, prune_percent=0.2,
                                               weight_temperature=wt,
                                               weight_norm=norm)
        assert w.mean().item() == pytest.approx(1.0, rel=1e-5)


def test_unknown_weight_norm_rejected():
    with pytest.raises(ValueError, match="weight_norm"):
        F.normalized_connectivity(torch.ones(4), "bogus")


# --------------------------------------------------------------------------
# the loss and the criterion
# --------------------------------------------------------------------------

LOSS_CASES = [(prune, norm, tw, raw, tensor_tau)
              for prune in (0.0, 0.1)
              for norm, tw in (("raw", 0.0035), ("standardized", 1.0))
              for raw in (None, 2, 3)
              for tensor_tau in (False, True)
              if not (tensor_tau and raw == 2)]


@pytest.mark.parametrize("prune,weight_norm,tw,raw,tensor_tau", LOSS_CASES)
def test_cross_clr_matches_jax(prune, weight_norm, tw, raw, tensor_tau):
    """Value and gradients (and dτ at a tensor τ) of ``cross_clr`` without
    raw inputs, with ``[B, D]`` and with ``[B, S, D]`` raw inputs."""
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.losses import functional as JF

    v, t = _arrays(4, (40, 16), (40, 16))
    vi = ti = None
    if raw is not None:
        shape = (40, 20) if raw == 2 else (40, 3, 20)
        vi, ti = _arrays(5, shape, shape)
    kw = dict(prune_percent=prune, weight_norm=weight_norm, weight_temperature=tw)
    tv, tt = (torch.tensor(x, requires_grad=True) for x in (v, t))
    tau = torch.tensor(0.05, requires_grad=True) if tensor_tau else 0.05
    loss = F.cross_clr(tv, tt, None if vi is None else torch.from_numpy(vi),
                       None if ti is None else torch.from_numpy(ti),
                       temperature=tau, **kw)
    loss.backward()

    def ref(a, b, tau_):
        return JF.cross_clr(a, b, vi, ti, temperature=tau_, **kw)

    value, grads = jax.value_and_grad(ref, argnums=(0, 1, 2))(
        jnp.asarray(v), jnp.asarray(t), jnp.asarray(0.05, jnp.float32))
    np.testing.assert_allclose(loss.item(), float(value), rtol=RTOL, atol=ATOL)
    _close(tv.grad.numpy(), grads[0], err_msg="dv")
    _close(tt.grad.numpy(), grads[1], err_msg="dt")
    if tensor_tau:
        _close(tau.grad.numpy(), grads[2], err_msg="dtau")


@pytest.mark.parametrize("weight_norm,tw", [("raw", 0.0035), ("standardized", 1.0)])
@pytest.mark.parametrize("prune", [0.0, 0.1])
def test_criterion_matches_jax(weight_norm, tw, prune):
    from crossclr_tpu.losses import criterion as JC

    v, t, vi, ti = _arrays(6, (32, 16), (32, 16), (32, 24), (32, 24))
    kw = dict(weight_temperature=tw, prune_percent=prune, weight_norm=weight_norm)
    port, ref = C.CrossCLR(**kw), JC.CrossCLR(**kw)
    for args in ((v, t), (v, t, vi, ti)):
        np.testing.assert_allclose(
            port(*(torch.from_numpy(x) for x in args)).item(), float(ref(*args)),
            rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

BASE = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20, temperature=0.1)
STEPS = 5


def _tower(cls, dtype, input_dim, seq_len):
    return cls(kind="transformer", input_dim=input_dim, embed_dim=32,
               hidden_dim=48, num_layers=2, num_heads=4, max_seq_len=seq_len,
               dtype=dtype)


def _data(n_batches=STEPS, seed=0):
    return SyntheticPairs(num_pairs=16 * n_batches, video_dim=12, text_dim=10,
                          video_seq_len=8, text_seq_len=6,
                          variable_lengths=True, seed=seed)


TRAINER_CASES = [
    ("crossclr", dict(learnable_temperature=True)),
    ("crossclr_fused", dict(learnable_temperature=True)),
    ("crossclr_fused", dict(learnable_temperature=True, weight_norm="standardized",
                            weight_temperature=1.0, prune_percent=0.25)),
]


@pytest.mark.parametrize("loss,extra", TRAINER_CASES)
def test_five_steps_match_the_jax_trainer(loss, extra):
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.models import TowerConfig as JTowerConfig
    from crossclr_tpu.training import TrainConfig as JTrainConfig
    from crossclr_tpu.training import Trainer as JTrainer

    cfg = {**BASE, "loss": loss, **extra}
    batches = list(epoch_batches(_data(), 16))
    assert all(b["video_mask"].min() == 0 for b in batches)  # ragged
    jt = JTrainer(_tower(JTowerConfig, jnp.float32, 12, 8),
                  _tower(JTowerConfig, jnp.float32, 10, 6), JTrainConfig(**cfg))
    jstate = jt.init_state(batches[0]["video"], batches[0]["text"])
    pt = Trainer(_tower(TowerConfig, torch.float32, 12, 8),
                 _tower(TowerConfig, torch.float32, 10, 6), TrainConfig(**cfg),
                 device="cpu")
    module = DualEncoder(pt.video_cfg, pt.text_cfg)
    pstate = pt.init_state(state_dict_from_flax(jax.device_get(jstate.params), module))
    for batch in batches:
        jstate, jm = jt.train_step(jstate, batch)
        pstate, pm = pt.train_step(pstate, batch)
        for key in ("loss", "grad_norm", "logit_scale"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
    want = state_dict_from_flax(jax.device_get(jstate.params), module)
    got = pstate.model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        # a key bias's true gradient is exactly zero: see
        # tests/test_torch_train_transformer.py
        atol = BASE["learning_rate"] * STEPS if k.endswith("key.bias") else 2e-5
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=atol, err_msg=k)


def _mlp_trainer(**cfg):
    tower = dict(kind="mlp", embed_dim=16, hidden_dim=32, dtype=torch.float32)
    return Trainer(TowerConfig(input_dim=24, **tower), TowerConfig(input_dim=20, **tower),
                   TrainConfig(**{**BASE, "loss": "crossclr", **cfg}), device="cpu")


def _batch(n=64):
    data = SyntheticPairs(num_pairs=n, video_dim=24, text_dim=20, seed=3)
    return {"video": data.video, "text": data.text}


def test_degeneracy_check_matches_the_jax_trainer():
    from crossclr_tpu.models import TowerConfig as JTowerConfig
    from crossclr_tpu.training import TrainConfig as JTrainConfig
    from crossclr_tpu.training import Trainer as JTrainer

    batch = next(epoch_batches(_data(1), 16))
    cfg = dict(loss="crossclr", weight_temperature=0.01)
    jt = JTrainer(_tower(JTowerConfig, np.float32, 12, 8),
                  _tower(JTowerConfig, np.float32, 10, 6), JTrainConfig(**cfg))
    pt = Trainer(_tower(TowerConfig, torch.float32, 12, 8),
                 _tower(TowerConfig, torch.float32, 10, 6), TrainConfig(**cfg),
                 device="cpu")
    got, want = pt.weight_degeneracy_check(batch), jt.weight_degeneracy_check(batch)
    assert got.keys() == want.keys() == {"video", "text"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    assert _mlp_trainer(loss="crossclr_intra").weight_degeneracy_check(batch) is None


def test_fit_warns_on_degenerate_weight_softmax(capfd):
    trainer = _mlp_trainer(weight_temperature=1e-6)
    batch = _batch()
    trainer.fit(trainer.init_state(), iter([batch, batch]), steps=2, log_every=1)
    err = capfd.readouterr().err
    assert "near-one-hot" in err and "weight_norm" in err
    # once per trainer: the next fit stays silent
    trainer.fit(trainer.init_state(), iter([batch]), steps=1, log_every=1)
    assert "near-one-hot" not in capfd.readouterr().err


def test_fit_silent_on_healthy_weights(capfd):
    trainer = _mlp_trainer(weight_temperature=1.0, weight_norm="standardized")
    batch = _batch()
    state, history = trainer.fit(trainer.init_state(), iter([batch]), steps=1,
                                 log_every=1)
    err = capfd.readouterr().err
    assert "near-one-hot" not in err
    # the ESS line reports what the check computed
    fracs = trainer.weight_degeneracy_check(batch)
    assert (f"positive-weight ESS on the first batch: video ESS={fracs['video']:.4f}, "
            f"text ESS={fracs['text']:.4f}") in err
    assert state.step == 1 and len(history) == 1  # the first batch still trains
    assert min(trainer.weight_degeneracy_check(batch).values()) > 0.3
