"""The port's trainer on transformer towers against the JAX trainer.

Both trainers start from the same Flax parameters (moved into the port by
``utils.params.state_dict_from_flax``) and take the same numpy batches:
two-layer towers of width 32 with four heads, ragged sequence masks,
fp32, batch 16.  On the CPU the flash tower's attention is the plain
version in both packages.

Tolerances: the loss and the gradient norm of each step at rtol 1e-5, and
every parameter after 5 steps at atol 2e-5, as for the MLP towers — except
``*.key.bias``.  A key bias adds the same amount to every logit of a
softmax row, so its true gradient is exactly zero; what either package
computes for it is rounding noise, which AdamW turns into steps as large
as the learning rate.  It is held at atol = learning rate × steps.

Dropout (``attention="flash"``) cannot be held against the JAX trainer:
the JAX towers draw their seeds from ``jax.random``.  It is held against
itself: the same (seed, step) gives the same step, another step another
mask, eval mode no dropout, and a resumed run the uninterrupted one.
"""

import csv

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.data import SyntheticPairs, epoch_batches, infinite_batches
from crossclr_tpu_torch.models.encoders import DualEncoder, TowerConfig
from crossclr_tpu_torch.training import CheckpointManager, TrainConfig, Trainer
from crossclr_tpu_torch.utils.params import state_dict_from_flax
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

BASE = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20, temperature=0.1)
STEPS = 5
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
# the exactly-zero true gradient of a key bias: see the module docstring
KEY_BIAS_ATOL = BASE["learning_rate"] * STEPS


def _tower(cls, dtype, input_dim, seq_len, **kw):
    return cls(kind="transformer", input_dim=input_dim, embed_dim=32,
               hidden_dim=48, num_layers=2, num_heads=4, max_seq_len=seq_len,
               dtype=dtype, **kw)


def _data(n_batches=STEPS, seed=0):
    return SyntheticPairs(num_pairs=16 * n_batches, video_dim=12, text_dim=10,
                          video_seq_len=8, text_seq_len=6,
                          variable_lengths=True, seed=seed)


def _port_trainer(attention="flash", dropout=0.0, device="cpu", **cfg):
    return Trainer(
        _tower(TowerConfig, torch.float32, 12, 8, attention=attention,
               dropout=dropout),
        _tower(TowerConfig, torch.float32, 10, 6, attention=attention,
               dropout=dropout),
        TrainConfig(**{**BASE, **cfg}), device=device)


def _state_dicts_close(got, want):
    assert got.keys() == want.keys()
    for k in got:
        atol = KEY_BIAS_ATOL if k.endswith("key.bias") else PARAM_ATOL
        np.testing.assert_allclose(got[k].float().cpu().numpy(),
                                   want[k].float().cpu().numpy(),
                                   rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_five_steps_match_the_jax_trainer(attention):
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.models import TowerConfig as JTowerConfig
    from crossclr_tpu.training import TrainConfig as JTrainConfig
    from crossclr_tpu.training import Trainer as JTrainer

    cfg = {**BASE, "loss": "crossclr_intra_fused"}
    batches = list(epoch_batches(_data(), 16))
    assert all(b["video_mask"].min() == 0 for b in batches)  # ragged
    jt = JTrainer(_tower(JTowerConfig, jnp.float32, 12, 8, attention=attention),
                  _tower(JTowerConfig, jnp.float32, 10, 6, attention=attention),
                  JTrainConfig(**cfg))
    jstate = jt.init_state(batches[0]["video"], batches[0]["text"])
    pt = _port_trainer(attention, **cfg)
    module = DualEncoder(pt.video_cfg, pt.text_cfg)
    pstate = pt.init_state(state_dict_from_flax(jax.device_get(jstate.params), module))
    for batch in batches:
        jstate, jm = jt.train_step(jstate, batch)
        pstate, pm = pt.train_step(pstate, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                       rtol=LOSS_RTOL, err_msg=key)
    assert pstate.step == int(jstate.step) == STEPS
    want = state_dict_from_flax(jax.device_get(jstate.params), module)
    _state_dicts_close(pstate.model.state_dict(), want)


def _one_step(trainer, batch, step=0):
    state = trainer.init_state()
    state.step = step
    state, metrics = trainer.train_step(state, batch)
    return state, float(metrics["loss"])


def test_dropout_step_is_a_function_of_seed_and_step():
    batch = next(epoch_batches(_data(1), 16))
    (a, loss_a), (b, loss_b) = (_one_step(_port_trainer(dropout=0.3), batch)
                                for _ in range(2))
    assert loss_a == loss_b
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    # another step draws other masks: another loss on the same weights
    _, loss_c = _one_step(_port_trainer(dropout=0.3), batch, step=1)
    _, loss_off = _one_step(_port_trainer(), batch)
    assert loss_c != loss_a and loss_off not in (loss_a, loss_c)
    # and another train.seed other masks too
    _, loss_d = _one_step(_port_trainer(dropout=0.3, seed=1), batch)
    _, loss_d_off = _one_step(_port_trainer(seed=1), batch)
    assert loss_d != loss_d_off


def test_dropout_masks_follow_the_kernel_hash():
    """Train mode draws one seed per attention call from the model's
    generator, in module order, and applies exactly the mask that
    ``dropout_keep_mask`` gives for it."""
    import importlib

    fa = importlib.import_module("crossclr_tpu_torch.ops.flash_attention")
    trainer = _port_trainer(dropout=0.4)
    model = trainer.init_state().model.train()
    calls = []

    def spy(q, k, v, mask, **drop):
        calls.append(drop)
        return fa.mha_reference(q, k, v, mask, **drop)

    for m in model.modules():
        if hasattr(m, "attend"):
            m.attend = spy
    batch = next(epoch_batches(_data(1), 16))
    video, text = torch.from_numpy(batch["video"]), torch.from_numpy(batch["text"])
    masks = torch.from_numpy(batch["video_mask"]), torch.from_numpy(batch["text_mask"])
    model.reseed_dropout(0, 3)
    out = model(video, text, *masks)
    seeds = [c["dropout_seed"] for c in calls]
    assert len(seeds) == 4 and all(0 <= s < 1 << 23 for s in seeds)
    assert all(c["dropout_rate"] == 0.4 for c in calls)
    gen = torch.Generator().manual_seed((0 << 32) + 3)
    assert seeds == [int(torch.randint(0, 1 << 23, (), generator=gen))
                     for _ in range(4)]
    model.reseed_dropout(0, 3)
    again = model(video, text, *masks)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


def test_step_model_sets_train_mode_and_the_steps_generator():
    """``Trainer.step_model``, which both ``train_step`` and the profiler's
    split call, puts the model in train mode and reseeds its dropout
    generator from ``(train.seed, step)`` alone."""
    trainer = _port_trainer(dropout=0.3, seed=2)
    state = trainer.init_state()
    state.step = 7
    assert not state.model.training
    model = trainer.step_model(state)
    assert model is state.model and model.training
    draw = torch.randint(0, 1 << 23, (3,), generator=model.dropout_gen)
    want = torch.Generator().manual_seed((2 << 32) + 7)
    assert torch.equal(draw, torch.randint(0, 1 << 23, (3,), generator=want))
    trainer.step_model(state)
    assert torch.equal(draw, torch.randint(0, 1 << 23, (3,),
                                           generator=model.dropout_gen))


def test_eval_equals_the_dropout_free_tower():
    batch = next(epoch_batches(_data(1), 16))
    with_dropout = _port_trainer(dropout=0.5)
    without = _port_trainer()
    a = with_dropout.encode(with_dropout.init_state(), batch)
    b = without.encode(without.init_state(), batch)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_dropout_resume_equals_an_uninterrupted_run(tmp_path):
    data = _data(8, seed=2)
    trainer = _port_trainer(dropout=0.2)
    whole, _ = trainer.fit(trainer.init_state(), infinite_batches(data, 16), steps=6)

    first = _port_trainer(dropout=0.2)
    state, _ = first.fit(first.init_state(), infinite_batches(data, 16), steps=3)
    mngr = CheckpointManager(tmp_path / "ckpt")
    mngr.save(3, state)
    second = _port_trainer(dropout=0.2)
    resumed = mngr.restore(second.init_state())
    resumed, _ = second.fit(resumed, infinite_batches(data, 16, start_step=3),
                            steps=3)
    assert resumed.step == whole.step == 6
    for k, v in whole.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k


def test_xla_dropout_is_refused_in_train_mode_only():
    with pytest.raises(NotImplementedError, match="item 10"):
        _port_trainer("xla", dropout=0.1)
    # the module itself refuses only when it would drop
    model = DualEncoder(_tower(TowerConfig, torch.float32, 12, 8, dropout=0.1),
                        _tower(TowerConfig, torch.float32, 10, 6, dropout=0.1))
    x = torch.zeros(2, 8, 12)
    model.eval().encode("video", x)
    with pytest.raises(NotImplementedError, match="jax.random"):
        model.train().encode("video", x)


# --------------------------------------------------------------------------
# the CLI on the LSMDC config, at tiny widths
# --------------------------------------------------------------------------

CLI_ARGS = [
    "--config", "configs/lsmdc_transformer.json", "--device", "cpu",
    "video_tower.attention=flash", "text_tower.attention=flash",
    "video_tower.dropout=0.1", "text_tower.dropout=0.1",
    "video_tower.input_dim=12", "text_tower.input_dim=10",
    "video_tower.embed_dim=16", "text_tower.embed_dim=16",
    "video_tower.hidden_dim=32", "text_tower.hidden_dim=32",
    "video_tower.num_layers=1", "text_tower.num_layers=1",
    "video_tower.num_heads=2", "text_tower.num_heads=2",
    "data.source=synthetic", "data.num_pairs=160", "data.video_dim=12",
    "data.text_dim=10", "data.video_seq_len=8", "data.text_seq_len=6",
    "data.variable_lengths=true", "data.batch_size=16",
    "train.warmup_steps=2", "eval_every=3", "log_every=3",
]


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def test_cli_trains_the_transformer_config_evaluates_and_resumes(tmp_path):
    from crossclr_tpu_torch import train

    ckpt, metrics_csv = tmp_path / "ckpt", tmp_path / "metrics.csv"
    args = [*CLI_ARGS[:4], "--metrics-csv", str(metrics_csv), *CLI_ARGS[4:],
            f"checkpoint_dir={ckpt}"]
    assert train.main(["--steps", "6", *args]) == 0
    mngr = CheckpointManager(ckpt)
    assert mngr.latest_step() == 6
    rows = _rows(metrics_csv)
    evals = [r for r in rows if r.get("eval/v2t/R@1")]
    assert [int(r["step"]) for r in evals] == [3, 6]
    assert all(0.0 <= float(r["eval/t2v/R@1"]) <= 100.0 for r in evals)
    losses = [float(r["loss"]) for r in rows if r.get("loss")]
    assert losses and all(np.isfinite(losses))
    assert train.main(["--steps", "9", *args]) == 0
    assert mngr.latest_step() == 9
    steps = [int(r["step"]) for r in _rows(metrics_csv) if r.get("loss")]
    assert steps == sorted(steps) and steps[-1] == 9


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products, as on the CPU
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_cuda_dropout_train_steps_match_cpu(cuda):
    """Three steps with dropout 0.1 through the flash kernels on the card
    against the same steps on the CPU (plain attention): the same seeds
    give the same masks, so the steps agree within the fp32 limits."""
    import importlib

    fa = importlib.import_module("crossclr_tpu_torch.ops.flash_attention")
    batches = list(epoch_batches(_data(3), 16))
    states, losses = [], []
    before = dict(fa.launch_counts)
    for device in ("cpu", cuda):
        trainer = _port_trainer(dropout=0.1, device=device,
                                loss="crossclr_intra_fused")
        state = trainer.init_state()
        for batch in batches:
            state, m = trainer.train_step(state, batch)
            losses.append(float(m["loss"]))
        states.append(state.model.state_dict())
    np.testing.assert_allclose(losses[3:], losses[:3], rtol=LOSS_RTOL)
    _state_dicts_close(states[1], states[0])
    # 2 towers x 2 layers per step; no eval, so fwd = dq = dkv
    assert all(fa.launch_counts[k] - before[k] == 3 * 4 for k in fa.KERNELS)
