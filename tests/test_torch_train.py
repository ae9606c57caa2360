"""The port's trainer and training CLI against the JAX trainer.

Both trainers start from the same Flax parameters (moved into the port
by ``utils.params.state_dict_from_flax``) and take the same numpy batches
of small MLP towers (inputs 24 / 20, hidden 32, embed 16, batch 32).

Tolerances: fp32 towers — the loss and the gradient norm of each step at
rtol 1e-5, every parameter after 5 steps at atol 2e-5 (measured at most
2.7e-6 on the CPU: the same arithmetic, summed in another order).  bf16
towers — the loss at atol 5e-2 (bf16 rounds at other places in the two
frameworks, as for the towers alone) and the parameters at atol 2e-3
(measured 1.9e-4; an AdamW step moves a parameter by about the learning
rate, 1e-3).  Runs that the port repeats on itself (``steps_per_call``,
checkpoint resume) must agree exactly.
"""

import csv

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.data import SyntheticPairs, epoch_batches, infinite_batches
from crossclr_tpu_torch.evaluation import retrieval_metrics
from crossclr_tpu_torch.models.encoders import DualEncoder, TowerConfig
from crossclr_tpu_torch.training import (
    LAMB,
    AdamW,
    CheckpointManager,
    TrainConfig,
    Trainer,
    make_optimizer,
)
from crossclr_tpu_torch.utils.params import state_dict_from_flax
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

FP32 = dict(loss_rtol=1e-5, loss_atol=0.0, param_atol=2e-5)
BF16 = dict(loss_rtol=0.0, loss_atol=5e-2, param_atol=2e-3)
BASE = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20, temperature=0.1)


def _tower(cls, dtype, input_dim, **kw):
    return cls(kind="mlp", input_dim=input_dim, embed_dim=16, hidden_dim=32,
               dtype=dtype, **kw)


def _batches(n=5):
    data = SyntheticPairs(num_pairs=32 * n, video_dim=24, text_dim=20, seed=0)
    return list(epoch_batches(data, 32))


def _port_trainer(dtype=torch.float32, **cfg):
    return Trainer(_tower(TowerConfig, dtype, 24), _tower(TowerConfig, dtype, 20),
                   TrainConfig(**{**BASE, **cfg}), device="cpu")


def _state_dicts_close(a, b, atol):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].float().numpy(), b[k].float().numpy(),
                                   rtol=0, atol=atol, err_msg=k)


PARITY_CASES = [
    ("crossclr_intra", "float32", {}),
    ("crossclr_intra_fused", "float32", {}),
    # learnable τ through the dual route; from -4.602 the first updates
    # push logit_scale past -ln 100, so the clamp engages
    ("crossclr_intra_fused", "float32",
     dict(learnable_temperature=True, learning_rate=1e-2, logit_scale=-4.602)),
    ("crossclr_intra", "float32",
     dict(learnable_temperature=True, learning_rate=1e-2, logit_scale=4.602)),
    ("info_nce", "float32", dict(ema_decay=0.9, clip_norm=100.0)),
    ("max_margin", "float32", dict(weight_decay=0.1)),
    ("crossclr_intra", "bfloat16", {}),
]


@pytest.mark.parametrize("loss,dtype,extra", PARITY_CASES)
def test_five_steps_match_the_jax_trainer(loss, dtype, extra):
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.models import TowerConfig as JTowerConfig
    from crossclr_tpu.training import TrainConfig as JTrainConfig
    from crossclr_tpu.training import Trainer as JTrainer
    from crossclr_tpu.training.trainer import TrainState as JTrainState
    from crossclr_tpu.training.trainer import make_optimizer as jax_optimizer

    extra = dict(extra)
    logit_scale = extra.pop("logit_scale", None)
    cfg = {**BASE, "loss": loss, **extra}
    jdt, tdt, tol = {"float32": (jnp.float32, torch.float32, FP32),
                     "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}[dtype]
    batches = _batches()
    jt = JTrainer(_tower(JTowerConfig, jdt, 24), _tower(JTowerConfig, jdt, 20),
                  JTrainConfig(**cfg))
    jstate = jt.init_state(batches[0]["video"], batches[0]["text"])
    params = jax.device_get(jstate.params)
    if logit_scale is not None:
        params = jax.tree.map(jnp.asarray, dict(params, logit_scale=np.float32(logit_scale)))
        jstate = JTrainState.create(
            apply_fn=jstate.apply_fn, params=params, tx=jax_optimizer(jt.cfg),
            ema_params=None if jt.cfg.ema_decay is None else params)
    pt = _port_trainer(tdt, **cfg)
    module = DualEncoder(pt.video_cfg, pt.text_cfg)
    pstate = pt.init_state(state_dict_from_flax(jax.device_get(jstate.params), module))

    clamped = False
    for batch in batches:
        jstate, jm = jt.train_step(jstate, batch)
        pstate, pm = pt.train_step(pstate, batch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]),
                                       rtol=tol["loss_rtol"], atol=tol["loss_atol"],
                                       err_msg=key)
        if cfg.get("learnable_temperature"):
            np.testing.assert_allclose(float(pm["logit_scale"]), float(jm["logit_scale"]),
                                       rtol=0, atol=tol["param_atol"])
            np.testing.assert_allclose(float(pm["effective_temperature"]),
                                       float(jm["effective_temperature"]), rtol=1e-5)
            # the bound as the fp32 parameter stores it
            bound = np.float32(4.6051702)
            assert abs(np.float32(pm["logit_scale"])) <= bound
            clamped |= abs(np.float32(pm["logit_scale"])) == bound
    assert pstate.step == int(jstate.step) == len(batches)
    if logit_scale is not None and logit_scale < 0:
        assert clamped  # the clamp engaged on the way
    want = state_dict_from_flax(jax.device_get(jstate.params), module)
    _state_dicts_close(pstate.model.state_dict(), want, tol["param_atol"])
    if not cfg.get("learnable_temperature"):
        # a fixed τ leaves logit_scale exactly as it was: no gradient and
        # no weight decay (the decay mask)
        assert float(pstate.model.logit_scale.detach()) == 1.0
    if jstate.ema_params is not None:
        want = state_dict_from_flax(jax.device_get(jstate.ema_params), module)
        _state_dicts_close(pstate.ema, want, tol["param_atol"])


def test_logit_scale_starts_at_zero_under_learnable_temperature():
    """exp(logit_scale) = 1 must reproduce cfg.temperature at step 0, as in
    the JAX trainer (``crossclr_tpu/training/trainer.py:627``)."""
    learnable = _port_trainer(learnable_temperature=True).init_state()
    fixed = _port_trainer().init_state()
    assert float(learnable.model.logit_scale.detach()) == 0.0
    assert float(fixed.model.logit_scale.detach()) == 1.0


def test_schedule_and_clip_follow_optax():
    import optax

    cfg = TrainConfig(learning_rate=3e-4, warmup_steps=7, total_steps=50)
    opt = AdamW(cfg)
    schedule = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 7, 50)
    # optax evaluates the cosine in fp32, the port in float64 (the update
    # rounds the rate to fp32 where it multiplies): rtol 2e-6
    for count in range(0, 60):
        np.testing.assert_allclose(opt.learning_rate(count),
                                   float(schedule(count)), rtol=2e-6, atol=1e-12)
    assert opt.learning_rate(0) == 0.0  # the first update has lr 0
    # warmup + 1 guards decay_steps as in the JAX trainer
    assert AdamW(TrainConfig(warmup_steps=30, total_steps=10)).decay_steps == 31
    # optax's clip: g / ‖g‖ · c, with no epsilon
    p = {"w": torch.zeros(3)}
    state = AdamW.init(p)
    gnorm = AdamW(TrainConfig(clip_norm=1.0)).update(
        p, {"w": torch.tensor([3.0, 0.0, 4.0])}, state)
    assert float(gnorm) == 5.0
    torch.testing.assert_close(state["mu"]["w"], 0.1 * torch.tensor([0.6, 0.0, 0.8]))
    # LAMB shares the clip, the schedule and the moments' shape
    lamb = make_optimizer(TrainConfig(optimizer="lamb", clip_norm=1.0))
    assert isinstance(lamb, LAMB) and lamb.eps == 1e-6
    state = lamb.init(p)
    assert float(lamb.update(p, {"w": torch.tensor([3.0, 0.0, 4.0])}, state)) == 5.0
    torch.testing.assert_close(state["mu"]["w"], 0.1 * torch.tensor([0.6, 0.0, 0.8]))
    assert state["count"] == 1 and set(state) == {"count", "mu", "nu"}


def test_steps_per_call_equals_single_steps():
    data = SyntheticPairs(num_pairs=256, video_dim=24, text_dim=20, seed=1)
    params = []
    for spc in (1, 4):
        trainer = _port_trainer(steps_per_call=spc)
        state = trainer.init_state()
        state, history = trainer.fit(state, infinite_batches(data, 32), steps=10,
                                     log_every=4)
        assert state.step == 10
        params.append(state.model.state_dict())
        # logged at the chunk boundaries that cross a log_every multiple
        assert [h["step"] for h in history] == [4, 8, 10]
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), k


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path):
    data = SyntheticPairs(num_pairs=256, video_dim=24, text_dim=20, seed=2)
    cfg = dict(ema_decay=0.5, learnable_temperature=True)
    trainer = _port_trainer(**cfg)
    whole, _ = trainer.fit(trainer.init_state(), infinite_batches(data, 32), steps=6)

    first = _port_trainer(**cfg)
    state, _ = first.fit(first.init_state(), infinite_batches(data, 32), steps=3)
    mngr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    mngr.save(3, state)
    second = _port_trainer(**cfg)
    resumed = mngr.restore(second.init_state())
    assert resumed.step == 3 and mngr.latest_step() == 3
    resumed, _ = second.fit(resumed, infinite_batches(data, 32, start_step=3), steps=3)
    assert resumed.step == 6
    for k, v in whole.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    for k in whole.ema:
        assert torch.equal(whole.ema[k], resumed.ema[k]), k
    assert whole.opt_state["count"] == resumed.opt_state["count"] == 6


def test_checkpoint_retention_and_best_metric(tmp_path):
    trainer = _port_trainer()
    state = trainer.init_state()
    latest = CheckpointManager(tmp_path / "latest", max_to_keep=2)
    best = CheckpointManager(tmp_path / "best", max_to_keep=1, best_metric="r1")
    for step, r1 in ((1, 10.0), (2, 30.0), (3, 20.0)):
        latest.save(step, state)
        best.save(step, state, metrics={"r1": r1})
    assert latest.steps() == [2, 3]
    assert best.steps() == [2] and best.best_step() == 2
    with pytest.raises(ValueError, match="best_metric"):
        best.save(4, state, metrics={"other": 1.0})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(state)


def test_overfit_synthetic_retrieval():
    """The JAX package's overfit gate (``tests/test_training.py:42``)."""
    data = SyntheticPairs(num_pairs=256, video_dim=48, text_dim=32, seed=0)
    tower = dict(kind="mlp", embed_dim=32, hidden_dim=64, dtype=torch.float32)
    trainer = Trainer(TowerConfig(input_dim=48, **tower),
                      TowerConfig(input_dim=32, **tower),
                      TrainConfig(loss="crossclr_intra_fused", learning_rate=1e-3,
                                  warmup_steps=10, total_steps=400,
                                  temperature=0.1),
                      device="cpu")
    state, history = trainer.fit(trainer.init_state(), infinite_batches(data, 64),
                                 steps=300, log_every=100)
    assert history[-1]["loss"] < history[0]["loss"]
    v_emb, t_emb = trainer.encode(state, {"video": data.video, "text": data.text})
    metrics = retrieval_metrics(v_emb, t_emb)
    assert metrics["v2t/R@1"] > 80.0, metrics
    assert metrics["t2v/R@1"] > 80.0, metrics


def test_refusals():
    # LAMB trains where it was refused; an unknown optimizer is refused
    trainer = _port_trainer(optimizer="lamb")
    _, metrics = trainer.train_step(trainer.init_state(), _batches(1)[0])
    assert np.isfinite(float(metrics["loss"]))
    with pytest.raises(ValueError, match="'adamw' or 'lamb'"):
        _port_trainer(optimizer="sgd")
    # the full CrossCLR losses train, a learnable τ included
    batch = _batches(1)[0]
    for loss in ("crossclr", "crossclr_fused"):
        trainer = _port_trainer(loss=loss, learnable_temperature=True)
        _, metrics = trainer.train_step(trainer.init_state(), batch)
        assert np.isfinite(float(metrics["loss"])), loss
    with pytest.raises(ValueError, match="learnable_temperature"):
        _port_trainer(loss="max_margin", learnable_temperature=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        Trainer(TowerConfig(kind="transformer", dropout=0.1), TowerConfig(),
                TrainConfig(), device="cpu")


def test_abort_on_nonfinite_loss():
    """A poisoned batch (NaN features) raises at the next log boundary, as
    in the JAX trainer (``tests/test_training.py:686``); opting out trains
    on."""
    data = SyntheticPairs(num_pairs=64, video_dim=24, text_dim=20, seed=3)
    poisoned = np.array(data.video[:32])
    poisoned[0, 0] = np.nan

    def batches():
        return iter([{"video": data.video[:32], "text": data.text[:32]},
                     {"video": poisoned, "text": data.text[:32]},
                     {"video": data.video[32:], "text": data.text[32:]}])

    trainer = _port_trainer()
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        trainer.fit(trainer.init_state(), batches(), steps=3, log_every=1)
    trainer = _port_trainer(abort_on_nonfinite=False)
    state, history = trainer.fit(trainer.init_state(), batches(), steps=3,
                                 log_every=1)
    assert state.step == 3 and not np.isfinite(history[1]["loss"])


def test_mlp_dropout_trains_and_is_off_in_eval():
    trainer = Trainer(_tower(TowerConfig, torch.float32, 24, dropout=0.5),
                      _tower(TowerConfig, torch.float32, 20, dropout=0.5),
                      TrainConfig(**BASE), device="cpu")
    state = trainer.init_state()
    assert set(state.model.state_dict()) == set(
        DualEncoder(_tower(TowerConfig, torch.float32, 24),
                    _tower(TowerConfig, torch.float32, 20)).state_dict())
    batch = _batches(1)[0]
    a, _ = trainer.encode(state, batch)
    b, _ = trainer.encode(state, batch)
    assert torch.equal(a, b)  # eval mode: no dropout
    torch.manual_seed(0)
    state, m = trainer.train_step(state, batch)
    assert np.isfinite(float(m["loss"]))


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

CLI_ARGS = [
    "--device", "cpu",
    "video_tower.input_dim=24", "text_tower.input_dim=20",
    "video_tower.hidden_dim=32", "text_tower.hidden_dim=32",
    "video_tower.embed_dim=16", "text_tower.embed_dim=16",
    "video_tower.dtype=float32", "text_tower.dtype=float32",
    "data.num_pairs=320", "data.video_dim=24", "data.text_dim=20",
    "data.batch_size=32", "train.loss=crossclr_intra_fused",
    "train.warmup_steps=2", "train.temperature=0.1", "train.learning_rate=1e-3",
    "eval_every=10", "log_every=5", "train.keep_best_metric=v2t/R@1",
]


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def test_cli_trains_evaluates_and_resumes(tmp_path):
    from crossclr_tpu_torch import train

    ckpt = tmp_path / "ckpt"
    metrics_csv = tmp_path / "metrics.csv"
    args = CLI_ARGS + [f"checkpoint_dir={ckpt}", "--metrics-csv", str(metrics_csv)]
    assert train.main(["--steps", "20", *args]) == 0
    mngr = CheckpointManager(ckpt)
    assert mngr.latest_step() == 20
    rows = _rows(metrics_csv)
    evals = [r for r in rows if r.get("eval/v2t/R@1")]
    assert [int(r["step"]) for r in evals] == [10, 20]
    assert all(0.0 <= float(r["eval/t2v/R@1"]) <= 100.0 for r in evals)
    assert CheckpointManager(ckpt / "best", best_metric="v2t/R@1").best_step() in (10, 20)

    # resume: the step count continues, the CSV is extended
    assert train.main(["--steps", "30", "--stop-after", "5", *args]) == 0
    assert mngr.latest_step() == 25
    assert train.main(["--steps", "30", *args]) == 0
    assert mngr.latest_step() == 30
    steps = [int(r["step"]) for r in _rows(metrics_csv) if r.get("loss")]
    assert steps == sorted(steps) and steps[-1] == 30


@pytest.mark.parametrize("flag", [["--n-model", "2"], ["--profile-dir", "x"],
                                  ["--tensorboard-dir", "x"]])
def test_cli_refuses_what_is_not_ported(flag, tmp_path, monkeypatch, capsys):
    """Every flag of the JAX CLI is ported: one process cannot hold a model
    axis of 2; ``--profile-dir`` writes a trace of the first chunk;
    ``--tensorboard-dir`` names the package it misses when neither
    TensorBoard writer is installed, and streams the scalars through one
    when it is (a stub ``SummaryWriter`` here)."""
    import json
    import sys
    import types

    from crossclr_tpu_torch import train

    if flag[0] == "--n-model":
        with pytest.raises(SystemExit, match="1 ranks not divisible by model axis 2"):
            train.main([*flag, *CLI_ARGS])
        return
    args = ["--steps", "10", *CLI_ARGS, f"checkpoint_dir={tmp_path / 'ckpt'}"]
    if flag[0] == "--profile-dir":
        trace_dir = tmp_path / "trace"
        assert train.main(["--profile-dir", str(trace_dir), *args]) == 0
        (trace,) = trace_dir.glob("*.pt.trace.json")
        names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
        assert any(str(n).startswith("aten::") for n in names)
        return
    for name in ("tensorboardX", "tensorboard"):
        monkeypatch.setitem(sys.modules, name, None)  # neither installed
    with pytest.raises(SystemExit, match="neither tensorboardX nor tensorboard"):
        train.main(["--tensorboard-dir", str(tmp_path / "tb"), *args])

    scalars = []

    class SummaryWriter:
        def __init__(self, logdir):
            self.logdir = logdir

        def add_scalar(self, key, value, step):
            scalars.append((key, value, step))

        def flush(self):
            pass

        def close(self):
            pass

    monkeypatch.setitem(sys.modules, "tensorboardX",
                        types.SimpleNamespace(SummaryWriter=SummaryWriter))
    assert train.main(["--tensorboard-dir", str(tmp_path / "tb"), *args]) == 0
    steps = {step for key, _, step in scalars if key == "eval/v2t/R@1"}
    assert steps == {10}
    assert {step for key, _, step in scalars if key == "loss"} == {5, 10}
    assert all(np.isfinite(v) for _, v, _ in scalars)


def test_save_config_round_trips(tmp_path, capsys):
    """``--save-config`` writes the resolved config and exits; it loads back
    equal in both packages."""
    from crossclr_tpu.utils import config as jconfig
    from crossclr_tpu_torch import train
    from crossclr_tpu_torch.utils import config as tconfig

    path = tmp_path / "cfg.json"
    assert train.main(["--save-config", str(path), "--steps", "7", *CLI_ARGS]) == 0
    assert f"wrote {path}" in capsys.readouterr().out
    cfg = tconfig.load_config(path)
    assert cfg == tconfig.apply_overrides(tconfig.ExperimentConfig(),
                                          CLI_ARGS[2:] + ["train.total_steps=7"])
    tconfig.save_config(cfg, tmp_path / "again.json")
    assert (tmp_path / "again.json").read_text() == path.read_text()
    jcfg = jconfig.load_config(path)
    assert jcfg.train.total_steps == 7 and jcfg.video_tower.hidden_dim == 32


@pytest.mark.parametrize("learnable", [False, True])
def test_profile_split_reads_the_spans_of_train_step(learnable):
    """The profiler's split runs ``Trainer.train_step`` itself and reports
    its spans: the parts are the step's layers, and the state is a plain
    run's bit for bit (same batches, same init)."""
    from crossclr_tpu_torch.profile_train import split_step

    cfg = dict(loss="crossclr_intra_fused", learnable_temperature=learnable,
               ema_decay=0.9)
    batches = _batches(2)
    states = []
    for split in (False, True):
        trainer = Trainer(_tower(TowerConfig, torch.float32, 24),
                          _tower(TowerConfig, torch.float32, 20),
                          TrainConfig(**{**BASE, **cfg}), device="cpu")
        state = trainer.init_state()
        if split:
            parts = split_step(trainer, state, iter(batches), repeats=2)
            assert list(parts) == ["gather", "train.inputs", "train.forward",
                                   "train.loss", "train.backward",
                                   "train.optimizer", "train.step", "whole"]
            assert parts["whole"] >= parts["train.step"] >= parts["train.backward"] > 0
        else:
            for batch in batches:
                state, _ = trainer.train_step(state, batch)
        states.append((state.step, state.model.state_dict(), state.ema))
    (step_a, params_a, ema_a), (step_b, params_b, ema_b) = states
    assert step_a == step_b == 2
    for k in params_a:
        torch.testing.assert_close(params_b[k], params_a[k], rtol=0, atol=0)
        torch.testing.assert_close(ema_b[k], ema_a[k], rtol=0, atol=0)


def test_profile_cli_writes_its_numbers(tmp_path):
    import json

    from crossclr_tpu_torch import profile_train

    out = tmp_path / "profile.json"
    args = [a for a in CLI_ARGS if not a.startswith(("eval_every", "log_every",
                                                     "train.keep_best"))]
    assert profile_train.main(["--warmup", "2", "--repeats", "2", "--steps", "3",
                               "--out", str(out), *args]) == 0
    got = json.loads(out.read_text())
    assert got["card"] == "cpu" and got["route"] == "sym" and got["steps"] == 3
    assert got["wall_ms"] > 0 and got["parts_ms"]["whole"] > 0
    assert got["device_events"] == 0  # no device on the CPU


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
@pytest.mark.parametrize("learnable", [False, True])
def test_cuda_train_steps_match_cpu(cuda, learnable):
    """Three steps of the fused-loss trainer through the sym (fixed τ) or
    dual (learnable τ) kernels on the card against the same steps on the
    CPU (plain pairs): the fp32 limits of the JAX parity test."""
    from crossclr_tpu_torch.ops import fused_dual as fd

    cfg = dict(loss="crossclr_intra_fused", learnable_temperature=learnable)
    batches = _batches(3)
    states, losses = [], []
    before = dict(fd.launch_counts)
    for device in ("cpu", cuda):
        trainer = Trainer(_tower(TowerConfig, torch.float32, 24),
                          _tower(TowerConfig, torch.float32, 20),
                          TrainConfig(**{**BASE, **cfg}), device=device)
        state = trainer.init_state()
        for batch in batches:
            state, m = trainer.train_step(state, batch)
            losses.append(float(m["loss"]))
        states.append({k: v.cpu() for k, v in state.model.state_dict().items()})
    np.testing.assert_allclose(losses[3:], losses[:3], rtol=FP32["loss_rtol"])
    _state_dicts_close(states[1], states[0], FP32["param_atol"])
    route = ("dual_fwd", "dual_bwd") if learnable else ("sym_fwd", "sym_bwd")
    assert all(fd.launch_counts[k] - before[k] == 3 for k in route)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("chunk", [None, 8])
def test_cuda_step_spans_hold_the_steps_launches(cuda, chunk):
    """Under ``torch.profiler`` with CUDA activity only, as the benchmark's
    traced block runs it, every kernel launch lies inside a ``train.step``
    span's host interval, and each step holds launches: the spans and the
    profiler's events share a clock.  Each span's device ms is positive,
    and a step's child spans take no more device time than the step."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from crossclr_tpu_torch.utils.profiling import clear_spans, span_log

    trainer = Trainer(_tower(TowerConfig, torch.float32, 24),
                      _tower(TowerConfig, torch.float32, 20),
                      TrainConfig(**{**BASE, "loss": "crossclr_intra_fused",
                                     "embedding_chunk": chunk}), device=cuda)
    state = trainer.init_state()
    batches = _batches(4)
    trainer.train_step(state, batches[0])  # kernels built and loaded
    torch.cuda.synchronize()
    clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for batch in batches[1:]:
            trainer.train_step(state, batch)
            torch.cuda.synchronize()
            time.sleep(0.005)
    spans = span_log()
    clear_spans()
    steps = [r for r in spans if r["name"] == "train.step"]
    assert len(steps) == 3
    launches = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CPU and "LaunchKernel" in e.name()]
    assert launches
    for a, b in launches:
        assert any(s["host_start_ns"] <= a and b <= s["host_end_ns"] for s in steps), \
            (a, b, [(s["host_start_ns"], s["host_end_ns"]) for s in steps])
    for s in steps:
        assert any(s["host_start_ns"] <= a <= s["host_end_ns"] for a, _ in launches)
        children = [r["device_ms"] for r in spans if r["parent"] == s["index"]]
        assert len(children) == 5
        assert sum(children) <= s["device_ms"] * (1 + 1e-6)
    assert all(r["device_ms"] > 0 for r in spans), spans
