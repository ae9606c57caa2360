"""The port's profiling and NaN hooks (``crossclr_tpu_torch/utils/
profiling.py``), the TensorBoard stream of ``utils.logging.MetricsWriter``
and the trainer's NaN message, as ``tests/test_utils.py`` holds the JAX
package's: a trace of the host operators (the card's kernels join it on a
card; ``chip_smoke.py`` checks them), anomaly mode restored after
``nan_debug`` and raising at the operator that made a NaN, ``checked``
naming the non-finite output.  On the CPU."""

import contextlib
import json
import time

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.data import SyntheticPairs, epoch_batches
from crossclr_tpu_torch.models.encoders import TowerConfig
from crossclr_tpu_torch.ops.flash_attention import flash_attention
from crossclr_tpu_torch.training import TrainConfig, Trainer
from crossclr_tpu_torch.utils import MetricsWriter
from crossclr_tpu_torch.utils.profiling import (
    StepTimer,
    checked,
    clear_spans,
    nan_debug,
    recording,
    span,
    span_log,
    trace,
)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_trace_writes_a_chrome_trace(tmp_path):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 5, 8, generator=g) for _ in range(3))
    with trace(tmp_path / "tr"):
        with torch.no_grad():
            flash_attention(q, k, v)
        torch.ones(4, 4) @ torch.ones(4, 4)
    (path,) = (tmp_path / "tr").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"crossclr::flash_fwd", "aten::mm"} <= names


def test_step_timer():
    import time

    t = StepTimer(batch_size=32)
    t.tick(10)
    time.sleep(0.05)  # make elapsed time >> clock-read jitter
    assert t.steps_per_sec > 0
    assert abs(t.pairs_per_sec / t.steps_per_sec - 32) < 0.5


def test_nan_debug_restores_flag():
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    with nan_debug(True):
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        with nan_debug(False):
            assert not torch.is_anomaly_enabled()
        assert torch.is_anomaly_enabled()
    assert (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()) == prev


def test_nan_debug_catches_nan():
    """The NaN is caught at the backward function that made it, not at the
    loss: ``sqrt`` of a negative input, whose product with 0 leaves the
    forward finite."""
    def loss_of(x):
        return (torch.sqrt(x) * 0.0).sum()

    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    loss_of(x).backward()  # silently NaN without the hook
    assert torch.isnan(x.grad).any()
    x.grad = None
    with nan_debug(True), pytest.warns(UserWarning, match="SqrtBackward0"):
        with pytest.raises(RuntimeError, match="SqrtBackward0.*nan"):
            loss_of(x).backward()


def test_checked_catches_nan():
    def bad(x):
        return torch.log(x) * 2.0

    good = checked(bad)(torch.tensor(2.0))
    np.testing.assert_allclose(float(good), 2 * np.log(2.0), rtol=1e-6)
    with pytest.raises(FloatingPointError, match="non-finite values in output"):
        checked(bad)(torch.tensor(-1.0))


def test_checked_names_the_output():
    def two(x):
        return {"ok": x, "pair": (x, x / 0.0)}

    with pytest.raises(FloatingPointError, match=r"output\['pair'\]\[1\] \(shape \(3,\)\)"):
        checked(two)(torch.ones(3))
    assert checked(two)(torch.zeros(0))["ok"].shape == (0,)
    # integer outputs are not float-checked
    assert checked(lambda: torch.arange(3))().tolist() == [0, 1, 2]


def test_metrics_writer_tensorboard(tmp_path):
    """``tensorboard_dir`` streams scalars to event files beside the CSV
    (``tensorboardX`` is installed here)."""
    w = MetricsWriter(tmp_path / "m.csv", echo=False, tensorboard_dir=tmp_path / "tb")
    w({"loss": 1.5, "step": 1})
    w({"loss": np.float32(1.25), "grad_norm": 3.0, "step": 2})
    w.close()
    events = list((tmp_path / "tb").glob("events.out.tfevents.*"))
    assert events and events[0].stat().st_size > 0
    rows = (tmp_path / "m.csv").read_text().strip().splitlines()
    assert len(rows) == 3


def test_trainer_nan_message_names_nan_debug():
    tower = dict(kind="mlp", embed_dim=16, hidden_dim=32, dtype=torch.float32)
    trainer = Trainer(TowerConfig(input_dim=24, **tower), TowerConfig(input_dim=20, **tower),
                      TrainConfig(warmup_steps=1, total_steps=4), device="cpu")
    data = SyntheticPairs(num_pairs=64, video_dim=24, text_dim=20, seed=0)
    batches = list(epoch_batches(data, 32))
    batches[0]["video"][0, 0] = np.nan
    with pytest.raises(FloatingPointError, match="non-finite loss.*nan_debug"):
        trainer.fit(trainer.init_state(), iter(batches), steps=2, log_every=1)


# --------------------------------------------------------------------------
# the train step's spans
# --------------------------------------------------------------------------

TOWER = dict(kind="mlp", embed_dim=16, hidden_dim=32, dtype=torch.float32)
ONE_PASS = ["train.inputs", "train.forward", "train.loss", "train.backward",
            "train.optimizer"]
TWO_PASS = ["train.inputs", "train.encode", "train.loss", "train.backward",
            "train.optimizer"]


@pytest.fixture
def empty_log():
    clear_spans()
    yield
    clear_spans()


def _trainer(**cfg):
    return Trainer(TowerConfig(input_dim=24, **TOWER), TowerConfig(input_dim=20, **TOWER),
                   TrainConfig(warmup_steps=1, total_steps=4, **cfg), device="cpu")


def _batches(n=2):
    data = SyntheticPairs(num_pairs=32 * n, video_dim=24, text_dim=20, seed=0)
    return list(epoch_batches(data, 32))


def test_no_spans_without_a_profiler(empty_log):
    trainer = _trainer()
    trainer.train_step(trainer.init_state(), _batches(1)[0])
    assert span_log() == []
    assert span("train.step") is span("train.optimizer", 3)


@pytest.mark.parametrize("chunk,children", [(None, ONE_PASS), (8, TWO_PASS)])
def test_step_spans_under_the_profiler(empty_log, chunk, children):
    """A step under ``torch.profiler`` (host activity only) records
    ``train.step`` and its layers in order, nested in host time inside the
    clock's readings around the step, with their counts."""
    from torch.profiler import ProfilerActivity, profile

    trainer = _trainer(embedding_chunk=chunk, ema_decay=0.9)
    state = trainer.init_state()
    state.step = 7
    with profile(activities=[ProfilerActivity.CPU]):
        before = time.time_ns()
        trainer.train_step(state, _batches(1)[0])
        after = time.time_ns()
    step, *rest = span_log()
    assert (step["name"], step["parent"], step["count"]) == ("train.step", None, 32)
    assert [r["name"] for r in rest] == children
    assert before <= step["host_start_ns"] <= step["host_end_ns"] <= after
    end = step["host_start_ns"]
    for r in rest:
        assert r["parent"] == step["index"] and r["step"] == 7
        assert r["device_ms"] is None
        assert end <= r["host_start_ns"] <= r["host_end_ns"] <= step["host_end_ns"]
        assert r["host_ms"] == (r["host_end_ns"] - r["host_start_ns"]) / 1e6
        end = r["host_end_ns"]
    counts = {r["name"]: r["count"] for r in rest}
    assert counts["train.optimizer"] == len(list(state.model.parameters()))
    if chunk:
        assert counts["train.encode"] == counts["train.backward"] == 32 // chunk


def test_recording_changes_no_bit(empty_log):
    states = []
    for recorded in (False, True):
        trainer = _trainer(ema_decay=0.9, embedding_chunk=8)
        state = trainer.init_state()
        with recording() if recorded else contextlib.nullcontext():
            for batch in _batches(2):
                state, _ = trainer.train_step(state, batch)
        states.append((state.model.state_dict(), state.ema))
        assert len(span_log()) == (12 if recorded else 0)
    (params_a, ema_a), (params_b, ema_b) = states
    for k in params_a:
        torch.testing.assert_close(params_b[k], params_a[k], rtol=0, atol=0)
        torch.testing.assert_close(ema_b[k], ema_a[k], rtol=0, atol=0)


def test_trace_shows_the_step_spans(tmp_path, empty_log):
    trainer = _trainer()
    state = trainer.init_state()
    with trace(tmp_path / "tr"):
        trainer.train_step(state, _batches(1)[0])
    (path,) = (tmp_path / "tr").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"train.step", "train.backward", "train.optimizer"} <= names


def test_spans_follow_the_profilers_flag():
    """``span`` records while ``torch.autograd.profiler._is_profiler_enabled``
    is set, which every profiler session sets and clears: a torch without
    the flag fails here rather than leaving the spans off."""
    from torch.autograd import profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile

    assert autograd_profiler._is_profiler_enabled is False
    assert span("x") is span("x")
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert span("x") is not span("x")
    assert autograd_profiler._is_profiler_enabled is False
