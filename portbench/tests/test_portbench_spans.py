"""The readers of the program's spans (``layer_metrics/spans.py``) on a
made-up span log with known device times: each metric's arithmetic, None
off a CUDA trace or without the program's spans, and the refusal of a log
whose steps are not the traced block's."""

from __future__ import annotations

import pytest

from crossclr_tpu_torch.utils import profiling
from portbench import harness

TRACE = {"device": "cuda", "window_s": 0.5}


def _record(index, name, parent, device_ms, step=0, count=None):
    return {"index": index, "name": name, "parent": parent, "step": step,
            "count": count, "host_start_ns": 0, "host_end_ns": 1, "host_ms": 1e-6,
            "device_ms": device_ms}


def _log(children: dict[str, float], steps: int = 2,
         counts: dict[str, int] | None = None) -> list[dict]:
    """``steps`` train steps numbered from 10, step i's child spans at
    ``(i + 1)`` times ``children``' device ms, and the step at their sum
    plus 1 ms; spans named in ``counts`` carry that count."""
    counts = counts or {}
    out, index = [], 0
    for i in range(steps):
        step = index
        out.append(_record(step, "train.step", None,
                           (i + 1) * sum(children.values()) + 1.0, step=10 + i,
                           count=counts.get("train.step")))
        index += 1
        for name, ms in children.items():
            out.append(_record(index, name, step, (i + 1) * ms, step=10 + i,
                               count=counts.get(name)))
            index += 1
    return out


@pytest.fixture
def program_log(monkeypatch):
    """Replace the program's log with ``set(records)``'s; count clears."""
    state = {"log": [], "cleared": 0}
    monkeypatch.setattr(profiling, "span_log", lambda: list(state["log"]))
    monkeypatch.setattr(profiling, "clear_spans",
                        lambda: state.update(cleared=state["cleared"] + 1))
    return state


def _read(metric, readings):
    return harness.layer_reader(metric)(readings, None)


ONE_PASS = {"train.inputs": 0.5, "train.forward": 10.0, "train.loss": 2.0,
            "train.backward": 20.0, "train.optimizer": 4.0}
TWO_PASS = {"train.inputs": 0.25, "train.encode": 3.0, "train.loss": 40.0,
            "train.backward": 6.0, "train.optimizer": 1.5}


@pytest.mark.parametrize("metric,children,want", [
    # mean over 2 steps at 1x and 2x: 1.5 times one step's
    ("towers_ms.train", ONE_PASS, 1.5 * 30.0),
    ("optimizer_ms.train", ONE_PASS, 1.5 * 4.0),
    ("towers_ms.gradcache", TWO_PASS, 1.5 * 9.0),
    ("optimizer_ms.gradcache", TWO_PASS, 1.5 * 1.5),
])
def test_layer_ms(program_log, capsys, metric, children, want):
    program_log["log"] = _log(children)
    readings = {"trace": TRACE, "trace_steps": 2}
    assert _read(metric, readings) == pytest.approx(want)
    err = capsys.readouterr().err
    assert "train.step" in err and "cover" in err
    # the second reader takes the kept steps: no second read, no second report
    program_log["log"] = []
    assert _read(metric, readings) == pytest.approx(want)
    assert program_log["cleared"] == 1 and capsys.readouterr().err == ""


def test_coverage_lines(program_log, capsys):
    program_log["log"] = _log({"train.forward": 3.0}, steps=1)
    _read("towers_ms.train", {"trace": TRACE, "trace_steps": 1})
    err = capsys.readouterr().err
    assert "4.000 device ms of the traced span's 500.000 ms (0.80%)" in err
    assert "child spans cover 75.00%" in err


def test_steps_and_counts_lines(program_log, capsys):
    """Each traced step's device ms by span under its step number, and
    each counted span's device ms a unit of its count."""
    program_log["log"] = _log({"train.encode": 3.0, "train.optimizer": 2.0},
                              counts={"train.step": 64, "train.encode": 4,
                                      "train.optimizer": 8})
    _read("towers_ms.gradcache", {"trace": TRACE, "trace_steps": 2})
    err = capsys.readouterr().err
    assert ("traced step 10, device ms: train.step 6.000, train.encode 3.000, "
            "train.optimizer 2.000") in err
    assert ("traced step 11, device ms: train.step 11.000, train.encode 6.000, "
            "train.optimizer 4.000") in err
    # (6 + 11) ms over 2 x 64 rows; 9 ms over 2 x 4 chunks; 6 ms over 2 x 8 leaves
    assert ("device ms a unit of the span's count, over the traced steps: "
            "train.step 0.13281 (count 64), train.encode 1.12500 (count 4), "
            "train.optimizer 0.37500 (count 8)") in err


@pytest.mark.parametrize("trace", [None, {"device": "cpu", "window_s": 0.5}])
def test_none_off_a_cuda_trace(program_log, trace):
    program_log["log"] = _log(ONE_PASS)
    assert _read("towers_ms.train", {"trace": trace, "trace_steps": 2}) is None
    assert program_log["cleared"] == 0


def test_none_without_the_programs_spans(monkeypatch):
    monkeypatch.delattr(profiling, "span_log")
    assert _read("optimizer_ms.train", {"trace": TRACE, "trace_steps": 2}) is None


@pytest.mark.parametrize("steps", [0, 1, 3])
def test_refuses_another_number_of_steps(program_log, steps):
    program_log["log"] = _log(ONE_PASS, steps=steps)
    with pytest.raises(harness.HarnessError, match="train.step"):
        _read("optimizer_ms.train", {"trace": TRACE, "trace_steps": 2})
