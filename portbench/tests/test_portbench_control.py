"""The control at a size a test run holds: the reference put in the
program's place in float8, and the planted faults (half of each batch
left out; attention's queries and keys given no gradient) fail the
cell's limits, where the program passes them."""

from __future__ import annotations

import pytest

from portbench import controls
from portbench.reference import trajectory
from portbench.tests import tiny


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in numbers)


@pytest.mark.parametrize("name", ["lsmdc_train", "podslice_train"])
def test_training_control_and_fault_fail(monkeypatch, name):
    captured = {}
    original = trajectory.run

    def capture(*a, **kw):
        captured.update(args=a, kw=kw, result=original(*a, **kw))
        return captured["result"]

    monkeypatch.setattr(trajectory, "run", capture)
    result = tiny.run(name)
    assert result["correct"] is True
    cell, _ = tiny.cell(name)
    found = controls.training(captured["args"], captured["kw"], captured["result"],
                              run=original)
    for control, numbers in found.items():
        assert _fails(numbers, cell["limits"]), (control, numbers)
