"""Each cell's command on the card, with a short window: it exits 0 and
prints the contract's last line with ``correct`` true.  Run on the card:
``python -m pytest -m requires_cuda portbench/tests``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", tiny.CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cuda, name, trace):
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", name,
         "--seed", "2147483999", "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
