"""The result line: its keys in order, the cell's metrics by name and unit,
the device, and the refusal to report without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny

TOP = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", tiny.CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(name, trace):
    result = tiny.run(name, trace=trace)
    assert list(result) == TOP + (["breakdown"] if trace else []) + ["checks"]
    json.dumps(result)
    assert result["correct"] is True, result["checks"]
    bench = harness.manifest()
    if trace:
        wanted = {m["name"]: m["unit"] for m in bench["per_layer"]
                  if harness.applies(m, name)}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["window_s"] > 0
        # device readers are silent off the card; the host's are there
        assert set(result["metrics"]) <= set(wanted)
    else:
        wanted = {m["name"]: m["unit"] for m in bench["end_to_end"]
                  if harness.applies(m, name)}
        assert set(result["metrics"]) == set(wanted)
        assert "setup_s" in result["metrics"]
    for key, metric in result["metrics"].items():
        assert metric["unit"] == wanted[key] and metric["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}


def test_every_cell_is_in_the_manifest_with_its_files():
    bench = harness.manifest()
    for entry in bench["workloads"]:
        cell, config, path = harness.cell_files(entry["name"])
        assert cell["config"] == entry["config"] and cell["traffic"] == entry["traffic"]
        assert cell["chips"] == entry["chips"] and cell["why"] == entry["why"]
        assert set(cell["limits"]) == {"loss_gap", "grad_gap", "change_gap", "pair_faults"}
        assert any(m["name"] == cell["params"]["rate_metric"]
                   and m["workloads"] == [entry["name"]] for m in bench["end_to_end"])
        names = [c["file"] for c in bench["configs"] if c["name"] == entry["config"]]
        assert names == [str(path.relative_to(harness.ROOT))]
        harness.traffic_kind(cell["traffic"])
    for metric in bench["per_layer"]:
        harness.layer_reader(metric["name"])


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", "lsmdc_train",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr
