"""A cell, a configuration and a per-layer metric are added with new files
and ``BENCHMARK.json`` entries alone: a copy of the harness gains them
without an edit to any file it had, and runs the new cell."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from portbench import harness
from portbench.tests import tiny

REPO = harness.ROOT


def test_new_cell_config_and_metric_from_files_alone(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    cell, cfg = tiny.cell("podslice_train")
    cfg["name"] = "tiny-mlp"
    (tmp_path / "portbench/configs/tiny_mlp.json").write_text(json.dumps(cfg))
    cell["config"] = "tiny_mlp"
    (tmp_path / "portbench/workloads/tiny_mlp_train.json").write_text(json.dumps(cell))
    (tmp_path / "portbench/layer_metrics/steps_seen.py").write_text(
        "def read(readings, ctx):\n    return readings['steps']\n")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_mlp", "source": "https://arxiv.org/abs/2109.14910",
                             "file": "portbench/configs/tiny_mlp.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "tiny_mlp_train", "config": "tiny_mlp",
                               "traffic": "train", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "gradcache_pairs_per_s":
            m["workloads"].append("tiny_mlp_train")
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "train step",
                               "moves": "gradcache_pairs_per_s",
                               "workloads": ["tiny_mlp_train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(REPO)!r}]\n"
        "from portbench import harness\n"
        "assert harness.ROOT == __import__('pathlib').Path(sys.path[0])\n"
        "out = [harness.execute('tiny_mlp_train', 11, 0.3, t, device='cpu')"
        " for t in (False, True)]\n"
        "print(json.dumps(out))\n")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    plain, traced = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(plain["metrics"]) == {"gradcache_pairs_per_s", "setup_s"}
    assert traced["metrics"]["steps_seen"]["value"] == traced["attempted"]
    assert set(traced["metrics"]) == {"steps_seen"}  # the others list their cells
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "portbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items()), "a file that was there changed"
