"""One run of one cell: find its files by name, run its traffic, read its
per-layer metrics, judge it, and print the result line.

Everything a cell needs is found from its name: ``workloads/<cell>.json``
(the configuration, the traffic kind and its parameters, the limits of
the output check), ``configs/<config>.json``, ``traffic/<kind>.py`` and,
for each per-layer metric ``BENCHMARK.json`` lists for the cell,
``layer_metrics/<metric>.py``.  Which metrics a cell reports comes from
``BENCHMARK.json`` alone: an end-to-end or per-layer entry without a
``workloads`` key applies to every cell.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "crossclr_tpu")


class HarnessError(RuntimeError):
    """A run that cannot report: a missing file, a family of kernels that
    took no device time, a share above its roofline."""


@dataclasses.dataclass
class Context:
    """What a traffic kind is given: the cell, its configuration, the
    run's arguments, the device, and the clock reading at process start
    (``setup_s`` runs from it)."""

    name: str
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float

    @property
    def params(self) -> dict:
        return self.cell["params"]

    def lap(self, what: str) -> None:
        """Note on stderr how far into set-up ``what`` was done."""
        print(f"portbench: set-up {what} at {time.perf_counter() - self.t_start:.3f} s",
              file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """What a traffic kind returns: its end-to-end readings (by metric
    name), the work attempted and failed, the device's peak memory, the
    readings the per-layer metrics take (``readings["trace"]`` is the
    profiled span's summary in a traced run), and each number of the
    output check as ``(value, limit)``."""

    end_to_end: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    readings: dict
    checks: dict


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise HarnessError(f"missing file {path}")
    return json.loads(path.read_text())


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_files(name: str) -> tuple[dict, dict, Path]:
    """``(cell, config, the configuration's path)`` of the cell ``name``."""
    cell = load_json(HERE / "workloads" / f"{name}.json")
    path = HERE / "configs" / f"{cell['config']}.json"
    return cell, load_json(path), path


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def traffic_kind(kind: str):
    return importlib.import_module(f"portbench.traffic.{kind}")


def layer_reader(metric: str):
    """``read(readings, ctx) -> float | None`` of ``layer_metrics/<metric>.py``."""
    path = HERE / "layer_metrics" / f"{metric}.py"
    if not path.is_file():
        raise HarnessError(f"per-layer metric {metric!r} has no reader {path}")
    module_name = "portbench.layer_metrics._" + re.sub(r"\W", "_", metric)
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_loaded() -> list[str]:
    """The forbidden top-level names among ``sys.modules``, compared whole
    (``crossclr_tpu_torch`` is not ``crossclr_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def port_location() -> Path:
    """Where ``crossclr_tpu_torch`` was imported from; the checkout's own
    copy, or the run is refused."""
    import crossclr_tpu_torch

    where = Path(crossclr_tpu_torch.__file__).resolve().parent
    if not where.is_relative_to(ROOT):
        raise HarnessError(f"crossclr_tpu_torch comes from {where}, outside the "
                           f"checkout {ROOT}")
    return where


def card_power() -> str:
    """``name, power limit`` of card 0 as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def execute(name: str, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", t_start: float | None = None,
            cell: dict | None = None, config: dict | None = None) -> dict:
    """Run cell ``name`` once and return the result object (not printed).
    ``cell`` and ``config`` replace the files (tests pass small ones)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = manifest()
    if cell is None:
        cell, config, _ = cell_files(name)
    ends = [m for m in bench["end_to_end"] if applies(m, name)]
    layers = [m for m in bench["per_layer"] if applies(m, name)] if trace else []
    readers = {m["name"]: layer_reader(m["name"]) for m in layers}
    ctx = Context(name=name, cell=cell, config=config, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace), device=device,
                  t_start=t_start)
    outcome = traffic_kind(cell["traffic"]).run(ctx)
    print(f"portbench: {name} seed {seed} " + " ".join(
        f"{k}={v!r}" for k, v in outcome.end_to_end.items()), file=sys.stderr)

    metrics = {}
    if trace:
        for m in layers:
            value = readers[m["name"]](outcome.readings, ctx)
            if value is None:
                continue
            value = float(value)
            if not math.isfinite(value):
                raise HarnessError(f"{m['name']} read {value}")
            if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]) \
                    and value > 100.0:
                raise HarnessError(
                    f"{m['name']} read {value}% of its peak: the work is "
                    "counted too high or the time leaves part of it out")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in ends:
            if m["name"] not in outcome.end_to_end:
                raise HarnessError(f"{cell['traffic']} traffic gave no {m['name']}")
            metrics[m["name"]] = {"value": float(outcome.end_to_end[m["name"]]),
                                  "unit": m["unit"]}
    checks = {k: {"value": float(v), "limit": float(lim)}
              for k, (v, lim) in outcome.checks.items()}
    correct = (outcome.failed == 0 and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {
        "correct": correct,
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
        "metrics": metrics,
        "device": _device(device, int(cell["chips"]), outcome),
    }
    if trace and outcome.readings.get("trace"):
        summary = outcome.readings["trace"]
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result


def _device(device: str, chips: int, outcome: Outcome) -> dict:
    if device == "cuda":
        import torch

        platform, kind = "gpu", torch.cuda.get_device_name(0)
    else:
        platform, kind = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": chips,
            "memory_peak_bytes": int(outcome.memory_peak_bytes)}


def main(args, t_start: float) -> int:
    """The command line's run: refuse without the cards the cell asks for,
    run, refuse a process that loaded JAX, print the checks on stderr and
    the result line last on stdout."""
    cell, _, _ = cell_files(args.workload)
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    port_location()
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                     t_start=t_start)
    print(f"portbench: {card_power()}", file=sys.stderr)
    loaded = forbidden_loaded()
    if loaded:
        print(f"portbench: the run's process loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"check failed {result['failed']} limit 0", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
