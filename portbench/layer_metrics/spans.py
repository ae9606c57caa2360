"""The program's own spans of the traced steps (``crossclr_tpu_torch.utils.
profiling.span``), which several readers share: a layer's device ms a
step, after the rate each moves (``.train`` / ``.gradcache``).

The traced block runs ``trace_steps`` train steps under ``torch.profiler``,
and while a profiler session is active the program records its spans:
``train.step`` and, inside it, the step's layers (``train.inputs``,
``train.forward`` or ``train.encode``, ``train.loss``, ``train.backward``,
``train.collectives``, ``train.optimizer``), each with its device time
between two CUDA events.  Nothing else of a run records.  The readers run
after the traffic, in its process: the first reads the program's log,
prints every span's mean device and host ms a step and how much of the
traced span the steps cover on stderr, with each traced step's device ms
by span (labelled by the step's ``step``) and each counted span's device
ms a unit of its ``count`` (rows, chunks, parameter leaves); keeps the
steps in ``readings`` for the others, and empties the log.  A program
without spans, or a trace that is not a CUDA device's, gives None."""

from __future__ import annotations

import sys
from collections import defaultdict

from ..harness import HarnessError
from .common import device_trace

STEP = "train.step"
KEY = "program_spans"  # where the first reader keeps the traced steps


def traced_steps(readings: dict) -> list[dict] | None:
    """Each traced ``train.step`` span with its child spans by name
    (``{"step": record, "children": {name: [records]}}``), or None where
    the trace is not a CUDA device's or the program keeps no spans.
    Raises where the log holds another number of steps than the block
    traced."""
    if device_trace(readings) is None:
        return None
    if KEY not in readings:
        try:
            from crossclr_tpu_torch.utils.profiling import clear_spans, span_log
        except ImportError:  # a program without spans
            readings[KEY] = None
            return None
        log = span_log()
        clear_spans()
        steps = [r for r in log if r["name"] == STEP and r["parent"] is None]
        if len(steps) != readings["trace_steps"]:
            raise HarnessError(f"the program's span log holds {len(steps)} "
                               f"{STEP} spans; the traced block ran "
                               f"{readings['trace_steps']} steps")
        by_index = {r["index"]: {"step": r, "children": defaultdict(list)}
                    for r in steps}
        for r in log:
            if r["parent"] in by_index:
                by_index[r["parent"]]["children"][r["name"]].append(r)
        readings[KEY] = list(by_index.values())
        _report(log, readings[KEY], device_trace(readings))
    return readings[KEY]


def layer_ms(readings: dict, names: tuple[str, ...]) -> float | None:
    """The mean over the traced steps of the device ms of the steps' child
    spans named ``names``."""
    steps = traced_steps(readings)
    if steps is None:
        return None
    return sum(r["device_ms"] for s in steps for name in names
               for r in s["children"][name]) / len(steps)


def _report(log: list[dict], steps: list[dict], summary: dict) -> None:
    n = len(steps)
    device, host = defaultdict(float), defaultdict(float)
    for r in log:
        device[r["name"]] += r["device_ms"] or 0.0
        host[r["name"]] += r["host_ms"]
    print(f"portbench: program spans, mean device ms / host ms a step over {n} "
          "traced steps: " + ", ".join(f"{k} {device[k] / n:.3f} / {host[k] / n:.3f}"
                                       for k in device), file=sys.stderr)
    for s in steps:
        parts = [(STEP, s["step"]["device_ms"])] + [
            (name, sum(r["device_ms"] for r in rs)) for name, rs in s["children"].items()]
        print(f"portbench: traced step {s['step']['step']}, device ms: "
              + ", ".join(f"{k} {ms:.3f}" for k, ms in parts), file=sys.stderr)
    per_unit = defaultdict(lambda: [0.0, 0])
    for r in log:
        if r["count"]:
            per_unit[r["name"]][0] += r["device_ms"] or 0.0
            per_unit[r["name"]][1] += r["count"]
    if per_unit:
        print("portbench: device ms a unit of the span's count, over the traced steps: "
              + ", ".join(f"{k} {ms / units:.5f} (count {units // n})"
                          for k, (ms, units) in per_unit.items()), file=sys.stderr)
    step_ms = [s["step"]["device_ms"] for s in steps]
    window_ms = summary["window_s"] * 1e3
    print(f"portbench: {STEP} spans cover {sum(step_ms):.3f} device ms of the traced "
          f"span's {window_ms:.3f} ms ({100 * sum(step_ms) / window_ms:.2f}%)",
          file=sys.stderr)
    shares = [100 * sum(r["device_ms"] for rs in s["children"].values() for r in rs)
              / s["step"]["device_ms"] for s in steps]
    print(f"portbench: child spans cover {', '.join(f'{x:.2f}%' for x in shares)} "
          f"of each {STEP}'s device ms", file=sys.stderr)
