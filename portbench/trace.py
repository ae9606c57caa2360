"""The traced span of a ``--trace 1`` run, read from ``torch.profiler``.

A :class:`Profiled` block synchronises, starts the profiler, runs,
synchronises and stops; the profile stays in memory and only its summary
is kept.  On a CUDA device it records the device's activity and the CUDA
runtime calls only, not every host operation: recording each operator
doubled a launch-bound step's host time on an H100, which would read as
device idle time.  The span is the host's wall clock between the two
synchronisations (the profiler's timestamps are on the same clock).

* ``window_s``: the span's length;
* ``busy_s``: the union of the device's operations' intervals inside the
  span (``profile_train.profiled_fit``'s arithmetic);
* ``kernel_s``: device seconds by operation name;
* ``device_ops``: the ten operations that took most device time;
* ``idle_gaps``: the device's idle time inside the span summed by what
  the dispatching thread (the host thread that made the most CUDA
  runtime calls) was doing meanwhile: the runtime call it was in, or
  ``python`` where it was in none; the ten largest.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict

TOP = 10
# the CUDA runtime and driver calls a dispatching thread makes
RUNTIME_CALLS = ("cuda", "cuLaunch", "cuMemcpy")


class Profiled:
    def __init__(self, device: str):
        self.device = device
        self.summary: dict | None = None

    def _sync(self):
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        activity = ProfilerActivity.CUDA if self.device == "cuda" else ProfilerActivity.CPU
        self._sync()
        self._prof = profile(activities=[activity])
        self._prof.__enter__()
        self.ns0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.ns1 = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self._prof, self.device, self.ns0, self.ns1)
        del self._prof
        return False


def _name(raw: str) -> str:
    name = raw.removeprefix("void ")
    return name if len(name) <= 120 else name[:117] + "..."


def summarize(prof, device: str, s0: int, s1: int) -> dict:
    from torch.autograd import DeviceType

    cpu, device_events = [], []
    for e in prof.profiler.kineto_results.events():
        (cpu if e.device_type() == DeviceType.CPU else device_events).append(e)
    host, calls = defaultdict(list), defaultdict(int)
    for e in cpu:
        tid = e.start_thread_id()
        host[tid].append((e.start_ns(), e.end_ns(), e.name()))
        calls[tid] += e.name().startswith(RUNTIME_CALLS)
    # an annotation's mirror on the device timeline carries a host event's
    # name; no kernel or copy does
    host_names = {e.name() for e in cpu}
    dev = []
    for e in device_events:
        a, b = max(e.start_ns(), s0), min(e.end_ns(), s1)
        if b > a and e.name() not in host_names:
            dev.append((a, b, e.name()))
    if device_events:
        first = min(e.start_ns() for e in device_events)
        last = max(e.end_ns() for e in device_events)
        print(f"portbench: traced span {(s1 - s0) / 1e9:.6f} s; device events "
              f"from {(first - s0) / 1e6:.3f} ms to {(s1 - last) / 1e6:.3f} ms before "
              f"its end; {len(dev)} of {len(device_events)} inside", file=sys.stderr)
    tid = max(calls, key=calls.get, default=None)
    host = sorted(host.get(tid, []))
    kernel_ns = defaultdict(int)
    for a, b, name in dev:
        kernel_ns[name] += b - a
    busy, gaps, end = 0, [], s0
    for a, b, _ in sorted(dev):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if s1 > end:
        gaps.append((end, s1))
    starts = [h[0] for h in host]
    idle_ns = defaultdict(int)
    for a, b in gaps:
        idle_ns[_doing(host, starts, (a + b) // 2)] += b - a
    top = sorted(kernel_ns.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(idle_ns.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "device": device,
        "window_s": (s1 - s0) / 1e9,
        "busy_s": busy / 1e9,
        "kernel_s": {name: ns / 1e9 for name, ns in kernel_ns.items()},
        "device_ops": [[_name(n), ns / 1e9] for n, ns in top],
        "idle_gaps": [[_name(n), ns / 1e9] for n, ns in idle],
    }


def _doing(host: list, starts: list, t: int, reach: int = 256) -> str:
    """The innermost host operation of the thread running at ``t``: host
    events on one thread nest, so the latest-starting one that still
    runs at ``t`` is the innermost."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "python"


def family_seconds(summary: dict, patterns: list[str]) -> float:
    """Device seconds of the operations whose names hold any pattern."""
    return sum(s for name, s in summary["kernel_s"].items()
               if any(p in name for p in patterns))
