"""Profiling and NaN hooks.

Counterpart of ``crossclr_tpu/utils/profiling.py``: :func:`trace` takes a
``torch.profiler`` trace (host and card) in place of ``jax.profiler``'s,
:func:`nan_debug` turns on autograd's anomaly mode with its NaN checks in
place of ``jax_debug_nans``, :func:`checked` checks a function's outputs
for non-finite values, and :class:`StepTimer` counts steps and pairs per
second.

:func:`span` marks a layer of the program (the train step's inputs,
towers, loss, backward, collectives and optimizer): while a
``torch.profiler`` session is active, or inside :func:`recording`, each
span keeps its host interval and, on a CUDA device, its device interval
between two timing events, in a bounded in-memory log that
:func:`span_log` reads; it also enters ``record_function``, so a
:func:`trace` shows the same spans.  Otherwise a span is one shared
no-op context.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "nan_debug", "checked", "StepTimer", "span", "recording",
           "span_log", "clear_spans"]

LOG_SIZE = 4096  # span records kept; the oldest are dropped first

_OFF = contextlib.nullcontext()
_log: collections.deque = collections.deque(maxlen=LOG_SIZE)
_lock = threading.Lock()
_local = threading.local()  # a thread's open spans, innermost last
_indices = itertools.count()
_recording = 0  # open recording() scopes


class _Record:
    __slots__ = ("index", "name", "parent", "step", "count", "device",
                 "host_start_ns", "host_end_ns", "events", "device_ms")


class _Span:
    """One recorded span: the host clock (``time.time_ns()``, the clock of
    the profiler's events) read first at entry and last at exit, the
    device's timing events recorded on the current stream innermost."""

    __slots__ = ("record", "annotation", "stream")

    def __init__(self, name: str, count, step, device):
        rec = self.record = _Record()
        rec.name, rec.count, rec.step, rec.device = name, count, step, device
        rec.events = rec.device_ms = None

    def __enter__(self):
        rec = self.record
        rec.host_start_ns = time.time_ns()
        try:
            stack = _local.stack
        except AttributeError:  # the thread's first span
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        rec.index = next(_indices)
        rec.parent = None if parent is None else parent.index
        if rec.step is None and parent is not None:
            rec.step = parent.step
        if rec.device is None:
            rec.device = None if parent is None else parent.device
        else:
            device = torch.device(rec.device)
            if device.type != "cuda":
                rec.device = None
            elif device.index is None:
                rec.device = torch.device("cuda", torch.cuda.current_device())
            else:
                rec.device = device
        self.annotation = torch.profiler.record_function(rec.name)
        self.annotation.__enter__()
        if rec.device is not None:
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            self.stream = torch.cuda.current_stream(rec.device)
            rec.events[0].record(self.stream)
        stack.append(rec)
        return rec

    def __exit__(self, *exc):
        rec = self.record
        if rec.events is not None:
            rec.events[1].record(self.stream)
        self.annotation.__exit__(*exc)
        _local.stack.pop()
        rec.host_end_ns = time.time_ns()
        with _lock:
            _log.append(rec)
        return False


def span(name: str, count: int | None = None, *, step: int | None = None,
         device: torch.device | str | None = None):
    """A context that records the layer ``name`` while a ``torch.profiler``
    session is active (``torch.autograd.profiler._is_profiler_enabled``)
    or inside :func:`recording`; otherwise one shared no-op context (a
    flag read: no allocation, no CUDA call).

    ``count`` is the span's work (rows, chunks, parameter leaves), by
    which a reader gives its time a unit; ``step`` the train step it
    belongs to and ``device`` where its work runs, both taken from the
    enclosing span of the same thread when not given.  On a CUDA device
    the span's device time runs between two timing events recorded on the
    device's current stream at entry and exit."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, count, step, device)


@contextlib.contextmanager
def recording():
    """Within the scope, :func:`span` records without a profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def span_log() -> list[dict]:
    """The recorded spans, in the order they were entered: ``index``,
    ``name``, ``parent`` (the enclosing span's index, or None), ``step``,
    ``count``, ``host_start_ns`` and ``host_end_ns`` (``time.time_ns()``),
    ``host_ms`` and ``device_ms`` (None off a CUDA device).  Device times
    are read from the spans' events here, once, waiting for any the
    device has not reached."""
    out = []
    with _lock:
        for rec in sorted(_log, key=lambda r: r.index):
            if rec.events is not None:
                start, end = rec.events
                end.synchronize()
                rec.device_ms = start.elapsed_time(end)
                rec.events = None
            out.append({
                "index": rec.index, "name": rec.name, "parent": rec.parent,
                "step": rec.step, "count": rec.count,
                "host_start_ns": rec.host_start_ns, "host_end_ns": rec.host_end_ns,
                "host_ms": (rec.host_end_ns - rec.host_start_ns) / 1e6,
                "device_ms": rec.device_ms,
            })
    return out


def clear_spans() -> None:
    """Empty the span log."""
    with _lock:
        _log.clear()


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Trace the scope's host operators and, where a card is present, its
    kernels (``torch.profiler``, CPU and CUDA activities), and write a
    Chrome trace (``<host>_<pid>.<time>.pt.trace.json``) into ``logdir``
    at exit; TensorBoard's profiler plugin and ``chrome://tracing`` read
    it.  It shows the program's spans (:func:`span`) by name.  Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        yield prof


@contextlib.contextmanager
def nan_debug(enabled: bool = True):
    """Within the scope, autograd's anomaly mode with its NaN checks: a
    backward function that returns NaN raises at the operator that made
    it, with the forward's traceback, rather than at the loss.  The
    previous setting is restored at exit."""
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.set_anomaly_enabled(enabled, enabled)
    try:
        yield
    finally:
        torch.set_anomaly_enabled(*prev)


def checked(fn):
    """``fn`` with its outputs checked: a non-finite value in any tensor
    output raises ``FloatingPointError`` naming that output (its position
    in the flattened outputs, or its key).  The JAX package's
    ``checkify`` also checks indexing inside jitted code; eager PyTorch
    has no such check to turn on (an out-of-range index already raises on
    the CPU, and on a card surfaces as a device-side assertion), so only
    the float checks are ported.  A debugging tool: each check reads the
    outputs back to the host."""

    def where(out, path):
        if isinstance(out, torch.Tensor):
            yield path, out
        elif isinstance(out, dict):
            for k, v in out.items():
                yield from where(v, f"{path}[{k!r}]")
        elif isinstance(out, (tuple, list)):
            for i, v in enumerate(out):
                yield from where(v, f"{path}[{i}]")

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, t in where(out, "output"):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', 'fn')}: non-finite values in "
                    f"{path} (shape {tuple(t.shape)})")
        return out

    return wrapper


class StepTimer:
    """Wall-clock steps/sec and pairs/sec tracker (host side)."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        self._steps += n

    @property
    def steps_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else 0.0

    @property
    def pairs_per_sec(self) -> float:
        return self.steps_per_sec * self.batch_size
