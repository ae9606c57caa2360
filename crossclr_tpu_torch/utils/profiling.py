"""Profiling and NaN hooks.

Counterpart of ``crossclr_tpu/utils/profiling.py``: :func:`trace` takes a
``torch.profiler`` trace (host and card) in place of ``jax.profiler``'s,
:func:`nan_debug` turns on autograd's anomaly mode with its NaN checks in
place of ``jax_debug_nans``, :func:`checked` checks a function's outputs
for non-finite values, and :class:`StepTimer` counts steps and pairs per
second.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

__all__ = ["trace", "nan_debug", "checked", "StepTimer"]


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Trace the scope's host operators and, where a card is present, its
    kernels (``torch.profiler``, CPU and CUDA activities), and write a
    Chrome trace (``<host>_<pid>.<time>.pt.trace.json``) into ``logdir``
    at exit; TensorBoard's profiler plugin and ``chrome://tracing`` read
    it.  Yields the profiler."""
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
