"""Checkpoints of the full train state: model, optimizer moments, EMA, step.

Counterpart of ``crossclr_tpu/training/checkpoint.py`` (Orbax there; the
format is not Orbax's).  Each checkpoint is one ``step_<n>.pt`` file
written with ``torch.save`` to a temporary name and renamed into place, so
a crash never leaves a torn file; its metrics (``best_metric`` ranking) sit
beside it in ``step_<n>.json``.  Files hold tensors, dicts and numbers only
and load with ``weights_only=True``.  Deterministic data order plus the
restored step is the recovery story, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path

import torch

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _atomic_write(path: Path, write) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


class CheckpointManager:
    """Keeps the newest ``max_to_keep`` checkpoints in ``directory`` — or,
    with ``best_metric``, the ``max_to_keep`` best by that saved metric
    (``best_mode`` "max" or "min"; pass ``metrics=`` to :meth:`save`).
    Keep best-ranked retention in its own directory (the train CLI uses
    ``<dir>/best``): ranking may delete the newest step."""

    def __init__(self, directory: str | Path, *, max_to_keep: int = 3,
                 best_metric: str | None = None, best_mode: str = "max"):
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be 'max' or 'min', got {best_mode!r}")
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.best_mode = best_mode

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step}.pt"

    def steps(self) -> list[int]:
        return sorted(
            int(m.group(1)) for p in self.directory.iterdir()
            if (m := _NAME.match(p.name))
        )

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def _metric(self, step: int) -> float:
        sidecar = self._path(step).with_suffix(".json")
        value = json.loads(sidecar.read_text())[self.best_metric]
        return value if self.best_mode == "max" else -value

    def best_step(self) -> int | None:
        """Step of the best saved checkpoint (needs ``best_metric``)."""
        if self.best_metric is None:
            raise ValueError("best_step needs a best_metric")
        steps = self.steps()
        return max(steps, key=self._metric) if steps else None

    def save(self, step: int, state, *, metrics: dict | None = None) -> None:
        if self.best_metric is not None and (
                metrics is None or self.best_metric not in metrics):
            raise ValueError(
                f"best_metric {self.best_metric!r} missing from the saved "
                f"metrics {sorted(metrics or {})}"
            )
        payload = {
            "step": int(step),
            "model": state.model.state_dict(),
            "opt_state": state.opt_state,
            "ema": state.ema,
        }
        path = self._path(step)
        if metrics is not None:
            _atomic_write(path.with_suffix(".json"),
                          lambda p: p.write_text(json.dumps(metrics)))
        _atomic_write(path, lambda p: torch.save(payload, p))
        self._prune()

    def _prune(self) -> None:
        steps = self.steps()
        if self.best_metric is None:
            ranked = steps[::-1]
        else:
            ranked = sorted(steps, key=self._metric, reverse=True)
        for step in ranked[self.max_to_keep:]:
            self._path(step).unlink(missing_ok=True)
            self._path(step).with_suffix(".json").unlink(missing_ok=True)

    def restore(self, state, step: int | None = None):
        """Load checkpoint ``step`` (default: the latest) into ``state`` —
        a state of the same configuration, e.g. ``Trainer.init_state()`` —
        in place, on its model's device, and return it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        device = next(state.model.parameters()).device
        payload = torch.load(self._path(step), map_location=device,
                             weights_only=True)
        if (payload["ema"] is None) != (state.ema is None):
            raise ValueError(
                "checkpoint and state disagree on the EMA (train.ema_decay "
                "must be set from step 0 of training, or not at all)"
            )
        state.model.load_state_dict(payload["model"], strict=True)
        state.opt_state = payload["opt_state"]
        state.ema = payload["ema"]
        state.step = payload["step"]
        return state
