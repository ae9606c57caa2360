"""Metrics logging: CSV writer + stderr echo + an optional TensorBoard
stream, usable as the trainer's ``writer``.

Counterpart of ``crossclr_tpu/utils/logging.py``.  Train and eval rows log
different key sets; the CSV
schema is the union of all keys seen.  Rows are appended one flushed write
at a time (a crash leaves a valid prefix); when new keys appear the file
is rewritten with the widened header.  An existing file is extended, so a
resumed run keeps its history.
"""

from __future__ import annotations

import csv
import numbers
import sys
from pathlib import Path

__all__ = ["MetricsWriter"]


def _summary_writer():
    """TensorBoard's event writer class: ``tensorboardX``'s, else
    ``torch.utils.tensorboard``'s (which needs the ``tensorboard``
    package).  Neither is a dependency of the port."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            import tensorboard  # noqa: F401  torch.utils.tensorboard needs it
        except ImportError as e:
            raise RuntimeError(
                "tensorboard_dir was requested but neither tensorboardX nor "
                "tensorboard is installed"
            ) from e
        from torch.utils.tensorboard import SummaryWriter
    return SummaryWriter


class MetricsWriter:
    """Echoes metrics to stderr, appends them to a CSV, and with
    ``tensorboard_dir`` streams the numeric ones to TensorBoard event
    files (at the row's ``step``)."""

    def __init__(self, path: str | Path | None = None, *, echo: bool = True,
                 tensorboard_dir: str | Path | None = None):
        self.path = Path(path) if path else None
        self.echo = echo
        self._rows: list[dict] = []
        self._fieldnames: list[str] = []
        self._fh = None
        self._append_writer = None
        self._tb = (None if tensorboard_dir is None
                    else _summary_writer()(str(tensorboard_dir)))
        if self.path is not None and self.path.exists():
            with open(self.path, newline="") as fh:
                reader = csv.DictReader(fh)
                if reader.fieldnames:
                    self._fieldnames = list(reader.fieldnames)
                    self._rows = [dict(row) for row in reader]

    def __call__(self, metrics: dict) -> None:
        if self.echo:
            print(" ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()
            ), file=sys.stderr)
        if self._tb is not None:
            step = int(metrics.get("step", len(self._rows)))
            for k, v in metrics.items():
                # numbers.Real admits numpy scalars too
                if k != "step" and isinstance(v, numbers.Real):
                    self._tb.add_scalar(k, float(v), step)
            self._tb.flush()
        if self.path is None:
            return
        row = dict(metrics)
        self._rows.append(row)
        new_keys = [k for k in row if k not in self._fieldnames]
        if new_keys or self._fh is None:
            self._fieldnames.extend(new_keys)
            self._rewrite()
        else:
            self._append_writer.writerow({k: row.get(k) for k in self._fieldnames})
            self._fh.flush()

    def _rewrite(self) -> None:
        if self._fh is not None:
            self._fh.close()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=self._fieldnames)
            w.writeheader()
            for row in self._rows:
                w.writerow({k: row.get(k) for k in self._fieldnames})
        self._fh = open(self.path, "a", newline="")
        self._append_writer = csv.DictWriter(self._fh, fieldnames=self._fieldnames)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
