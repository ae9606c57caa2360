"""Experiment configuration: dataclasses + JSON round-trip + CLI overrides.

Counterpart of ``crossclr_tpu/utils/config.py``: the same JSON and the same
``section.key=value`` override syntax.  dtype strings (``"bfloat16"``,
``"float32"``) map to torch dtypes.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any

import torch

from ..models.encoders import TowerConfig
from ..training.trainer import TrainConfig

__all__ = [
    "DataConfig",
    "ExperimentConfig",
    "apply_overrides",
    "load_config",
    "save_config",
]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Field for field the JAX ``DataConfig``."""

    source: str = "synthetic"  # "synthetic" | "files"
    video_path: str = ""
    text_path: str = ""
    video_mask_path: str = ""
    text_mask_path: str = ""
    features_dtype: str = "float32"
    num_pairs: int = 4096
    video_dim: int = 512
    text_dim: int = 384
    video_seq_len: int = 0
    text_seq_len: int = 0
    variable_lengths: bool = False
    batch_size: int = 256
    eval_fraction: float = 0.1
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "crossclr"
    video_tower: TowerConfig = dataclasses.field(default_factory=TowerConfig)
    text_tower: TowerConfig = dataclasses.field(default_factory=TowerConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    checkpoint_dir: str = ""
    eval_every: int = 500
    log_every: int = 50


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: _to_dict(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, torch.dtype):
        return str(obj).removeprefix("torch.")
    return obj


_NESTED_FIELDS = {
    "video_tower": TowerConfig,
    "text_tower": TowerConfig,
    "train": TrainConfig,
    "data": DataConfig,
}


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        val = d[f.name]
        if f.name in _NESTED_FIELDS:
            val = _from_dict(_NESTED_FIELDS[f.name], val)
        elif f.name == "dtype" and isinstance(val, str):
            val = _dtype(val)
        kwargs[f.name] = val
    return cls(**kwargs)


def save_config(cfg: ExperimentConfig, path: str | Path) -> None:
    """Write ``cfg`` as the JAX package's ``save_config`` writes it (dtypes
    by name, indent 2); :func:`load_config` of either package reads it."""
    Path(path).write_text(json.dumps(_to_dict(cfg), indent=2))


def load_config(path: str | Path) -> ExperimentConfig:
    return _from_dict(ExperimentConfig, json.loads(Path(path).read_text()))


def apply_overrides(cfg: ExperimentConfig, overrides: list[str]) -> ExperimentConfig:
    """Apply ``section.key=value`` CLI overrides (dotted paths)."""
    d = _to_dict(cfg)
    for item in overrides:
        key, _, raw = item.partition("=")
        if not _:
            raise ValueError(f"override {item!r} must be key=value")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        node = d
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown config key: {key}")
        node[parts[-1]] = val
    return _from_dict(ExperimentConfig, d)
