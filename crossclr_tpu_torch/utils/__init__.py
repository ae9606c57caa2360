"""Configs, metrics logging and the Flax → torch weight bridge."""

from .config import (
    DataConfig,
    ExperimentConfig,
    apply_overrides,
    load_config,
)
from .logging import MetricsWriter
from .params import state_dict_from_flax

__all__ = [
    "DataConfig",
    "ExperimentConfig",
    "MetricsWriter",
    "apply_overrides",
    "load_config",
    "state_dict_from_flax",
]
