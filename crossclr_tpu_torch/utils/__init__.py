"""Configs, metrics logging, the Flax → torch weight bridge and the
torch tower import."""

from .config import (
    DataConfig,
    ExperimentConfig,
    apply_overrides,
    load_config,
    save_config,
)
from .logging import MetricsWriter
from .params import state_dict_from_flax
from .torch_import import (
    dual_encoder_params_from_torch,
    logit_scale_from_torch,
    params_from_torch,
    state_dict_from_params,
)

__all__ = [
    "DataConfig",
    "ExperimentConfig",
    "MetricsWriter",
    "apply_overrides",
    "dual_encoder_params_from_torch",
    "load_config",
    "logit_scale_from_torch",
    "params_from_torch",
    "save_config",
    "state_dict_from_flax",
    "state_dict_from_params",
]
