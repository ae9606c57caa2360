"""Configs, metrics logging, the Flax → torch weight bridge, the torch
tower import and the profiling hooks.

The names below are imported at first use: ``utils.config`` imports the
trainer, whose train step imports ``utils.profiling``, so importing this
package imports no submodule of its own.
"""

import importlib

_EXPORTS = {
    "DataConfig": "config",
    "ExperimentConfig": "config",
    "apply_overrides": "config",
    "load_config": "config",
    "save_config": "config",
    "MetricsWriter": "logging",
    "state_dict_from_flax": "params",
    "dual_encoder_params_from_torch": "torch_import",
    "logit_scale_from_torch": "torch_import",
    "params_from_torch": "torch_import",
    "state_dict_from_params": "torch_import",
}


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(_EXPORTS)
