"""The port's configuration objects from a configuration file's dict."""

from __future__ import annotations

import dataclasses

import torch


def _fill(cls, d: dict, **extra):
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in d.items() if k in names}
    if isinstance(kwargs.get("dtype"), str):
        kwargs["dtype"] = getattr(torch, kwargs["dtype"])
    return cls(**{**kwargs, **extra})


def towers(config: dict):
    from crossclr_tpu_torch.models import TowerConfig

    return (_fill(TowerConfig, config["video_tower"]),
            _fill(TowerConfig, config["text_tower"]))


def trainer(config: dict, seed: int, device: str):
    """A ``Trainer`` of the configuration on ``device``, its dropout
    stream seeded with the run's seed."""
    from crossclr_tpu_torch.training import TrainConfig, Trainer

    video, text = towers(config)
    return Trainer(video, text, _fill(TrainConfig, config["train"], seed=int(seed)),
                   device)


def feature_dtype(config: dict) -> torch.dtype:
    return getattr(torch, config["data"]["features_dtype"])
