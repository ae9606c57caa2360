"""Training: config and the trainer's init/encode surface (no step yet)."""

from .trainer import TrainConfig, Trainer, TrainState

__all__ = ["TrainConfig", "Trainer", "TrainState"]
