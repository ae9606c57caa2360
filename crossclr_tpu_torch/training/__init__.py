"""Training: config, optimizer, train step and loop, checkpoints."""

from .checkpoint import CheckpointManager
from .trainer import (
    LAMB,
    AdamW,
    TrainConfig,
    Trainer,
    TrainState,
    loss_route,
    make_loss_fn,
    make_optimizer,
)

__all__ = [
    "LAMB",
    "AdamW",
    "CheckpointManager",
    "TrainConfig",
    "TrainState",
    "Trainer",
    "loss_route",
    "make_loss_fn",
    "make_optimizer",
]
