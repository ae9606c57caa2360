"""Dual-encoder model towers."""

from .encoders import DualEncoder, MLPTower, TowerConfig, TransformerTower

__all__ = ["DualEncoder", "MLPTower", "TowerConfig", "TransformerTower"]
