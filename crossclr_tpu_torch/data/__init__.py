"""Datasets and batching."""

from .datasets import (
    FeaturePairDataset,
    SyntheticPairs,
    dataset_from_config,
    epoch_batches,
)

__all__ = [
    "FeaturePairDataset",
    "SyntheticPairs",
    "dataset_from_config",
    "epoch_batches",
]
