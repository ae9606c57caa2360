"""Datasets and batching."""

from .datasets import (
    FeaturePairDataset,
    RowSubset,
    SyntheticPairs,
    dataset_from_config,
    epoch_batches,
    infinite_batches,
    train_eval_split,
)

__all__ = [
    "FeaturePairDataset",
    "RowSubset",
    "SyntheticPairs",
    "dataset_from_config",
    "epoch_batches",
    "infinite_batches",
    "train_eval_split",
]
