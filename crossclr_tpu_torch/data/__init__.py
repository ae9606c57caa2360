"""Datasets, batching, the native host gather, int8 stores and the
host→device prefetch."""

from .datasets import (
    DevicePrefetcher,
    FeaturePairDataset,
    HostShard,
    RowSubset,
    SyntheticPairs,
    dataset_from_config,
    epoch_batches,
    infinite_batches,
    prefetch_to_device,
    stack_batches,
    stacked_chunks,
    train_eval_split,
    train_stream,
)
from .native_io import f32_to_bf16, gather_rows
from .quantize import dequantize, dequantize_batch, quantize_features

__all__ = [
    "DevicePrefetcher",
    "FeaturePairDataset",
    "HostShard",
    "RowSubset",
    "SyntheticPairs",
    "dataset_from_config",
    "dequantize",
    "dequantize_batch",
    "epoch_batches",
    "f32_to_bf16",
    "gather_rows",
    "infinite_batches",
    "prefetch_to_device",
    "quantize_features",
    "stack_batches",
    "stacked_chunks",
    "train_eval_split",
    "train_stream",
]
