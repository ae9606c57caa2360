"""Feature datasets and batching (numpy only).

Counterpart of ``crossclr_tpu/data/datasets.py``, copied rather than
imported because importing ``crossclr_tpu`` loads jax.  The arrays are
bit-identical to the JAX package's for the same config and seed.

* :class:`SyntheticPairs` — seeded correlated video/text pairs sharing a
  latent, pooled or as ragged sequences with key-padding masks.
* :class:`FeaturePairDataset` — memory-mapped ``.npy`` stores in fp32 or
  bf16.  A bf16 store is kept as its raw ``uint16`` records (numpy has no
  bf16 without ml_dtypes); ``training.trainer.to_tensor`` reinterprets
  them as ``torch.bfloat16``.  int8 stores wait for a later port.
* :func:`epoch_batches` — the deterministic per-(seed, epoch) batcher;
  :func:`infinite_batches` — its endless, resumable stream.
* :class:`RowSubset` / :func:`train_eval_split` — the held-out eval split.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path
from typing import Iterator

import numpy as np

__all__ = [
    "FeaturePairDataset",
    "RowSubset",
    "SyntheticPairs",
    "dataset_from_config",
    "epoch_batches",
    "infinite_batches",
    "train_eval_split",
]

# per-row companions to the two feature fields, carried through every view
# and batcher (the JAX package also carries int8 scales, not ported yet)
_AUX_FIELDS = ("video_mask", "text_mask")


def dataset_from_config(data_cfg):
    """Build the dataset a ``DataConfig`` describes.  Returns ``(dataset,
    ids)`` where ``ids`` is the row-aligned ``ids.json`` manifest next to
    a files store, else None."""
    if data_cfg.source == "synthetic":
        return (
            SyntheticPairs(
                num_pairs=data_cfg.num_pairs,
                video_dim=data_cfg.video_dim,
                text_dim=data_cfg.text_dim,
                video_seq_len=data_cfg.video_seq_len,
                text_seq_len=data_cfg.text_seq_len,
                variable_lengths=data_cfg.variable_lengths,
                seed=data_cfg.seed,
            ),
            None,
        )
    if data_cfg.source == "files":
        dataset = FeaturePairDataset(
            data_cfg.video_path,
            data_cfg.text_path,
            video_mask_path=data_cfg.video_mask_path or None,
            text_mask_path=data_cfg.text_mask_path or None,
            dtype=data_cfg.features_dtype or None,
        )
        if dataset.video.dtype == np.float32:
            print(
                "NOTE: fp32 feature store — host batch assembly moves 2x "
                "the bytes of a bfloat16 store; re-export with "
                "prepare_features --dtype bfloat16 (value-identical for "
                "bf16 towers) unless the towers need fp32 inputs",
                file=sys.stderr,
            )
        manifest = Path(data_cfg.video_path).parent / "ids.json"
        ids = None
        if manifest.exists():
            ids = json.loads(manifest.read_text())
            if len(ids) != len(dataset):
                raise SystemExit(
                    f"ids manifest {manifest} has {len(ids)} entries but the "
                    f"feature store has {len(dataset)} rows — stale manifest?"
                )
        return dataset, ids
    raise SystemExit(f"unknown data.source {data_cfg.source!r}")


@dataclasses.dataclass
class SyntheticPairs:
    """Correlated random feature pairs with a shared latent:
    ``video = W_v z + noise``, ``text = W_t z + noise``."""

    num_pairs: int = 2048
    video_dim: int = 512
    text_dim: int = 384
    latent_dim: int = 64
    noise: float = 0.1
    seed: int = 0
    video_seq_len: int = 0
    text_seq_len: int = 0
    variable_lengths: bool = False

    def __post_init__(self):
        # the draw order is the JAX package's, so the arrays match bit for bit
        rng = np.random.default_rng(self.seed)
        z = rng.standard_normal((self.num_pairs, self.latent_dim)).astype(np.float32)

        def modality(dim: int, seq_len: int):
            w = rng.standard_normal((self.latent_dim, dim)).astype(
                np.float32
            ) / np.sqrt(self.latent_dim)
            pooled = z @ w
            if seq_len == 0:
                feats = pooled + self.noise * rng.standard_normal(
                    pooled.shape
                ).astype(np.float32)
                return feats, None
            seq = np.repeat(pooled[:, None, :], seq_len, axis=1)
            seq = seq + self.noise * rng.standard_normal(seq.shape).astype(
                np.float32
            )
            if not self.variable_lengths:
                return seq, None
            lengths = rng.integers(1, seq_len + 1, size=self.num_pairs)
            mask = (
                np.arange(seq_len)[None, :] < lengths[:, None]
            ).astype(np.float32)
            return seq * mask[:, :, None], mask

        self.video, self.video_mask = modality(self.video_dim, self.video_seq_len)
        self.text, self.text_mask = modality(self.text_dim, self.text_seq_len)

    def __len__(self) -> int:
        return self.num_pairs


class FeaturePairDataset:
    """Aligned pre-extracted features from two memory-mapped ``.npy``
    files, with optional ``[N, S]`` key-padding masks for ``[N, S, D]``
    sequence stores.  ``dtype``: ``"float32"`` (default) or
    ``"bfloat16"`` (2-byte records, kept as ``uint16``)."""

    def __init__(self, video_path, text_path, video_mask_path=None,
                 text_mask_path=None, dtype: str | None = None):
        self.video = self._load_feats(video_path, dtype, "video")
        self.text = self._load_feats(text_path, dtype, "text")
        if self.video.shape[0] != self.text.shape[0]:
            raise ValueError(
                f"row mismatch: video {self.video.shape[0]} vs text "
                f"{self.text.shape[0]}"
            )
        self.video_mask = self._load_mask(video_mask_path, self.video, "video")
        self.text_mask = self._load_mask(text_mask_path, self.text, "text")

    @staticmethod
    def _load_feats(path, dtype, name):
        arr = np.load(path, mmap_mode="r")
        if dtype in (None, "float32"):
            if arr.dtype.itemsize == 2 and arr.dtype.kind in ("V", "u"):
                raise ValueError(
                    f"{name} store {path} holds 2-byte records (a bf16 "
                    "store?) — pass dtype='bfloat16' (data.features_dtype)"
                )
            if arr.dtype == np.int8:
                raise ValueError(
                    f"{name} store {path} holds int8 payloads — pass "
                    "dtype='int8' (data.features_dtype)"
                )
            return arr
        if dtype == "int8":
            raise NotImplementedError(
                "int8 feature stores (data.quantize) are not ported to "
                "crossclr_tpu_torch yet"
            )
        if dtype != "bfloat16":
            raise ValueError(f"unsupported features dtype {dtype!r}")
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in ("V", "u"):
            raise ValueError(
                f"{name} store {path} has dtype {arr.dtype}, not a 2-byte "
                "bf16 payload — re-export with prepare_features "
                "--dtype bfloat16 (float16 stores must be CONVERTED, "
                "not relabeled; or drop data.features_dtype)"
            )
        return arr.view(np.uint16)

    @staticmethod
    def _load_mask(path, feats, name):
        if path is None:
            return None
        mask = np.load(path, mmap_mode="r")
        if feats.ndim != 3:
            raise ValueError(
                f"{name}_mask provided but {name} features are pooled "
                f"{feats.shape}; masks require [N, S, D] sequences"
            )
        if mask.shape != feats.shape[:2]:
            raise ValueError(
                f"{name}_mask shape {mask.shape} does not match "
                f"features {feats.shape[:2]}"
            )
        return mask

    def __len__(self) -> int:
        return self.video.shape[0]


class RowSubset:
    """Lazy contiguous row-range view ``[start, stop)`` of a dataset (plain
    slicing keeps memory-mapped stores lazy)."""

    def __init__(self, dataset, start: int, stop: int):
        self.video = dataset.video[start:stop]
        self.text = dataset.text[start:stop]
        for name in _AUX_FIELDS:
            m = getattr(dataset, name, None)
            setattr(self, name, None if m is None else m[start:stop])

    def __len__(self) -> int:
        return self.video.shape[0]


def train_eval_split(dataset, eval_rows: int) -> tuple[RowSubset, RowSubset]:
    """Disjoint ``(train, eval)`` row views: eval = the FIRST ``eval_rows``
    rows, train = everything after (the same eval set across resumed
    runs, with no extra state)."""
    n = len(dataset)
    if not 0 < eval_rows < n:
        raise ValueError(
            f"eval_rows must be in (0, {n}), got {eval_rows}: need at least "
            "one train row and one eval row"
        )
    return RowSubset(dataset, eval_rows, n), RowSubset(dataset, 0, eval_rows)


def _epoch_indices(n_rows: int, batch_size: int, *, seed: int, epoch: int,
                   shuffle: bool, drop_remainder: bool, start_batch: int
                   ) -> Iterator[np.ndarray]:
    """One epoch of sorted per-batch row indices (the JAX package's
    order)."""
    order = np.arange(n_rows)
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    end = n_rows - (n_rows % batch_size) if drop_remainder else n_rows
    for start in range(start_batch * batch_size, end, batch_size):
        yield np.sort(order[start : start + batch_size])


def epoch_batches(dataset, batch_size: int, *, seed: int = 0, epoch: int = 0,
                  shuffle: bool = True, drop_remainder: bool = True,
                  start_batch: int = 0) -> Iterator[dict]:
    """Yield ``{"video", "text", "video_mask"?, "text_mask"?}`` numpy
    batches, deterministic in (seed, epoch)."""
    fields = {"video": dataset.video, "text": dataset.text}
    for name in _AUX_FIELDS:
        m = getattr(dataset, name, None)
        if m is not None:
            fields[name] = m
    for idx in _epoch_indices(
        len(dataset), batch_size, seed=seed, epoch=epoch, shuffle=shuffle,
        drop_remainder=drop_remainder, start_batch=start_batch,
    ):
        yield {k: np.ascontiguousarray(src[idx]) for k, src in fields.items()}


def infinite_batches(dataset, batch_size: int, *, seed: int = 0,
                     start_step: int = 0, **kw) -> Iterator[dict]:
    """Endless stream of epoch batches, reshuffled per epoch.
    ``start_step`` fast-forwards to the state after that many batches (a
    resumed run continues the exact sequence); the skip gathers no rows."""
    n = len(dataset)
    if kw.get("drop_remainder", True):
        per_epoch = n // batch_size
    else:
        per_epoch = -(-n // batch_size)  # ceil: the last partial batch counts
    if per_epoch == 0:
        raise ValueError(f"batch_size {batch_size} exceeds dataset size {n}")
    epoch, start_batch = divmod(start_step, per_epoch)
    while True:
        yield from epoch_batches(
            dataset, batch_size, seed=seed, epoch=epoch,
            start_batch=start_batch, **kw
        )
        start_batch = 0
        epoch += 1
