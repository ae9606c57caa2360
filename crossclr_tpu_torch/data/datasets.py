"""Feature datasets, batching and the host→device prefetch.

Counterpart of ``crossclr_tpu/data/datasets.py``, copied rather than
imported because importing ``crossclr_tpu`` loads jax.  The arrays are
bit-identical to the JAX package's for the same config and seed.

* :class:`SyntheticPairs` — seeded correlated video/text pairs sharing a
  latent, pooled or as ragged sequences with key-padding masks.
* :class:`FeaturePairDataset` — memory-mapped ``.npy`` stores in fp32,
  bf16 or int8.  A bf16 store is kept as its raw ``uint16`` records (numpy
  has no bf16 without ml_dtypes); the prefetcher and
  ``training.trainer.to_tensor`` reinterpret them as ``torch.bfloat16``.
  An int8 store carries per-row fp32 scales (``data.quantize``).
* :func:`epoch_batches` — the deterministic per-(seed, epoch) batcher;
  :func:`infinite_batches` — its endless, resumable stream; both gather
  through the native thread pool (``data.native_io``).
* :func:`stacked_chunks` — ``[n, B, ...]`` chunks in one gather each, into
  a ring of reused buffers; :func:`stack_batches`.
* :func:`prefetch_to_device` — a worker thread that assembles the next
  batches and copies them to the card on its own stream.
* :func:`train_stream` — the train CLI's path: chunks into a page-locked
  ring of two, prefetched to the card.
* :class:`RowSubset` / :func:`train_eval_split` — the held-out eval split;
  :class:`HostShard` — one process's rows of a multi-process run.
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
    "HostShard",
    "RowSubset",
    "SyntheticPairs",
    "dataset_from_config",
    "epoch_batches",
    "infinite_batches",
    "prefetch_to_device",
    "stack_batches",
    "stacked_chunks",
    "train_eval_split",
    "train_stream",
]

# per-row companions to the two feature fields, carried through every view
# and batcher: key-padding masks for ragged sequences, per-row scales for
# int8 stores (data.quantize)
_AUX_FIELDS = ("video_mask", "text_mask", "video_scale", "text_scale")


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
    sequence stores.  ``dtype``: ``"float32"`` (default), ``"bfloat16"``
    (2-byte records, kept as ``uint16``) or ``"int8"`` (per-row symmetric
    payloads with fp32 scales in sibling ``<stem>_scale.npy`` files; batches
    then carry ``video_scale`` / ``text_scale`` ``[B]``, dequantized on the
    device)."""

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
        self.video_scale = self.text_scale = None
        if dtype == "int8":
            self.video_scale = self._load_scale(video_path, self.video, "video")
            self.text_scale = self._load_scale(text_path, self.text, "text")

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
            if arr.dtype != np.int8:
                raise ValueError(
                    f"{name} store {path} has dtype {arr.dtype}, not int8 "
                    "— re-export with prepare_features --dtype int8 (or "
                    "fix data.features_dtype)"
                )
            return arr
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
    def _load_scale(path, feats, name):
        """Per-row fp32 scales of an int8 store: the sibling
        ``<stem>_scale.npy`` next to the payload file."""
        path = Path(path)
        scale_path = path.with_name(path.stem + "_scale.npy")
        if not scale_path.exists():
            raise ValueError(
                f"int8 {name} store {path} has no scale file {scale_path} "
                "— re-export with prepare_features --dtype int8"
            )
        scale = np.load(scale_path, mmap_mode="r")
        if scale.shape != (feats.shape[0],) or scale.dtype != np.float32:
            raise ValueError(
                f"{scale_path} must be float32 [{feats.shape[0]}], got "
                f"{scale.dtype} {scale.shape}"
            )
        return scale

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


class HostShard:
    """Process ``p`` of ``P``'s rows of a dataset: rows ``p::P`` (a lazy
    strided view, no copy even of a memory-mapped store), cut to
    ``floor(N/P)`` so that every process has the same shard length and
    therefore the same epoch boundaries; every process shuffles its shard
    with the same stream, so the global batch is a deterministic disjoint
    union.  Each rank of the data-parallel step reads its own shard at the
    local batch (``train.py``; ``parallel.host_local_batch_size``)."""

    def __init__(self, dataset, process_index: int, process_count: int):
        usable = len(dataset) // process_count
        self.video = dataset.video[process_index::process_count][:usable]
        self.text = dataset.text[process_index::process_count][:usable]
        for name in _AUX_FIELDS:
            m = getattr(dataset, name, None)
            setattr(self, name,
                    None if m is None else m[process_index::process_count][:usable])

    def __len__(self) -> int:
        return self.video.shape[0]


def _epoch_indices(n_rows: int, batch_size: int, *, seed: int, epoch: int,
                   shuffle: bool, drop_remainder: bool, start_batch: int
                   ) -> Iterator[np.ndarray]:
    """One epoch of sorted per-batch row indices (the JAX package's
    order): the one source of batch order for every batcher."""
    order = np.arange(n_rows)
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    end = n_rows - (n_rows % batch_size) if drop_remainder else n_rows
    for start in range(start_batch * batch_size, end, batch_size):
        yield np.sort(order[start : start + batch_size])


def _batch_fields(dataset) -> dict:
    fields = {"video": dataset.video, "text": dataset.text}
    for name in _AUX_FIELDS:
        m = getattr(dataset, name, None)
        if m is not None:
            fields[name] = m
    return fields


def epoch_batches(dataset, batch_size: int, *, seed: int = 0, epoch: int = 0,
                  shuffle: bool = True, drop_remainder: bool = True,
                  start_batch: int = 0) -> Iterator[dict]:
    """Yield ``{"video", "text", and each of "video_mask", "text_mask",
    "video_scale", "text_scale" the dataset has}`` numpy batches,
    deterministic in (seed, epoch), each field gathered by the native
    thread pool into a fresh array.  ``start_batch`` skips batches without
    gathering their rows."""
    from .native_io import gather_rows

    fields = _batch_fields(dataset)
    for idx in _epoch_indices(
        len(dataset), batch_size, seed=seed, epoch=epoch, shuffle=shuffle,
        drop_remainder=drop_remainder, start_batch=start_batch,
    ):
        yield {k: gather_rows(src, idx) for k, src in fields.items()}


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


def _pinned_empty(shape: tuple, dtype: np.dtype) -> np.ndarray:
    """A page-locked host array of ``shape`` and ``dtype``: a card's DMA
    engine copies from it while the host runs on.  Page-aligned numpy
    memory registered with ``cudaHostRegister``, so that it locks exactly
    its own bytes (torch's pinned allocator rounds each block up to a power
    of two and keeps it cached after use); unregistered when the array is
    freed."""
    import weakref

    import torch

    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    page = 4096
    raw = np.empty(nbytes + page, np.uint8)
    offset = -raw.ctypes.data % page
    arr = raw[offset:offset + nbytes].view(dtype).reshape(shape)
    if nbytes:
        cudart = torch.cuda.cudart()
        addr = raw.ctypes.data + offset
        err = cudart.cudaHostRegister(addr, nbytes, 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: "
                               f"{cudart.cudaGetErrorString(err)}")
        weakref.finalize(raw, cudart.cudaHostUnregister, addr)
    return arr


def _index_stream(n_rows: int, batch_size: int, *, seed: int, start_step: int,
                  shuffle: bool) -> Iterator[np.ndarray]:
    """The endless per-batch sorted indices of :func:`infinite_batches`
    (drop_remainder), resumed at ``start_step``; raises at once when a
    batch exceeds the rows."""
    per_epoch = n_rows // batch_size
    if per_epoch == 0:
        raise ValueError(f"batch_size {batch_size} exceeds dataset size {n_rows}")
    epoch, start_batch = divmod(start_step, per_epoch)

    def stream():
        e, sb = epoch, start_batch
        while True:
            yield from _epoch_indices(
                n_rows, batch_size, seed=seed, epoch=e, shuffle=shuffle,
                drop_remainder=True, start_batch=sb,
            )
            sb = 0
            e += 1

    return stream()


def _ring(fields: dict, rows: int, k: int, empty) -> list[dict]:
    """``k`` destination buffers of ``rows`` rows for each field."""
    return [{name: empty((rows, *src.shape[1:]), src.dtype)
             for name, src in fields.items()} for _ in range(k)]


def _chunks(fields: dict, indices: Iterator[np.ndarray], batch_size: int,
            n: int, ring: list[dict]) -> Iterator[dict]:
    """``[n, B, ...]`` chunks of the next ``n`` batches of ``indices``, each
    field in ONE native gather, into the ring's buffers in turn (fresh
    arrays when the ring is empty)."""
    from .native_io import gather_rows

    draw = 0
    while True:
        flat = np.concatenate([next(indices) for _ in range(n)])
        bufs = ring[draw % len(ring)] if ring else {}
        draw += 1
        yield {
            k: gather_rows(src, flat, out=bufs.get(k)).reshape(
                n, batch_size, *src.shape[1:])
            for k, src in fields.items()
        }


def stacked_chunks(dataset, batch_size: int, n: int, *, seed: int = 0,
                   start_step: int = 0, shuffle: bool = True,
                   reuse_buffers: int = 0) -> Iterator[dict]:
    """Endless ``[n, B, ...]`` stacked chunks, each field assembled with ONE
    native gather.

    The chunks equal ``stack_batches(infinite_batches(dataset, B, ...), n)``
    (the same shuffle stream, per-batch sorted indices, epoch wrap and
    ``start_step`` resume), without ``n`` gathers plus an ``np.stack``
    copy.  ``stacked_chunks(n=1)`` yields the batches of
    ``infinite_batches`` with a leading axis of 1.

    ``reuse_buffers=k`` (k ≥ 2): gather into a ring of ``k`` destination
    buffers, all allocated when the first chunk is drawn and reused after,
    instead of a fresh allocation per chunk (fresh pages fault on first
    touch, several times slower than the copy).
    CONTRACT: a yielded chunk's arrays are only valid until ``k - 1`` more
    chunks have been drawn; a caller that keeps chunks uses fresh
    allocations (``reuse_buffers=0``).
    """
    if reuse_buffers < 0 or reuse_buffers == 1:
        # a negative ring would be empty and silently allocate per chunk;
        # a ring of 1 would overwrite the chunk just yielded
        raise ValueError(
            f"reuse_buffers={reuse_buffers}: use 0 (fresh allocations) "
            "or >= 2 (destination ring)"
        )
    fields = _batch_fields(dataset)
    indices = _index_stream(len(dataset), batch_size, seed=seed,
                            start_step=start_step, shuffle=shuffle)
    ring = _ring(fields, n * batch_size, reuse_buffers, np.empty)
    yield from _chunks(fields, indices, batch_size, n, ring)


def chunk_nbytes(dataset, batch_size: int, n: int) -> int:
    """The bytes of one ``[n, B, ...]`` chunk of ``dataset``."""
    return n * batch_size * sum(
        src.dtype.itemsize * int(np.prod(src.shape[1:]))
        for src in _batch_fields(dataset).values())


def check_chunk_bytes(nbytes: int, n: int, budget: int) -> None:
    """Refuse a stacked chunk of ``n`` steps and ``nbytes`` bytes over
    ``budget`` (0: no budget)."""
    if budget and nbytes > budget:
        raise ValueError(
            f"stacked chunk is {nbytes / 2**30:.2f} GiB "
            f"({n} steps x {nbytes / n / 2**20:.0f} MiB/batch), "
            f"over the {budget / 2**30:.2f} GiB chunk budget (a quarter "
            "of the device's memory; the chunk plus the prefetched next "
            "one must leave room for params and activations) — lower "
            "train.steps_per_call, or raise/disable the guard via "
            "train.max_stacked_bytes (0 disables)"
        )


# the train stream's host ring: two buffers are enough, since the
# prefetcher finishes each copy before it draws again (on the CPU it hands
# over private copies); on a card the rings of one host's ranks may lock at
# most this share of the host's memory together
TRAIN_RING = 2
PINNED_HOST_SHARE = 0.5


def host_memory_bytes() -> int:
    import os

    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def train_stream(dataset, batch_size: int, n: int, *, device="cuda",
                 seed: int = 0, start_step: int = 0,
                 max_chunk_bytes: int = 0,
                 host_ranks: int = 1) -> "DevicePrefetcher":
    """The train CLI's data path: the batches of ``infinite_batches``
    (resumed at ``start_step``) on ``device``, ``n`` to a chunk.

    Each ``[n, B, ...]`` chunk is gathered into a ring of ``TRAIN_RING``
    host buffers, page-locked on a CUDA device, and prefetched one chunk
    ahead by a :class:`DevicePrefetcher`; with ``n == 1`` the chunks are
    unstacked into ``[B, ...]`` batches, prefetched two ahead.  Before
    anything is allocated it refuses a stacked chunk (``n > 1``) over
    ``max_chunk_bytes`` (the trainer's ``stacked_budget``; 0: none), and on
    a CUDA device a ring that would lock more than its rank's part of
    ``PINNED_HOST_SHARE`` of the host's memory: the share over
    ``host_ranks``, the ranks on this host, each of which locks its own
    ring.  A data-parallel rank passes its :class:`HostShard` and its
    local batch."""
    import torch

    device = torch.device(device)
    fields = _batch_fields(dataset)
    indices = _index_stream(len(dataset), batch_size, seed=seed,
                            start_step=start_step, shuffle=True)
    nbytes = chunk_nbytes(dataset, batch_size, n)
    if n > 1:
        check_chunk_bytes(nbytes, n, max_chunk_bytes)
    pinned = device.type == "cuda"
    if pinned:
        limit = int(host_memory_bytes() * PINNED_HOST_SHARE / host_ranks)
        if TRAIN_RING * nbytes > limit:
            raise ValueError(
                f"the host ring of {TRAIN_RING} chunks of {n} x {batch_size} "
                f"rows would lock {TRAIN_RING * nbytes / 2**30:.2f} GiB, over "
                f"{PINNED_HOST_SHARE:.0%} of the host's memory shared by "
                f"{host_ranks} rank(s) on this host ({limit / 2**30:.2f} GiB) — "
                "lower train.steps_per_call or data.batch_size")
    ring = _ring(fields, n * batch_size, TRAIN_RING,
                 _pinned_empty if pinned else np.empty)
    chunks = _chunks(fields, indices, batch_size, n, ring)
    if n == 1:
        chunks = ({k: v[0] for k, v in c.items()} for c in chunks)
    return prefetch_to_device(chunks, size=1 if n > 1 else 2, device=device)


def stack_batches(batches: Iterator[dict], n: int) -> Iterator[dict]:
    """Group consecutive batches into ``[n, B, ...]`` host chunks with
    ``np.stack``; a final partial group is yielded with a shorter leading
    axis."""
    group: list[dict] = []
    for b in batches:
        group.append(b)
        if len(group) == n:
            yield {k: np.stack([g[k] for g in group]) for k in group[0]}
            group = []
    if group:
        yield {k: np.stack([g[k] for g in group]) for k in group[0]}


def prefetch_to_device(batches: Iterator[dict], size: int = 2,
                       device="cuda", sharding=None) -> "DevicePrefetcher":
    """Keep up to ``size`` batches (or chunks) on ``device`` ahead of the
    consumer: a :class:`DevicePrefetcher` over ``batches``.  Under a
    data-parallel group each rank owns its prefetcher on its own device,
    over its own rows (:class:`HostShard`).  ``sharding`` is refused: a
    rank's chunk is already its shard of the global batch, so there is
    nothing to lay out across devices."""
    if sharding is not None:
        raise NotImplementedError(
            "prefetch_to_device(sharding=...) has no counterpart in "
            "crossclr_tpu_torch (decided in ROADMAP queue 1 #16): each rank "
            "prefetches its own HostShard's chunks to its own device")
    return DevicePrefetcher(batches, size, device)


_SENTINEL = object()


def _host_tensor(v):
    """A host batch field as a CPU tensor sharing its memory, and whether
    it is a bf16 payload (``uint16`` records, moved as ``int16``)."""
    import torch

    if isinstance(v, torch.Tensor):
        return v, False
    v = np.asarray(v)
    if v.dtype == np.uint16:
        return torch.from_numpy(v.view(np.int16)), True
    return torch.from_numpy(v), False


class DevicePrefetcher:
    """An iterator of ``{name: tensor on the device}`` batches, assembled
    and copied ahead of the consumer by one worker thread.

    The worker draws each host batch from ``batches`` (the native gather
    runs with the GIL released), then on a CUDA device copies it with
    ``non_blocking=True`` on its own ``torch.cuda.Stream``, between two
    timing events.  Before it draws the next batch it waits for that copy's
    event: a ring buffer of :func:`stacked_chunks` is never refilled while
    a copy reads it.  The consumer's stream waits for the event before the
    batch is used, and each tensor is ``record_stream``-ed on it, so the
    caching allocator never hands its memory to the worker's stream while
    the step still reads it.  The host batch must be page-locked (as
    :func:`train_stream`'s ring is): a ``non_blocking`` copy from pageable
    memory is silently synchronous, so a pageable batch raises.  bf16
    payloads travel as ``int16`` and are viewed as ``torch.bfloat16`` on
    the device; int8 payloads and fp32 scales travel as they are.

    At most ``size + 1`` batches are resident on the device: the
    consumer's and ``size`` queued.  The worker allocates and copies a
    batch only for a free queue slot, and only once the card has run the
    work the consumer queued before its last draw (an event recorded at
    that draw), so the batch before the consumer's is released first.

    On the CPU (tests, ``--device cpu``) the worker hands over a private
    copy of each batch, so a reused ring buffer never aliases a batch the
    consumer holds.

    A worker exception is raised again in the consumer; a worker that dies
    without a word is noticed within ``POLL_S`` seconds.  :meth:`close`
    stops and joins the worker.  ``stats`` holds, per batch, the worker's
    ``gather_ms`` (its draw from ``batches``), ``h2d_ms`` (the copy, by the
    stream's events; CUDA only), ``bytes`` and the consumer's ``wait_ms``
    for the next batch.
    """

    POLL_S = 5.0

    def __init__(self, batches, size: int = 2, device="cuda"):
        import queue
        import threading

        import torch

        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"prefetch_to_device: unsupported device {device}")
        self.device = device
        self.stats: dict[str, list[float]] = {
            "gather_ms": [], "h2d_ms": [], "bytes": [], "wait_ms": []}
        self._batches = iter(batches)
        self._queue = queue.Queue()
        # one token per free queue slot: None, or the event recorded on
        # the consumer's stream when it drew the batch that freed the slot
        self._free = queue.Queue()
        for _ in range(max(size, 1)):
            self._free.put(None)
        self._stop = threading.Event()
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._done = False
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name="crossclr-prefetch")
        self._thread.start()

    # -- the worker ---------------------------------------------------------

    def _slot(self) -> bool:
        """Wait for a free queue slot and for the card to have run the
        work queued before the draw that freed it; False once stopped."""
        import queue

        while not self._stop.is_set():
            try:
                event = self._free.get(timeout=0.1)
            except queue.Empty:
                continue
            if event is not None:
                event.synchronize()
            return True
        return False

    def _stage(self, batch: dict):
        """``(device batch, its copy's end event or None), pending`` where
        ``pending`` is what the next draw must wait for."""
        import torch

        host = {k: _host_tensor(v) for k, v in batch.items()}
        self.stats["bytes"].append(
            sum(t.numel() * t.element_size() for t, _ in host.values()))
        if self._stream is None:  # CPU: a private copy, detached from the ring
            return ({k: t.clone().view(torch.bfloat16) if bf16 else t.clone()
                     for k, (t, bf16) in host.items()}, None), None
        for k, (t, _) in host.items():
            if not t.is_pinned():
                raise ValueError(
                    f"batch field {k!r} lies in pageable host memory: a "
                    "non_blocking copy from it would be synchronous; draw "
                    "the batches from train_stream (a page-locked ring)")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            start.record(self._stream)
            moved = {k: t.to(self.device, non_blocking=True)
                     for k, (t, _) in host.items()}
            end.record(self._stream)
        moved = {k: t.view(torch.bfloat16) if host[k][1] else t
                 for k, t in moved.items()}
        return (moved, end), (start, end, host)

    def _fence(self, pending) -> None:
        start, end, _ = pending  # the host batch stays alive until here
        end.synchronize()
        self.stats["h2d_ms"].append(start.elapsed_time(end))

    def _work(self) -> None:
        import time

        import torch

        pending = None
        try:
            if self._stream is not None:
                torch.cuda.set_device(self.device)
            while not self._stop.is_set():
                if pending is not None:
                    self._fence(pending)
                    pending = None
                t0 = time.perf_counter()
                try:
                    batch = next(self._batches)
                except StopIteration:
                    self._queue.put(_SENTINEL)
                    return
                self.stats["gather_ms"].append((time.perf_counter() - t0) * 1e3)
                if not self._slot():
                    return
                item, pending = self._stage(batch)
                self._queue.put(item)
        except BaseException as exc:  # noqa: BLE001 — raised again by the consumer
            self._queue.put(exc)
        finally:
            if pending is not None:
                pending[1].synchronize()

    # -- the consumer -------------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        import queue
        import time

        import torch

        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        while True:
            try:
                item = self._queue.get(timeout=self.POLL_S)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    self._done = True
                    raise RuntimeError(
                        "prefetch worker thread died without delivering a "
                        "sentinel or an exception") from None
        self.stats["wait_ms"].append((time.perf_counter() - t0) * 1e3)
        if item is _SENTINEL:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        batch, event = item
        if event is None:
            self._free.put(None)
        else:
            stream = torch.cuda.current_stream(self.device)
            drawn = torch.cuda.Event()
            drawn.record(stream)
            self._free.put(drawn)
            stream.wait_event(event)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker and join it (it finishes the draw or copy it is
        in), drop the batches still queued, then close the source."""
        import queue

        self._stop.set()
        self._done = True
        self._thread.join(timeout)
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        if not self._thread.is_alive() and hasattr(self._batches, "close"):
            self._batches.close()
