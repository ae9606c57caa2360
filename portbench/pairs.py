"""Feature pairs made from the seed: a shared latent ``z`` (64 wide) and
per modality ``pooled = z W / 8``.  An MLP's (pooled) store holds
``pooled + 0.1·noise``; a sequence store holds at every position
``pooled + u W / 8 + 0.1·noise``, with a latent ``u`` of its own per
position, so that the positions differ as much as the pairs do and
attention is far from uniform (identical positions would leave the query
and key weights all but no gradient).  Made on the device in blocks,
stored in host memory in the configuration's feature dtype (a bf16 store
as raw ``uint16`` records, as the port's feature stores keep it)."""

from __future__ import annotations

import numpy as np
import torch

LATENT = 64
NOISE = 0.1
BLOCK_ELEMENTS = 1 << 27


class Store:
    """Host arrays ``video`` and ``text`` of ``len`` aligned rows."""

    def __init__(self, video: np.ndarray, text: np.ndarray):
        self.video, self.text = video, text

    def __len__(self) -> int:
        return self.video.shape[0]


def _modality(gen, z, dim: int, seq: int, dtype: torch.dtype, device: str):
    n = z.shape[0]
    w = torch.randn(LATENT, dim, generator=gen, device=device) / 8.0
    pooled = z @ w
    shape = (n, seq, dim) if seq else (n, dim)
    host = np.empty(shape, np.uint16 if dtype == torch.bfloat16 else np.float32)
    sink = torch.from_numpy(host.view(np.int16) if dtype == torch.bfloat16 else host)
    rows = max(1, BLOCK_ELEMENTS // (max(seq, 1) * dim))
    for lo in range(0, n, rows):
        p = pooled[lo:lo + rows]
        if seq:
            u = torch.randn(p.shape[0], seq, LATENT, generator=gen, device=device)
            noise = torch.randn(p.shape[0], seq, dim, generator=gen, device=device)
            x = p[:, None, :] + u @ w + NOISE * noise
        else:
            x = p + NOISE * torch.randn(p.shape, generator=gen, device=device)
        x = x.to(dtype)
        sink[lo:lo + rows].copy_(x.view(torch.int16) if dtype == torch.bfloat16 else x)
    return host


def make(config: dict, n: int, seed: int, device: str, dtype: torch.dtype) -> Store:
    """``n`` pairs of the configuration's input widths and lengths (a
    pooled store for MLP towers)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    z = torch.randn(n, LATENT, generator=gen, device=device)
    out = []
    for side in ("video", "text"):
        cfg = config[f"{side}_tower"]
        seq = cfg["max_seq_len"] if cfg["kind"] == "transformer" else 0
        out.append(_modality(gen, z, cfg["input_dim"], seq, dtype, device))
    return Store(*out)


KEY_BYTES = 16


def _row_bytes(a) -> np.ndarray:
    """``[n, bytes]`` raw view of a store array or a CPU tensor's rows."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous().view(torch.uint8).numpy()
    a = np.ascontiguousarray(a)
    return a.reshape(a.shape[0], -1).view(np.uint8)


def locate(store: Store, batches: list[dict]) -> tuple[list[dict], int]:
    """The store's own rows of each gathered batch, and the count of
    faulty rows.  A batch row is found by its video record's first bytes;
    it is faulty where no store row starts so, or where its video or its
    text record is not that row's, bit for bit (a row gathered wrong, or a
    video paired with another row's text).  Returns the store's rows of
    each batch, ``{"video": rows, "text": rows}`` as bf16 or fp32 tensors
    (the reference's inputs), and the faults."""
    keys = _keys(_row_bytes(store.video))
    where = dict(zip(keys.tolist(), range(len(keys))))
    bf16 = store.video.dtype == np.uint16
    own, faults = [], 0
    for batch in batches:
        got = {side: _row_bytes(batch[side]) for side in ("video", "text")}
        rows = np.array([where.get(k, -1) for k in _keys(got["video"]).tolist()])
        at = np.maximum(rows, 0)
        mine = {side: getattr(store, side)[at] for side in got}
        good = rows >= 0
        for side in got:
            good &= (_row_bytes(mine[side]) == got[side]).all(axis=1)
        faults += int((~good).sum())
        own.append({side: _tensor(mine[side], bf16) for side in mine})
    return own, faults


def _keys(rows: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(rows[:, :KEY_BYTES]).view(f"V{KEY_BYTES}").ravel()


def _tensor(rows: np.ndarray, bf16: bool) -> torch.Tensor:
    return (torch.from_numpy(rows.view(np.int16)).view(torch.bfloat16) if bf16
            else torch.from_numpy(rows))
