"""int8 feature stores: per-row symmetric scales.

Counterpart of ``crossclr_tpu/data/quantize.py``.  For each row ``x`` (all
of ``[D]`` or ``[S, D]``), ``scale = max|x| / 127`` and the payload is
``round(x / scale)``, 4x fewer bytes than fp32 through the page cache, the
gather and the host→device copy.

Quantizing is numpy, on the host.  Dequantizing runs on the device, in
eager torch, on the batch the prefetcher moved: ``Trainer.step_inputs`` and
``Trainer.encode`` call :func:`dequantize_batch` before the towers (and
before the full CrossCLR losses' connectivity), as the JAX trainer does
inside its jitted step, where XLA fuses the multiply into the first
matmul.  One elementwise multiply is not a kernel to hand-write.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "SCALE_KEYS",
    "dequantize",
    "dequantize_batch",
    "quantize_features",
    "symmetric_int8_rows",
]

# batch keys carrying quantization scales, and the feature key each scales
SCALE_KEYS = {"video_scale": "video", "text_scale": "text"}


def symmetric_int8_rows(flat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``[N, K]`` fp32 → (int8 payload, fp32 scales ``[N]``).

    Guards: an all-zero row gets scale 1.0 (its payload is zero either
    way); the scale is floored at 1e-12, since ``amax / 127`` of a
    denormal ``amax`` underflows to 0 and the division would poison the
    int8 cast.  Rows holding a NaN or an infinity are refused.
    """
    amax = np.max(np.abs(flat), axis=1)
    if not np.isfinite(amax).all():
        bad = np.where(~np.isfinite(amax))[0]
        raise ValueError(
            f"non-finite values in rows {bad[:8].tolist()}"
            f"{'...' if bad.size > 8 else ''} — refusing to quantize "
            "(rint(NaN) poisons the int8 payload silently)"
        )
    scale = np.where(amax > 0, np.maximum(amax / 127.0, 1e-12), 1.0).astype(np.float32)
    q = np.round(flat / scale[:, None]).astype(np.int8)
    return q, scale


def quantize_features(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """fp32 features ``[N, D]`` / ``[N, S, D]`` → (int8 payload of the same
    shape, fp32 per-row scales ``[N]``)."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim < 2:
        raise ValueError(f"expected [N, D] or [N, S, D] features, got {x.shape}")
    q, scale = symmetric_int8_rows(x.reshape(x.shape[0], -1))
    return q.reshape(x.shape), scale


def dequantize(features, scale):
    """``features * scale`` in fp32 on the tensors' device, the per-row
    scale broadcast over the trailing dims."""
    import torch

    extra = features.ndim - scale.ndim
    return features.to(torch.float32) * scale.to(torch.float32).reshape(
        tuple(scale.shape) + (1,) * extra)


def dequantize_batch(batch: dict) -> dict:
    """Replace the int8 feature entries of a batch of tensors by their fp32
    values and drop the scale keys; ``batch`` itself when it has no scales.
    Takes ``[B, ...]`` batches and ``[n, B, ...]`` chunks alike (scales
    ``[B]`` / ``[n, B]``)."""
    present = [k for k in SCALE_KEYS if k in batch]
    if not present:
        return batch
    out = dict(batch)
    for skey in present:
        fkey = SCALE_KEYS[skey]
        out[fkey] = dequantize(out[fkey], out.pop(skey))
    return out
