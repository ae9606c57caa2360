"""Split encoding for eval and serving.

Counterpart of ``crossclr_tpu/eval.py:_encode_split``; the eval CLI and
its metrics wait for a later port (ROADMAP queue 1 #7).  Batches are
gathered by the native thread pool (``data.epoch_batches``); fp32, bf16
and int8 stores encode alike, an int8 batch dequantized on the device by
``Trainer.encode``.
"""

from __future__ import annotations

import torch

from .data import epoch_batches


def _encode_split(trainer, state, data, batch_size: int):
    """Encode every row of ``data`` in aligned batches -> ``(v_emb,
    t_emb)``, fp32 tensors on the trainer's device."""
    v_parts, t_parts = [], []
    for batch in epoch_batches(
        data, batch_size, shuffle=False, drop_remainder=False
    ):
        v, t = trainer.encode(state, batch)
        v_parts.append(v)
        t_parts.append(t)
    return torch.cat(v_parts), torch.cat(t_parts)
