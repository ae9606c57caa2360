"""The trainer's model-init and encode surface.

Counterpart of ``crossclr_tpu/training/trainer.py``.  ``TrainConfig`` has
every field and default of the JAX one, so the JSON configs load; of them
this slice reads only ``seed``.  There is no optimizer and no train step
yet: the trainer builds the dual towers on an explicit device, fills them
from a seeded ``torch.Generator``, and encodes in eval mode.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.encoders import DualEncoder, TowerConfig

__all__ = ["TrainConfig", "TrainState", "Trainer", "to_tensor"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Field for field the JAX ``TrainConfig`` (see its comments)."""

    loss: str = "crossclr_intra"
    temperature: float = 0.03
    negative_weight: float = 0.8
    weight_temperature: float = 0.0035
    prune_percent: float = 0.10
    weight_norm: str = "raw"
    margin: float = 0.1
    learning_rate: float = 1e-4
    zero1: bool = False
    optimizer: str = "adamw"
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    global_negatives: bool = True
    global_candidate_chunk: int | None = None
    loss_precision: str | None = None
    embedding_chunk: int | None = None
    abort_on_nonfinite: bool = True
    steps_per_call: int = 1
    max_stacked_bytes: int | None = None
    learnable_temperature: bool = False
    ema_decay: float | None = None
    keep_best_metric: str | None = None
    eval_with_ema: bool = False
    seed: int = 0


@dataclasses.dataclass
class TrainState:
    """The step count and the model whose parameters it holds."""

    step: int
    model: DualEncoder


def to_tensor(x, device, dtype=None) -> torch.Tensor:
    """A host array (numpy, or a bf16 store's raw ``uint16`` records) as a
    tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    x = np.asarray(x)
    if x.dtype == np.uint16:  # bf16 payload: reinterpret the bits
        t = torch.from_numpy(np.ascontiguousarray(x).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype)


def init_params(model: torch.nn.Module, seed: int) -> None:
    """Fill ``model`` in place from a CPU ``torch.Generator`` seeded with
    ``seed``, so the weights do not depend on the device.  The scales
    follow the Flax initializers: LeCun-normal weights (std 1/sqrt(fan_in),
    truncated at two standard deviations), zero biases, unit LayerNorm
    scales, ``pos_embed`` ~ N(0, 0.02²); ``logit_scale`` starts at 1."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pos_embed":
            value = torch.randn(p.shape, generator=gen) * 0.02
        elif leaf == "logit_scale":
            value = torch.ones(p.shape)
        elif leaf == "bias":
            value = torch.zeros(p.shape)
        elif p.ndim == 1:  # LayerNorm weight
            value = torch.ones(p.shape)
        else:  # Linear weight [out, in]
            # a standard normal truncated at ±2 has std 0.87962566
            value = torch.nn.init.trunc_normal_(
                torch.empty(p.shape), generator=gen
            ) * (1.0 / math.sqrt(p.shape[1]) / 0.87962566)
        with torch.no_grad():
            p.copy_(value)


class Trainer:
    """Owns the dual towers on ``device`` and their eval-mode encode.

    Unlike the JAX trainer, no flash→xla demotion exists here: the port
    runs on one device.
    """

    def __init__(self, video_cfg: TowerConfig, text_cfg: TowerConfig,
                 train_cfg: TrainConfig, device: str | torch.device = "cuda"):
        self.video_cfg = video_cfg
        self.text_cfg = text_cfg
        self.cfg = train_cfg
        self.device = torch.device(device)

    def init_state(self) -> TrainState:
        """Step-0 state with towers seeded from ``train.seed``; a torch
        module knows its shapes from the config, so no sample batch is
        needed."""
        model = DualEncoder(self.video_cfg, self.text_cfg)
        init_params(model, self.cfg.seed)
        return TrainState(step=0, model=model.to(self.device).eval())

    def encode(self, state: TrainState, batch: dict):
        """``(video_emb, text_emb)`` fp32 ``[B, E]`` for a host batch."""
        dev = self.device
        with torch.inference_mode():
            return state.model(
                to_tensor(batch["video"], dev),
                to_tensor(batch["text"], dev),
                _optional(batch.get("video_mask"), dev),
                _optional(batch.get("text_mask"), dev),
            )

    def encode_modality(self, state: TrainState, side: str, features,
                        mask=None) -> torch.Tensor:
        """Encode ONE modality through its own tower only (the serving
        hot path): fp32 ``[B, E]`` on the trainer's device."""
        dev = self.device
        with torch.inference_mode():
            return state.model.encode(
                side, to_tensor(features, dev), _optional(mask, dev)
            )


def _optional(x, device):
    return None if x is None else to_tensor(x, device)
