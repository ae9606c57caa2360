"""Criterion classes with the JAX package's signatures and defaults.

Counterpart of ``crossclr_tpu/losses/criterion.py``, as ``nn.Module``s::

    criterion = CrossCLR_onlyIntraModality(temperature, negative_weight)
    loss = criterion(video_features, text_features)

``logit_scale`` is the reference criterion's vestigial parameter (a
``nn.Parameter`` of 1 that never enters the math), kept so a training loop
that registers the criterion's parameters has the same surface.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from . import functional as F

__all__ = ["CrossCLR", "CrossCLR_onlyIntraModality", "InfoNCE", "MaxMarginCoot"]


class CrossCLR_onlyIntraModality(nn.Module):
    """CrossCLR loss, intra-modality-negatives variant.

    ``backend``: ``"jnp"`` (the eager functional path; the name is the JAX
    package's, kept for signature parity), ``"fused"`` (the fused loss of
    :mod:`..ops.fused_crossclr`: the CUDA kernels on CUDA tensors, fp32
    operands) or ``"fused_fast"`` (the same at the ``default`` tier: bf16
    operands, fp32 accumulation and gradients).
    """

    def __init__(self, temperature: float = 0.03, negative_weight: float = 0.8,
                 logger: Any = None, backend: str = "jnp"):
        super().__init__()
        if backend not in ("jnp", "fused", "fused_fast"):
            raise ValueError(f"unknown backend {backend!r}")
        self.temperature = float(temperature)
        self.negative_w = float(negative_weight)
        self.logger = logger  # accepted and unused, as in the reference
        self.backend = backend
        self.logit_scale = nn.Parameter(torch.ones(()))

    def forward(self, video_features, text_features):
        if self.backend != "jnp":
            from ..ops.fused_crossclr import cross_clr_intra_fused

            return cross_clr_intra_fused(
                video_features, text_features, temperature=self.temperature,
                negative_weight=self.negative_w,
                precision="default" if self.backend == "fused_fast" else None,
            )
        return F.cross_clr_intra(
            video_features, text_features, temperature=self.temperature,
            negative_weight=self.negative_w,
        )


class CrossCLR(nn.Module):
    """Full CrossCLR: inter+intra negatives, influential-sample pruning and
    connectivity-weighted positives (:func:`.functional.cross_clr`).

    ``forward`` takes optional raw input features for connectivity
    scoring; with the embeddings alone the two-argument reference
    signature still works (the scores then come from the embeddings).
    """

    def __init__(self, temperature: float = 0.03, negative_weight: float = 0.8,
                 weight_temperature: float = 0.0035, prune_percent: float = 0.10,
                 weight_norm: str = "raw", logger: Any = None):
        super().__init__()
        self.temperature = float(temperature)
        self.negative_w = float(negative_weight)
        self.weight_temperature = float(weight_temperature)
        self.prune_percent = float(prune_percent)
        self.weight_norm = str(weight_norm)
        self.logger = logger
        self.logit_scale = nn.Parameter(torch.ones(()))

    def forward(self, video_features, text_features, video_inputs=None,
                text_inputs=None):
        return F.cross_clr(
            video_features, text_features, video_inputs, text_inputs,
            temperature=self.temperature, negative_weight=self.negative_w,
            weight_temperature=self.weight_temperature,
            prune_percent=self.prune_percent, weight_norm=self.weight_norm,
        )


class MaxMarginCoot(nn.Module):
    """COOT max-margin ranking criterion; ``use_cuda`` is accepted for
    signature parity and ignored (the tensors' device decides)."""

    def __init__(self, use_cuda: bool = False, margin: float = 0.1):
        super().__init__()
        del use_cuda
        self.margin = float(margin)

    def forward(self, im, s):
        return F.max_margin(im, s, margin=self.margin)


class InfoNCE(nn.Module):
    """Plain symmetric InfoNCE (CLIP-style) for ablations."""

    def __init__(self, temperature: float = 0.03):
        super().__init__()
        self.temperature = float(temperature)

    def forward(self, video_features, text_features):
        return F.info_nce(video_features, text_features,
                          temperature=self.temperature)
