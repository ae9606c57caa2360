"""The fused CrossCLR-onlyIntraModality loss.

Counterpart of ``crossclr_tpu/ops/fused_crossclr.py``: normalization and
the positive logits are plain PyTorch (autograd chains through them); the
``[B, 2B]`` logit matrices of both directions live only inside the
logsumexp pair of :mod:`.fused_dual`, whose autograd Functions carry a
hand-written backward.  There is no jnp-style fallback: on a CUDA tensor
the pair launches the CUDA kernels, on a CPU tensor it runs their plain
versions.  The full CrossCLR loss takes the same pair with keep masks
(:func:`.fused_global.cross_clr_fused`).  The per-direction kernels of the
JAX module (``_lse_fwd_kernel`` / ``_lse_bwd_kernel``) are reached there
only past the dual kernel's VMEM budget, which the CUDA kernels do not
have; they are not ported yet (ROADMAP queue 2 items 11-12).
"""

from __future__ import annotations

import torch

from ..losses.functional import l2_normalize
from .fused_dual import dual_lse_pair

__all__ = ["cross_clr_intra_fused", "fused_lse_pair"]


def fused_lse_pair(v_norm: torch.Tensor, t_norm: torch.Tensor, *,
                   temperature=0.03, negative_weight: float = 0.8,
                   precision: str | None = None):
    """Per-row logsumexp over each direction's virtual ``[B, 2B]``
    candidates of L2-normalized features: ``(lse_v, lse_t)``, fp32
    ``[B, 1]``.  ``temperature`` may be a tensor (learnable τ); the route
    (sym or dual kernels) is :func:`.fused_dual.dual_lse_pair`'s."""
    return dual_lse_pair(v_norm, t_norm, temperature=temperature,
                         negative_weight=negative_weight, precision=precision)


def cross_clr_intra_fused(video_features: torch.Tensor,
                          text_features: torch.Tensor, *, temperature=0.03,
                          negative_weight: float = 0.8,
                          precision: str | None = None) -> torch.Tensor:
    """Drop-in fused equivalent of ``losses.cross_clr_intra``:
    ``(mean(lse_v − pos) + mean(lse_t − pos)) / 2`` with ``pos_i =
    ṽ_i·t̃_i / τ``, differentiable in the features and in a tensor τ."""
    v = l2_normalize(video_features.float(), dim=1)
    t = l2_normalize(text_features.float(), dim=1)
    lse_v, lse_t = fused_lse_pair(v, t, temperature=temperature,
                                  negative_weight=negative_weight,
                                  precision=precision)
    pos = (v * t).sum(dim=1, keepdim=True) / temperature
    return ((lse_v - pos).mean() + (lse_t - pos).mean()) / 2
