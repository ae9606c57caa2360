"""Loss math; this slice needs only the normalization.

Counterpart of ``crossclr_tpu/losses/functional.py``.
"""

from __future__ import annotations

import torch

__all__ = ["l2_normalize"]


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along ``dim``, the norm clamped at ``eps`` (not added)."""
    return x / torch.linalg.vector_norm(x, ord=2, dim=dim, keepdim=True).clamp_min(eps)
