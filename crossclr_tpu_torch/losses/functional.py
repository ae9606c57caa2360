"""Pure-functional CrossCLR losses in eager PyTorch.

Counterpart of ``crossclr_tpu/losses/functional.py``, with its semantics:

* :func:`cosine_sim` is the raw dot product (it normalizes nothing);
* :func:`cross_clr_intra_per_row` ZEROES the intra-modal self-similarity
  logit (it is not excluded), so each softmax denominator carries an
  ``exp(0) = 1`` term, as the released reference loss does;
* every similarity product runs in the inputs' float type: fp32 for fp32
  features (float64 inputs stay float64).  On the card this assumes
  PyTorch's default ``torch.backends.cuda.matmul.allow_tf32 = False``;
  callers that compare against these functions there set it so.

``temperature`` may be a tensor (learnable temperature): autograd flows
through it.  The full CrossCLR loss (pruning and positive weights) is not
ported yet (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import torch

__all__ = [
    "cosine_sim",
    "cross_clr_intra",
    "cross_clr_intra_per_row",
    "info_nce",
    "l2_normalize",
    "max_margin",
]


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along ``dim``, the norm clamped at ``eps`` (not added)."""
    return x / torch.linalg.vector_norm(x, ord=2, dim=dim, keepdim=True).clamp_min(eps)


def cosine_sim(emb1: torch.Tensor, emb2: torch.Tensor) -> torch.Tensor:
    """Raw dot-product similarity ``[B1, B2]``: a cosine only when the
    inputs are already unit vectors."""
    return emb1 @ emb2.T


def _intra_logit_rows(anchor_sim, inter_sim, temperature, negative_weight):
    """Per-row loss of one direction: ``logsumexp([inter/τ ‖ w·(anchor/τ)
    ⊙ (1 − I)]) − inter_ii/τ``."""
    b = inter_sim.shape[0]
    inter = inter_sim / temperature
    eye = torch.eye(b, dtype=anchor_sim.dtype, device=anchor_sim.device)
    intra = negative_weight * (anchor_sim / temperature) * (1.0 - eye)
    lse = torch.logsumexp(torch.cat([inter, intra], dim=1), dim=1)
    return lse - torch.diagonal(inter)


def cross_clr_intra_per_row(video_features, text_features, *,
                            temperature=0.03, negative_weight: float = 0.8):
    """Per-row (video-anchored, text-anchored) CrossCLR-onlyIntraModality
    losses of raw ``[B, D]`` features (both L2-normalized here)."""
    v = l2_normalize(video_features, dim=1)
    t = l2_normalize(text_features, dim=1)
    sim_vt = v @ t.T
    loss_v = _intra_logit_rows(v @ v.T, sim_vt, temperature, negative_weight)
    loss_t = _intra_logit_rows(t @ t.T, sim_vt.T, temperature, negative_weight)
    return loss_v, loss_t


def cross_clr_intra(video_features, text_features, *, temperature=0.03,
                    negative_weight: float = 0.8) -> torch.Tensor:
    """CrossCLR-onlyIntraModality scalar loss:
    ``(mean_i L^v_i + mean_i L^t_i) / 2``."""
    loss_v, loss_t = cross_clr_intra_per_row(
        video_features, text_features, temperature=temperature,
        negative_weight=negative_weight,
    )
    return (loss_v.mean() + loss_t.mean()) / 2


def info_nce(video_features, text_features, *, temperature=0.03) -> torch.Tensor:
    """Symmetric InfoNCE (CLIP-style) over the inter-modal logits only."""
    v = l2_normalize(video_features, dim=1)
    t = l2_normalize(text_features, dim=1)
    logits = (v @ t.T) / temperature
    pos = torch.diagonal(logits)
    loss_v = torch.logsumexp(logits, dim=1) - pos
    loss_t = torch.logsumexp(logits.T, dim=1) - pos
    return (loss_v.mean() + loss_t.mean()) / 2


def max_margin(im: torch.Tensor, s: torch.Tensor, *, margin: float = 0.1) -> torch.Tensor:
    """COOT bidirectional max-margin ranking loss on raw dot products:
    hinge costs against the diagonal in both directions, the diagonal
    zeroed, summed and scaled by ``1 / (B_im · B_s)``."""
    if im.shape[0] != s.shape[0]:
        raise ValueError(
            f"max_margin needs paired batches (diagonal positives); got "
            f"{im.shape[0]} vs {s.shape[0]} rows"
        )
    scores = cosine_sim(im, s)
    diag = torch.diagonal(scores)
    cost_s = (margin + scores - diag[:, None]).clamp_min(0)
    cost_im = (margin + scores - diag[None, :]).clamp_min(0)
    off = 1.0 - torch.eye(scores.shape[0], dtype=scores.dtype, device=scores.device)
    total = (cost_s * off).sum() + (cost_im * off).sum()
    return total / (im.shape[0] * s.shape[0])
