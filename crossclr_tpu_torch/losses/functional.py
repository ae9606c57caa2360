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
through it.

:func:`cross_clr` is the full CrossCLR loss (the paper's: influential
samples pruned from the negative sets, connectivity-weighted positives).
Its connectivity scores come from FIXED input statistics: the pooled
inputs are detached, so neither the keep masks nor the positive weights
carry a gradient.  Pruned and self columns are excluded outright (−inf),
not zeroed.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "connectivity_keep_and_weights",
    "connectivity_scores",
    "cosine_sim",
    "cross_clr",
    "cross_clr_intra",
    "cross_clr_intra_per_row",
    "info_nce",
    "l2_normalize",
    "masked_mean_pool",
    "max_margin",
    "normalized_connectivity",
    "pooled_unit_inputs",
    "weight_effective_fraction",
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


def pooled_unit_inputs(input_features: torch.Tensor) -> torch.Tensor:
    """Detached, mean-pooled (``[B, S, D]`` over S), L2-normalized fp32
    connectivity inputs ``[B, D]``: the scores come from fixed input
    statistics, so no gradient reaches them."""
    x = input_features.float()
    if x.dim() == 3:
        x = x.mean(dim=1)
    return l2_normalize(x, dim=1).detach()


def masked_mean_pool(x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean-pool ``[B, S, D]`` sequences to fp32 ``[B, D]`` over the valid
    steps of a ``[B, S]`` key-padding mask (1 = valid; all steps without
    one).  ``[B, D]`` inputs pass through unchanged."""
    if x.dim() != 3:
        return x
    if mask is None:
        return x.float().mean(dim=1)
    w = mask.float()[:, :, None]
    return (x.float() * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)


def connectivity_scores(input_features: torch.Tensor) -> torch.Tensor:
    """Per-sample connectivity ``[B]``: the mean cosine of sample i to the
    other samples of its modality, ``(x_i · Σ_j x_j − ‖x_i‖²) / (B − 1)``
    on :func:`pooled_unit_inputs` (one matrix-vector product, O(B·D))."""
    x = pooled_unit_inputs(input_features)
    off_sum = x @ x.sum(dim=0) - (x * x).sum(dim=1)
    return off_sum / max(x.shape[0] - 1, 1)


def normalized_connectivity(conn: torch.Tensor, weight_norm: str) -> torch.Tensor:
    """Connectivity as the positive-weight softmax sees it: ``"raw"`` (the
    paper's formula) or ``"standardized"`` (``(c − mean) / max(std,
    1e-6)`` with the population std; pair it with τ_w ≈ 1)."""
    if weight_norm == "raw":
        return conn
    if weight_norm == "standardized":
        sd = torch.std(conn, correction=0)
        return (conn - conn.mean()) / sd.clamp_min(1e-6)
    raise ValueError(
        f"unknown weight_norm {weight_norm!r}: expected 'raw' or 'standardized'"
    )


def weight_effective_fraction(weights: torch.Tensor) -> torch.Tensor:
    """``(Σw)² / (N·Σw²)`` in (0, 1]: 1 for flat weights, 1/N for one-hot."""
    return weights.sum().square() / (weights.shape[0] * weights.square().sum())


def connectivity_keep_and_weights(conn: torch.Tensor, *, prune_percent: float,
                                  weight_temperature: float,
                                  weight_norm: str = "raw"):
    """Keep mask ``[B]`` (False above the ``1 − prune_percent`` quantile of
    ``conn``, linear interpolation; ties with the quantile are kept) and
    mean-one positive weights ``softmax(norm(conn) / τ_w) · B``."""
    n = conn.shape[0]
    if prune_percent > 0.0:
        keep = conn <= torch.quantile(conn, 1.0 - prune_percent)
    else:
        keep = torch.ones(n, dtype=torch.bool, device=conn.device)
    scores = normalized_connectivity(conn, weight_norm)
    weights = torch.softmax(scores / weight_temperature, dim=0) * n
    return keep, weights


def _pruned_direction_rows(inter_sim, anchor_sim, keep_inter_cols,
                           keep_intra_cols, temperature, negative_weight):
    """Per-row full-CrossCLR loss of one direction: inter columns pruned by
    the other modality's keep mask (the positive diagonal always kept),
    intra columns by the anchor modality's, the self column dropped; each
    exclusion is −inf."""
    eye = torch.eye(inter_sim.shape[0], dtype=torch.bool, device=inter_sim.device)
    inter = inter_sim / temperature
    inter_masked = inter.masked_fill(~(keep_inter_cols[None, :] | eye), -math.inf)
    intra = negative_weight * (anchor_sim / temperature)
    intra_masked = intra.masked_fill(~(keep_intra_cols[None, :] & ~eye), -math.inf)
    lse = torch.logsumexp(torch.cat([inter_masked, intra_masked], dim=1), dim=1)
    return lse - torch.diagonal(inter)


def cross_clr(video_features, text_features, video_inputs=None, text_inputs=None,
              *, temperature=0.03, negative_weight: float = 0.8,
              weight_temperature: float = 0.0035, prune_percent: float = 0.10,
              weight_norm: str = "raw") -> torch.Tensor:
    """Full CrossCLR: inter+intra negatives with influential-sample pruning
    and connectivity-weighted positives.  ``video_inputs`` /
    ``text_inputs`` (raw input features, ``[B, D]`` or ``[B, S, D]``) score
    the connectivity; they default to the embeddings.  Returns
    ``(mean(w_v · L_v) + mean(w_t · L_t)) / 2``."""
    if video_inputs is None:
        video_inputs = video_features
    if text_inputs is None:
        text_inputs = text_features
    v = l2_normalize(video_features, dim=1)
    t = l2_normalize(text_features, dim=1)
    sim_vt = v @ t.T
    keep_v, w_v = connectivity_keep_and_weights(
        connectivity_scores(video_inputs), prune_percent=prune_percent,
        weight_temperature=weight_temperature, weight_norm=weight_norm,
    )
    keep_t, w_t = connectivity_keep_and_weights(
        connectivity_scores(text_inputs), prune_percent=prune_percent,
        weight_temperature=weight_temperature, weight_norm=weight_norm,
    )
    # video anchors: inter columns are text samples (pruned by keep_t),
    # intra columns video samples (keep_v); the text direction mirrors it
    loss_v = _pruned_direction_rows(sim_vt, v @ v.T, keep_t, keep_v,
                                    temperature, negative_weight)
    loss_t = _pruned_direction_rows(sim_vt.T, t @ t.T, keep_v, keep_t,
                                    temperature, negative_weight)
    return ((w_v * loss_v).mean() + (w_t * loss_t).mean()) / 2


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
