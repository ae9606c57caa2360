"""The CrossCLR-onlyIntraModality loss, a frozen copy of its semantics:
both embeddings L2-normalized (norm clamped at 1e-12); per video anchor
``i`` the row ``[ṽ_i·t̃_j/τ over j ‖ w·ṽ_i·ṽ_j/τ over j, the j = i logit
zeroed (not removed)]``, its logsumexp minus ``ṽ_i·t̃_i/τ``; the same per
text anchor; the loss is the mean of the two means.

:func:`loss_and_grads` takes it in blocks of anchor rows, so no ``[B,
2B]`` row block larger than ``block × 2B`` lives at once, and returns the
loss with its gradients in the raw embeddings.  ``rows`` (default all)
is the batch the mean runs over: the half-batch fault passes half."""

from __future__ import annotations

import torch


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)


def _direction(anchor, other, lo: int, hi: int, tau: float, w: float, mm):
    a = anchor[lo:hi]
    inter = mm(a, other.t()) / tau
    intra = w * (mm(a, anchor.t()) / tau)
    rows = torch.arange(lo, hi, device=a.device)
    intra = intra.index_put((rows - lo, rows), torch.zeros((), device=a.device))
    lse = torch.logsumexp(torch.cat([inter, intra], dim=1), dim=1)
    pos = inter[rows - lo, rows]
    return (lse - pos).sum()


def loss_and_grads(v_emb, t_emb, *, temperature: float, negative_weight: float,
                   mm=torch.matmul, block: int = 4096, rows: int | None = None):
    """``(loss, d_v, d_t)`` of the fp32 embeddings."""
    n = v_emb.shape[0] if rows is None else rows
    v_raw = v_emb[:n].detach().float().requires_grad_()
    t_raw = t_emb[:n].detach().float().requires_grad_()
    v_hat, t_hat = _normalize(v_raw), _normalize(t_raw)
    v = v_hat.detach().requires_grad_()
    t = t_hat.detach().requires_grad_()
    total = torch.zeros((), dtype=torch.float64, device=v.device)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        part = (_direction(v, t, lo, hi, temperature, negative_weight, mm)
                + _direction(t, v, lo, hi, temperature, negative_weight, mm)) / (2 * n)
        part.backward()
        total += part.detach().double()
    torch.autograd.backward([v_hat, t_hat], [v.grad, t.grad])
    d_v = torch.zeros_like(v_emb, dtype=torch.float32)
    d_t = torch.zeros_like(t_emb, dtype=torch.float32)
    d_v[:n], d_t[:n] = v_raw.grad, t_raw.grad
    return float(total), d_v, d_t
