"""CrossCLR with global negatives: each rank's anchors against the
candidates all-gathered from every rank of a ``torch.distributed`` group.

Counterpart of ``crossclr_tpu/parallel/global_loss.py``, with a process
group in place of the mesh axis: every rank calls these functions on its
own shard ``[b_loc, D]`` (all ranks the same ``b_loc``), and the rank's
rows sit at the global row offset ``rank · b_loc``.  With ``group=None``
and no initialised process group the world is this one rank and no
collective runs.

Gradients come from the row-block formulation.  Each rank computes the
loss rows of its OWN anchors against the gathered candidates; the
candidates come through :func:`all_gather`, whose backward is a
reduce-scatter (sum), so each rank receives every rank's contribution to
its shard's candidates, once.  The scalar is the all-reduced sum of the
ranks' row sums, but only the rank's local contribution is differentiated
(:func:`_global_sum`): an autograd all-reduce would carry the cotangent
back through every rank and scale the gradients by the world size.  So
each rank's feature gradients are exactly those of the global loss with
respect to its shard.  A tensor temperature's gradient on each rank is its
local contribution; the ranks' sum is the global one.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..losses.functional import (
    connectivity_keep_and_weights,
    l2_normalize,
    pooled_unit_inputs,
)

__all__ = [
    "all_gather",
    "global_cross_clr",
    "global_cross_clr_intra",
    "global_cross_clr_row_terms",
    "global_row_losses",
    "local_rows_cross_clr_intra",
    "pruned_rows_global",
]

# the online logsumexp's running max starts here: −inf − (−inf) in the
# rescale would be NaN; masked logits stay −inf, so their exp is exactly 0
_MAX_FLOOR = -1e30


def _distributed(group) -> bool:
    """Whether collectives run: a group was given or one is initialised."""
    return group is not None or (dist.is_available() and dist.is_initialized())


def _rank(group) -> int:
    return dist.get_rank(group) if _distributed(group) else 0


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


class _AllGather(torch.autograd.Function):
    """Rank-major concatenation of every rank's ``x``; the backward
    reduce-scatters (sums) the cotangent back to the shards."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        out = g.new_empty((g.shape[0] // dist.get_world_size(ctx.group),
                           *g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), op=dist.ReduceOp.SUM,
                                   group=ctx.group)
        return out, None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable all-gather along dim 0 (``x`` itself on one rank)."""
    if not _distributed(group):
        return x
    return _AllGather.apply(x, group)


def _gather_constant(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather of a value that carries no gradient."""
    x = x.detach()
    return _gather(x, group) if _distributed(group) else x


def _global_sum(local: torch.Tensor, group) -> torch.Tensor:
    """The value of the sum of ``local`` over the ranks, with the gradient
    of ``local`` alone (see the module doc)."""
    if not _distributed(group):
        return local
    total = local.detach().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return local + (total - local.detach())


def local_rows_cross_clr_intra(anchor_rows, anchor_all, other_all,
                               row_offset: int, *, temperature,
                               negative_weight: float) -> torch.Tensor:
    """Per-row CrossCLR-intra losses ``[b]`` of normalized anchors (rows
    ``row_offset ..`` of the batch) against the normalized ``[B, D]``
    candidates: the zeroed global self logit and ``B`` inter plus ``B``
    weighted intra columns, as on one device."""
    b, n = anchor_rows.shape[0], anchor_all.shape[0]
    scale = 1.0 / temperature
    inter = scale * (anchor_rows @ other_all.T)
    intra = (negative_weight * scale) * (anchor_rows @ anchor_all.T)
    rows = row_offset + torch.arange(b, device=anchor_rows.device)[:, None]
    on_diag = rows == torch.arange(n, device=anchor_rows.device)[None, :]
    intra = intra.masked_fill(on_diag, 0.0)  # zeroed, not dropped
    lse = torch.logsumexp(torch.cat([inter, intra], dim=1), dim=1)
    # the positive of global row r is column r of the inter block
    return lse - torch.gather(inter, 1, rows)[:, 0]


def _fused_rows_losses(v_loc, t_loc, v_all, t_all, offset: int, temperature,
                       negative_weight: float, precision):
    """Per-row losses through the rows kernels (:mod:`..ops.fused_global`):
    the lse over the gathered candidates minus the positive logit, which
    lives in the local shard."""
    from ..ops.fused_global import fused_lse_rows

    kw = dict(temperature=temperature, negative_weight=negative_weight,
              precision=precision)
    lse_v = fused_lse_rows(v_loc, v_all, t_all, offset, **kw)
    lse_t = fused_lse_rows(t_loc, t_all, v_all, offset, **kw)
    pos = (v_loc * t_loc).sum(dim=1, keepdim=True) / temperature
    return (lse_v - pos)[:, 0], (lse_t - pos)[:, 0]


def global_row_losses(v_loc, t_loc, group=None, *, temperature,
                      negative_weight: float, use_fused: bool = False,
                      precision: str | None = None):
    """``(loss_v_rows, loss_t_rows, n_global)`` of this rank's anchors
    against the gathered candidates of the CrossCLR-intra loss; the
    reduction over ranks is the caller's."""
    v = l2_normalize(v_loc.float(), dim=1)
    t = l2_normalize(t_loc.float(), dim=1)
    v_all, t_all = all_gather(v, group), all_gather(t, group)
    offset = _rank(group) * v.shape[0]
    if use_fused:
        loss_v, loss_t = _fused_rows_losses(v, t, v_all, t_all, offset,
                                            temperature, negative_weight,
                                            precision)
    else:
        kw = dict(temperature=temperature, negative_weight=negative_weight)
        loss_v = local_rows_cross_clr_intra(v, v_all, t_all, offset, **kw)
        loss_t = local_rows_cross_clr_intra(t, t_all, v_all, offset, **kw)
    return loss_v, loss_t, v_all.shape[0]


def pruned_rows_global(anchor_rows, other_all, anchor_all, keep_inter,
                       keep_intra, row_offset: int, *, temperature,
                       negative_weight: float,
                       candidate_chunk: int | None = None) -> torch.Tensor:
    """Per-row full-CrossCLR losses ``[b]`` of an anchor block at
    ``row_offset`` against the global candidates: inter negatives pruned by
    ``keep_inter`` (the positive always kept), intra negatives by
    ``keep_intra`` with the self column excluded; exclusions are −inf.

    ``candidate_chunk``: take the ``2B`` candidate columns in blocks of
    this many with an online logsumexp (a Python loop), so no
    ``[b, 2B]`` logits exist at once in the forward; None, or a chunk that
    does not divide ``B``, computes the block directly."""
    b = anchor_rows.shape[0]
    n = other_all.shape[0]
    dev = anchor_rows.device
    scale = 1.0 / temperature
    rows = row_offset + torch.arange(b, device=dev)

    def block_logits(o_blk, a_blk, ki_blk, ka_blk, cols):
        on_diag = rows[:, None] == cols[None, :]
        inter = scale * (anchor_rows @ o_blk.T)
        inter_m = inter.masked_fill(~(ki_blk[None, :] | on_diag), -math.inf)
        intra = (negative_weight * scale) * (anchor_rows @ a_blk.T)
        intra_m = intra.masked_fill(~(ka_blk[None, :] & ~on_diag), -math.inf)
        pos_blk = torch.where(on_diag, inter, 0.0).sum(dim=1)
        return inter_m, intra_m, pos_blk

    if candidate_chunk is None or n % candidate_chunk != 0:
        inter_m, intra_m, pos = block_logits(other_all, anchor_all, keep_inter,
                                             keep_intra, torch.arange(n, device=dev))
        return torch.logsumexp(torch.cat([inter_m, intra_m], dim=1), dim=1) - pos

    m = torch.full((b,), _MAX_FLOOR, device=dev, dtype=anchor_rows.dtype)
    l = torch.zeros_like(m)
    pos = torch.zeros_like(m)
    for c0 in range(0, n, candidate_chunk):
        blk = slice(c0, c0 + candidate_chunk)
        inter_m, intra_m, pos_blk = block_logits(
            other_all[blk], anchor_all[blk], keep_inter[blk], keep_intra[blk],
            torch.arange(c0, c0 + candidate_chunk, device=dev))
        blk_max = torch.maximum(inter_m.amax(dim=1), intra_m.amax(dim=1))
        m_new = torch.maximum(m, blk_max.clamp_min(_MAX_FLOOR))
        l = (l * torch.exp(m - m_new)
             + torch.exp(inter_m - m_new[:, None]).sum(dim=1)
             + torch.exp(intra_m - m_new[:, None]).sum(dim=1))
        m, pos = m_new, pos + pos_blk
    return m + torch.log(l) - pos


def global_cross_clr_row_terms(v_loc, t_loc, v_inputs_loc, t_inputs_loc,
                               group=None, *, temperature,
                               negative_weight: float,
                               weight_temperature: float, prune_percent: float,
                               weight_norm: str = "raw",
                               candidate_chunk: int | None = None,
                               use_fused: bool = False,
                               precision: str | None = None):
    """``(this rank's weighted full-CrossCLR row-loss sum, n_global)``.

    Connectivity, the pruning quantile and the positive weights are taken
    over the GLOBAL batch (the pooled unit inputs and then the scores are
    gathered), so the ranks' sums over ``2·n`` equal the one-device
    ``losses.cross_clr`` on the concatenated batch.  ``use_fused`` routes
    the rows through the pruned rows kernels (:mod:`..ops.fused_global`),
    else :func:`pruned_rows_global` with ``candidate_chunk``."""
    v = l2_normalize(v_loc.float(), dim=1)
    t = l2_normalize(t_loc.float(), dim=1)
    v_all, t_all = all_gather(v, group), all_gather(t, group)
    b_loc, n = v.shape[0], v_all.shape[0]
    offset = _rank(group) * b_loc

    def conn(x_loc):
        # the matrix-vector form of functional.connectivity_scores: the
        # local rows against the global sum, no [b_loc, n] block
        x_all = _gather_constant(x_loc, group)
        return (x_loc @ x_all.sum(dim=0) - (x_loc * x_loc).sum(dim=1)) / max(n - 1, 1)

    xv = pooled_unit_inputs(v_loc if v_inputs_loc is None else v_inputs_loc)
    xt = pooled_unit_inputs(t_loc if t_inputs_loc is None else t_inputs_loc)
    weights = dict(prune_percent=prune_percent,
                   weight_temperature=weight_temperature, weight_norm=weight_norm)
    keep_v, w_v = connectivity_keep_and_weights(
        _gather_constant(conn(xv), group), **weights)
    keep_t, w_t = connectivity_keep_and_weights(
        _gather_constant(conn(xt), group), **weights)
    local = slice(offset, offset + b_loc)

    if use_fused:
        from ..ops.fused_global import fused_lse_rows

        kw = dict(temperature=temperature, negative_weight=negative_weight,
                  precision=precision)
        lse_v = fused_lse_rows(v, v_all, t_all, offset, keep_inter=keep_t,
                               keep_intra=keep_v, **kw)[:, 0]
        lse_t = fused_lse_rows(t, t_all, v_all, offset, keep_inter=keep_v,
                               keep_intra=keep_t, **kw)[:, 0]
        pos = (v * t).sum(dim=1) / temperature
        loss_v, loss_t = lse_v - pos, lse_t - pos
    else:
        kw = dict(temperature=temperature, negative_weight=negative_weight,
                  candidate_chunk=candidate_chunk)
        loss_v = pruned_rows_global(v, t_all, v_all, keep_t, keep_v, offset, **kw)
        loss_t = pruned_rows_global(t, v_all, t_all, keep_v, keep_t, offset, **kw)
    return (w_v[local] * loss_v).sum() + (w_t[local] * loss_t).sum(), n


def global_cross_clr(video_features, text_features, video_inputs=None,
                     text_inputs=None, *, group=None, temperature=0.03,
                     negative_weight: float = 0.8,
                     weight_temperature: float = 0.0035,
                     prune_percent: float = 0.10, weight_norm: str = "raw",
                     candidate_chunk: int | None = None,
                     use_fused: bool = False,
                     precision: str | None = None) -> torch.Tensor:
    """Full CrossCLR (pruning and positive weights) over the GLOBAL batch:
    this rank's shards in, the global scalar out (the same value on every
    rank), equal within fp32 tolerance to ``losses.cross_clr`` on the
    concatenated batch; differentiable, each rank's gradients those of its
    shard."""
    if (video_inputs is None) != (text_inputs is None):
        raise ValueError("pass both input arrays or neither")
    total, n = global_cross_clr_row_terms(
        video_features, text_features, video_inputs, text_inputs, group,
        temperature=temperature, negative_weight=negative_weight,
        weight_temperature=weight_temperature, prune_percent=prune_percent,
        weight_norm=weight_norm, candidate_chunk=candidate_chunk,
        use_fused=use_fused, precision=precision,
    )
    return _global_sum(total, group) / (2 * n)


def global_cross_clr_intra(video_features, text_features, *, group=None,
                           temperature=0.03, negative_weight: float = 0.8,
                           use_fused: bool = False,
                           precision: str | None = None) -> torch.Tensor:
    """CrossCLR-onlyIntraModality over the GLOBAL batch: this rank's shards
    in, the global scalar out, equal within fp32 tolerance to the one-device
    loss on the concatenated batch.  ``use_fused`` routes each rank's row
    block through the rows kernels instead of materializing its
    ``[b_loc, 2B]`` candidate matrix."""
    loss_v, loss_t, n = global_row_losses(
        video_features, text_features, group, temperature=temperature,
        negative_weight=negative_weight, use_fused=use_fused,
        precision=precision,
    )
    return _global_sum(loss_v.sum() + loss_t.sum(), group) / (2 * n)
