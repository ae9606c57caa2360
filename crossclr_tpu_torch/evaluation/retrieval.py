"""Cosine top-k retrieval, the int8 index and the video↔text retrieval
metrics.

Counterpart of ``crossclr_tpu/evaluation/retrieval.py``: R@K, median rank
(MdR) and mean rank (MnR) in both directions, and top-k search over a
dense or an int8 (:class:`QuantizedCorpus`) index.  Every fp32 product
runs with TF32 off (PyTorch's default), as the JAX package scores at
HIGHEST precision; the int8 product accumulates exactly in int32.  Top-k
keeps ``lax.top_k``'s order (:func:`topk`): scores descending, exact ties
to the lowest index.

The row-sharded index spans the ranks of a ``torch.distributed`` group in
place of the JAX package's mesh axis: rank r keeps rows ``[r·per,
(r+1)·per)`` of the corpus, ``per = ceil(N / P)``, zero-padded to ``per``
(:func:`pad_block`, :func:`shard_corpus`).  :func:`sharded_retrieve_topk`
merges O(k) winners a rank; ``retrieval_metrics(group=)`` sums partial rank counts.
On a gloo group, CUDA tensors are staged through host memory.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.quantize import symmetric_int8_rows
from ..losses.functional import l2_normalize

__all__ = [
    "QuantizedCorpus",
    "encode_corpus",
    "gather_row_blocks",
    "local_candidates",
    "merge_candidates",
    "pad_block",
    "quantize_corpus",
    "rank_of_ground_truth",
    "retrieval_metrics",
    "retrieve_topk",
    "row_block",
    "shard_corpus",
    "sharded_retrieve_topk",
    "similarity_matrix",
    "topk",
]

# past this many rows the [N, N] similarity is not materialized: ranks are
# computed in query chunks (the JAX package's threshold)
_DENSE_SIM_MAX_ROWS = 16384
# torch._int_mm's shape rules: more than 16 rows; depth and columns
# multiples of 8 (both operands are zero-padded to them; a zero row or
# column adds 0 to the exact int32 sums)
_INT_MM_MIN_ROWS = 17
_INT_MM_MULTIPLE = 8


class QuantizedCorpus(NamedTuple):
    """An int8 retrieval index, 4x smaller than fp32: ``values[i] *
    scales[i]`` reconstructs the L2-normalized corpus row i (symmetric
    per-row quantization, no zero points).  ``values`` int8 ``[N, D]``,
    ``scales`` fp32 ``[N]``, on one device."""

    values: torch.Tensor
    scales: torch.Tensor

    def to(self, device) -> "QuantizedCorpus":
        return QuantizedCorpus(self.values.to(device), self.scales.to(device))


def quantize_corpus(corpus_emb) -> QuantizedCorpus:
    """Quantize a corpus to int8 on the HOST: rows L2-normalized, then
    ``scale = max|row| / 127`` and ``values = round(row / scale)``
    (``data.quantize.symmetric_int8_rows``).  The worst per-element error
    is ``scale / 2 <= 1/254`` of a unit vector, so cosine scores move by
    about 1e-2 at most.  Returns CPU tensors."""
    if isinstance(corpus_emb, torch.Tensor):
        corpus_emb = corpus_emb.detach().float().cpu().numpy()
    arr = np.asarray(corpus_emb, np.float32)
    norms = np.linalg.norm(arr, axis=1, keepdims=True)
    values, scales = symmetric_int8_rows(arr / np.maximum(norms, 1e-12))
    return QuantizedCorpus(torch.from_numpy(values), torch.from_numpy(scales))


def _quantize_queries(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of the normalized queries on
    their device: ``symmetric_int8_rows``' arithmetic and guards (scale 1
    for an all-zero row, floored at 1e-12) in torch."""
    qn = l2_normalize(q.float(), dim=1)
    amax = qn.abs().amax(dim=1)
    scale = torch.where(amax > 0, torch.clamp_min(amax / 127.0, 1e-12),
                        torch.ones_like(amax))
    return torch.round(qn / scale[:, None]).to(torch.int8), scale


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if x.shape == (rows, cols):
        return x
    out = x.new_zeros((rows, cols))
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _int8_dot(q_values: torch.Tensor, c_values: torch.Tensor) -> torch.Tensor:
    """``q_values @ c_values.T`` as exact int32 sums (int8 ``[M, D]`` x int8
    ``[N, D]`` -> int32 ``[M, N]``; D·127² < 2³¹ for any embedding width)
    through ``torch._int_mm``, both operands zero-padded to its shape
    rules and the result cut back to ``[M, N]``.  The queries always get
    17 zero rows below them, so nothing branches on M (an exported
    program keeps it symbolic)."""
    m, d = q_values.shape
    n = c_values.shape[0]
    mult = _INT_MM_MULTIPLE
    d_pad = -(-d // mult) * mult
    n_pad = -(-n // mult) * mult
    a = torch.nn.functional.pad(q_values, (0, d_pad - d, 0, _INT_MM_MIN_ROWS))
    b = _pad_to(c_values, n_pad, d_pad)
    return torch._int_mm(a, b.t())[:m, :n]


def _quantized_sim(q_values: torch.Tensor, q_scales: torch.Tensor,
                   corpus: QuantizedCorpus) -> torch.Tensor:
    """The int32 product rescaled to cosine similarity, in the JAX
    package's order: ``acc * q_scale[:, None] * c_scale[None, :]``."""
    acc = _int8_dot(q_values, corpus.values)
    return acc.float() * q_scales[:, None] * corpus.scales[None, :]


def similarity_matrix(video_emb: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
    """Cosine similarity ``[Nv, Nt]`` between normalized embeddings."""
    v = l2_normalize(video_emb.float(), dim=1)
    t = l2_normalize(text_emb.float(), dim=1)
    return torch.matmul(v, t.T)


def rank_of_ground_truth(sim: torch.Tensor) -> torch.Tensor:
    """0-based rank of the diagonal (ground-truth pair) per row:
    ``#{j : sim[i, j] > sim[i, i]}`` — ties resolve in favour of the
    ground truth."""
    return (sim > torch.diagonal(sim)[:, None]).sum(dim=1)


def _ranks_chunked(q: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
    """Ground-truth ranks (query i ↔ corpus row i) with at most
    ``[chunk, N]`` similarities alive; the truth is read from the same
    product the comparisons see."""
    out = []
    for start in range(0, q.shape[0], chunk):
        sim = torch.matmul(q[start:start + chunk], c.T)
        rows = torch.arange(sim.shape[0], device=sim.device)
        truth = sim[rows, rows + start][:, None]
        out.append((sim > truth).sum(dim=1))
    return torch.cat(out)


def _metrics_from_ranks(ranks: torch.Tensor, ks) -> dict:
    r = ranks.float()
    n = r.shape[0]
    # a mean as XLA takes it: the exact sum times fp32(1/n), so the
    # metrics equal the JAX package's to the last bit
    inv_n = torch.tensor(1.0 / n, dtype=torch.float32, device=r.device)
    out = {f"R@{k}": (r < k).float().sum() * inv_n * 100 for k in ks}
    # the median of an even count averages the two middle ranks, as
    # jnp.median does (torch.median would return the lower one)
    s = torch.sort(r).values
    out["MdR"] = (s[(n - 1) // 2] + s[n // 2]) / 2 + 1  # 1-based
    out["MnR"] = r.sum() * inv_n + 1
    return out


def retrieval_metrics(video_emb: torch.Tensor, text_emb: torch.Tensor,
                      ks: tuple[int, ...] = (1, 5, 10),
                      query_chunk: int | None = None,
                      group=None) -> dict[str, float]:
    """Bidirectional retrieval metrics as host floats
    (``v2t/R@1`` … ``t2v/MnR``) for aligned ``[N, D]`` embeddings (row i of
    each is a ground-truth pair).  Past 16384 rows, or with
    ``query_chunk``, ranks are computed in query chunks; both paths give
    the same ranks.

    ``group``: a ``torch.distributed`` group whose ranks each pass their
    :func:`row_block` of both modalities' rows.  Each direction's queries
    are gathered and its corpus side stays sharded: a rank holds a
    ``[chunk, N/P]`` score block, the ground truth is read from its
    owner's block and summed, and the partial counts are summed (the JAX
    package's ``retrieval_metrics(mesh=)``; chunks of 4096 by default).
    Every rank returns the metrics."""
    if group is not None:
        return _sharded_metrics(video_emb, text_emb, ks,
                                query_chunk or 4096, group)
    n = video_emb.shape[0]
    if query_chunk is None and n > _DENSE_SIM_MAX_ROWS:
        query_chunk = 4096
    v = l2_normalize(video_emb.float(), dim=1)
    t = l2_normalize(text_emb.float(), dim=1)
    out = {}
    if query_chunk is None:
        sim = torch.matmul(v, t.T)
        pairs = (("v2t", rank_of_ground_truth(sim)),
                 ("t2v", rank_of_ground_truth(sim.T)))
    else:
        chunk = min(query_chunk, n)
        pairs = (("v2t", _ranks_chunked(v, t, chunk)),
                 ("t2v", _ranks_chunked(t, v, chunk)))
    for tag, ranks in pairs:
        out.update({f"{tag}/{k}": x for k, x in _metrics_from_ranks(ranks, ks).items()})
    return {k: float(x) for k, x in out.items()}


def topk(scores: torch.Tensor, k: int, index: torch.Tensor | None = None):
    """The ``k`` largest fp32 ``scores`` along the last dimension in
    ``lax.top_k``'s order: descending, exact ties to the lowest position
    (``torch.topk`` leaves the order of ties unspecified).  ``index``: each
    column's index, returned in place of its position (broadcast against
    ``scores``); it must rise with the position among equal scores, as a
    block's global rows do, and the merge's candidates (each rank's in
    this order, rank by rank).

    One ``torch.topk`` finds the k-th largest score ``t``; a second ranks
    int32 words, ``2³¹ − 1`` above ``t``, ``−position`` at ``t`` and
    ``−2³¹`` below, so a score tied with ``t`` outside the first k still
    wins on position; the k picked are put in order by two sorts of
    ``[.., k]``.  The word is the only temporary as large as ``scores``,
    with a one-byte mask.  Returns ``(scores fp32, indices int64)``."""
    s = scores.float()
    t = torch.topk(s, k, dim=-1, sorted=False).values.amin(dim=-1, keepdim=True)
    at = s == t
    pos = torch.arange(s.shape[-1], dtype=torch.int32, device=s.device)
    word = torch.where(at, -pos, torch.iinfo(torch.int32).min)
    del at
    above = s > t
    word.masked_fill_(above, torch.iinfo(torch.int32).max)
    del above
    picked = torch.topk(word, k, dim=-1, sorted=False).indices
    del word
    picked = picked.sort(dim=-1).values  # ties in position order ...
    vals = s.gather(-1, picked)
    order = vals.sort(dim=-1, descending=True, stable=True).indices  # ... kept
    picked = picked.gather(-1, order)
    return (vals.gather(-1, order),
            picked if index is None else index.expand_as(s).gather(-1, picked))


def _similarity(query_emb: torch.Tensor, corpus_emb):
    """``(q, sim)``: the queries as the index scores them and ``sim(rows)``,
    the cosine scores of query rows ``rows`` against the whole index
    (fp32 product, or int8 x int8 -> int32 for a :class:`QuantizedCorpus`)."""
    if isinstance(corpus_emb, QuantizedCorpus):
        q, q_scales = _quantize_queries(query_emb)
        return q, lambda rows: _quantized_sim(q[rows], q_scales[rows], corpus_emb)
    q = l2_normalize(query_emb.float(), dim=1)
    c = l2_normalize(corpus_emb.float(), dim=1)
    return q, lambda rows: torch.matmul(q[rows], c.T)


def _corpus_rows(corpus) -> int:
    c = corpus.values if isinstance(corpus, QuantizedCorpus) else corpus
    return int(c.shape[0])


def retrieve_topk(query_emb: torch.Tensor, corpus_emb, *, k: int = 10,
                  query_chunk: int = 1024):
    """Top-k corpus rows per query by cosine similarity, in blocks of
    ``query_chunk`` queries so only ``[chunk, Nc]`` scores live at a time.
    ``corpus_emb`` is a dense ``[Nc, D]`` tensor (an fp32 product) or a
    :class:`QuantizedCorpus` (the queries quantized on their device, the
    product int8 x int8 -> int32).  Returns ``(scores [Nq, k] fp32,
    indices [Nq, k] int64)``, scores descending, exact ties to the lowest
    corpus index (:func:`topk`)."""
    q, sim = _similarity(query_emb, corpus_emb)
    k = min(k, _corpus_rows(corpus_emb))  # top-k cannot exceed the corpus
    scores, idx = [], []
    for start in range(0, q.shape[0], query_chunk):
        s, i = topk(sim(slice(start, start + query_chunk)), k)
        scores.append(s)
        idx.append(i)
    if not scores:
        return (torch.zeros((0, k), device=q.device),
                torch.zeros((0, k), dtype=torch.int64, device=q.device))
    return torch.cat(scores), torch.cat(idx)


# ---------------------------------------------------------------------------
# the row-sharded index over a torch.distributed group
# ---------------------------------------------------------------------------


def row_block(n: int, rank: int, world: int) -> tuple[int, int]:
    """Rows ``[lo, hi)`` of ``n`` that ``rank`` of ``world`` holds: blocks
    of ``ceil(n / world)`` in rank order (the last ones short or empty),
    the JAX package's ``shard_corpus`` layout."""
    per = -(-n // world)
    return min(n, rank * per), min(n, (rank + 1) * per)


def _rank_world(group) -> tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` crosses ``group`` through host memory: a CUDA tensor
    on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` stacked ``[P, *t.shape]`` in rank order."""
    src = (t.cpu() if _staged(t, group) else t).contiguous()
    world = dist.get_world_size(group)
    out = src.new_empty((world * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.view(world, *src.shape).to(t.device)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t``."""
    src = t.cpu() if _staged(t, group) else t.clone()
    dist.all_reduce(src, group=group)
    return src.to(t.device)


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    out = x.new_zeros((rows, *x.shape[1:]))
    out[:x.shape[0]] = x
    return out


def pad_block(local, n: int, group=None):
    """This rank's :func:`row_block` of an ``n``-row index (a tensor, or a
    :class:`QuantizedCorpus`) zero-padded to ``ceil(n / P)`` rows, the
    block shape every rank of ``group`` holds; a padded int8 row has value
    0 and scale 0.  ``group``: default the default group."""
    per = -(-n // dist.get_world_size(group))
    if isinstance(local, QuantizedCorpus):
        return QuantizedCorpus(_pad_rows(local.values, per), _pad_rows(local.scales, per))
    return _pad_rows(local, per)


def gather_row_blocks(x_loc: torch.Tensor, n: int, group) -> torch.Tensor:
    """Every rank's :func:`row_block` of ``n`` rows, joined in row order on
    every rank: each block padded (:func:`pad_block`), all-gathered and
    cut to ``n`` (only the last blocks are short, so the real rows come
    first)."""
    world = dist.get_world_size(group)
    return _all_gather(pad_block(x_loc, n, group), group).reshape(
        world * -(-n // world), -1)[:n]


def shard_corpus(corpus_emb, group=None):
    """This rank's :func:`pad_block` of a whole corpus (``[N, D]`` array or
    tensor, or a :class:`QuantizedCorpus`), on the corpus' device (the CPU
    for a host array).  ``group``: default the default group."""
    rank, world = _rank_world(group)
    n = _corpus_rows(corpus_emb)
    rows = slice(*row_block(n, rank, world))

    def cut(x):
        return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x)))[rows]

    if isinstance(corpus_emb, QuantizedCorpus):
        return pad_block(QuantizedCorpus(*map(cut, corpus_emb)), n, group)
    return pad_block(cut(corpus_emb), n, group)


def local_candidates(query_emb: torch.Tensor, corpus_emb, *, k: int,
                     group=None, n_real: int | None = None,
                     query_chunk: int = 1024):
    """This rank's half of :func:`sharded_retrieve_topk`, with no
    collective: the queries scored against this rank's :func:`pad_block`,
    padded rows (global index ``>= n_real``, default every row) masked to
    −inf, and the local top ``min(k, rows_per)`` kept with their global
    indices.  ``k``: already clamped to ``n_real``.  Returns ``(scores
    [Nq, k_loc], global indices [Nq, k_loc])`` for
    :func:`merge_candidates`."""
    rank, world = _rank_world(group)
    rows_per = _corpus_rows(corpus_emb)
    n_real = rows_per * world if n_real is None else int(n_real)
    q, sim = _similarity(query_emb, corpus_emb)
    gidx = rank * rows_per + torch.arange(rows_per, device=q.device)
    real = gidx < n_real
    k_loc = min(k, rows_per)
    scores, idx = [], []
    for start in range(0, max(q.shape[0], 1), query_chunk):
        block = torch.where(real, sim(slice(start, start + query_chunk)), float("-inf"))
        s, i = topk(block, k_loc, gidx)
        scores.append(s)
        idx.append(i)
    return torch.cat(scores), torch.cat(idx)


def merge_candidates(scores: torch.Tensor, gidx: torch.Tensor, *, k: int, group=None):
    """Every rank's :func:`local_candidates` all-gathered (only these O(k)
    winners a query cross ``group``) and re-ranked by :func:`topk`, so
    exact ties resolve to the lowest global index.  Every rank returns
    ``(scores [Nq, k], indices [Nq, k])``."""
    nq, k_loc = scores.shape
    world = dist.get_world_size(group)
    s_all = _all_gather(scores, group).movedim(0, 1).reshape(nq, world * k_loc)
    g_all = _all_gather(gidx, group).movedim(0, 1).reshape(nq, world * k_loc)
    return topk(s_all, k, g_all)


def sharded_retrieve_topk(query_emb: torch.Tensor, corpus_emb, *, k: int = 10,
                          group=None, n_real: int | None = None,
                          query_chunk: int = 1024):
    """:func:`retrieve_topk` over an index row-sharded across ``group``
    (default the default group), from this rank's :func:`shard_corpus`
    block; every rank passes the same queries.  Each rank keeps its local
    top ``min(k, rows_per)`` (:func:`local_candidates`) and the ``P·k_loc``
    candidates are merged (:func:`merge_candidates`).  No rank's top-k can
    hold more than ``min(k, rows_per)`` of the global top-k, so the merge
    loses nothing.  Every rank returns ``(scores [Nq, k], indices [Nq,
    k])``."""
    rows = _corpus_rows(corpus_emb) * dist.get_world_size(group)
    k = min(k, rows if n_real is None else int(n_real))
    cands = local_candidates(query_emb, corpus_emb, k=k, group=group,
                             n_real=n_real, query_chunk=query_chunk)
    return merge_candidates(*cands, k=k, group=group)


def _sharded_metrics(video_loc, text_loc, ks, query_chunk: int, group) -> dict:
    """:func:`retrieval_metrics` over ``group``, each rank holding its
    :func:`row_block` of both modalities (the JAX package's
    ``_sharded_ranks_fn``, rank for rank)."""
    rank, world = _rank_world(group)
    dev = video_loc.device
    counts = _all_gather(torch.tensor([video_loc.shape[0]], device=dev), group)
    counts = [int(c) for c in counts.reshape(-1)]
    n = sum(counts)
    if counts != [hi - lo for lo, hi in (row_block(n, r, world) for r in range(world))]:
        raise ValueError(f"ranks hold {counts} rows: not the row blocks of {n}")
    per = -(-n // world)
    gidx = rank * per + torch.arange(per, device=dev)
    chunk = min(query_chunk, n)
    out = {}
    for tag, q_loc, c_loc in (("v2t", video_loc, text_loc),
                              ("t2v", text_loc, video_loc)):
        q = gather_row_blocks(l2_normalize(q_loc.float(), dim=1), n, group)
        c = pad_block(l2_normalize(c_loc.float(), dim=1), n, group)
        partial = []
        for start in range(0, n, chunk):
            sim = torch.matmul(q[start:start + chunk], c.T)
            qi = torch.arange(start, start + sim.shape[0], device=dev)
            self_col = gidx[None, :] == qi[:, None]
            # the truth is the very product the comparisons see, read from
            # its owner's block (the other ranks add zeros)
            truth = _all_reduce(torch.where(self_col, sim, 0.0).sum(dim=1), group)
            valid = (gidx < n)[None, :] & ~self_col
            partial.append(((sim > truth[:, None]) & valid).sum(dim=1))
        ranks = _all_reduce(torch.cat(partial), group)
        out.update({f"{tag}/{k}": x for k, x in _metrics_from_ranks(ranks, ks).items()})
    return {k: float(x) for k, x in out.items()}


def encode_corpus(encode_fn, batches, *, side: str = "video") -> torch.Tensor:
    """One modality's embeddings of every batch, concatenated.
    ``encode_fn(batch) -> (video_emb, text_emb)`` (e.g. ``Trainer.encode``
    with its state bound); ``side`` picks the modality."""
    if side not in ("video", "text"):
        raise ValueError(f"side must be 'video' or 'text', got {side!r}")
    out = [encode_fn(batch)[0 if side == "video" else 1] for batch in batches]
    if not out:
        raise ValueError("encode_corpus received no batches")
    return torch.cat(out)
