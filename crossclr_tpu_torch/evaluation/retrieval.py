"""Cosine top-k retrieval and the video↔text retrieval metrics.

Counterpart of the dense branches of ``crossclr_tpu/evaluation/retrieval.py``:
R@K, median rank (MdR) and mean rank (MnR) in both directions, and top-k
search.  Every product runs in fp32 with TF32 off (PyTorch's default), as
the JAX package scores at HIGHEST precision.
"""

from __future__ import annotations

import torch

from ..losses.functional import l2_normalize

__all__ = [
    "rank_of_ground_truth",
    "retrieval_metrics",
    "retrieve_topk",
    "similarity_matrix",
]

# past this many rows the [N, N] similarity is not materialized: ranks are
# computed in query chunks (the JAX package's threshold)
_DENSE_SIM_MAX_ROWS = 16384


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
    out = {f"R@{k}": (r < k).float().mean() * 100 for k in ks}
    # the median of an even count averages the two middle ranks, as
    # jnp.median does (torch.median would return the lower one)
    s = torch.sort(r).values
    n = s.shape[0]
    out["MdR"] = (s[(n - 1) // 2] + s[n // 2]) / 2 + 1  # 1-based
    out["MnR"] = r.mean() + 1
    return out


def retrieval_metrics(video_emb: torch.Tensor, text_emb: torch.Tensor,
                      ks: tuple[int, ...] = (1, 5, 10),
                      query_chunk: int | None = None) -> dict[str, float]:
    """Bidirectional retrieval metrics as host floats
    (``v2t/R@1`` … ``t2v/MnR``) for aligned ``[N, D]`` embeddings (row i of
    each is a ground-truth pair).  Past 16384 rows, or with
    ``query_chunk``, ranks are computed in query chunks; both paths give
    the same ranks."""
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


def retrieve_topk(query_emb: torch.Tensor, corpus_emb: torch.Tensor, *,
                  k: int = 10, query_chunk: int = 1024):
    """Top-k corpus rows per query by cosine similarity, in blocks of
    ``query_chunk`` queries so only ``[chunk, Nc]`` scores live at a time.
    Returns ``(scores [Nq, k] fp32, indices [Nq, k] int64)``, scores
    descending."""
    q = l2_normalize(query_emb.float(), dim=1)
    c = l2_normalize(corpus_emb.float(), dim=1)
    k = min(k, c.shape[0])  # top-k cannot exceed the corpus
    scores, idx = [], []
    for start in range(0, q.shape[0], query_chunk):
        s, i = torch.topk(torch.matmul(q[start:start + query_chunk], c.T), k, dim=1)
        scores.append(s)
        idx.append(i)
    if not scores:
        return (torch.zeros((0, k), device=q.device),
                torch.zeros((0, k), dtype=torch.int64, device=q.device))
    return torch.cat(scores), torch.cat(idx)
