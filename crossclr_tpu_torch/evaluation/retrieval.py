"""Cosine top-k retrieval.

Counterpart of the dense branch of ``crossclr_tpu/evaluation/retrieval.py``.
Both products run in fp32 with TF32 off (PyTorch's default), as the JAX
package scores at HIGHEST precision.
"""

from __future__ import annotations

import torch

from ..losses.functional import l2_normalize

__all__ = ["retrieve_topk", "similarity_matrix"]


def similarity_matrix(video_emb: torch.Tensor, text_emb: torch.Tensor) -> torch.Tensor:
    """Cosine similarity ``[Nv, Nt]`` between normalized embeddings."""
    v = l2_normalize(video_emb.float(), dim=1)
    t = l2_normalize(text_emb.float(), dim=1)
    return torch.matmul(v, t.T)


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
