"""Cosine top-k retrieval, the int8 index and the video↔text retrieval
metrics.

Counterpart of the one-device branches of
``crossclr_tpu/evaluation/retrieval.py``: R@K, median rank (MdR) and mean
rank (MnR) in both directions, and top-k search over a dense or an int8
(:class:`QuantizedCorpus`) index.  Every fp32 product runs with TF32 off
(PyTorch's default), as the JAX package scores at HIGHEST precision; the
int8 product accumulates exactly in int32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.quantize import symmetric_int8_rows
from ..losses.functional import l2_normalize

__all__ = [
    "QuantizedCorpus",
    "quantize_corpus",
    "rank_of_ground_truth",
    "retrieval_metrics",
    "retrieve_topk",
    "similarity_matrix",
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
    rules and the result cut back to ``[M, N]``."""
    m, d = q_values.shape
    n = c_values.shape[0]
    mult = _INT_MM_MULTIPLE
    d_pad = -(-d // mult) * mult
    n_pad = -(-n // mult) * mult
    a = _pad_to(q_values, max(m, _INT_MM_MIN_ROWS), d_pad)
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


def retrieve_topk(query_emb: torch.Tensor, corpus_emb, *, k: int = 10,
                  query_chunk: int = 1024):
    """Top-k corpus rows per query by cosine similarity, in blocks of
    ``query_chunk`` queries so only ``[chunk, Nc]`` scores live at a time.
    ``corpus_emb`` is a dense ``[Nc, D]`` tensor (an fp32 product) or a
    :class:`QuantizedCorpus` (the queries quantized on their device, the
    product int8 x int8 -> int32).  Returns ``(scores [Nq, k] fp32,
    indices [Nq, k] int64)``, scores descending."""
    if isinstance(corpus_emb, QuantizedCorpus):
        q, q_scales = _quantize_queries(query_emb)
        n_rows = corpus_emb.values.shape[0]

        def sim(rows: slice) -> torch.Tensor:
            return _quantized_sim(q[rows], q_scales[rows], corpus_emb)
    else:
        q = l2_normalize(query_emb.float(), dim=1)
        c = l2_normalize(corpus_emb.float(), dim=1)
        n_rows = c.shape[0]

        def sim(rows: slice) -> torch.Tensor:
            return torch.matmul(q[rows], c.T)
    k = min(k, n_rows)  # top-k cannot exceed the corpus
    scores, idx = [], []
    for start in range(0, q.shape[0], query_chunk):
        s, i = torch.topk(sim(slice(start, start + query_chunk)), k, dim=1)
        scores.append(s)
        idx.append(i)
    if not scores:
        return (torch.zeros((0, k), device=q.device),
                torch.zeros((0, k), dtype=torch.int64, device=q.device))
    return torch.cat(scores), torch.cat(idx)
