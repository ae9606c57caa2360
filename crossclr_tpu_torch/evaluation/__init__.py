"""Retrieval, the int8 index and the retrieval metrics."""

from .retrieval import (
    QuantizedCorpus,
    quantize_corpus,
    rank_of_ground_truth,
    retrieval_metrics,
    retrieve_topk,
    similarity_matrix,
)

__all__ = [
    "QuantizedCorpus",
    "quantize_corpus",
    "rank_of_ground_truth",
    "retrieval_metrics",
    "retrieve_topk",
    "similarity_matrix",
]
