"""Retrieval and its metrics."""

from .retrieval import (
    rank_of_ground_truth,
    retrieval_metrics,
    retrieve_topk,
    similarity_matrix,
)

__all__ = [
    "rank_of_ground_truth",
    "retrieval_metrics",
    "retrieve_topk",
    "similarity_matrix",
]
