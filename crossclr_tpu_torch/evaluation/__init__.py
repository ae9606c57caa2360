"""Retrieval."""

from .retrieval import retrieve_topk, similarity_matrix

__all__ = ["retrieve_topk", "similarity_matrix"]
