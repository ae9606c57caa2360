"""Retrieval, the int8 index and the retrieval metrics."""

from .retrieval import (
    QuantizedCorpus,
    encode_corpus,
    gather_row_blocks,
    local_candidates,
    merge_candidates,
    pad_block,
    quantize_corpus,
    rank_of_ground_truth,
    retrieval_metrics,
    retrieve_topk,
    row_block,
    shard_corpus,
    sharded_retrieve_topk,
    similarity_matrix,
    topk,
)

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
