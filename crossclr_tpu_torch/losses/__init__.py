"""Loss math and criterion classes."""

from .criterion import CrossCLR, CrossCLR_onlyIntraModality, InfoNCE, MaxMarginCoot
from .functional import (
    connectivity_keep_and_weights,
    connectivity_scores,
    cosine_sim,
    cross_clr,
    cross_clr_intra,
    cross_clr_intra_per_row,
    info_nce,
    l2_normalize,
    masked_mean_pool,
    max_margin,
    normalized_connectivity,
    pooled_unit_inputs,
    weight_effective_fraction,
)

__all__ = [
    "CrossCLR",
    "CrossCLR_onlyIntraModality",
    "InfoNCE",
    "MaxMarginCoot",
    "connectivity_keep_and_weights",
    "connectivity_scores",
    "cosine_sim",
    "cross_clr",
    "cross_clr_intra",
    "cross_clr_intra_per_row",
    "info_nce",
    "l2_normalize",
    "masked_mean_pool",
    "max_margin",
    "normalized_connectivity",
    "pooled_unit_inputs",
    "weight_effective_fraction",
]
