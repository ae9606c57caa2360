"""Loss math and criterion classes."""

from .criterion import CrossCLR, CrossCLR_onlyIntraModality, InfoNCE, MaxMarginCoot
from .functional import (
    cosine_sim,
    cross_clr_intra,
    cross_clr_intra_per_row,
    info_nce,
    l2_normalize,
    max_margin,
)

__all__ = [
    "CrossCLR",
    "CrossCLR_onlyIntraModality",
    "InfoNCE",
    "MaxMarginCoot",
    "cosine_sim",
    "cross_clr_intra",
    "cross_clr_intra_per_row",
    "info_nce",
    "l2_normalize",
    "max_margin",
]
