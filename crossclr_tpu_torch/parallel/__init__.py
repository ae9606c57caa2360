"""The global-negative CrossCLR losses over ``torch.distributed``."""

from .global_loss import (
    all_gather,
    global_cross_clr,
    global_cross_clr_intra,
    global_cross_clr_row_terms,
    global_row_losses,
    local_rows_cross_clr_intra,
    pruned_rows_global,
)

__all__ = [
    "all_gather",
    "global_cross_clr",
    "global_cross_clr_intra",
    "global_cross_clr_row_terms",
    "global_row_losses",
    "local_rows_cross_clr_intra",
    "pruned_rows_global",
]
