"""Data-parallel training over ``torch.distributed``: the launcher's ranks
joined in one group (:mod:`.multihost`), and the global-negative CrossCLR
losses over that group (:mod:`.global_loss`)."""

from .global_loss import (
    all_gather,
    global_cross_clr,
    global_cross_clr_intra,
    global_cross_clr_row_terms,
    global_row_losses,
    local_rows_cross_clr_intra,
    pruned_rows_global,
)
from .multihost import host_local_batch_size, initialize_multihost, is_multihost

__all__ = [
    "all_gather",
    "global_cross_clr",
    "global_cross_clr_intra",
    "global_cross_clr_row_terms",
    "global_row_losses",
    "host_local_batch_size",
    "initialize_multihost",
    "is_multihost",
    "local_rows_cross_clr_intra",
    "pruned_rows_global",
]
