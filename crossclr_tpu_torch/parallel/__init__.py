"""Training over ``torch.distributed``: the launcher's ranks joined in one
group (:mod:`.multihost`), laid out as a data × model grid
(:mod:`.mesh`); the global-negative CrossCLR losses over the data group
(:mod:`.global_loss`) and ring attention over the model group
(:mod:`.ring_attention`)."""

from .global_loss import (
    all_gather,
    global_cross_clr,
    global_cross_clr_intra,
    global_cross_clr_row_terms,
    global_row_losses,
    local_rows_cross_clr_intra,
    pruned_rows_global,
)
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh
from .multihost import host_local_batch_size, initialize_multihost, is_multihost
from .ring_attention import ring_attention, sequence_parallel_attention

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "all_gather",
    "global_cross_clr",
    "global_cross_clr_intra",
    "global_cross_clr_row_terms",
    "global_row_losses",
    "host_local_batch_size",
    "initialize_multihost",
    "is_multihost",
    "local_rows_cross_clr_intra",
    "make_mesh",
    "pruned_rows_global",
    "ring_attention",
    "sequence_parallel_attention",
]
