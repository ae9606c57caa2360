"""Kernels written by hand for Hopper, each beside its plain PyTorch
version.  Importing this package builds nothing: a kernel is compiled at
its first launch on a CUDA tensor."""

from .flash_attention import flash_attention, mha_reference
from .fused_crossclr import cross_clr_intra_fused, fused_lse_pair, route
from .fused_dual import dual_lse_pair, sym_supported
from .fused_global import cross_clr_fused, fused_lse_rows, rows_supported

__all__ = [
    "cross_clr_fused",
    "cross_clr_intra_fused",
    "dual_lse_pair",
    "flash_attention",
    "fused_lse_pair",
    "fused_lse_rows",
    "mha_reference",
    "route",
    "rows_supported",
    "sym_supported",
]
