"""The whole step's share of the bf16 peak (``common.mfu_pct``), in the
cells that report ``gradcache_pairs_per_s``."""

from portbench.layer_metrics.common import mfu_pct as read  # noqa: F401
