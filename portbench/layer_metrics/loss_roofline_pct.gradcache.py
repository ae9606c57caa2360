"""The loss kernels' share of their roofline (``common.loss_roofline_pct``),
in the cells that report ``gradcache_pairs_per_s``."""

from portbench.layer_metrics.common import loss_roofline_pct as read  # noqa: F401
