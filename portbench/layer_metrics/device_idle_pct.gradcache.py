"""The device's idle share of the traced span (``common.idle_pct``), in the
cells that report ``gradcache_pairs_per_s``."""

from portbench.layer_metrics.common import idle_pct as read  # noqa: F401
