"""The train step's wait for its inputs (``common.wait_ms``), in the cells
that report ``train_pairs_per_s``."""

from portbench.layer_metrics.common import wait_ms as read  # noqa: F401
