"""The device ms a traced step spends in the optimizer (``train.optimizer``:
the clip, the update, the clamp and the EMA), in the cells that report
``gradcache_pairs_per_s``."""

from portbench.layer_metrics.spans import layer_ms


def read(readings: dict, ctx) -> float | None:
    return layer_ms(readings, ("train.optimizer",))
