"""The device ms a traced step spends in GradCache's passes 1 and 3
(``train.encode`` + ``train.backward``, the recompute included), in the
cells that report ``gradcache_pairs_per_s``."""

from portbench.layer_metrics.spans import layer_ms


def read(readings: dict, ctx) -> float | None:
    return layer_ms(readings, ("train.encode", "train.backward"))
