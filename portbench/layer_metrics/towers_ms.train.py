"""The device ms a traced step spends in the towers' forward and backward
(``train.forward`` + ``train.backward``; the backward holds the loss's
own), in the cells that report ``train_pairs_per_s``."""

from portbench.layer_metrics.spans import layer_ms


def read(readings: dict, ctx) -> float | None:
    return layer_ms(readings, ("train.forward", "train.backward"))
