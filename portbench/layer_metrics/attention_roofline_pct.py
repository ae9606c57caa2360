"""Attention's share of its roofline in the traced span: the least time of
every attention call of the span's steps (both towers, each block,
forward and backward; ``work.attention``) over the device time of the
``attention`` family's kernels."""

from portbench.layer_metrics.common import device_trace, family_time
from portbench.work import attention, peaks, towers


def read(readings: dict, ctx) -> float | None:
    summary = device_trace(readings)
    if summary is None:
        return None
    least = 0.0
    for side in ("video_tower", "text_tower"):
        tower = ctx.config[side]
        shape = towers.attention_shape(tower, readings["batch"])
        if shape is None:
            continue
        size = 2 if tower["dtype"] == "bfloat16" else 4
        one = (peaks.least_seconds(attention.forward_flops(*shape),
                                   attention.forward_bytes(*shape, size))
               + peaks.least_seconds(attention.backward_flops(*shape),
                                     attention.backward_bytes(*shape, size)))
        least += one * tower["num_layers"]
    return 100.0 * least * readings["trace_steps"] / family_time(summary, "attention")
