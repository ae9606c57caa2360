"""The routed experts' share of their roofline in the traced span: the
least time of the grouped products of every MoE layer (three forward
products over the routed rows, counted twice, as the two-pass step runs
the forward twice, and their six backward products;
``work.moe.experts_least_seconds``) times the span's steps, over the
device time of the ``experts`` family's kernels."""

from portbench.layer_metrics.common import device_trace, family_time
from portbench.work import moe


def read(readings: dict, ctx) -> float | None:
    summary = device_trace(readings)
    if summary is None:
        return None
    least = moe.experts_least_seconds(ctx.config["text_tower"], readings["batch"])
    return 100.0 * least * readings["trace_steps"] / family_time(summary, "experts")
