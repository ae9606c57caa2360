"""Attention's share of its roofline in the traced span, in the cells of
an ``mla_moe`` text tower: the least time of both towers' attention
calls (video 8 heads × 48; text 16 heads at query/key width 192 and
value width 128, counted at those widths), the forward counted twice as
the two-pass step runs it, and the backward (``work.moe.
attention_least_seconds``), times the span's steps, over the device
time of the ``attention`` family's kernels."""

from portbench.layer_metrics.common import device_trace, family_time
from portbench.work import moe


def read(readings: dict, ctx) -> float | None:
    summary = device_trace(readings)
    if summary is None:
        return None
    least = moe.attention_least_seconds(ctx.config, readings["batch"])
    return 100.0 * least * readings["trace_steps"] / family_time(summary, "attention")
