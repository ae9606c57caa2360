"""The device ms a traced step spends in the routed and shared experts'
products (``moe.experts``: the forward of GradCache's passes 1 and 3), in
the cells of an ``mla_moe`` text tower."""

from portbench.layer_metrics.moe_spans import span_ms


def read(readings: dict, ctx) -> float | None:
    return span_ms(readings, ("moe.experts",))
