"""The ``mla_moe`` tower's spans of the traced steps (``moe.route``,
``moe.experts``, ``moe.combine``, ``mla.attention``; ``models.mla_moe``),
which the ``.moe`` readers share.  They nest inside the train step's
passes (``train.encode``, ``train.backward``: the forward of passes 1 and
3; the backward runs outside them), so they are read from the whole log,
not from the step's children.  The first reader keeps the log in
``readings`` and leaves the program's log as it is.  A program without
spans, or a trace that is not a CUDA device's, gives None."""

from __future__ import annotations

from .common import device_trace

KEY = "moe_span_log"


def span_ms(readings: dict, names: tuple[str, ...]) -> float | None:
    """The device ms of the spans named ``names``, summed over the traced
    block, over its steps; None where the program recorded none."""
    if device_trace(readings) is None:
        return None
    if KEY not in readings:
        try:
            from crossclr_tpu_torch.utils.profiling import span_log
        except ImportError:  # a program without spans
            readings[KEY] = []
        else:
            readings[KEY] = span_log()
    records = [r for r in readings[KEY] if r["name"] in names]
    if not records:
        return None
    return sum(r["device_ms"] or 0.0 for r in records) / readings["trace_steps"]
