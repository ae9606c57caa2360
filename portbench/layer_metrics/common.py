"""What several readers share: a layer's kernel family from
``families/<layer>/*.txt`` and its device seconds in the traced span,
and the readings of a training cell that two cells report under names
of their own (``.train`` / ``.gradcache``, after the rate each moves)."""

from __future__ import annotations

from pathlib import Path

from ..harness import HarnessError
from ..trace import family_seconds
from ..work import intra_loss, peaks, train_step

FAMILIES = Path(__file__).resolve().parent.parent / "families"


def patterns(layer: str) -> list[str]:
    out = []
    for path in sorted((FAMILIES / layer).glob("*.txt")):
        out += [line.strip() for line in path.read_text().splitlines()
                if line.strip() and not line.lstrip().startswith("#")]
    if not out:
        raise HarnessError(f"the kernel family {layer!r} names no kernel")
    return out


def device_trace(readings: dict) -> dict | None:
    """The traced span's summary when it traced a CUDA device, else None."""
    summary = readings.get("trace")
    if not summary or summary["device"] != "cuda":
        return None
    return summary


def family_time(summary: dict, layer: str) -> float:
    """Device seconds of the family ``layer``; raises where it took none."""
    seconds = family_seconds(summary, patterns(layer))
    if seconds <= 0:
        raise HarnessError(f"no kernel of the {layer!r} family ran on the device "
                           "in the traced span")
    return seconds


def idle_pct(readings: dict, ctx=None) -> float | None:
    """The device's idle share of the traced span."""
    summary = device_trace(readings)
    if summary is None:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def wait_ms(readings: dict, ctx) -> float | None:
    """The train step's wait for its inputs: ``DevicePrefetcher.stats
    ["wait_ms"]`` of the window's draws, summed, over the window's steps."""
    if not readings.get("steps"):
        return None
    return readings["wait_ms"] / readings["steps"]


def mfu_pct(readings: dict, ctx) -> float | None:
    """The whole step's share of the bf16 peak over the window: the model
    operations of a step (``work.train_step``) times the window's steps,
    over the window's seconds, over 989 TFLOP/s."""
    if not readings.get("steps"):
        return None
    flops = train_step.flops(ctx.config, readings["batch"]) * readings["steps"]
    return 100.0 * flops / readings["window_s"] / peaks.BF16_FLOPS


def loss_roofline_pct(readings: dict, ctx) -> float | None:
    """The loss's share of its roofline in the traced span: the least time
    of the intra loss's forward and backward at the step's ``(B, D)``
    (``work.intra_loss``) times the span's steps, over the device time of
    the ``loss`` family's kernels."""
    summary = device_trace(readings)
    if summary is None:
        return None
    b, d = readings["batch"], ctx.config["text_tower"]["embed_dim"]
    least = (peaks.least_seconds(intra_loss.forward_flops(b, d),
                                 intra_loss.forward_bytes(b, d))
             + peaks.least_seconds(intra_loss.backward_flops(b, d),
                                   intra_loss.backward_bytes(b, d)))
    return 100.0 * least * readings["trace_steps"] / family_time(summary, "loss")
