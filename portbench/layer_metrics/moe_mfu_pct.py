"""The whole step's share of the bf16 peak over the window, in the cells
of an ``mla_moe`` text tower: the model operations of a step
(``work.moe.step_flops``: both towers, latent attention's projections
and attention, the router, the routed and shared experts, the dense
layer and the loss, forward and backward, without GradCache's
recompute) times the window's steps, over the window's seconds, over
989 TFLOP/s."""

from portbench.work import moe, peaks


def read(readings: dict, ctx) -> float | None:
    if not readings.get("steps"):
        return None
    flops = moe.step_flops(ctx.config, readings["batch"]) * readings["steps"]
    return 100.0 * flops / readings["window_s"] / peaks.BF16_FLOPS
