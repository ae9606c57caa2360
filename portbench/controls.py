"""The control and the planted faults of the output check, computed from
the inputs the reference was given in a run: the reference put in the
program's place in float8 (e4m3, scaled per tensor; the precision below
the bf16 the configurations state); the reference with half of each
batch left out, its mean taken over the rest; and, in a transformer
cell, the reference with no gradient reaching the queries and keys of
attention (the dq and dk of the flash backward left at nought).  Each is
judged as the program is; the limits must pass the program and fail
these."""

from __future__ import annotations

from . import judge
from .reference import trajectory


def training(args: tuple, kw: dict, ref: dict, run=trajectory.run) -> dict:
    """``{control: judge.training numbers}`` from ``trajectory.run``'s
    arguments in the run and its result."""
    config = args[0]
    planted = [("fp8", {"precision": "fp8"}), ("half_batch", {"half_batch": True})]
    if config["video_tower"]["kind"] == "transformer":
        planted.append(("qk_frozen", {"qk_grad": False}))
    return {name: judge.training(run(*args, **{**kw, **extra}), ref)
            for name, extra in planted}
