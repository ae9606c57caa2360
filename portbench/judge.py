"""The numbers that decide ``correct`` in a training cell: the program's
and the reference's first three steps from the same weights and batches.

* ``loss_gap``: the largest relative gap of a step's loss.
* ``grad_gap``: over the leaves, the largest gap between the norms of the
  first step's clipped gradient (the program's worked out from its AdamW
  state after one step, ``mu / (1 − b1)``), as a share of the
  reference's norm of that leaf or of the median leaf, whichever is
  larger.
* ``change_gap``: the same of the norms of the parameters' change over
  the three steps, over the leaves whose reference gradient is at least
  a thousandth of the median leaf's (a gradient nought to rounding, as a
  key's bias has under softmax, moves under Adam by round-off alone).

``pair_faults`` (``portbench.pairs.locate``) is counted apart."""

from __future__ import annotations

import statistics

COUNTED = 1e-3


def _leaf_gap(prog: dict, ref: dict, names, leaf: str) -> float:
    """Leaf ``leaf``'s gap of norms against the reference's norm of it or
    of the median leaf of ``names``, whichever is larger."""
    base = statistics.median(ref[k] for k in names)
    return abs(prog[leaf] - ref[leaf]) / max(ref[leaf], base, 1e-30)


def _names(ref: dict, key: str) -> list:
    """The leaves ``key`` (``grad_norms`` / ``change_norms``) is compared over."""
    names = sorted(ref["grad_norms"])
    if key == "change_norms":
        median_grad = statistics.median(ref["grad_norms"][k] for k in names)
        names = [k for k in names if ref["grad_norms"][k] >= COUNTED * median_grad]
    return names


def worst_leaves(prog: dict, ref: dict, key: str, n: int = 6) -> list:
    """The ``n`` leaves of ``key`` with the widest gap as :func:`training`
    measures it: ``[leaf, program, reference, gap, reference gradient]``,
    for a look at a reading."""
    names = _names(ref, key)
    rows = [[k, prog[key][k], ref[key][k], _leaf_gap(prog[key], ref[key], names, k),
             ref["grad_norms"][k]] for k in names]
    return sorted(rows, key=lambda r: -r[3])[:n]


def training(prog: dict, ref: dict) -> dict:
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    out = {"loss_gap": loss_gap}
    for number, key in (("grad_gap", "grad_norms"), ("change_gap", "change_norms")):
        names = _names(ref, key)
        out[number] = max(_leaf_gap(prog[key], ref[key], names, k) for k in names)
    return out
