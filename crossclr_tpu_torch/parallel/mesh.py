"""The data × model process grid.

Counterpart of ``crossclr_tpu/parallel/mesh.py``.  Where the JAX package
lays devices out as a ``(data, model)`` ``jax.sharding.Mesh``, the port
runs one process per rank and lays the ranks of the default
``torch.distributed`` group out the same way, ``reshape(n_data,
n_model)``: rank ``d·M + m`` sits at data coordinate ``d`` and model
coordinate ``m``, each model group's ranks contiguous.  A rank holds its
coordinates and two subgroups:

* the data group (the ranks of its model coordinate, one per data shard):
  global negatives, the gradient sum and ZeRO-1 (``training.Trainer``);
* the model group (the ranks of its data coordinate): ring attention's
  sequence shards (:mod:`.ring_attention`), the towers' pooling and the
  model axis's own gradient sum.

At ``n_model == 1`` the data group is the default group itself, the
data-parallel step's group; at ``n_data == 1`` the model group is.  One
rank without a group is the 1 × 1 grid with no groups, as JAX's one-device
mesh is 1 × 1.  The model axis carries sequence parallelism only: tensor
parallelism and the DCN layouts (``dcn``, ``granule``) are not ported
(ROADMAP queue 1 item 13).
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "make_mesh"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in the ``(data, model)`` grid: the axis sizes, its
    coordinates and its two subgroups (None where the axis is this rank
    alone).  A deep copy is the mesh itself: process groups are not
    copied, so a module that holds the mesh (``models.DualEncoder``)
    copies."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    def __deepcopy__(self, memo) -> "Mesh":
        return self


def make_mesh(n_data: int | None = None, n_model: int = 1, *,
              dcn: int | str | None = "auto", granule: str = "slice") -> Mesh:
    """The ``(data, model)`` grid over the default group's ranks.

    ``n_data=None`` takes every rank the model axis leaves; the grid must
    cover every rank.  The subgroups are made here, every data group and
    then every model group, in the same order on every rank (each
    ``dist.new_group`` is a collective of the whole default group): call
    it on every rank at the same point.  Without an initialised group the
    grid is 1 × 1 with no groups.  ``dcn`` and ``granule`` other than their
    defaults are refused (ROADMAP queue 1 item 13)."""
    if dcn != "auto" or granule != "slice":
        raise NotImplementedError(
            "the DCN mesh layouts (dcn, granule) are not ported to "
            "crossclr_tpu_torch yet (ROADMAP queue 1 item 13)"
        )
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    if n_model < 1 or world % n_model:
        raise ValueError(f"{world} ranks not divisible by model axis {n_model}")
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(
            f"a {n_data} x {n_model} grid must cover all {world} ranks of the "
            "default group"
        )
    data_index, model_index = divmod(rank, n_model)
    if not grouped:
        return Mesh(1, 1, 0, 0)
    data_group = model_group = None
    if n_model == 1:
        data_group = dist.group.WORLD
    elif n_data > 1:
        for m in range(n_model):
            group = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == model_index:
                data_group = group
    if n_data == 1:
        model_group = dist.group.WORLD if n_model > 1 else None
    elif n_model > 1:
        for d in range(n_data):
            group = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == data_index:
                model_group = group
    return Mesh(n_data, n_model, data_index, model_index, data_group,
                model_group)
