"""The data × model process grid.

Counterpart of ``crossclr_tpu/parallel/mesh.py``.  Where the JAX package
lays devices out as a ``(data, model)`` ``jax.sharding.Mesh``, the port
runs one process per rank and lays the ranks of the default
``torch.distributed`` group out the same way (:func:`grid_layout`, the
pure layout): by default ``reshape(n_data, n_model)``, rank ``d·M + m`` at
data coordinate ``d`` and model coordinate ``m``, each model group's ranks
contiguous.  A rank holds its coordinates and two subgroups:

* the data group (the ranks of its model coordinate, one per data shard):
  global negatives, the gradient sum and ZeRO-1 (``training.Trainer``);
* the model group (the ranks of its data coordinate): ring attention's
  sequence shards (:mod:`.ring_attention`) or the towers' tensor-parallel
  shards (:mod:`.tensor_parallel`), and the model axis's own sums.

At ``n_model == 1`` the data group is the default group itself, the
data-parallel step's group; at ``n_data == 1`` the model group is.  One
rank without a group is the 1 × 1 grid with no groups, as JAX's one-device
mesh is 1 × 1.

The DCN layouts (``dcn``, ``granule``) are JAX's: the ranks fall into
granules (``"slice"``: the node, named by the launcher's ``GROUP_RANK``,
else the hostname; ``"process"``: the rank itself, as JAX sees a platform
of one device a process; ``"contiguous"``: ``dcn`` equal blocks of ranks),
each model group stays inside one granule and the data axis runs granule
by granule, granules in the order of their ids.  ``torch.distributed``
numbers a group's members by their global rank, so a rank's coordinates
are its places in its groups in that order; a layout whose groups cannot
agree on them is refused.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import numpy as np
import torch.distributed as dist

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "grid_layout", "make_mesh"]

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


_GRANULES = ("slice", "process", "contiguous")


def grid_layout(granule_ids, n_data: int, n_model: int,
                dcn: int | str | None = "auto",
                granule: str = "slice") -> np.ndarray:
    """The ``[n_data, n_model]`` grid of ranks ``0 .. len(granule_ids)``
    that ``crossclr_tpu.parallel.make_mesh`` builds over devices whose
    granule ids (``slice_index`` under ``"slice"``, ``process_index``
    under ``"process"``; unread under ``"contiguous"``) are
    ``granule_ids``, in rank order, with JAX's errors.  One granule, or
    ``dcn`` 1 or None, is the plain ``reshape(n_data, n_model)``; past one,
    the granules sorted by id, each one's ranks in order reshaped to
    ``[n_data / G, n_model]`` and stacked along the data axis."""
    ranks = np.arange(len(granule_ids))
    if granule not in _GRANULES:
        raise ValueError("granule must be 'slice', 'process', or 'contiguous', "
                         f"got {granule!r}")
    if n_data * n_model != len(ranks):
        raise ValueError(f"a {n_data} x {n_model} grid must cover all "
                         f"{len(ranks)} ranks of the default group")
    if granule == "contiguous":
        if dcn in ("auto", None):
            raise ValueError("granule='contiguous' needs an explicit dcn=<int>")
        n_granules = int(dcn)
        if n_granules > 1 and n_data % n_granules:
            raise ValueError(f"data axis {n_data} not divisible by {n_granules} "
                             "DCN granules (or devices don't fill the mesh)")
        # the granules are contiguous blocks: the plain reshape is their stack
        return ranks.reshape(n_data, n_model)
    groups: dict = {}
    for r, gid in zip(ranks, granule_ids):
        groups.setdefault(gid, []).append(r)
    n_granules = len(groups) if dcn == "auto" else int(dcn or 1)
    if n_granules <= 1:
        return ranks.reshape(n_data, n_model)
    if n_data % n_granules:
        raise ValueError(
            f"data axis {n_data} not divisible by {n_granules} DCN granules — "
            f"global batch must split evenly across {granule} groups")
    if len(groups) != n_granules:
        raise ValueError(f"Number of slices {len(groups)} must equal the "
                         f"product of dcn_mesh_shape ({n_granules}, 1)")
    shape = (n_data // n_granules, n_model)
    blocks = []
    for gid in sorted(groups):
        members = groups[gid]
        if len(members) != shape[0] * shape[1]:
            raise ValueError(f"Number of devices {len(members)} must equal the "
                             f"product of mesh_shape {shape}")
        blocks.append(np.asarray(members).reshape(shape))
    return np.concatenate(blocks, axis=0)


def _coordinates(grid: np.ndarray, rank: int) -> tuple[int, int]:
    """``rank``'s (data, model) coordinates on ``grid``: its places in its
    column and its row in ascending rank, the order ``torch.distributed``
    gives a group's members; refused where two ranks of one group would
    disagree."""
    order_d = np.argsort(np.argsort(grid, axis=0), axis=0)  # place in column
    order_m = np.argsort(np.argsort(grid, axis=1), axis=1)  # place in row
    if ((order_d != order_d[:, :1]).any() or (order_m != order_m[:1]).any()):
        raise ValueError(
            f"the layout {grid.tolist()} orders its data and model groups "
            "differently from ascending rank, the order torch.distributed "
            "numbers a group's members in: start the ranks so that each "
            "granule's ranks ascend with its id")
    d, m = (int(x[0]) for x in np.nonzero(grid == rank))
    return int(order_d[d, m]), int(order_m[d, m])


def _granule_ids(granule: str, world: int, rank: int) -> list:
    """Every rank's granule id, in rank order (a collective under
    ``"slice"``: the node names are gathered)."""
    if granule != "slice":  # "process": the rank; "contiguous": unread
        return list(range(world))
    node = os.environ.get("GROUP_RANK")
    node = int(node) if node is not None else socket.gethostname()
    if world == 1:
        return [node]
    ids = [None] * world
    dist.all_gather_object(ids, node)
    return ids


def make_mesh(n_data: int | None = None, n_model: int = 1, *,
              dcn: int | str | None = "auto", granule: str = "slice") -> Mesh:
    """The ``(data, model)`` grid over the default group's ranks.

    ``n_data=None`` takes every rank the model axis leaves; the grid must
    cover every rank.  ``dcn`` and ``granule`` lay it out as
    :func:`grid_layout` does (the module doc).  The subgroups are made
    here, every data group and then every model group, in the same order
    on every rank (each ``dist.new_group`` is a collective of the whole
    default group, and under ``granule="slice"`` the node names are
    gathered first past one model rank or with an explicit ``dcn``): call
    it on every rank at the same point.  Without an initialised group the
    grid is 1 × 1 with no groups."""
    if granule not in _GRANULES:
        raise ValueError("granule must be 'slice', 'process', or 'contiguous', "
                         f"got {granule!r}")
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    if n_model < 1 or world % n_model:
        raise ValueError(f"{world} ranks not divisible by model axis {n_model}")
    if n_data is None:
        n_data = world // n_model
    # one model rank: whatever the layout, each rank's data coordinate is
    # its rank, so the granules are only gathered for a layout asked for
    ids = (_granule_ids(granule, world, rank) if n_model > 1 or dcn != "auto"
           else [0] * world)
    grid = grid_layout(ids, n_data, n_model, dcn, granule)
    data_index, model_index = _coordinates(grid, rank)
    if not grouped:
        return Mesh(1, 1, 0, 0)
    data_group = model_group = None
    if n_model == 1:
        data_group = dist.group.WORLD
    elif n_data > 1:
        for m in range(n_model):
            group = dist.new_group(sorted(grid[:, m].tolist()))
            if rank in grid[:, m]:
                data_group = group
    if n_data == 1:
        model_group = dist.group.WORLD if n_model > 1 else None
    elif n_model > 1:
        for d in range(n_data):
            group = dist.new_group(sorted(grid[d].tolist()))
            if rank in grid[d]:
                model_group = group
    return Mesh(n_data, n_model, data_index, model_index, data_group,
                model_group)
