"""Tensor parallelism over the model group: the tower weights split
Megatron-style, the JAX trainer's rule.

Counterpart of ``crossclr_tpu/training/trainer.py``'s ``_tp_spec_for_param``
(the parameter specs GSPMD partitions the JAX step by).  Here the ranks of
a ``parallel.Mesh``'s model group each hold one slice of every parameter
the rule shards, exactly the slice that JAX's ``NamedSharding`` places at
that model coordinate, and the towers run the conjugate collectives
themselves:

* :func:`copy_to_model`: identity forward, all-reduce backward, where a
  sharded layer reads a replicated activation;
* :func:`reduce_from_model`: all-reduce forward, identity backward, after
  a row-parallel product;
* :func:`gather_from_model`: the shards of a column-parallel output joined
  along the last dimension, each rank's own slice of the cotangent back.

Every rank of the group computes the same loss of the whole batch, so a
parameter the rule leaves replicated but a layer consumes as a slice (the
``query``/``key``/``value`` biases, a column-parallel ``skip`` or
``Dense_*`` bias: :func:`consumed_sliced`) takes only its slice's gradient
on each rank and is summed over the group (``training.Trainer``); every
other gradient is already whole.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

__all__ = [
    "ModelShards",
    "consumed_sliced",
    "copy_to_model",
    "gather_from_model",
    "reduce_from_model",
    "shard",
    "tp_dim",
]

_COLUMN = ("fc1", "skip", "input_proj")  # Flax kernel P(None, model)
_ROW = ("fc2", "output_proj")  # P(model, None)
_HEADS = ("query", "key", "value")  # [E, H, Dh]: P(None, model, None)


def tp_dim(name: str, shape) -> int | None:
    """The dimension of the torch-layout parameter ``name`` (a state_dict
    key: module path, then ``weight`` for Flax's ``kernel``) that the JAX
    rule shards over the model axis, None where it is replicated.  A
    ``Dense`` weight is ``[out, in]``, Flax's kernel transposed: a column
    split is dim 0, a row split dim 1.  The ``query``/``key``/``value``
    weights are ``[H·Dh, E]`` flattened head-major, so a head shard is a
    block of rows; ``out`` takes the matching input columns.  The rule
    matches its names exactly: ``fc1_1``, ``skip_1``, ``fc2_1`` of an MLP's
    later blocks stay replicated, as in the JAX package."""
    parts = name.split(".")
    leaf, parent = parts[-1], parts[-2] if len(parts) > 1 else ""
    if leaf == "weight" and len(shape) == 2:
        if parent in _COLUMN or parent in _HEADS:
            return 0
        if parent in _ROW or parent == "out":
            return 1
        if parent.startswith("Dense_"):
            # Flax compares its kernel's [in, out]: in < out splits out
            if shape[1] < shape[0]:
                return 0
            if shape[1] > shape[0]:
                return 1
    if leaf == "bias" and parent in ("fc1", "input_proj"):
        return 0
    return None


def consumed_sliced(name: str, dims: dict) -> bool:
    """Whether ``name`` is a replicated bias of a column-parallel layer
    (``dims``: every parameter's :func:`tp_dim`): each rank adds its slice,
    so its gradient is summed over the model group."""
    if not name.endswith(".bias") or dims.get(name) is not None:
        return False
    return dims.get(name[: -len("bias")] + "weight") == 0


def shard(x: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    """Model rank ``index``'s slice of ``x`` along ``dim`` (a view)."""
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size)


@dataclasses.dataclass(frozen=True, eq=False)
class ModelShards:
    """A model group's tensor-parallel split: ``n`` ranks, this one
    ``index``, their ``group``."""

    n: int
    index: int
    group: object

    @classmethod
    def of(cls, mesh) -> "ModelShards":
        return cls(mesh.n_model, mesh.model_index, mesh.model_group)

    def __deepcopy__(self, memo) -> "ModelShards":
        return self  # process groups are not copied

    def check(self, width: int, what: str) -> int:
        """``width / n``; a width the group does not divide is refused, as
        JAX's ``device_put`` refuses the sharding."""
        if width % self.n:
            raise ValueError(f"{what} {width} is not divisible by n_model "
                             f"{self.n}: tensor parallelism splits it over "
                             "the model axis")
        return width // self.n


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shards: ModelShards):
        ctx.shards = shards
        local = x.movedim(-1, 0).contiguous()
        out = local.new_empty((shards.n * local.shape[0], *local.shape[1:]))
        dist.all_gather_into_tensor(out, local, group=shards.group)
        # [n·w, ...] -> [..., n·w]: rank m's columns at m·w
        return out.movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        shards = ctx.shards
        return shard(g, g.dim() - 1, shards.index, shards.n).contiguous(), None


def copy_to_model(x: torch.Tensor, shards: ModelShards) -> torch.Tensor:
    """``x`` (replicated over the group) as the input of sharded layers:
    the same values, its cotangent summed over the group."""
    return _CopyToModel.apply(x, shards.group)


def reduce_from_model(x: torch.Tensor, shards: ModelShards) -> torch.Tensor:
    """The sum of the group's partial products (in ``x``'s dtype)."""
    return _ReduceFromModel.apply(x, shards.group)


def gather_from_model(x: torch.Tensor, shards: ModelShards) -> torch.Tensor:
    """The group's column shards of ``x`` joined along the last dimension."""
    return _GatherFromModel.apply(x, shards)
