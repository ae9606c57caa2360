"""One process per rank: the launcher's environment to a process group.

Counterpart of ``crossclr_tpu/parallel/multihost.py``, with
``torch.distributed`` in place of ``jax.distributed``.  A launcher
(``torchrun``, or any that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``) starts one process per rank;
:func:`initialize_multihost` joins them in the default group, whose ranks
are the data axis of the data-parallel step (``training.Trainer``).
Without a launcher it starts nothing, and the run is the one-device run.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "is_multihost", "host_local_batch_size"]

_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _launched() -> bool:
    """Whether a launcher set the environment: ``WORLD_SIZE`` above 1, or
    ``WORLD_SIZE`` 1 beside ``MASTER_ADDR`` (a one-rank group asked for)."""
    world = os.environ.get("WORLD_SIZE")
    if world is None:
        return False
    return int(world) > 1 or "MASTER_ADDR" in os.environ


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """The device of this process: ``cuda`` means ``cuda:LOCAL_RANK``
    under a launcher (``cuda:0`` without one); an explicit index or the
    CPU stays as it is."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def initialize_multihost(device: str | torch.device = "cuda") -> bool:
    """Join the launcher's ranks in the default process group, once.

    Returns False and starts nothing when ``WORLD_SIZE`` is unset, or 1
    without ``MASTER_ADDR``: the one-device run.  Else it needs every one
    of ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``; binds a CUDA rank to :func:`rank_device` (so a
    missing card raises here); starts ``nccl`` on a card and ``gloo`` on
    the CPU; and returns True.  Idempotent: an initialised group returns
    True."""
    if dist.is_available() and dist.is_initialized():
        return True
    if not _launched():
        return False
    missing = [k for k in _LAUNCHER_VARS if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"WORLD_SIZE={os.environ['WORLD_SIZE']} but the launcher set no "
            f"{', '.join(missing)}: start the ranks with torchrun (or set "
            f"all of {', '.join(_LAUNCHER_VARS)})")
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device} for a process group")
    backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kwargs)
    return True


def is_multihost() -> bool:
    """Whether more than one rank is joined in the default group."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def host_local_batch_size(global_batch_size: int) -> int:
    """This rank's share of a global batch: each rank feeds its own rows
    (``data.HostShard``), so the world size must divide the batch."""
    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if global_batch_size % n != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {n} hosts"
        )
    return global_batch_size // n
