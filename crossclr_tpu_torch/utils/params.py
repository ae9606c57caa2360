"""Flax parameter tree → state_dict of the port's modules.

The weights bridge between the two packages, after the layout rules of
``crossclr_tpu/utils/torch_import.py:state_dict_from_params``:

* ``Dense`` kernel ``[in, out]`` → Linear weight ``[out, in]``;
* ``DenseGeneral`` q/k/v kernel ``[E, H, Dh]`` → ``[H·Dh, E]``, its bias
  ``[H, Dh]`` → ``[H·Dh]``; the output projection ``[H, Dh, E]`` →
  ``[E, H·Dh]``;
* LayerNorm ``scale`` → ``weight``;
* bare leaves (``pos_embed``, ``logit_scale``) keep their names.

The attention submodule is ``_MHA_0`` under attention="flash" and
``MultiHeadDotProductAttention_0`` under "xla"; the layouts are the same,
so either name in the tree maps onto the target module's own.  The tree
is nested mappings of numpy arrays (``jax.device_get`` of the JAX
trainer's params): reading it needs no jax.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_flax"]

_ATTENTION_NAMES = ("_MHA_0", "MultiHeadDotProductAttention_0")


def _leaves(tree, prefix=()):
    for name, node in tree.items():
        path = (*prefix, str(name))
        if isinstance(node, Mapping):
            yield from _leaves(node, path)
        else:
            yield path, np.asarray(node)


def _torch_layout(path: tuple[str, ...], value: np.ndarray):
    *modules, leaf = path
    if leaf == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 3 and modules and modules[-1] == "out":
            value = value.reshape(-1, value.shape[-1]).T  # [H, Dh, E]
        elif value.ndim == 3:
            value = value.reshape(value.shape[0], -1).T  # [E, H, Dh]
        else:
            raise ValueError(
                f"{'.'.join(path)}: cannot express a {value.ndim}-D kernel "
                "as a Linear weight"
            )
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf == "bias" and value.ndim > 1:
        value = value.reshape(-1)  # q/k/v bias [H, Dh]
    return ".".join([*modules, leaf]), value


def _retarget(key: str, targets) -> str:
    """Map the tree's attention name onto the one ``targets`` uses."""
    if key in targets:
        return key
    a, b = _ATTENTION_NAMES
    for src, dst in ((a, b), (b, a)):
        alt = key.replace(f".{src}.", f".{dst}.")
        if alt in targets:
            return alt
    return key


def state_dict_from_flax(params: Mapping, module: torch.nn.Module
                         ) -> dict[str, torch.Tensor]:
    """Convert a Flax parameter (sub)tree into ``module``'s state_dict.

    Strict: every leaf of the tree is consumed, every entry of
    ``module.state_dict()`` is filled, and every shape matches; any
    mismatch raises.  Values come back as fp32 CPU tensors, ready for
    ``module.load_state_dict``.
    """
    targets = module.state_dict()
    out: dict[str, torch.Tensor] = {}
    extra = []
    for path, value in _leaves(params):
        key, value = _torch_layout(path, value)
        key = _retarget(key, targets)
        if key not in targets:
            extra.append(".".join(path))
            continue
        if key in out:
            raise ValueError(f"two leaves of the tree map to {key!r}")
        want = tuple(targets[key].shape)
        if value.shape != want:
            raise ValueError(
                f"{'.'.join(path)}: shape {value.shape} does not match "
                f"{key} {want}"
            )
        out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    missing = sorted(set(targets) - set(out))
    if extra or missing:
        raise KeyError(
            f"parameter tree and module disagree: leaves with no module "
            f"entry {sorted(extra)[:10]}, module entries with no leaf "
            f"{missing[:10]}"
        )
    return out
