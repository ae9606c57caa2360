"""A PyTorch tower's state_dict → the port's towers, and back.

Counterpart of ``crossclr_tpu/utils/torch_import.py``.  Migrating users
arrive with the state_dicts of dual towers they wrote in torch, and
perhaps of the reference criterion (its scalar ``logit_scale``).  The
port's submodule names equal the Flax module paths (``models.encoders``),
so a torch tower whose attribute names mirror them converts with no extra
configuration, as it does into the JAX package: ``block_0.LayerNorm_0.weight``
is the same key on both sides.  Unlike the Flax layouts, nothing needs a
transpose: a torch ``Linear`` weight is already the port's ``[out, in]``,
and ``[E, E]`` q/k/v/out projections are already the port's flattened
``[H·Dh, E]``.  What stays is the JAX version's checking: every template
entry found, every shape checked, nothing silently dropped.

Towers with other naming pass ``rename=``: a ``{torch_prefix:
port_prefix}`` dict applied longest-prefix-first, or a callable on full
keys.  The numerical conventions a migrating tower must share are the
architecture's (tanh GELU, LayerNorm eps 1e-6, queries scaled by
1/sqrt(head_dim)), not the conversion's.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
from typing import Any

import numpy as np
import torch

__all__ = [
    "dual_encoder_params_from_torch",
    "logit_scale_from_torch",
    "params_from_torch",
    "state_dict_from_params",
]

# torch buffer suffixes that are bookkeeping, not parameters: never
# reported as unconsumed (BatchNorm-style buffers in user towers)
_IGNORED_SUFFIXES = ("num_batches_tracked",)
_TOWERS = ("video_tower", "text_tower")

Rename = Mapping[str, str] | Callable[[str], str] | None


def _entries(template) -> dict[str, torch.Tensor]:
    """A module's state_dict, or a mapping of name → tensor as it is."""
    if isinstance(template, torch.nn.Module):
        return template.state_dict()
    return dict(template)


def _to_tensor(value: Any) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.array(value))


def _apply_rename(key: str, rename: Rename) -> str:
    if rename is None:
        return key
    if callable(rename):
        return rename(key)
    # longest-prefix-first so "tower.block." beats "tower."
    for prefix in sorted(rename, key=len, reverse=True):
        if key.startswith(prefix):
            return rename[prefix] + key[len(prefix):]
    return key


def _convert(key: str, want: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """One torch tensor in the template entry's shape and dtype.  A Linear
    weight (a 2-D ``*.weight``) must match exactly; any other entry may be
    reshaped when its size matches (a ``[1]`` scale for a scalar)."""
    shape = tuple(want.shape)
    if tuple(value.shape) != shape:
        linear = want.ndim == 2 and key.endswith("weight")
        if linear or value.numel() != want.numel():
            raise ValueError(
                f"{key}: torch tensor {tuple(value.shape)} does not match "
                f"the port's {shape}"
            )
        value = value.reshape(shape)
    return value.to(want.dtype).clone()


def params_from_torch(template, state_dict: Mapping[str, Any], *,
                      rename: Rename = None, strict: bool = True
                      ) -> dict[str, torch.Tensor]:
    """Convert a torch ``state_dict`` into the entries of ``template``.

    ``template``: a port module (a tower, or :class:`DualEncoder`) or its
    state_dict; its entries define the output, CPU tensors in their
    dtype, ready for ``module.load_state_dict``.  ``rename``: a torch-key
    rewrite applied before matching.  ``strict``: raise when a torch entry
    other than a bookkeeping buffer goes unconsumed (the silently dropped
    weight, the classic porting bug).  A missing entry raises
    ``KeyError``; a shape that does not match, or a rename that maps two
    keys onto one, ``ValueError``.
    """
    source: dict[str, torch.Tensor] = {}
    renamed_from: dict[str, str] = {}
    for torch_key, v in state_dict.items():
        key = _apply_rename(torch_key, rename)
        if key in source:
            # a collapsing rename would silently overwrite a weight
            raise ValueError(
                f"rename maps both {renamed_from[key]!r} and "
                f"{torch_key!r} to {key!r}"
            )
        source[key] = _to_tensor(v)
        renamed_from[key] = torch_key

    out = {}
    for key, want in _entries(template).items():
        if key not in source:
            raise KeyError(
                f"no torch key for parameter {key} (state_dict has "
                f"{sorted(source)[:20]}{'...' if len(source) > 20 else ''})"
            )
        out[key] = _convert(key, want, source[key])

    leftover = [k for k in source
                if k not in out and not k.endswith(_IGNORED_SUFFIXES)]
    if strict and leftover:
        raise ValueError(
            f"{len(leftover)} torch entries were not consumed: "
            f"{sorted(leftover)[:20]} — pass strict=False to ignore, or fix "
            "the rename map"
        )
    return out


def logit_scale_from_torch(criterion_state_dict: Mapping[str, Any], *,
                           key: str = "logit_scale") -> torch.Tensor:
    """The reference criterion's scalar ``logit_scale``, fp32 ``[]``."""
    if key not in criterion_state_dict:
        raise KeyError(
            f"{key!r} not in criterion state_dict "
            f"(has {sorted(criterion_state_dict)})"
        )
    return _to_tensor(criterion_state_dict[key]).reshape(()).to(torch.float32)


def dual_encoder_params_from_torch(template, video_state_dict: Mapping[str, Any],
                                   text_state_dict: Mapping[str, Any],
                                   criterion_state_dict: Mapping[str, Any] | None = None,
                                   *, video_rename: Rename = None,
                                   text_rename: Rename = None,
                                   strict: bool = True) -> dict[str, torch.Tensor]:
    """The whole :class:`DualEncoder` state_dict (``video_tower.*``,
    ``text_tower.*``, ``logit_scale``) from per-tower torch state_dicts.

    ``template``: a ``DualEncoder`` or its state_dict (e.g.
    ``Trainer.init_state().model``).  Without a criterion state_dict the
    template's own ``logit_scale`` is kept.
    """
    entries = _entries(template)
    for k in entries:
        if k != "logit_scale" and k.split(".", 1)[0] not in _TOWERS:
            raise KeyError(
                f"template has an unexpected top-level entry {k!r}; "
                "dual_encoder_params_from_torch handles the standard "
                "{video_tower, text_tower, logit_scale} layout"
            )
    out = {}
    for tower, sd, rename in (("video_tower", video_state_dict, video_rename),
                              ("text_tower", text_state_dict, text_rename)):
        prefix = f"{tower}."
        sub = {k[len(prefix):]: v for k, v in entries.items()
               if k.startswith(prefix)}
        converted = params_from_torch(sub, sd, rename=rename, strict=strict)
        out.update({prefix + k: v for k, v in converted.items()})
    if criterion_state_dict is not None:
        out["logit_scale"] = logit_scale_from_torch(criterion_state_dict)
    elif "logit_scale" in entries:
        out["logit_scale"] = entries["logit_scale"].detach().cpu().clone()
    return out


def state_dict_from_params(params, *, rename: Rename = None
                           ) -> dict[str, np.ndarray]:
    """The REVERSE conversion: the port's parameters (a module or its
    state_dict) → a torch-layout state_dict of numpy arrays
    (``torch.save``-able after ``{k: torch.from_numpy(v) for ...}``), so
    migrating is a two-way door.  ``rename`` rewrites the keys afterward
    (a ``{port_prefix: torch_prefix}`` map or a callable); two keys
    renamed onto one raise.  bf16 entries upcast to fp32.  The round trip
    is exact: ``params_from_torch(t, state_dict_from_params(p))`` equals
    ``p``.
    """
    flat: dict[str, np.ndarray] = {}
    emitted_from: dict[str, str] = {}
    for key, value in _entries(params).items():
        rk = _apply_rename(key, rename)
        if rk in flat:
            raise ValueError(
                f"params {emitted_from[rk]!r} and {key!r} both map to the "
                f"torch key {rk!r}"
                + (" — fix the rename map" if rename is not None else "")
            )
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()  # numpy has no bfloat16
        flat[rk] = np.ascontiguousarray(value.numpy())
        emitted_from[rk] = key
    return flat
