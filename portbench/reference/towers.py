"""The dual towers in plain float32, after ``models.encoders``.

Parameters are a ``{name: tensor}`` dict under the port's state_dict
names (``text_tower.block_0._MHA_0.query.weight``, weights ``[out,
in]``).  A transformer tower: ``input_proj``, plus ``pos_embed``, pre-norm
blocks (LayerNorm eps 1e-6, multi-head attention with scale
``1/sqrt(Dh)`` and key-padding mask, LayerNorm, dense → tanh-GELU →
dense, residual adds), a final LayerNorm, the mean over the valid
positions and ``output_proj``.  ``qk_grad=False`` stops the gradient at the
queries and keys of attention (a planted fault: the flash backward's dq
and dk left at nought).  An MLP tower: per block ``skip(h) +
fc2(gelu(fc1(h)))``, then a LayerNorm.  Every product goes through
``mm`` (``reference.precision``): no bf16 anywhere."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def _linear(p: dict, name: str, x: torch.Tensor, mm) -> torch.Tensor:
    shape = x.shape
    y = mm(x.reshape(-1, shape[-1]), p[f"{name}.weight"].t())
    return y.reshape(*shape[:-1], -1) + p[f"{name}.bias"]


def _ln(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"],
                        LN_EPS)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def _attention(p: dict, name: str, x, mask, heads: int, mm, qk_grad: bool):
    b, s, e = x.shape
    dh = e // heads
    q, k, v = (_linear(p, f"{name}.{w}", x, mm).view(b, s, heads, dh).transpose(1, 2)
               for w in ("query", "key", "value"))
    if not qk_grad:
        q, k = q.detach(), k.detach()
    logits = mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, None, :] == 0, float("-inf"))
    out = mm(torch.softmax(logits, dim=-1), v)
    return _linear(p, f"{name}.out", out.transpose(1, 2).reshape(b, s, e), mm)


def transformer(p: dict, prefix: str, cfg: dict, x, mask, mm, qk_grad: bool = True):
    x = x.float()
    s = x.shape[1]
    h = _linear(p, f"{prefix}input_proj", x, mm) + p[f"{prefix}pos_embed"][:s]
    for layer in range(cfg["num_layers"]):
        blk = f"{prefix}block_{layer}."
        h = h + _attention(p, blk + "_MHA_0", _ln(p, blk + "LayerNorm_0", h), mask,
                           cfg["num_heads"], mm, qk_grad)
        y = _ln(p, blk + "LayerNorm_1", h)
        h = h + _linear(p, blk + "Dense_1", _gelu(_linear(p, blk + "Dense_0", y, mm)), mm)
    h = _ln(p, f"{prefix}final_norm", h)
    if mask is None:
        pooled = h.mean(dim=1)
    else:
        w = mask.float()[:, :, None]
        pooled = (h * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
    return _linear(p, f"{prefix}output_proj", pooled, mm)


def mlp(p: dict, prefix: str, cfg: dict, x, mm):
    h = x.float()
    for block in range(max(cfg["num_layers"], 1)):
        sfx = "" if block == 0 else f"_{block}"
        skip = _linear(p, f"{prefix}skip{sfx}", h, mm)
        h = skip + _linear(p, f"{prefix}fc2{sfx}",
                           _gelu(_linear(p, f"{prefix}fc1{sfx}", h, mm)), mm)
    return _ln(p, f"{prefix}norm", h)


def encode(p: dict, config: dict, side: str, x, mask=None, mm=torch.matmul,
           qk_grad: bool = True):
    """The ``side`` tower's fp32 embeddings ``[B, E]`` of ``x``."""
    cfg = config[f"{side}_tower"]
    prefix = f"{side}_tower."
    if cfg["kind"] == "transformer":
        return transformer(p, prefix, cfg, x, mask, mm, qk_grad)
    return mlp(p, prefix, cfg, x, mm)
