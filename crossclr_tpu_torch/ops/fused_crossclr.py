"""The fused CrossCLR-onlyIntraModality loss, and its per-direction kernel
pair: two CUDA kernels for Hopper beside their plain PyTorch versions.

Counterpart of ``crossclr_tpu/ops/fused_crossclr.py``: normalization and
the positive logits are plain PyTorch (autograd chains through them); the
``[B, 2B]`` logit matrices of both directions live only inside a
logsumexp pair whose autograd Function carries a hand-written backward.
:func:`route` picks the pair as the JAX package does:

* ``"per_direction"`` — a static τ past the JAX dual kernels' column
  accumulator budget, ``B · lane_pad(D) · 4 > 48 MiB``
  (``crossclr_tpu/ops/fused_dual.py:78-85``; B > 49,152 at D = 256), where
  the JAX package switches to its per-direction kernels
  (``_lse_fwd_kernel`` / ``_lse_bwd_kernel``).  The CUDA kernels hold no
  such scratch: the boundary is kept as the rule where the JAX package
  changes algorithm, not as a memory budget;
* otherwise the route of :func:`.fused_dual.dual_lse_pair` (``"sym"`` or
  ``"dual"``).  A tensor τ past the boundary stays on the dual kernels;
  the JAX package takes its jnp path there, the same function.

The per-direction pair, in ``csrc/fused_crossclr.cu``: ``lse_fwd`` (one
direction's online lse over ``[s·a·oᵀ ‖ w·s·a·aᵀ]``, the self intra logit
zeroed, not dropped) and ``lse_bwd`` (the gradient of ``g_a·lse_a +
g_o·lse_o`` with respect to the anchors, ``s·(P·O + w·Q·A)``; the
factored coefficients ``exp(z)·(g·e^{−lse})`` where ``0 < s < 80`` and
``0 ≤ w·s < 80``, subtract-first elsewhere — the JAX gate,
``fused_crossclr.py:327``, kept as it is).  Each kernel has two builds:
fp32 features run scalar fp32 FMAs; bf16 features run the products on
tensor cores (``mma.sync``, fp32 accumulators; ``csrc/loss_mma.cuh``).
The bf16 ``lse_fwd`` keeps each warp's anchor fragments in registers and
an online logsumexp in log2 units; the bf16 ``lse_bwd`` forms the
coefficients in fp32 with the scalar build's arithmetic and carries them
into P·O and Q·A as a bf16 part plus the bf16 rounding of the remainder.
Each kernel has its plain version here (``*_plain``: the CPU path and the
oracle the kernel is held against on the card), a wrapper that launches it
on CUDA tensors (``*_cuda``) and counts the launch in
:data:`launch_counts`, and a dispatcher that picks by the tensors' device.
Nothing falls back: a CUDA tensor launches the kernel or raises.

Not ported, because the CUDA kernels mask ragged edges: ``_pad_lanes``,
``_pick_tiles``, ``check_explicit_tiles`` and the ``(1, B)`` pre-transposed
column vectors of the backward (they only avoid a Mosaic relayout).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..losses.functional import l2_normalize
from . import fused_dual
from .fused_dual import (
    TIERS,
    _check_f32,
    _check_features,
    _cotangent,
    _dots,
    _fetch_cast,
    dual_lse_pair,
)

__all__ = [
    "cross_clr_intra_fused",
    "fused_lse_pair",
    "launch_counts",
    "route",
]

KERNELS = ("lse_fwd", "lse_bwd")
# launches of each CUDA kernel, counted where its wrapper launches it
launch_counts = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()

SOURCE = "fused_crossclr.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# where the JAX package leaves its pair for the per-direction kernels: the
# dual backward's [B, D] fp32 column accumulator over this many bytes, D
# padded to the 128-lane width (crossclr_tpu/ops/fused_dual.py:78-85)
_LANE = 128
_MAX_COL_ACC_BYTES = 48 * 1024 * 1024


def _lane_pad(d: int) -> int:
    return d if d % _LANE == 0 else d + _LANE - d % _LANE


def route(b: int, d: int, temperature, neg_weight: float) -> str:
    """The pair :func:`fused_lse_pair` runs: ``"per_direction"`` exactly
    when ``temperature`` is a float and ``b · lane_pad(d) · 4 > 48 MiB``,
    else :func:`.fused_dual.route` (``"sym"`` or ``"dual"``)."""
    if (not isinstance(temperature, torch.Tensor)
            and b * _lane_pad(max(d, 1)) * 4 > _MAX_COL_ACC_BYTES):
        return "per_direction"
    return fused_dual.route(b, temperature, neg_weight)


def factored(scale: float, neg_weight: float) -> bool:
    """The backward's factored form holds for ``0 < s < 80`` and
    ``0 ≤ w·s < 80`` (strict, unlike :func:`.fused_dual.sym_supported`):
    ``exp(z)`` stays finite.  It does not bound ``e^{−lse}``, which turns
    subnormal at ``s`` near 80 and large B; this build keeps subnormals."""
    return 0.0 < scale < 80.0 and 0.0 <= neg_weight * scale < 80.0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _self_logits(anchor, rows: slice):
    """``[len(rows), B]``: where each of the anchor ``rows`` meets itself
    in the intra block."""
    idx = torch.arange(anchor.shape[0], device=anchor.device)
    return idx[rows, None] == idx[None, :]


def lse_fwd_plain(anchor, other, scale: float, neg_weight: float,
                  rows: slice = slice(None)):
    """One direction's lse, fp32 ``[B, 1]``: a logsumexp over
    ``[s·a·oᵀ ‖ w·s·a·aᵀ]`` with the intra diagonal zeroed.  ``rows``
    limits it to those anchor rows (each still against every candidate),
    so a batch whose ``[B, 2B]`` logits do not fit is taken in blocks."""
    a = anchor[rows]
    inter = scale * _dots(a, other)
    intra = ((neg_weight * scale) * _dots(a, anchor)).masked_fill(
        _self_logits(anchor, rows), 0.0)
    return torch.logsumexp(torch.cat([inter, intra], dim=1), dim=1, keepdim=True)


def lse_bwd_plain(anchor, other, lse_a, lse_o, g_a, g_o, scale: float,
                  neg_weight: float, rows: slice = slice(None)):
    """The anchors' gradient of ``Σ g_a·lse_a + Σ g_o·lse_o``, fp32
    ``[B, D]``: ``s·(P·O + w·Q·A)``, the coefficients factored or
    subtract-first as :func:`factored` says, Q zero on the diagonal.
    ``rows``: only those anchor rows' gradient, as in :func:`lse_fwd_plain`."""
    a = anchor[rows]
    z_ao = scale * _dots(a, other)
    z_aa = (neg_weight * scale) * _dots(a, anchor)
    if factored(scale, neg_weight):
        f_a = g_a * torch.exp(-lse_a)  # [B, 1]
        f_o = g_o * torch.exp(-lse_o)
        p = torch.exp(z_ao) * (f_a[rows] + f_o.T)
        q = torch.exp(z_aa) * (f_a[rows] + f_a.T)
    else:
        p = (g_a[rows] * torch.exp(z_ao - lse_a[rows])
             + g_o.T * torch.exp(z_ao - lse_o.T))
        q = (g_a[rows] * torch.exp(z_aa - lse_a[rows])
             + g_a.T * torch.exp(z_aa - lse_a.T))
    q = q.masked_fill(_self_logits(anchor, rows), 0.0)
    return scale * (p @ other.float() + neg_weight * (q @ anchor.float()))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_ptr, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # (dtype, anchor, other, lse, n, d, scale, w, stream)
    "crossclr_direction_fwd": [_int, _ptr, _ptr, _ptr, _int, _int, _float,
                               _float, _ptr],
    # (dtype, anchor, other, lse_a, lse_o, g_a, g_o, grad, n, d, scale, w,
    #  factored, stream)
    "crossclr_direction_bwd": [_int, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                               _int, _int, _float, _float, _int, _ptr],
}


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library(SOURCE)
    if lib.crossclr_direction_fwd.argtypes is None:
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _int
        lib.crossclr_cuda_error_string.argtypes = [_int]
        lib.crossclr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, fn, *args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = _library().crossclr_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")
    with _count_lock:
        launch_counts[name] += 1


def lse_fwd_cuda(anchor, other, scale: float, neg_weight: float):
    """Launch ``lse_fwd`` on CUDA ``anchor, other [B, D]`` (fp32 or bf16,
    one dtype); returns the anchors' fp32 lse ``[B, 1]``."""
    _check_features(anchor, other, "lse_fwd")
    b, d = anchor.shape
    lse = torch.empty((b, 1), device=anchor.device, dtype=torch.float32)
    _launch("lse_fwd", _library().crossclr_direction_fwd,
            _DTYPE_CODES[anchor.dtype], anchor.data_ptr(), other.data_ptr(),
            lse.data_ptr(), b, d, float(scale), float(neg_weight),
            device=anchor.device)
    return lse


def lse_bwd_cuda(anchor, other, lse_a, lse_o, g_a, g_o, scale: float,
                 neg_weight: float):
    """Launch ``lse_bwd``; returns the anchors' fp32 gradient ``[B, D]``."""
    _check_features(anchor, other, "lse_bwd")
    b, d = anchor.shape
    for x, what in ((lse_a, "lse_a"), (lse_o, "lse_o"), (g_a, "g_a"), (g_o, "g_o")):
        _check_f32(x, (b, 1), anchor.device, what)
    grad = torch.empty((b, d), device=anchor.device, dtype=torch.float32)
    _launch("lse_bwd", _library().crossclr_direction_bwd,
            _DTYPE_CODES[anchor.dtype], anchor.data_ptr(), other.data_ptr(),
            lse_a.data_ptr(), lse_o.data_ptr(), g_a.data_ptr(), g_o.data_ptr(),
            grad.data_ptr(), b, d, float(scale), float(neg_weight),
            int(factored(scale, neg_weight)), device=anchor.device)
    return grad


# the route of each kernel follows the tensors' device
def lse_fwd(*args):
    return (lse_fwd_cuda if args[0].is_cuda else lse_fwd_plain)(*args)


def lse_bwd(*args):
    return (lse_bwd_cuda if args[0].is_cuda else lse_bwd_plain)(*args)


# ---------------------------------------------------------------------------
# autograd and entry points
# ---------------------------------------------------------------------------


class _LsePairDirections(torch.autograd.Function):
    """``(lse_v, lse_t)`` through the per-direction kernels at a static
    float scale: forward ``(v, t)`` then ``(t, v)``, backward the same with
    the roles and cotangents swapped; gradients flow to the features."""

    @staticmethod
    def forward(ctx, v, t, scale: float, neg_weight: float, precision):
        vk, tk = (x.contiguous() for x in _fetch_cast(precision, v, t))
        lse_v = lse_fwd(vk, tk, scale, neg_weight)
        lse_t = lse_fwd(tk, vk, scale, neg_weight)
        ctx.save_for_backward(vk, tk, lse_v, lse_t)
        ctx.scale, ctx.neg_weight = scale, neg_weight
        ctx.dtypes = (v.dtype, t.dtype)
        return lse_v, lse_t

    @staticmethod
    def backward(ctx, g_v, g_t):
        vk, tk, lse_v, lse_t = ctx.saved_tensors
        g_v, g_t = _cotangent(g_v), _cotangent(g_t)
        dv = lse_bwd(vk, tk, lse_v, lse_t, g_v, g_t, ctx.scale, ctx.neg_weight)
        dt = lse_bwd(tk, vk, lse_t, lse_v, g_t, g_v, ctx.scale, ctx.neg_weight)
        return dv.to(ctx.dtypes[0]), dt.to(ctx.dtypes[1]), None, None, None


def fused_lse_pair(v_norm: torch.Tensor, t_norm: torch.Tensor, *,
                   temperature=0.03, negative_weight: float = 0.8,
                   precision: str | None = None):
    """Per-row logsumexp over each direction's virtual ``[B, 2B]``
    candidates of L2-normalized features: ``(lse_v, lse_t)``, fp32
    ``[B, 1]``.  ``temperature`` may be a tensor (learnable τ); the pair
    is :func:`route`'s.  ``precision``: None / ``"highest"`` (fp32
    operands) or ``"default"`` / ``"bf16"`` (bf16 operands, fp32
    accumulation; the gradients still leave in the features' dtype)."""
    b, d = v_norm.shape
    if route(b, d, temperature, negative_weight) == "per_direction":
        if precision not in TIERS:
            raise ValueError(f"precision must be one of {TIERS}, got {precision!r}")
        return _LsePairDirections.apply(v_norm, t_norm, 1.0 / float(temperature),
                                        negative_weight, precision)
    return dual_lse_pair(v_norm, t_norm, temperature=temperature,
                         negative_weight=negative_weight, precision=precision)


def cross_clr_intra_fused(video_features: torch.Tensor,
                          text_features: torch.Tensor, *, temperature=0.03,
                          negative_weight: float = 0.8,
                          precision: str | None = None) -> torch.Tensor:
    """Drop-in fused equivalent of ``losses.cross_clr_intra``:
    ``(mean(lse_v − pos) + mean(lse_t − pos)) / 2`` with ``pos_i =
    ṽ_i·t̃_i / τ``, differentiable in the features and in a tensor τ."""
    v = l2_normalize(video_features.float(), dim=1)
    t = l2_normalize(text_features.float(), dim=1)
    lse_v, lse_t = fused_lse_pair(v, t, temperature=temperature,
                                  negative_weight=negative_weight,
                                  precision=precision)
    pos = (v * t).sum(dim=1, keepdim=True) / temperature
    return ((lse_v - pos).mean() + (lse_t - pos).mean()) / 2
