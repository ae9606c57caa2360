"""A block of anchor rows against a set of candidates: the row-block
logsumexp of CrossCLR and its two backward kernels, three CUDA kernels for
Hopper beside their plain PyTorch versions, which the global-negative
losses of :mod:`..parallel` run on; and the one-device full CrossCLR loss
:func:`cross_clr_fused`, which takes the keep-mask branch of
:mod:`.fused_dual` instead, as the JAX package does on one device.

Counterpart of ``crossclr_tpu/ops/fused_global.py``.  For ``b_loc``
L2-normalized anchor rows ``a_r`` that are rows ``off .. off + b_loc`` of
a batch of ``B`` (``anchor_all``, ``other_all`` ``[B, D]``), scale
``s = 1/τ`` and negative weight ``w``::

    lse_r = log( Σ_j exp(s·a_r·o_j) + Σ_j exp(w·s·a_r·a_j) )

over the ``2B`` virtual candidates ``[inter ‖ w·intra]``, which never
reach device memory.  Two variants:

* unpruned (the released loss): the self intra logit ``j = off + r`` is
  ZEROED, its ``exp(0) = 1`` stays in the sum;
* pruned (full CrossCLR, keep masks ``[B]``): an inter column is kept
  where ``keep_inter | on_diag``, an intra column where ``keep_intra &
  ~on_diag``; an excluded logit is ``−1e9`` (:data:`MASKED`), whose exp
  is exactly 0 once a real logit has been seen, and which keeps the
  running max and the ``p⊙z`` products of the scale's gradient NaN-free
  (``0 · −1e9 = −0``, where ``0 · −inf`` would be NaN).  Every row keeps
  its positive, so a real logit always comes.

The kernels, in ``csrc/fused_global.cu``: ``rows_lse`` (``_rows_lse_kernel``),
``rows_bwd_rows`` (``_rows_bwd_rows_kernel``: d anchor_rows and the per-row
``Σ p⊙z`` from which ``d loss/d s`` is taken here, outside the kernel, as
``Σ / s``) and ``rows_bwd_cols`` (``_rows_bwd_cols_kernel``: d other_all
and d anchor_all, the candidates' gradients, which a data-parallel caller
reduce-scatters to their owners).  The bf16 builds (the ``default`` tier)
are tensor-core kernels built from the loss kernels' blocks
(``csrc/loss_mma.cuh``): ``rows_lse`` the dual forward's online
logsumexp in its rows form, ``rows_bwd_rows`` the anchor-gradient block in
its rows form and ``rows_bwd_cols`` in its cols form (the rows form
transposed).  Where ``b_loc`` leaves the card idle each splits its walked
tiles over more blocks whose fp32 partials a second kernel combines in a
fixed order, in a scratch buffer allocated here (its size asked of the
library once per shape and cached in ``fused_dual._plans``).  The fp32
builds are scalar kernels.  Each has its plain version here
(``*_plain``: the CPU path and the oracle the kernel is held against on
the card), a wrapper that launches it on CUDA tensors (``*_cuda``) and
counts the launch in :data:`launch_counts`, and a dispatcher that picks
by the tensors' device.  Nothing falls back: a CUDA tensor launches the
kernel or raises.

Not ported, because the CUDA kernels mask ragged edges and take the row
offset as an ``int``: ``_pad_lanes``, ``_pick_tiles`` /
``check_explicit_tiles`` and the ``interpret`` / ``tiles`` arguments; any
``b_loc``, ``B`` and ``D`` run, so :func:`rows_supported` is always true.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .fused_dual import (
    MASKED,
    TIERS,
    _check_f32,
    _cotangent,
    _fetch_cast,
    _plan_size,
    _ptr_of,
    _scratch,
    dual_lse_pair,
)

__all__ = [
    "cross_clr_fused",
    "fused_lse_rows",
    "launch_counts",
    "rows_supported",
]

KERNELS = ("rows_lse", "rows_bwd_rows", "rows_bwd_cols")
# launches of each CUDA kernel, counted where its wrapper launches it
launch_counts = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()

SOURCE = "fused_global.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _logits(anchor_rows, anchor_all, other_all, off: int, scale, neg_weight,
            keep_inter, keep_intra):
    """``(z_inter, z_intra, intra_live)`` ``[b_loc, B]`` fp32: the masked
    logits of both candidate blocks and where an intra logit is a live
    (differentiable) one.  bf16 operands widen exactly to fp32."""
    a, aa, oa = anchor_rows.float(), anchor_all.float(), other_all.float()
    rows = off + torch.arange(a.shape[0], device=a.device)[:, None]
    on_diag = rows == torch.arange(aa.shape[0], device=a.device)[None, :]
    z_inter = scale * (a @ oa.T)
    z_intra = (neg_weight * scale) * (a @ aa.T)
    if keep_inter is None:
        return z_inter, z_intra.masked_fill(on_diag, 0.0), ~on_diag
    z_inter = z_inter.masked_fill(~(keep_inter[None, :] | on_diag), MASKED)
    live = keep_intra[None, :] & ~on_diag
    return z_inter, z_intra.masked_fill(~live, MASKED), live


def rows_lse_plain(anchor_rows, anchor_all, other_all, off: int, scale,
                   neg_weight: float, keep_inter=None, keep_intra=None):
    """The rows forward: fp32 ``lse [b_loc, 1]``."""
    z_inter, z_intra, _ = _logits(anchor_rows, anchor_all, other_all, off,
                                  scale, neg_weight, keep_inter, keep_intra)
    return torch.logsumexp(torch.cat([z_inter, z_intra], dim=1), dim=1,
                           keepdim=True)


def _coefficients(anchor_rows, anchor_all, other_all, off, scale, lse, g,
                  neg_weight, keep_inter, keep_intra):
    """``p = g·exp(z_inter − lse)`` and ``q = g·exp(z_intra − lse)`` (0 where
    the intra logit is not live), with the masked logits."""
    z_inter, z_intra, live = _logits(anchor_rows, anchor_all, other_all, off,
                                     scale, neg_weight, keep_inter, keep_intra)
    p = g * torch.exp(z_inter - lse)
    q = (g * torch.exp(z_intra - lse)).masked_fill(~live, 0.0)
    return p, q, z_inter, z_intra


def rows_bwd_rows_plain(anchor_rows, anchor_all, other_all, off: int, scale,
                        lse, g, neg_weight: float, keep_inter=None,
                        keep_intra=None):
    """The rows backward: fp32 ``(d anchor_rows [b_loc, D], ds_rows
    [b_loc, 1])`` with ``ds_rows = Σ (p⊙z_inter + q⊙z_intra)``, ``s ·
    d loss / d s`` per row."""
    p, q, z_inter, z_intra = _coefficients(
        anchor_rows, anchor_all, other_all, off, scale, lse, g, neg_weight,
        keep_inter, keep_intra)
    d_rows = scale * (p @ other_all.float() + neg_weight * (q @ anchor_all.float()))
    ds_rows = (p * z_inter + q * z_intra).sum(dim=1, keepdim=True)
    return d_rows, ds_rows


def rows_bwd_cols_plain(anchor_rows, anchor_all, other_all, off: int, scale,
                        lse, g, neg_weight: float, keep_inter=None,
                        keep_intra=None):
    """The candidates' backward: fp32 ``(d other_all, d anchor_all)``
    ``[B, D]``."""
    p, q, _, _ = _coefficients(
        anchor_rows, anchor_all, other_all, off, scale, lse, g, neg_weight,
        keep_inter, keep_intra)
    a = anchor_rows.float()
    return scale * (p.T @ a), (neg_weight * scale) * (q.T @ a)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_ptr, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (dtype, anchor_rows, anchor_all, other_all, keep_inter, keep_intra, scale,
#  ..., b_loc, b, d, off, w, stream)
_SIGNATURES = {
    "crossclr_rows_lse": [_int, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                          _ptr, _int, _int, _int, _int, _float, _ptr],
    "crossclr_rows_bwd_rows": [_int, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                               _ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int,
                               _float, _ptr],
    "crossclr_rows_bwd_cols": [_int, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                               _ptr, _ptr, _ptr, _ptr, _int, _int, _int, _int,
                               _float, _ptr],
}
# (dtype, b_loc, B, D, pruned) -> floats of a kernel's scratch, or a negated
# cudaError_t
_SIZE_QUERIES = tuple(f"{name}_scratch" for name in _SIGNATURES)
_SIGNATURES.update((query, [_int] * 5) for query in _SIZE_QUERIES)


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library(SOURCE)
    if lib.crossclr_rows_lse.argtypes is None:
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong if name in _SIZE_QUERIES else _int
        lib.crossclr_rows_error_string.argtypes = [_int]
        lib.crossclr_rows_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(anchor_rows, anchor_all, other_all, off: int, keep_inter,
                    keep_intra, scale, name: str) -> None:
    feats = (anchor_rows, anchor_all, other_all)
    dev = anchor_rows.device
    if not all(x.is_cuda and x.device == dev for x in feats):
        raise ValueError(f"{name} takes its features as CUDA tensors on one device")
    if (any(x.dim() != 2 for x in feats) or anchor_all.shape != other_all.shape
            or anchor_rows.shape[1] != anchor_all.shape[1]
            or min(anchor_rows.shape) < 1 or anchor_all.shape[0] < 1):
        raise ValueError(
            f"{name} takes anchor_rows [b_loc, D] and anchor_all, other_all "
            f"[B, D], got {[tuple(x.shape) for x in feats]}"
        )
    if anchor_rows.dtype not in _DTYPE_CODES or any(x.dtype != anchor_rows.dtype
                                                    for x in feats):
        raise TypeError(
            f"{name} takes float32 or bfloat16 features of one dtype, got "
            f"{[x.dtype for x in feats]}"
        )
    if not all(x.is_contiguous() for x in feats):
        raise ValueError(f"{name} takes contiguous features")
    if not 0 <= off <= anchor_all.shape[0] - anchor_rows.shape[0]:
        raise ValueError(
            f"{name}: row offset {off} puts rows outside the {anchor_all.shape[0]} "
            f"candidates"
        )
    for mask, what in ((keep_inter, "keep_inter"), (keep_intra, "keep_intra")):
        if mask is not None and (mask.device != dev or mask.dtype != torch.bool
                                 or tuple(mask.shape) != (anchor_all.shape[0],)
                                 or not mask.is_contiguous()):
            raise ValueError(
                f"{what} must be a contiguous bool tensor of shape "
                f"({anchor_all.shape[0]},) on {dev}"
            )
    _check_f32(scale, (1,), dev, "scale")


def _launch(name: str, fn, *args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = _library().crossclr_rows_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")
    with _count_lock:
        launch_counts[name] += 1


def _split_scratch(lib, name: str, code: int, bl: int, b: int, d: int,
                   keep_inter, device):
    """The bf16 build's scratch for this shape (None where its plan does
    not split), of the size the library names."""
    return _scratch(_plan_size(lib, f"crossclr_{name}_scratch", name, code, bl, b,
                               d, int(keep_inter is not None), device=device,
                               error_string=lib.crossclr_rows_error_string),
                    device)


def rows_lse_cuda(anchor_rows, anchor_all, other_all, off: int, scale,
                  neg_weight: float, keep_inter=None, keep_intra=None):
    """Launch the rows forward; ``scale`` is a float32 ``[1]`` CUDA tensor
    read by the kernel (no host sync).  Returns fp32 ``lse [b_loc, 1]``.
    The bf16 build splits the candidates over more blocks where ``b_loc``
    leaves the card idle: each part's ``(m, l)`` per row goes to a scratch
    buffer allocated here."""
    _check_operands(anchor_rows, anchor_all, other_all, off, keep_inter,
                    keep_intra, scale, "rows_lse")
    (bl, d), b = anchor_rows.shape, anchor_all.shape[0]
    dev = anchor_rows.device
    lib = _library()
    code = _DTYPE_CODES[anchor_rows.dtype]
    part = _split_scratch(lib, "rows_lse", code, bl, b, d, keep_inter, dev)
    lse = torch.empty((bl, 1), device=dev, dtype=torch.float32)
    _launch("rows_lse", lib.crossclr_rows_lse, code, anchor_rows.data_ptr(),
            anchor_all.data_ptr(), other_all.data_ptr(), _ptr_of(keep_inter),
            _ptr_of(keep_intra), scale.data_ptr(), lse.data_ptr(), _ptr_of(part),
            bl, b, d, off, float(neg_weight), device=dev)
    return lse


def _check_row_vectors(lse, g, bl: int, device) -> None:
    _check_f32(lse, (bl, 1), device, "lse")
    _check_f32(g, (bl, 1), device, "g")


def rows_bwd_rows_cuda(anchor_rows, anchor_all, other_all, off: int, scale,
                       lse, g, neg_weight: float, keep_inter=None,
                       keep_intra=None):
    """Launch the rows backward; returns fp32 ``(d anchor_rows, ds_rows)``.
    The bf16 build splits the candidates over more blocks where ``b_loc``
    leaves the card idle: its fp32 partials go to a scratch buffer of the
    size the library names, allocated here."""
    _check_operands(anchor_rows, anchor_all, other_all, off, keep_inter,
                    keep_intra, scale, "rows_bwd_rows")
    (bl, d), b = anchor_rows.shape, anchor_all.shape[0]
    dev = anchor_rows.device
    _check_row_vectors(lse, g, bl, dev)
    lib = _library()
    code = _DTYPE_CODES[anchor_rows.dtype]
    part = _split_scratch(lib, "rows_bwd_rows", code, bl, b, d, keep_inter, dev)
    d_rows = torch.empty((bl, d), device=dev, dtype=torch.float32)
    ds_rows = torch.empty((bl, 1), device=dev, dtype=torch.float32)
    _launch("rows_bwd_rows", lib.crossclr_rows_bwd_rows, code,
            anchor_rows.data_ptr(), anchor_all.data_ptr(), other_all.data_ptr(),
            _ptr_of(keep_inter), _ptr_of(keep_intra), scale.data_ptr(),
            lse.data_ptr(), g.data_ptr(), d_rows.data_ptr(), ds_rows.data_ptr(),
            _ptr_of(part), bl, b, d, off, float(neg_weight), device=dev)
    return d_rows, ds_rows


def rows_bwd_cols_cuda(anchor_rows, anchor_all, other_all, off: int, scale,
                       lse, g, neg_weight: float, keep_inter=None,
                       keep_intra=None):
    """Launch the candidates' backward; returns fp32 ``(d other_all,
    d anchor_all)``.  The bf16 build splits the anchor rows over more
    blocks where ``B`` leaves the card idle: their fp32 partials go to a
    scratch buffer allocated here."""
    _check_operands(anchor_rows, anchor_all, other_all, off, keep_inter,
                    keep_intra, scale, "rows_bwd_cols")
    (bl, d), b = anchor_rows.shape, anchor_all.shape[0]
    dev = anchor_rows.device
    _check_row_vectors(lse, g, bl, dev)
    lib = _library()
    code = _DTYPE_CODES[anchor_rows.dtype]
    part = _split_scratch(lib, "rows_bwd_cols", code, bl, b, d, keep_inter, dev)
    d_other = torch.empty((b, d), device=dev, dtype=torch.float32)
    d_anchor = torch.empty_like(d_other)
    _launch("rows_bwd_cols", lib.crossclr_rows_bwd_cols, code,
            anchor_rows.data_ptr(), anchor_all.data_ptr(), other_all.data_ptr(),
            _ptr_of(keep_inter), _ptr_of(keep_intra), scale.data_ptr(),
            lse.data_ptr(), g.data_ptr(), d_other.data_ptr(), d_anchor.data_ptr(),
            _ptr_of(part), bl, b, d, off, float(neg_weight), device=dev)
    return d_other, d_anchor


# the route of each kernel follows the tensors' device
def rows_lse(*args, **kwargs):
    return (rows_lse_cuda if args[0].is_cuda else rows_lse_plain)(*args, **kwargs)


def rows_bwd_rows(*args, **kwargs):
    fn = rows_bwd_rows_cuda if args[0].is_cuda else rows_bwd_rows_plain
    return fn(*args, **kwargs)


def rows_bwd_cols(*args, **kwargs):
    fn = rows_bwd_cols_cuda if args[0].is_cuda else rows_bwd_cols_plain
    return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


class _FusedLseRows(torch.autograd.Function):
    """``lse [b_loc, 1]`` through the rows kernels; gradients flow to the
    three feature arrays and to the scale TENSOR ``[1]``.  When
    ``anchor_rows`` and ``anchor_all`` are one tensor, autograd adds their
    two gradients."""

    @staticmethod
    def forward(ctx, anchor_rows, anchor_all, other_all, scale, keep_inter,
                keep_intra, off: int, neg_weight: float, precision):
        ak = tuple(x.contiguous() for x in
                   _fetch_cast(precision, anchor_rows, anchor_all, other_all))
        masks = (keep_inter, keep_intra)
        lse = rows_lse(*ak, off, scale, neg_weight, *masks)
        ctx.save_for_backward(*ak, scale, lse, *masks)
        ctx.off, ctx.neg_weight = off, neg_weight
        ctx.dtypes = (anchor_rows.dtype, anchor_all.dtype, other_all.dtype)
        return lse

    @staticmethod
    def backward(ctx, g):
        *ak, scale, lse, keep_inter, keep_intra = ctx.saved_tensors
        args = (*ak, ctx.off, scale, lse, _cotangent(g), ctx.neg_weight,
                keep_inter, keep_intra)
        d_rows, ds_rows = rows_bwd_rows(*args)
        d_other, d_anchor = rows_bwd_cols(*args)
        # the kernel's rows sum Σ g·(p⊙z) = s · d loss / d s
        ds = ds_rows.sum().reshape(1) / scale
        rows_t, all_t, other_t = ctx.dtypes
        return (d_rows.to(rows_t), d_anchor.to(all_t), d_other.to(other_t), ds,
                None, None, None, None, None)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def rows_supported(b_local: int, b_global: int, d: int) -> bool:
    """Always true: the CUDA kernels mask ragged edges and hold no tile or
    VMEM budget (the JAX package's gate is a TPU tiling rule)."""
    del b_local, b_global, d
    return True


def fused_lse_rows(anchor_rows: torch.Tensor, anchor_all: torch.Tensor,
                   other_all: torch.Tensor, row_offset, *, temperature=0.03,
                   negative_weight: float = 0.8, precision: str | None = None,
                   keep_inter: torch.Tensor | None = None,
                   keep_intra: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row logsumexp ``[b_loc, 1]`` fp32 of the global-candidate
    CrossCLR direction for L2-normalized ``anchor_rows [b_loc, D]``, rows
    ``row_offset ..`` of the normalized ``anchor_all`` / ``other_all``
    ``[B, D]``.  ``row_offset`` is a Python int or a 0-d tensor;
    ``temperature`` a float or a tensor (learnable: its gradient is exact).
    ``keep_inter`` / ``keep_intra`` (both or neither): ``[B]`` bool masks
    of the pruned variant.  ``precision``: None / ``"highest"`` (fp32
    operands) or ``"default"`` / ``"bf16"`` (bf16 operands, fp32
    accumulation and gradients)."""
    if precision not in TIERS:
        raise ValueError(f"precision must be one of {TIERS}, got {precision!r}")
    if (keep_inter is None) != (keep_intra is None):
        raise ValueError("pass both keep masks or neither")
    dev = anchor_rows.device
    if isinstance(temperature, torch.Tensor):
        scale = (1.0 / temperature).float().reshape(1)
    else:
        scale = torch.full((1,), 1.0 / float(temperature), dtype=torch.float32,
                           device=dev)
    if keep_inter is not None:
        keep_inter = keep_inter.to(device=dev, dtype=torch.bool).contiguous()
        keep_intra = keep_intra.to(device=dev, dtype=torch.bool).contiguous()
    return _FusedLseRows.apply(anchor_rows, anchor_all, other_all, scale,
                               keep_inter, keep_intra, int(row_offset),
                               negative_weight, precision)


def cross_clr_fused(video_features: torch.Tensor, text_features: torch.Tensor,
                    video_inputs=None, text_inputs=None, *, temperature=0.03,
                    negative_weight: float = 0.8,
                    weight_temperature: float = 0.0035,
                    prune_percent: float = 0.10, weight_norm: str = "raw",
                    precision: str | None = None) -> torch.Tensor:
    """Drop-in fused equivalent of ``losses.cross_clr`` (the full paper
    loss).  Connectivity, the pruning quantile and the positive weights are
    plain PyTorch on ``[B]`` / ``[B, D]`` data; both directions' ``[B, 2B]``
    masked logsumexps run through the keep-mask branch of
    :func:`.fused_dual.dual_lse_pair`, as the JAX package routes it on one
    device: the sym kernels at a float τ inside their pruned gate, the dual
    kernels at a tensor τ (learnable) or a float outside it.  The JAX
    package falls back to its rows kernels past a TPU VMEM budget; the
    port has no such budget, so the rows kernels here serve only the
    global-negative losses of :mod:`..parallel`."""
    from ..losses.functional import (
        connectivity_keep_and_weights,
        connectivity_scores,
        l2_normalize,
    )

    if video_inputs is None:
        video_inputs = video_features
    if text_inputs is None:
        text_inputs = text_features
    v = l2_normalize(video_features.float(), dim=1)
    t = l2_normalize(text_features.float(), dim=1)
    weights = dict(prune_percent=prune_percent,
                   weight_temperature=weight_temperature, weight_norm=weight_norm)
    keep_v, w_v = connectivity_keep_and_weights(connectivity_scores(video_inputs),
                                                **weights)
    keep_t, w_t = connectivity_keep_and_weights(connectivity_scores(text_inputs),
                                                **weights)
    lse_v, lse_t = dual_lse_pair(v, t, temperature=temperature,
                                 negative_weight=negative_weight,
                                 precision=precision, keep_video=keep_v,
                                 keep_text=keep_t)
    pos = (v * t).sum(dim=1) / temperature
    return ((w_v * (lse_v[:, 0] - pos)).mean() + (w_t * (lse_t[:, 0] - pos)).mean()) / 2
