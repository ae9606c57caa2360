"""Both directions' logsumexps of the CrossCLR-intra loss in one fused pass:
four CUDA kernels for Hopper beside their plain PyTorch versions.

Counterpart of ``crossclr_tpu/ops/fused_dual.py``.  For L2-normalized
``v, t [B, D]``, scale ``s = 1/τ`` and negative weight ``w``::

    lse_v[i] = log( Σ_j exp(s·v_i·t_j) + Σ_j exp(w·s·v_i·v_j) )
    lse_t[i] = log( Σ_j exp(s·t_i·v_j) + Σ_j exp(w·s·t_i·t_j) )

with the intra logit of ``j = i`` zeroed (its ``exp(0) = 1`` stays in the
sum, as in the released reference loss).  The pruned variant (full
CrossCLR, keep masks ``keep_video``, ``keep_text`` ``[B]``) prunes each
anchor's candidates by the CANDIDATE modality's mask: for video anchor
``i`` an inter column ``j`` is kept where ``keep_text[j] | j == i``, an
intra column where ``keep_video[j] & j != i``, and the text anchors mirror
it.  The self column is DROPPED there, not zeroed, and the positive is
always kept.  Two kernel pairs compute it, in ``csrc/fused_dual.cu``:

* ``sym`` (a static τ, ``_sym_fwd_kernel`` / ``_sym_bwd_kernel``): every
  logit is bounded by ``m0 = max(s, w·s, 0)``, so the forward sums
  ``exp(z − m0)`` with no running max and the backward uses the factored
  coefficients ``exp(z)·(g·e^{−lse})``; the keep masks enter as 0/1
  factors on the exps;
* ``dual`` (a tensor τ, or a float τ outside the sym gates;
  ``_dual_fwd_kernel`` / ``_dual_bwd_kernel``): an online max with a
  −1e30 floor, subtract-first coefficients ``g·exp(z − lse)``, and
  ``Σ coeff⊙z`` for the exact gradient of the scale; an excluded logit is
  ``−1e9`` (:data:`MASKED`) in the forward, and each role's term of a
  coefficient is 0 where its mask drops the pair.  The JAX package's
  ``factored`` dual backward is reached there only when a float τ passes
  the numerical gates but the sym kernels are refused by a VMEM or tile
  gate; the port has no such gate, so that float τ always takes sym.

The bf16 builds (the ``default`` tier) of all four are tensor-core kernels
(``csrc/loss_mma.cuh``): the sym forward sums ``exp2`` of each logit in
log2 units at the static shift, the dual forward keeps an online max in
log2 units; each backward runs the per-direction backward's block per
direction, factored (sym) or subtract-first with a ``Σ coeff⊙z`` partial
per block (dual), the keep masks as role selects on the coefficients.  The
sym backward's bf16 build runs a Hopper design where the features allow
it (``csrc/loss_wgmma.cuh``: TMA-fed warpgroup products, 128 anchor rows a
block), the same arithmetic issued as the card wants it.
Where ``B`` leaves the card idle their candidate tiles split over more
blocks whose fp32 partial sums (the dual forward's partial ``(m, l)``) a
second kernel adds in a fixed order, in a scratch buffer allocated here:
its size comes from the library once per (library, device, dtype, B, D,
pruned) and is cached in :data:`_plans`.  Every fp32 build runs scalar
fp32 FMAs.

Each kernel has its plain version here (``*_plain``: the CPU path and the
oracle the kernel is held against on the card; the plain versions assume
PyTorch's default ``torch.backends.cuda.matmul.allow_tf32 = False`` there),
a wrapper that launches it on CUDA tensors (``*_cuda``) and counts the
launch in :data:`launch_counts`, and a dispatcher that picks by the
tensors' device.  Nothing falls back: a CUDA tensor launches the kernel or
raises.

Kept from the JAX package: the gates ``_coeff_safe`` and the numerical part
of ``sym_supported``, with its pruned gate ``2·m0 ≤ 80``.  Not ported,
because the CUDA kernels mask ragged edges and hold no VMEM budget:
``_MAX_COL_ACC_BYTES``, ``_MAX_SYM_ACC_BYTES``, ``_pick_tiles``,
``_pick_square_tile``, ``_lane_block_ok``, ``_pad_lanes`` and the halved
row tile of the pruned dual kernels; any B and D run.  The full CrossCLR
loss (:func:`.fused_global.cross_clr_fused`) takes the pruned branch.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

__all__ = [
    "dual_lse_pair",
    "launch_counts",
    "route",
    "sym_supported",
]

KERNELS = ("sym_fwd", "sym_bwd", "dual_fwd", "dual_bwd")
# launches of each CUDA kernel, counted where its wrapper launches it, and
# ("sym_bwd_wgmma") those of the sym backward that took its Hopper design
launch_counts = {**dict.fromkeys(KERNELS, 0), "sym_bwd_wgmma": 0}
_count_lock = threading.Lock()

SOURCE = "fused_dual.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the pruned variants' excluded-candidate logit: its exp is exactly 0 once a
# real logit has been seen, and 0 · −1e9 = −0 where 0 · −inf would be NaN
MASKED = -1e9
# None / "highest": fp32 operands; "default" / "bf16": bf16 operands with
# fp32 accumulation ("bf16" is the JAX package's alias of "default")
TIERS = (None, "highest", "default", "bf16")


def _coeff_safe(b: int, scale: float, neg_weight: float) -> bool:
    """Gate for the factored backward forms, which compute ``exp(z)`` and
    ``exp(-lse)`` as separate factors: ``lse`` can reach
    ``m0 + log(2B + 1)``, and ``exp(-x)`` past ~87 leaves the normal fp32
    range.  The worst case must stay below 85 (the JAX package's gate,
    kept as it is)."""
    m0 = max(scale, neg_weight * scale, 0.0)
    return m0 + math.log(2 * b + 1) <= 85.0


def sym_supported(b: int, scale: float, neg_weight: float,
                  pruned: bool = False) -> bool:
    """The static-max kernels hold for ``0 < s ≤ 80``, ``0 ≤ w·s ≤ 80`` and
    :func:`_coeff_safe`; elsewhere the online-max kernels run.  Pruned rows
    have no zeroed-diagonal ``exp(−m0)`` floor, only the kept positive at
    ``exp(z_pos − m0) ≥ exp(−2·m0)``, so the pruned variant also needs
    ``2·m0 ≤ 80``."""
    if pruned and 2.0 * max(scale, neg_weight * scale, 0.0) > 80.0:
        return False
    return (
        0.0 < scale <= 80.0
        and 0.0 <= neg_weight * scale <= 80.0
        and _coeff_safe(b, scale, neg_weight)
    )


def route(b: int, temperature, neg_weight: float, pruned: bool = False) -> str:
    """The pair :func:`dual_lse_pair` runs for this ``temperature``:
    ``"sym"`` for a float τ inside :func:`sym_supported`, ``"dual"`` for
    a tensor τ (learnable) or a float τ outside the gates."""
    if isinstance(temperature, torch.Tensor):
        return "dual"
    scale = 1.0 / float(temperature)
    return "sym" if sym_supported(b, scale, neg_weight, pruned=pruned) else "dual"


def _fetch_cast(precision, *arrays):
    """bf16 operands for the ``default`` tier.  Applied inside the
    autograd Functions, so the feature gradients still leave in the
    features' own dtype (fp32)."""
    if precision in ("default", "bf16"):
        return tuple(a.to(torch.bfloat16) for a in arrays)
    return arrays


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` in fp32; bf16 operands widen exactly, so this is the
    bf16-operand, fp32-accumulation product of the ``default`` tier."""
    return a.float() @ b.float().T


def _eye(b: int, device) -> torch.Tensor:
    return torch.eye(b, dtype=torch.bool, device=device)


def _keeps(v, keep_video, keep_text):
    """The role masks of the pruned variant (None when unpruned), each
    ``[B, B]`` over ``z_vt`` or an intra matrix: ``(video anchors over text
    columns, text anchors over video rows, video intra, text intra)``."""
    if keep_video is None:
        return None
    eye = _eye(v.shape[0], v.device)
    kv, kt = keep_video.bool(), keep_text.bool()
    return (kt[None, :] | eye, kv[:, None] | eye, kv[None, :] & ~eye,
            kt[None, :] & ~eye)


def sym_fwd_plain(v, t, scale: float, neg_weight: float, keep_video=None,
                  keep_text=None):
    """The sym forward: ``m0 + log(Σ exp(z − m0))`` over both candidate
    blocks, the keep masks as 0/1 factors.  Returns ``(lse_v, lse_t)``,
    each fp32 ``[B, 1]``."""
    eye = _eye(v.shape[0], v.device)
    ws = neg_weight * scale
    m0 = max(scale, ws, 0.0)
    e_vt = torch.exp(scale * _dots(v, t) - m0)
    keeps = _keeps(v, keep_video, keep_text)
    if keeps is None:
        e_vv = torch.exp((ws * _dots(v, v)).masked_fill(eye, 0.0) - m0)
        e_tt = torch.exp((ws * _dots(t, t)).masked_fill(eye, 0.0) - m0)
        e_v, e_t = e_vt, e_vt
    else:
        k_v, k_t, k_vv, k_tt = keeps
        e_vv = torch.exp(ws * _dots(v, v) - m0) * k_vv
        e_tt = torch.exp(ws * _dots(t, t) - m0) * k_tt
        e_v, e_t = e_vt * k_v, e_vt * k_t
    lse_v = m0 + torch.log(e_v.sum(1, keepdim=True) + e_vv.sum(1, keepdim=True))
    lse_t = m0 + torch.log(e_t.sum(0)[:, None] + e_tt.sum(1, keepdim=True))
    return lse_v, lse_t


def _select(keep, x):
    """``x`` (broadcast) where ``keep`` (a role mask, or None for all),
    else 0."""
    return x if keep is None else torch.where(keep, x, 0.0)


def _tr(keep):
    return None if keep is None else keep.T


def sym_bwd_plain(v, t, lse_v, lse_t, g_v, g_t, scale: float,
                  neg_weight: float, keep_video=None, keep_text=None):
    """The sym backward: ``(dV, dT)`` fp32 ``[B, D]`` from the factored
    coefficients ``exp(z)·(g_r e^{−lse_r} + g_c e^{−lse_c})``, each role's
    factor 0 where its mask drops the pair, zero on the intra diagonal."""
    eye = _eye(v.shape[0], v.device)
    ws = neg_weight * scale
    k_v, k_t, k_vv, k_tt = _keeps(v, keep_video, keep_text) or (None,) * 4
    f_v = g_v * torch.exp(-lse_v)  # [B, 1]
    f_t = g_t * torch.exp(-lse_t)
    m = torch.exp(scale * _dots(v, t)) * (_select(k_v, f_v) + _select(k_t, f_t.T))
    q_v = torch.exp(ws * _dots(v, v)) * (_select(k_vv, f_v) + _select(_tr(k_vv), f_v.T))
    q_t = torch.exp(ws * _dots(t, t)) * (_select(k_tt, f_t) + _select(_tr(k_tt), f_t.T))
    q_v, q_t = q_v.masked_fill(eye, 0.0), q_t.masked_fill(eye, 0.0)
    vf, tf = v.float(), t.float()
    dv = scale * (m @ tf + neg_weight * (q_v @ vf))
    dt = scale * (m.T @ vf + neg_weight * (q_t @ tf))
    return dv, dt


def dual_fwd_plain(v, t, scale, neg_weight: float, keep_video=None,
                   keep_text=None):
    """The dual forward: a max-shifted logsumexp over both candidate blocks
    (``scale`` may be a tensor), an excluded logit :data:`MASKED`.  Returns
    ``(lse_v, lse_t)`` fp32 ``[B, 1]``."""
    eye = _eye(v.shape[0], v.device)
    z_vt = scale * _dots(v, t)
    z_vv = (neg_weight * scale) * _dots(v, v)
    z_tt = (neg_weight * scale) * _dots(t, t)
    keeps = _keeps(v, keep_video, keep_text)
    if keeps is None:
        z_v, z_t = z_vt, z_vt
        z_vv, z_tt = z_vv.masked_fill(eye, 0.0), z_tt.masked_fill(eye, 0.0)
    else:
        k_v, k_t, k_vv, k_tt = keeps
        z_v, z_t = z_vt.masked_fill(~k_v, MASKED), z_vt.masked_fill(~k_t, MASKED)
        z_vv, z_tt = z_vv.masked_fill(~k_vv, MASKED), z_tt.masked_fill(~k_tt, MASKED)
    lse_v = torch.logsumexp(torch.cat([z_v, z_vv], dim=1), dim=1, keepdim=True)
    lse_t = torch.logsumexp(torch.cat([z_t.T, z_tt], dim=1), dim=1, keepdim=True)
    return lse_v, lse_t


def dual_bwd_plain(v, t, scale, lse_v, lse_t, g_v, g_t, neg_weight: float,
                   keep_video=None, keep_text=None):
    """The dual backward: ``(dV, dT, ds_raw)`` from the subtract-first
    coefficients, each role's term 0 where its mask drops the pair, where
    ``ds_raw = Σ M⊙z_vt + ½(Σ Q_v⊙z_vv + Σ Q_t⊙z_tt)`` is ``scale · d loss /
    d scale``."""
    eye = _eye(v.shape[0], v.device)
    k_v, k_t, k_vv, k_tt = _keeps(v, keep_video, keep_text) or (None,) * 4

    def coeff(z, g_r, l_r, keep_r, g_c, l_c, keep_c):
        # the select never multiplies an overflowed exp of a dropped pair
        return _select(keep_r, g_r * torch.exp(z - l_r)) + _select(
            keep_c, g_c * torch.exp(z - l_c))

    z_vt = scale * _dots(v, t)
    z_vv = (neg_weight * scale) * _dots(v, v)
    z_tt = (neg_weight * scale) * _dots(t, t)
    m = coeff(z_vt, g_v, lse_v, k_v, g_t.T, lse_t.T, k_t)
    q_v = coeff(z_vv, g_v, lse_v, k_vv, g_v.T, lse_v.T, _tr(k_vv)).masked_fill(eye, 0.0)
    q_t = coeff(z_tt, g_t, lse_t, k_tt, g_t.T, lse_t.T, _tr(k_tt)).masked_fill(eye, 0.0)
    vf, tf = v.float(), t.float()
    dv = scale * (m @ tf + neg_weight * (q_v @ vf))
    dt = scale * (m.T @ vf + neg_weight * (q_t @ tf))
    ds_raw = (m * z_vt).sum() + 0.5 * ((q_v * z_vv).sum() + (q_t * z_tt).sum())
    return dv, dt, ds_raw.reshape(1)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_ptr, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (dtype, v, t, keep_v, keep_t, ..., n, d, ..., stream)
_SIGNATURES = {
    "crossclr_sym_fwd": [_int, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _int,
                         _int, _float, _float, _ptr],
    "crossclr_sym_bwd": [_int, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                         _ptr, _ptr, _ptr, _int, _int, _float, _float, _ptr],
    "crossclr_dual_fwd": [_int, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                          _int, _int, _float, _ptr],
    "crossclr_dual_bwd": [_int, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _ptr,
                          _ptr, _ptr, _ptr, _ptr, _ptr, _ptr, _int, _int,
                          _float, _ptr],
    # (dtype, B, D, pruned) -> floats of scratch, or a negated cudaError_t
    "crossclr_sym_fwd_scratch": [_int, _int, _int, _int],
    "crossclr_dual_fwd_scratch": [_int, _int, _int, _int],
    "crossclr_sym_bwd_scratch": [_int, _int, _int, _int],
    "crossclr_dual_bwd_scratch": [_int, _int, _int, _int],
    "crossclr_dual_bwd_partials": [_int, _int, _int, _int],
    # (dtype, v, t, B, D) -> 1 where crossclr_sym_bwd takes the Hopper design
    "crossclr_sym_bwd_wgmma": [_int, _ptr, _ptr, _int, _int],
}
_SIZE_QUERIES = ("crossclr_sym_fwd_scratch", "crossclr_dual_fwd_scratch",
                 "crossclr_sym_bwd_scratch", "crossclr_dual_bwd_scratch",
                 "crossclr_dual_bwd_partials")


def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library(SOURCE)
    if lib.crossclr_sym_fwd.argtypes is None:
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong if name in _SIZE_QUERIES else _int
        lib.crossclr_cuda_error_string.argtypes = [_int]
        lib.crossclr_cuda_error_string.restype = ctypes.c_char_p
    return lib


# (library, size query, device, the query's arguments: dtype code, shape,
# pruned) -> the size the query names: asked once per key, as the
# library's plan is
_plans: dict = {}


def _plan_size(lib, query: str, name: str, *args, device,
               error_string=None) -> int:
    """The size (in floats) that ``query`` of ``lib`` names for this call
    (``query(*args)``), from :data:`_plans`; a negative answer (a CUDA
    error, named by ``error_string``, by default the library's
    ``crossclr_cuda_error_string``) raises."""
    key = (lib, query, device, *args)
    size = _plans.get(key)
    if size is None:
        with torch.cuda.device(device):
            size = getattr(lib, query)(*args)
        if size < 0:
            msg = (error_string or lib.crossclr_cuda_error_string)(-size).decode()
            raise RuntimeError(f"{name} launch failed: {msg} (cudaError {-size})")
        _plans[key] = size
    return size


def _scratch(size: int, device):
    """A float32 scratch buffer of ``size`` values, or None for none."""
    return torch.empty(size, device=device, dtype=torch.float32) if size else None


def _ptr_of(x):
    return None if x is None else x.data_ptr()


def _check_features(v, t, name: str) -> None:
    if not (v.is_cuda and t.is_cuda) or v.device != t.device:
        raise ValueError(f"{name} takes v and t as CUDA tensors on one device")
    if v.dim() != 2 or v.shape != t.shape or v.shape[0] < 1 or v.shape[1] < 1:
        raise ValueError(
            f"{name} takes v, t of one shape [B, D], got {tuple(v.shape)} "
            f"and {tuple(t.shape)}"
        )
    if v.dtype not in _DTYPE_CODES or t.dtype != v.dtype:
        raise TypeError(
            f"{name} takes float32 or bfloat16 v, t of one dtype, got "
            f"{v.dtype}, {t.dtype}"
        )
    if not (v.is_contiguous() and t.is_contiguous()):
        raise ValueError(f"{name} takes contiguous v, t")


def _check_f32(x, shape, device, what: str) -> None:
    if (x.device != device or x.dtype != torch.float32
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous()):
        raise ValueError(
            f"{what} must be a contiguous float32 tensor of shape "
            f"{tuple(shape)} on {device}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device}"
        )


def _check_masks(keep_video, keep_text, b: int, device, name: str) -> None:
    """Both keep masks or neither; each a contiguous bool ``[B]`` on the
    features' device."""
    if (keep_video is None) != (keep_text is None):
        raise ValueError(f"{name}: pass both keep masks or neither")
    for mask, what in ((keep_video, "keep_video"), (keep_text, "keep_text")):
        if mask is not None and (mask.device != device or mask.dtype != torch.bool
                                 or tuple(mask.shape) != (b,)
                                 or not mask.is_contiguous()):
            raise ValueError(
                f"{what} must be a contiguous bool tensor of shape ({b},) on "
                f"{device}"
            )


def _mask_ptrs(keep_video, keep_text) -> tuple:
    if keep_video is None:
        return None, None
    return keep_video.data_ptr(), keep_text.data_ptr()


def _launch(name: str, fn, *args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        msg = _library().crossclr_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")
    with _count_lock:
        launch_counts[name] += 1


def sym_fwd_cuda(v, t, scale: float, neg_weight: float, keep_video=None,
                 keep_text=None):
    """Launch the sym forward on CUDA ``v, t [B, D]`` (pruned when given
    the bool keep masks ``[B]``); returns fp32 ``(lse_v, lse_t)``
    ``[B, 1]``."""
    _check_features(v, t, "sym_fwd")
    b, d = v.shape
    _check_masks(keep_video, keep_text, b, v.device, "sym_fwd")
    lib = _library()
    code = _DTYPE_CODES[v.dtype]
    part = _scratch(_plan_size(lib, "crossclr_sym_fwd_scratch", "sym_fwd", code,
                               b, d, int(keep_video is not None), device=v.device),
                    v.device)
    lse_v = torch.empty((b, 1), device=v.device, dtype=torch.float32)
    lse_t = torch.empty_like(lse_v)
    _launch("sym_fwd", lib.crossclr_sym_fwd, code, v.data_ptr(), t.data_ptr(),
            *_mask_ptrs(keep_video, keep_text), lse_v.data_ptr(),
            lse_t.data_ptr(), _ptr_of(part), b, d, float(scale),
            float(neg_weight), device=v.device)
    return lse_v, lse_t


def sym_bwd_cuda(v, t, lse_v, lse_t, g_v, g_t, scale: float, neg_weight: float,
                 keep_video=None, keep_text=None):
    """Launch the sym backward; returns fp32 ``(dV, dT)`` ``[B, D]``.  The
    bf16 build splits the candidates over more blocks where ``B`` leaves
    the card idle: its fp32 partial gradients go to a scratch buffer of
    the size the library names, allocated here.  A launch that took the
    bf16 build's Hopper design (the library says which) is also counted
    under ``"sym_bwd_wgmma"``."""
    _check_features(v, t, "sym_bwd")
    b, d = v.shape
    _check_masks(keep_video, keep_text, b, v.device, "sym_bwd")
    for x, what in ((lse_v, "lse_v"), (lse_t, "lse_t"), (g_v, "g_v"), (g_t, "g_t")):
        _check_f32(x, (b, 1), v.device, what)
    lib = _library()
    code = _DTYPE_CODES[v.dtype]
    part = _scratch(_plan_size(lib, "crossclr_sym_bwd_scratch", "sym_bwd", code,
                               b, d, int(keep_video is not None), device=v.device),
                    v.device)
    dv = torch.empty((b, d), device=v.device, dtype=torch.float32)
    dt = torch.empty_like(dv)
    _launch("sym_bwd", lib.crossclr_sym_bwd, code, v.data_ptr(), t.data_ptr(),
            *_mask_ptrs(keep_video, keep_text), lse_v.data_ptr(),
            lse_t.data_ptr(), g_v.data_ptr(), g_t.data_ptr(), dv.data_ptr(),
            dt.data_ptr(), _ptr_of(part), b, d, float(scale), float(neg_weight),
            device=v.device)
    if lib.crossclr_sym_bwd_wgmma(code, v.data_ptr(), t.data_ptr(), b, d):
        with _count_lock:
            launch_counts["sym_bwd_wgmma"] += 1
    return dv, dt


def dual_fwd_cuda(v, t, scale, neg_weight: float, keep_video=None,
                  keep_text=None):
    """Launch the dual forward; ``scale`` is a float32 ``[1]`` CUDA tensor,
    read by the kernel (no host sync).  Returns fp32 ``(lse_v, lse_t)``.
    The bf16 build splits the candidates over more blocks where ``B``
    leaves the card idle: each part's ``(m, l)`` per row goes to a scratch
    buffer of the size the library names, allocated here."""
    _check_features(v, t, "dual_fwd")
    _check_f32(scale, (1,), v.device, "scale")
    b, d = v.shape
    _check_masks(keep_video, keep_text, b, v.device, "dual_fwd")
    lib = _library()
    code = _DTYPE_CODES[v.dtype]
    part = _scratch(_plan_size(lib, "crossclr_dual_fwd_scratch", "dual_fwd", code,
                               b, d, int(keep_video is not None), device=v.device),
                    v.device)
    lse_v = torch.empty((b, 1), device=v.device, dtype=torch.float32)
    lse_t = torch.empty_like(lse_v)
    _launch("dual_fwd", lib.crossclr_dual_fwd, code, v.data_ptr(), t.data_ptr(),
            *_mask_ptrs(keep_video, keep_text), scale.data_ptr(),
            lse_v.data_ptr(), lse_t.data_ptr(), _ptr_of(part), b, d,
            float(neg_weight), device=v.device)
    return lse_v, lse_t


def dual_bwd_cuda(v, t, scale, lse_v, lse_t, g_v, g_t, neg_weight: float,
                  keep_video=None, keep_text=None):
    """Launch the dual backward; returns fp32 ``(dV, dT, ds_raw [1])``.
    One scratch buffer holds the per-block partials of ``ds_raw`` and,
    where the bf16 build splits the candidates, the partial gradients,
    each of the size the library names."""
    _check_features(v, t, "dual_bwd")
    b, d = v.shape
    _check_masks(keep_video, keep_text, b, v.device, "dual_bwd")
    _check_f32(scale, (1,), v.device, "scale")
    for x, what in ((lse_v, "lse_v"), (lse_t, "lse_t"), (g_v, "g_v"), (g_t, "g_t")):
        _check_f32(x, (b, 1), v.device, what)
    lib = _library()
    code = _DTYPE_CODES[v.dtype]
    pruned = keep_video is not None
    rows, partials = (_plan_size(lib, query, "dual_bwd", code, b, d, int(pruned),
                                 device=v.device)
                      for query in ("crossclr_dual_bwd_scratch",
                                    "crossclr_dual_bwd_partials"))
    scratch = torch.empty(partials + rows, device=v.device, dtype=torch.float32)
    dv = torch.empty((b, d), device=v.device, dtype=torch.float32)
    dt = torch.empty_like(dv)
    ds_raw = torch.empty(1, device=v.device, dtype=torch.float32)
    _launch("dual_bwd", lib.crossclr_dual_bwd, code, v.data_ptr(), t.data_ptr(),
            *_mask_ptrs(keep_video, keep_text), scale.data_ptr(), lse_v.data_ptr(),
            lse_t.data_ptr(), g_v.data_ptr(), g_t.data_ptr(), dv.data_ptr(),
            dt.data_ptr(), scratch[partials:].data_ptr() if rows else None,
            scratch.data_ptr(), ds_raw.data_ptr(), b, d, float(neg_weight),
            device=v.device)
    return dv, dt, ds_raw


# the route of each kernel follows the tensors' device
def sym_fwd(*args):
    return (sym_fwd_cuda if args[0].is_cuda else sym_fwd_plain)(*args)


def sym_bwd(*args):
    return (sym_bwd_cuda if args[0].is_cuda else sym_bwd_plain)(*args)


def dual_fwd(*args):
    return (dual_fwd_cuda if args[0].is_cuda else dual_fwd_plain)(*args)


def dual_bwd(*args):
    return (dual_bwd_cuda if args[0].is_cuda else dual_bwd_plain)(*args)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def _cotangent(g: torch.Tensor) -> torch.Tensor:
    return g.float().contiguous()


class _SymLsePair(torch.autograd.Function):
    """``(lse_v, lse_t)`` through the sym kernels at a static float scale;
    gradients flow to the features only (the bool keep masks of the pruned
    variant, or None, are constants)."""

    @staticmethod
    def forward(ctx, v, t, scale: float, neg_weight: float, precision,
                keep_video=None, keep_text=None):
        vk, tk = (x.contiguous() for x in _fetch_cast(precision, v, t))
        lse_v, lse_t = sym_fwd(vk, tk, scale, neg_weight, keep_video, keep_text)
        ctx.save_for_backward(vk, tk, lse_v, lse_t, keep_video, keep_text)
        ctx.scale, ctx.neg_weight = scale, neg_weight
        ctx.dtypes = (v.dtype, t.dtype)
        return lse_v, lse_t

    @staticmethod
    def backward(ctx, g_v, g_t):
        vk, tk, lse_v, lse_t, keep_video, keep_text = ctx.saved_tensors
        dv, dt = sym_bwd(vk, tk, lse_v, lse_t, _cotangent(g_v),
                         _cotangent(g_t), ctx.scale, ctx.neg_weight, keep_video,
                         keep_text)
        return (dv.to(ctx.dtypes[0]), dt.to(ctx.dtypes[1]), None, None, None,
                None, None)


class _DualLsePair(torch.autograd.Function):
    """``(lse_v, lse_t)`` through the dual kernels at a scale TENSOR ``[1]``;
    gradients flow to the features and to the scale (the bool keep masks of
    the pruned variant, or None, are constants)."""

    @staticmethod
    def forward(ctx, v, t, scale, neg_weight: float, precision, keep_video=None,
                keep_text=None):
        vk, tk = (x.contiguous() for x in _fetch_cast(precision, v, t))
        lse_v, lse_t = dual_fwd(vk, tk, scale, neg_weight, keep_video, keep_text)
        ctx.save_for_backward(vk, tk, scale, lse_v, lse_t, keep_video, keep_text)
        ctx.neg_weight = neg_weight
        ctx.dtypes = (v.dtype, t.dtype)
        return lse_v, lse_t

    @staticmethod
    def backward(ctx, g_v, g_t):
        vk, tk, scale, lse_v, lse_t, keep_video, keep_text = ctx.saved_tensors
        dv, dt, ds_raw = dual_bwd(vk, tk, scale, lse_v, lse_t, _cotangent(g_v),
                                  _cotangent(g_t), ctx.neg_weight, keep_video,
                                  keep_text)
        # the kernel sums Σ coeff⊙z = scale · d loss / d scale
        ds = ds_raw / scale
        return (dv.to(ctx.dtypes[0]), dt.to(ctx.dtypes[1]), ds, None, None,
                None, None)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def dual_lse_pair(v_norm: torch.Tensor, t_norm: torch.Tensor, *, temperature,
                  negative_weight: float = 0.8, precision: str | None = None,
                  keep_video=None, keep_text=None):
    """Both directions' ``[B, 1]`` fp32 logsumexps of L2-normalized
    ``v_norm, t_norm [B, D]``.

    A float ``temperature`` that passes :func:`sym_supported` takes the sym
    kernels; a tensor ``temperature`` (learnable τ), or a float outside
    the gates, takes the dual kernels, whose backward also returns the
    temperature's gradient.  ``precision``: None / ``"highest"`` (fp32
    operands) or ``"default"`` / ``"bf16"`` (bf16 operands, fp32
    accumulation; the gradients still leave in the features' dtype).
    ``keep_video`` / ``keep_text`` (both or neither): ``[B]`` bool keep
    masks of the pruned (full-CrossCLR) variant, as the module doc states;
    the sym route then also needs ``2·m0 ≤ 80``.
    """
    if (keep_video is None) != (keep_text is None):
        raise ValueError("pass both keep masks or neither")
    if precision not in TIERS:
        raise ValueError(f"precision must be one of {TIERS}, got {precision!r}")
    pruned = keep_video is not None
    if pruned:
        dev = v_norm.device
        keep_video = keep_video.to(device=dev, dtype=torch.bool).contiguous()
        keep_text = keep_text.to(device=dev, dtype=torch.bool).contiguous()
    masks = (keep_video, keep_text)
    if route(v_norm.shape[0], temperature, negative_weight, pruned) == "sym":
        return _SymLsePair.apply(v_norm, t_norm, 1.0 / float(temperature),
                                 negative_weight, precision, *masks)
    if isinstance(temperature, torch.Tensor):
        scale = (1.0 / temperature).float().reshape(1)
    else:
        scale = torch.full((1,), 1.0 / float(temperature), dtype=torch.float32,
                           device=v_norm.device)
    return _DualLsePair.apply(v_norm, t_norm, scale, negative_weight,
                              precision, *masks)
