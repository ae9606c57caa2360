"""Flash attention: CUDA kernels for Hopper beside their plain PyTorch
version.

Counterpart of ``crossclr_tpu/ops/flash_attention.py``.  Three CUDA
kernels replace its three TPU kernels:

* ``csrc/flash_fwd.cu`` (``_fwd_kernel``): online-softmax attention with a
  key-padding mask, emitting the output and the per-row logsumexp;
* ``csrc/flash_bwd.cu`` (``_dq_kernel`` and ``_dkv_kernel``): dq with the
  query tile resident, dk and dv with the key tile resident, both from the
  forward's lse and ``delta = rowsum(dO∘out)`` (a plain reduction here, as
  the JAX package computes it outside Pallas).

Each kernel has two builds: fp32 q, k, v run scalar fp32 FMAs; bf16 q, k,
v run the products on tensor cores (``mma.sync``, fp32 accumulators), the
operands formed in registers (P̂ in the forward, P̂ᵀ and dSᵀ in dk/dv, dS in
dq) carried as a bf16 part plus the bf16 rounding of the remainder.

:class:`_FlashAttention` is the autograd Function around them.
:func:`mha_reference` is the plain version: the CPU path (differentiated by
autograd) and the oracle the kernels are held against.
:func:`flash_dq_plain` and :func:`flash_dkv_plain` are the backward
kernels' plain versions on the kernels' own operands.

Attention-probability dropout is the JAX kernels' stateless hash mask of
the global ``(bh, query, key)`` indices (:func:`_hash_keep`,
:func:`dropout_keep_mask`), bit for bit: the same seed gives the same mask
in the kernels, in the plain version and in the JAX package.  Dropout
zeroes normalized probabilities and scales the survivors by 1/(1−r); the
softmax denominator keeps every term.  The seed goes through
:func:`fold_seed` (fp32 round, then mod 2^23), the offsets place a call's
tiles inside a longer sequence and a wider batch·head range (0 on one
device), and ``head_count`` / ``head_offset`` place a tensor-parallel
rank's heads among the global heads (``bh = b·head_count + head_offset +
h``; the call's own head count and 0 on one device).

Layout: the public functions take ``[B, H, S, Dh]`` and a ``[B, S]`` key
mask (1 = valid), as the JAX package does.  The kernels read the folded
``[B·H, S, Dh]`` view (``bh = b·H + h``) and index the mask by batch entry,
so the mask is never repeated per head.  Neither the TPU's 128-lane
head-dim padding nor its divisor-only block sizes carry over: the kernels
mask the edges of any S and any ``Dh <= 128``; the bf16 builds also take
latent attention's 192-wide queries and keys, with its 128-wide values
zero-padded to that width (:func:`flash_attention`).
"""

from __future__ import annotations

import ctypes
import threading

import torch

__all__ = [
    "dropout_keep_mask",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_fwd",
    "flash_dkv_cuda",
    "flash_dkv_plain",
    "flash_dq_cuda",
    "flash_dq_plain",
    "fold_seed",
    "launch_counts",
    "mha_reference",
]

# crossclr_tpu _MAX_FLOOR: the running max's floor and a fully masked
# row's lse
MAX_FLOOR = -1e30
MAX_HEAD_DIM = 128
# latent attention's query/key width: the bf16 builds take head dims in
# (MLA_HEAD_DIM - 16, MLA_HEAD_DIM] besides those up to MAX_HEAD_DIM
MLA_HEAD_DIM = 192

KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
# launches of each CUDA kernel, counted where its wrapper launches it
launch_counts = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# ---------------------------------------------------------------------------
# the dropout hash (crossclr_tpu/ops/flash_attention.py:126-198, 257-272,
# 599-625), in int64 arithmetic kept to 32 bits
# ---------------------------------------------------------------------------

_BH_PRIME = 0x27D4EB2F  # per-(batch·head) decorrelation term
_SEED_MOD = float(1 << 23)
_U32 = 0xFFFFFFFF


def fold_seed(seed) -> int:
    """A dropout seed canonicalized to [0, 2^23) through an fp32 carrier:
    rounded to fp32 first, then reduced mod 2^23 (exact in fp32), as the
    JAX package's ``fold_seed`` does, so any seed drops the same entries
    there and here."""
    s = torch.as_tensor(seed).to(torch.float64).to(torch.float32)
    return int(torch.remainder(s, _SEED_MOD).item())


def _f32(x: float) -> float:
    """``x`` rounded to fp32, as JAX's weak typing rounds a Python float
    that meets an fp32 array."""
    return float(torch.tensor(x, dtype=torch.float32))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x · c) mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit
    constant, in two 16-bit halves so no product leaves int64's range."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _U32


def _hash_keep(q_idx, k_idx, bh_term, seed: int, rate: float) -> torch.Tensor:
    """The keep mask of global (query, key) index grids: each index mixed on
    its own (xorshift-multiply), the words summed with the per-(batch·head)
    term and the folded seed, a murmur3 finalizer, the top 24 bits as a
    uniform in [0, 1), kept where it is ``>= rate`` (rate rounded to fp32).
    Integer tensors broadcast against each other."""
    hq = _mul32(q_idx & _U32, 0x9E3779B1)
    hq = _mul32(hq ^ (hq >> 15), 0x735A2D97)
    hk = _mul32(k_idx & _U32, 0x85EBCA77)
    hk = _mul32(hk ^ (hk >> 13), 0xC2B2AE3D)
    u = (hq + hk + bh_term + seed) & _U32
    u = _mul32(u ^ (u >> 16), 0x85EBCA6B)
    u = _mul32(u ^ (u >> 13), 0xC2B2AE35)
    u = u ^ (u >> 16)
    unif = (u >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return unif >= _f32(rate)


def dropout_keep_mask(b: int, h: int, s: int, seed, rate: float, sk=None,
                      q_offset: int = 0, k_offset: int = 0,
                      bh_offset: int = 0, head_count: int | None = None,
                      head_offset: int = 0, device=None) -> torch.Tensor:
    """The kernels' attention-dropout keep mask as a bool ``[B, H, S, Sk]``
    tensor.  ``q_offset``/``k_offset`` place the window inside a longer
    sequence and ``bh_offset`` these rows inside the global folded
    batch·head range; the ``h`` heads are heads ``head_offset ..`` of
    ``head_count`` (default ``h``): ``bh = bh_offset + b·head_count +
    head_offset + h``."""
    sk = s if sk is None else sk
    head_count = h if head_count is None else int(head_count)
    q_idx = (int(q_offset) + torch.arange(s, device=device))[:, None]
    k_idx = (int(k_offset) + torch.arange(sk, device=device))[None, :]
    bh = (torch.arange(b, device=device)[:, None] * head_count
          + torch.arange(h, device=device)[None, :]).reshape(-1)
    bh = bh + 1 + int(bh_offset) + int(head_offset)
    bh_term = _mul32(bh & _U32, _BH_PRIME)[:, None, None]
    keep = _hash_keep(q_idx[None], k_idx[None], bh_term, fold_seed(seed), rate)
    return keep.reshape(b, h, s, sk)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def mha_reference(q, k, v, mask=None, scale=None, return_lse=False, *,
                  dropout_rate=0.0, dropout_seed=0, q_offset=0, k_offset=0,
                  bh_offset=0, head_count=None, head_offset=0):
    """Plain multi-head attention over ``[B, H, S, Dh]`` in fp32.

    ``mask``: ``[B, S]`` key padding (1 = valid); a masked logit is -inf
    and a query row with no valid key emits 0.  ``dropout_rate`` > 0 drops
    the normalized probabilities of :func:`dropout_keep_mask` and scales
    the survivors by 1/(1−rate).  Returns the output in q's dtype and, with
    ``return_lse``, the fp32 logsumexp ``[B, H, S]`` (-1e30 on rows with no
    valid key, as the kernel gives it; dropout does not change it).
    Differentiable by autograd.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = scale * torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    any_valid = None
    if mask is not None:
        key_mask = mask.bool()[:, None, None, :]
        s = s.masked_fill(~key_mask, float("-inf"))
        any_valid = key_mask.any(dim=-1, keepdim=True)  # [B, 1, 1, 1]
        s = torch.where(any_valid, s, torch.zeros_like(s))
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        b, h, sq, sk = p.shape
        keep = dropout_keep_mask(b, h, sq, dropout_seed, dropout_rate, sk=sk,
                                 q_offset=q_offset, k_offset=k_offset,
                                 bh_offset=bh_offset, head_count=head_count,
                                 head_offset=head_offset, device=p.device)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)),
                        torch.zeros_like(p))
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    lse = torch.logsumexp(s, dim=-1) if return_lse else None
    if any_valid is not None:
        out = torch.where(any_valid, out, torch.zeros_like(out))
        if return_lse:
            lse = torch.where(
                any_valid[..., 0], lse, torch.full_like(lse, MAX_FLOOR)
            )
    out = out.to(q.dtype)
    return (out, lse) if return_lse else out


def _bwd_plain(q, k, v, mask, lse, delta, dout, scale, drop):
    """The backward kernels' shared algebra in fp32 from the forward's
    ``lse`` and ``delta``: ``P = exp(s − lse)`` (0 on a masked key and on a
    row with no valid key), ``P̂ = keep·P/(1−r)`` and
    ``dS = P∘(keep·dP/(1−r) − delta)``.  Returns ``(P̂, dS, scale)``."""
    rate, _, q_offset, k_offset, bh_offset, head_count, head_offset = \
        _dropout_words(q.shape[1], **drop)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = scale * torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if mask is not None:
        s = s.masked_fill(~mask.bool()[:, None, None, :], float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v.float())
    p_hat = p
    if rate > 0.0:
        b, h, sq, sk = p.shape
        keep = dropout_keep_mask(b, h, sq, drop["dropout_seed"], rate, sk=sk,
                                 q_offset=q_offset, k_offset=k_offset,
                                 bh_offset=bh_offset, head_count=head_count,
                                 head_offset=head_offset, device=p.device)
        inv = 1.0 / (1.0 - rate)
        dp = torch.where(keep, dp * inv, torch.zeros_like(dp))
        p_hat = torch.where(keep, p * inv, torch.zeros_like(p))
    return p_hat, p * (dp - delta[..., None]), scale


def flash_dq_plain(q, k, v, mask, lse, delta, dout, scale=None, **drop):
    """The plain version of :func:`flash_dq_cuda` on the same operands:
    ``scale · dS·K`` in fp32, returned in q's dtype."""
    _, ds, scale = _bwd_plain(q, k, v, mask, lse, delta, dout, scale, drop)
    return (scale * torch.einsum("bhqk,bhkd->bhqd", ds, k.float())).to(q.dtype)


def flash_dkv_plain(q, k, v, mask, lse, delta, dout, scale=None, **drop):
    """The plain version of :func:`flash_dkv_cuda` on the same operands:
    ``(scale · dSᵀ·Q, P̂ᵀ·dO)`` in fp32, returned in k's and v's dtype."""
    p_hat, ds, scale = _bwd_plain(q, k, v, mask, lse, delta, dout, scale, drop)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p_hat, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_int, _uint, _float = ctypes.c_int, ctypes.c_uint, ctypes.c_float
_ptr = ctypes.c_void_p
# rate, seed, offsets, head count and head offset
_DROPOUT_ARGS = [_float, _uint, _int, _int, _int, _int, _int]
_SIGNATURES = {
    "flash_fwd.cu": {
        "crossclr_flash_fwd": [_int, *[_ptr] * 6, _int, _int, _int, _int,
                               _float, *_DROPOUT_ARGS, _ptr],
    },
    "flash_bwd.cu": {
        "crossclr_flash_dq": [_int, *[_ptr] * 8, _int, _int, _int, _int,
                              _float, *_DROPOUT_ARGS, _ptr],
        "crossclr_flash_dkv": [_int, *[_ptr] * 9, _int, _int, _int, _int,
                               _float, *_DROPOUT_ARGS, _ptr],
    },
}


def _library(source: str) -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library(source)
    if lib.crossclr_cuda_error_string.restype is not ctypes.c_char_p:
        for name, argtypes in _SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _int
        lib.crossclr_cuda_error_string.argtypes = [_int]
        lib.crossclr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, source: str, fn_name: str, *args, device) -> None:
    lib = _library(source)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        msg = lib.crossclr_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")
    with _count_lock:
        launch_counts[name] += 1


def _dropout_words(heads: int, dropout_rate: float = 0.0, dropout_seed=0,
                   q_offset: int = 0, k_offset: int = 0, bh_offset: int = 0,
                   head_count: int | None = None,
                   head_offset: int = 0) -> tuple:
    """The kernels' trailing arguments for a call of ``heads`` heads:
    rate, folded seed, offsets, the global head count (``heads`` when
    None) and the first head's place among them."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    head_count = heads if head_count is None else int(head_count)
    if not 0 <= head_offset <= head_count - heads:
        raise ValueError(f"heads [{head_offset}, {head_offset + heads}) lie "
                         f"outside the {head_count} global heads")
    folded = fold_seed(dropout_seed) if dropout_rate > 0.0 else 0
    return (float(dropout_rate), folded, int(q_offset), int(k_offset),
            int(bh_offset), head_count, int(head_offset))


def _check_qkv(q, k, v, name: str) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one shape [B, H, S, Dh], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"the kernels take float32 or bfloat16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    dh = q.shape[-1]
    if not (1 <= dh <= MAX_HEAD_DIM or (
            q.dtype == torch.bfloat16 and MLA_HEAD_DIM - 16 < dh <= MLA_HEAD_DIM)):
        raise ValueError(
            f"head dim {dh} is outside [1, {MAX_HEAD_DIM}] (and, in bf16, "
            f"({MLA_HEAD_DIM - 16}, {MLA_HEAD_DIM}])"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")


def _mask_arg(mask, b: int, s: int, device):
    if mask is None:
        return None
    if mask.shape != (b, s):
        raise ValueError(f"mask must be [B, S] = {(b, s)}, got {tuple(mask.shape)}")
    return mask.to(device=device, dtype=torch.float32).contiguous()


def _ptr_or_none(x):
    return None if x is None else x.data_ptr()


def flash_attention_fwd(q, k, v, mask=None, scale=None, *, dropout_rate=0.0,
                        dropout_seed=0, q_offset=0, k_offset=0, bh_offset=0,
                        head_count=None, head_offset=0):
    """Launch the forward kernel on ``[B, H, S, Dh]`` CUDA tensors.

    Returns ``(out [B, H, S, Dh] in q's dtype, lse [B, H, S] fp32)``.
    Raises on what the kernel does not take; a build or launch failure
    raises too.
    """
    _check_qkv(q, k, v, "flash_attention_fwd")
    words = _dropout_words(q.shape[1], dropout_rate, dropout_seed, q_offset,
                           k_offset, bh_offset, head_count, head_offset)
    b, h, s, dh = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = _mask_arg(mask, b, s, q.device)
    scale = dh**-0.5 if scale is None else scale
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    _launch("flash_fwd", "flash_fwd.cu", "crossclr_flash_fwd",
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr_or_none(mask), out.data_ptr(), lse.data_ptr(), b * h, s, dh,
            h, float(scale), *words, device=q.device)
    return out, lse


def _bwd_args(q, k, v, mask, lse, delta, dout, scale, drop, name):
    """Check the backward's operands; returns the arguments the two C
    launchers share, before and after their outputs."""
    _check_qkv(q, k, v, name)
    b, h, s, dh = q.shape
    if dout.shape != q.shape or lse.shape != (b, h, s) or delta.shape != (b, h, s):
        raise ValueError(
            f"dout must be {tuple(q.shape)} and lse, delta {(b, h, s)}, got "
            f"{tuple(dout.shape)}, {tuple(lse.shape)}, {tuple(delta.shape)}"
        )
    tensors = (q, k, v, dout, lse, delta)
    if not all(t.is_contiguous() for t in tensors) or dout.dtype != q.dtype \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(
            f"{name} takes contiguous q, k, v, dout of one dtype and fp32 lse, "
            "delta"
        )
    words = _dropout_words(h, **drop)
    mask = _mask_arg(mask, b, s, q.device)
    scale = dh**-0.5 if scale is None else scale
    head = (_DTYPE_CODES[q.dtype], *(t.data_ptr() for t in tensors),
            _ptr_or_none(mask))
    return head, (b * h, s, dh, h, float(scale), *words)


def flash_dq_cuda(q, k, v, mask, lse, delta, dout, scale=None, **drop):
    """Launch the dq kernel: ``scale · (P∘(dP−delta))·K`` with P from
    ``lse`` and dP dropped as in the forward.  Every tensor contiguous on
    one CUDA device; returns dq in q's dtype."""
    head, tail = _bwd_args(q, k, v, mask, lse, delta, dout, scale, drop,
                           "flash_dq")
    dq = torch.empty_like(q)
    _launch("flash_dq", "flash_bwd.cu", "crossclr_flash_dq", *head,
            dq.data_ptr(), *tail, device=q.device)
    return dq


def flash_dkv_cuda(q, k, v, mask, lse, delta, dout, scale=None, **drop):
    """Launch the dk/dv kernel: ``dk = scale · dSᵀ·Q``, ``dv = P̂ᵀ·dO``.
    Operands as :func:`flash_dq_cuda`; returns ``(dk, dv)``."""
    head, tail = _bwd_args(q, k, v, mask, lse, delta, dout, scale, drop,
                           "flash_dkv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_dkv", "flash_bwd.cu", "crossclr_flash_dkv", *head,
            dk.data_ptr(), dv.data_ptr(), *tail, device=q.device)
    return dk, dv


def flash_attention_bwd(q, k, v, mask, out, lse, dout, scale=None, **drop):
    """The backward of the forward that gave ``out`` and ``lse`` (with the
    same mask, scale and dropout keywords): ``delta = rowsum(dO∘out)`` as a
    plain reduction, then the dq and dk/dv kernels.  Returns
    ``(dq, dk, dv)`` in the inputs' dtype."""
    _check_qkv(q, k, v, "flash_attention_bwd")
    if out.shape != q.shape:
        raise ValueError(f"out must be {tuple(q.shape)}, got {tuple(out.shape)}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dout = dout.to(q.dtype).contiguous()
    lse = lse.to(torch.float32).contiguous()
    delta = (dout.float() * out.float()).sum(dim=-1)  # [B, H, S]
    dq = flash_dq_cuda(q, k, v, mask, lse, delta, dout, scale, **drop)
    dk, dv = flash_dkv_cuda(q, k, v, mask, lse, delta, dout, scale, **drop)
    return dq, dk, dv


# kernel 1 as an operator of its own, so ``torch.export`` records a call of
# it (a ctypes launch reads the data pointers of the tensors it traces
# with, which a traced fake tensor does not have): the CUDA implementation
# launches the forward kernel, the CPU one is the plain version, the fake
# one gives the shapes, for a symbolic batch too
_FLASH_FWD_SCHEMA = (
    "(Tensor q, Tensor k, Tensor v, Tensor? mask, float scale, "
    "float dropout_rate, int dropout_seed, int q_offset, int k_offset, "
    "int bh_offset, int head_count, int head_offset) -> (Tensor, Tensor)"
)


@torch.library.custom_op("crossclr::flash_fwd", mutates_args=(),
                         device_types="cuda", schema=_FLASH_FWD_SCHEMA)
def _flash_fwd_op(q, k, v, mask, scale, dropout_rate, dropout_seed, q_offset,
                  k_offset, bh_offset, head_count, head_offset):
    return flash_attention_fwd(
        q, k, v, mask, scale, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed, q_offset=q_offset, k_offset=k_offset,
        bh_offset=bh_offset, head_count=head_count, head_offset=head_offset)


@_flash_fwd_op.register_kernel("cpu")
def _(q, k, v, mask, scale, dropout_rate, dropout_seed, q_offset, k_offset,
      bh_offset, head_count, head_offset):
    return mha_reference(
        q, k, v, mask, scale, True, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed, q_offset=q_offset, k_offset=k_offset,
        bh_offset=bh_offset, head_count=head_count, head_offset=head_offset)


@_flash_fwd_op.register_fake
def _(q, k, v, mask, scale, *_):
    # contiguous, as both implementations return them, whatever q's strides
    return q.new_empty(q.shape), q.new_empty(q.shape[:3], dtype=torch.float32)


def _flash_fwd(q, k, v, mask, scale, drop):
    """``(out, lse)`` of ``crossclr::flash_fwd``: the forward kernel on CUDA
    tensors, :func:`mha_reference` on CPU tensors; ``drop`` holds the
    keyword arguments of the dropout words."""
    words = _dropout_words(q.shape[1], **drop)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return torch.ops.crossclr.flash_fwd(q, k, v, mask, scale, *words)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (through ``crossclr::flash_fwd``), and the dq and
    dk/dv kernels as its backward.  ``drop`` holds the keyword arguments of
    the dropout words."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, drop):
        # saved once in the layout the kernels read
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        mask = _mask_arg(mask, q.shape[0], q.shape[2], q.device)
        out, lse = _flash_fwd(q, k, v, mask, scale, drop)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.scale, ctx.drop = scale, drop
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, out, lse, dout,
                                         ctx.scale, **ctx.drop)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, mask=None, *, scale=None, dropout_rate=0.0,
                    dropout_seed=0, q_offset=0, k_offset=0, bh_offset=0,
                    head_count=None, head_offset=0, return_lse=False):
    """Attention over ``[B, H, S, Dh]`` with an optional ``[B, S]`` key mask
    and attention-probability dropout; differentiable in q, k and v.  ``v``
    may be narrower than q and k (latent attention's 128-wide values under
    192-wide queries and keys): it is zero-padded to their width for the
    kernels, which take one head width, and the output's padded columns
    are dropped, so their gradient is nought.

    The tensors' device decides the route: CUDA tensors launch the kernels
    (the forward, and under autograd the dq and dk/dv kernels in the
    backward), CPU tensors take :func:`mha_reference`, under autograd
    directly.  Without autograd both go through ``crossclr::flash_fwd``,
    which is what ``torch.export`` captures.  Nothing is retried on
    another route.  Returns the output in q's dtype (and the fp32 lse
    ``[B, H, S]`` with ``return_lse``, not differentiable).
    """
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    drop = dict(dropout_rate=float(dropout_rate), dropout_seed=dropout_seed,
                q_offset=q_offset, k_offset=k_offset, bh_offset=bh_offset,
                head_count=head_count, head_offset=head_offset)
    dv = v.shape[-1]
    if dv < q.shape[-1]:
        v = torch.nn.functional.pad(v, (0, q.shape[-1] - dv))
        out = flash_attention(q, k, v, mask, scale=scale, return_lse=return_lse,
                              **drop)
        return (out[0][..., :dv], out[1]) if return_lse else out[..., :dv]
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if not q.is_cuda:
            return mha_reference(q, k, v, mask, scale, return_lse, **drop)
        out, lse = _FlashAttention.apply(q, k, v, mask, scale, drop)
    else:
        out, lse = _flash_fwd(q, k, v, mask, scale, drop)
    return (out, lse) if return_lse else out
