"""Flash-attention forward: a CUDA kernel for Hopper beside its plain
PyTorch version.

Counterpart of ``crossclr_tpu/ops/flash_attention.py``.  The CUDA kernel
(``csrc/flash_fwd.cu``) replaces the TPU kernel ``_fwd_kernel`` for the
dropout-free forward: online-softmax attention with a key-padding mask,
emitting the output and the per-row logsumexp.  :func:`mha_reference` is
the plain version: the CPU path and the oracle the kernel is held against.

Layout: the public functions take ``[B, H, S, Dh]`` and a ``[B, S]`` key
mask (1 = valid), as the JAX package does.  The kernel reads the folded
``[B·H, S, Dh]`` view and indexes the mask by batch entry, so the mask is
never repeated per head.  Neither the TPU's 128-lane head-dim padding nor
its divisor-only block sizes carry over: the kernel masks the edges of any
S and any ``Dh <= 128``.

Not ported yet: attention-probability dropout (the hash mask of the JAX
kernels) and the backward kernels; both belong to training.
"""

from __future__ import annotations

import ctypes
import threading

import torch

__all__ = ["flash_attention", "flash_attention_fwd", "mha_reference"]

# crossclr_tpu _MAX_FLOOR: the running max's floor and a fully masked
# row's lse
MAX_FLOOR = -1e30
MAX_HEAD_DIM = 128

# launches of the CUDA kernel, counted where the wrapper launches it
launch_count = 0
_count_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mha_reference(q, k, v, mask=None, scale=None, return_lse=False):
    """Plain multi-head attention over ``[B, H, S, Dh]`` in fp32.

    ``mask``: ``[B, S]`` key padding (1 = valid); a masked logit is -inf
    and a query row with no valid key emits 0.  Returns the output in q's
    dtype and, with ``return_lse``, the fp32 logsumexp ``[B, H, S]`` (-1e30
    on rows with no valid key, as the kernel gives it).
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


def flash_attention_fwd(q, k, v, mask=None, scale=None):
    """Launch the CUDA kernel on ``[B, H, S, Dh]`` CUDA tensors.

    Returns ``(out [B, H, S, Dh] in q's dtype, lse [B, H, S] fp32)``.
    Raises on what the kernel does not take; a build or launch failure
    raises too.  Forward only: inputs must not require grad.
    """
    global launch_count
    b, h, s, dh = q.shape
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_fwd takes CUDA tensors")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"the kernel takes float32 or bfloat16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} is outside [1, {MAX_HEAD_DIM}]")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)
    ):
        raise RuntimeError(
            "the CUDA flash-attention backward is not ported yet: run the "
            "forward under torch.inference_mode() or torch.no_grad()"
        )
    device = q.device
    if k.device != device or v.device != device:
        raise ValueError("q, k, v must lie on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if mask is not None:
        if mask.shape != (b, s):
            raise ValueError(
                f"mask must be [B, S] = {(b, s)}, got {tuple(mask.shape)}"
            )
        mask = mask.to(device=device, dtype=torch.float32).contiguous()
    if scale is None:
        scale = dh**-0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), device=device, dtype=torch.float32)

    from ._build import load_library

    lib = _bind(load_library("flash_fwd.cu"))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.crossclr_flash_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, s, dh, h, float(scale), stream,
        )
    if err != 0:
        msg = lib.crossclr_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_fwd launch failed: {msg} (cudaError {err})")
    with _count_lock:
        launch_count += 1
    return out, lse


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.crossclr_flash_fwd
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [
            ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ptr,
        ]
        fn.restype = ctypes.c_int
        lib.crossclr_cuda_error_string.argtypes = [ctypes.c_int]
        lib.crossclr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q, k, v, mask=None, *, scale=None, dropout_rate=0.0,
                    return_lse=False):
    """Attention over ``[B, H, S, Dh]`` with an optional ``[B, S]`` key mask.

    The tensors' device decides the route: CUDA tensors launch the kernel,
    CPU tensors take :func:`mha_reference`.  Nothing is retried on another
    route.  Returns the output in q's dtype (and the fp32 lse ``[B, H, S]``
    with ``return_lse``).
    """
    if dropout_rate:
        raise NotImplementedError(
            "attention-probability dropout (the JAX kernels' hash mask) is "
            "not ported to crossclr_tpu_torch yet"
        )
    if q.is_cuda:
        out, lse = flash_attention_fwd(q, k, v, mask, scale)
        return (out, lse) if return_lse else out
    return mha_reference(q, k, v, mask, scale, return_lse)
