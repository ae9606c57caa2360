"""The products of the reference: float32 with TF32 off, or, for the
control, float8 (e4m3) operands scaled per tensor, the nearest precision
below the bf16 the configurations state.  An fp8 product rounds both
operands of the forward and of both backward products, as an fp8
training recipe does."""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale for the tensor, back in fp32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = to_fp8(a), to_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = to_fp8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def matmul_for(precision: str):
    """``mm(a, b)`` of same-rank operands (batch dimensions equal)."""
    if precision == "fp32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown reference precision {precision!r}")
