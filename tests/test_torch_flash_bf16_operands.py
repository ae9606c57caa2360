"""The bf16 flash kernels' operand rounding, held to the smoke's limits on the CPU.

The bf16 builds of the forward, dk/dv and dq kernels run their products
on tensor cores with fp32 accumulators.  The operands that they form in
registers, P̂ (forward), P̂ᵀ and dSᵀ (dk/dv), dS (dq), go in as a bf16 part
and the bf16 rounding of the remainder, two products each ("split", about
16 significant bits).  The TPU kernels' default-tier ``jnp.dot`` rounds them
to bf16 once ("bf16").  One rounding of P̂ flips about 30% of the
forward's bf16 outputs by an ulp; the backward's delta = rowsum(dO∘out)
sums those flips, and at the transformer leg's B=1024 the smoke found dk
past its limit on the card.  So the kernels carry the split.  The plain
versions keep the operands in fp32.

This test emulates each treatment on the plain algebra (``mha_reference``'s
steps, ``_bwd_plain``) and holds the kernels' split against the unrounded
plain versions within the limits ``chip_smoke.py`` holds the kernels to
(``LIMITS[torch.bfloat16]`` for the forward, ``FLASH_BF16_TOL`` for dk, dv
and dq), at the transformer towers' head shape (H=8, S in {64, 96}, Dh=48;
B=4), ragged masks with one fully masked entry and dropout 0 and 0.1, and
through the backward's delta taken from the emulated forward; the split
lies no farther from plain than one rounding does; with no rounding
(the fp32 build) the emulation equals the plain versions exactly.  The
emulation rounds the normalized P̂; the forward kernel rounds
exp(s − running max) before dividing by the sum, a rounding of the same
relative size.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

port = importlib.import_module("crossclr_tpu_torch.ops.flash_attention")


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _smoke()
OUT_ATOL, OUT_RTOL, _ = SMOKE.LIMITS[torch.bfloat16]
GRAD_TOL = SMOKE.FLASH_BF16_TOL


def _operand(x: torch.Tensor, mode) -> torch.Tensor:
    """``x`` as a product's operand: unchanged (None), rounded to bf16 once
    ("bf16"), or the kernels' bf16 hi part plus the bf16 rounding of the
    remainder ("split"; the sum is exact in fp32)."""
    if mode is None:
        return x
    hi = x.to(torch.bfloat16).float()
    return hi if mode == "bf16" else hi + (x - hi).to(torch.bfloat16).float()


def emulated_forward(q, k, v, mask, mode, *, dropout_rate=0.0, dropout_seed=0):
    """``mha_reference``'s algebra step for step, with P̂ treated by
    :func:`_operand` before P̂·V."""
    scale = q.shape[-1] ** -0.5
    s = scale * torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    key_mask = mask.bool()[:, None, None, :]
    s = s.masked_fill(~key_mask, float("-inf"))
    any_valid = key_mask.any(dim=-1, keepdim=True)
    s = torch.where(any_valid, s, torch.zeros_like(s))
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        b, h, sq, sk = p.shape
        keep = port.dropout_keep_mask(b, h, sq, dropout_seed, dropout_rate,
                                      sk=sk)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)),
                        torch.zeros_like(p))
    out = torch.einsum("bhqk,bhkd->bhqd", _operand(p, mode), v.float())
    out = torch.where(any_valid, out, torch.zeros_like(out))
    return out.to(q.dtype)


def emulated_dkv(q, k, v, mask, lse, delta, dout, mode, **drop):
    """``flash_dkv_plain``'s algebra, with P̂ᵀ and dSᵀ treated by
    :func:`_operand` before their products."""
    p_hat, ds, scale = port._bwd_plain(q, k, v, mask, lse, delta, dout, None,
                                       drop)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", _operand(ds, mode), q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", _operand(p_hat, mode), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def emulated_dq(q, k, v, mask, lse, delta, dout, mode, **drop):
    """``flash_dq_plain``'s algebra, with dS treated by :func:`_operand`
    before dS·K."""
    _, ds, scale = port._bwd_plain(q, k, v, mask, lse, delta, dout, None, drop)
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", _operand(ds, mode), k.float())
    return dq.to(q.dtype)


def _operands(s: int, dtype, seed: int, rate: float):
    """q, k, v, dO [4, 8, S, 48] from numpy, a ragged mask with one fully
    masked entry, and the forward's lse and delta = rowsum(dO∘out) from the
    plain forward (out in the inputs' dtype, as the backward takes it)."""
    rng = np.random.default_rng(seed)
    b, h, dh = 4, 8, 48
    q, k, v, g = (torch.from_numpy(rng.standard_normal((b, h, s, dh))
                                   .astype(np.float32)).to(dtype)
                  for _ in range(4))
    lengths = rng.integers(1, s + 1, size=b)
    mask = torch.from_numpy(
        (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32))
    mask[-1] = 0.0
    drop = dict(dropout_rate=rate, dropout_seed=seed)
    out, lse = port.mha_reference(q, k, v, mask, return_lse=True, **drop)
    delta = (g.float() * out.float()).sum(dim=-1)
    return (q, k, v, mask, lse, delta, g), drop


def _outputs(ops, drop, mode):
    q, k, v, mask, *_ = ops
    with torch.inference_mode():
        if mode == "plain":
            return (port.mha_reference(q, k, v, mask, **drop),
                    *port.flash_dkv_plain(*ops, **drop))
        return (emulated_forward(q, k, v, mask, mode, **drop),
                *emulated_dkv(*ops, mode, **drop))


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


CASES = [(s, rate) for s in (64, 96) for rate in (0.0, 0.1)]


@pytest.mark.parametrize("s,rate", CASES)
def test_split_operands_stay_within_the_smoke_limits(s, rate):
    ops, drop = _operands(s, torch.bfloat16, seed=s + int(rate * 10), rate=rate)
    want = _outputs(ops, drop, "plain")
    got = _outputs(ops, drop, "split")
    assert all(a.dtype == torch.bfloat16 for a in got)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=OUT_ATOL,
                               rtol=OUT_RTOL)
    for a, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(a.float(), w.float(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)
    assert all(torch.all(a[-1] == 0) for a in got)  # the fully masked entry


@pytest.mark.parametrize("s,rate", CASES)
def test_split_lies_no_farther_from_plain_than_one_rounding(s, rate):
    ops, drop = _operands(s, torch.bfloat16, seed=s + 2, rate=rate)
    want = _outputs(ops, drop, "plain")
    split = _outputs(ops, drop, "split")
    once = _outputs(ops, drop, "bf16")
    for a, b, w in zip(split, once, want):
        assert _err(a, w) <= _err(b, w)
    # one rounding moves the forward (the split may land on plain's bits)
    assert _err(once[0], want[0]) > 0


@pytest.mark.parametrize("s,rate", CASES)
def test_split_forward_keeps_the_backward_delta_close_to_plain(s, rate):
    """The backward takes delta = rowsum(dO∘out) from the forward's bf16
    output.  One rounding of P̂ flips more than a tenth of those outputs by
    an ulp, the split less than a hundredth; dk and dv through the split
    forward's delta stay within the limits."""
    ops, drop = _operands(s, torch.bfloat16, seed=s + 3, rate=rate)
    q, k, v, mask, lse, _, g = ops
    want_out, *want = _outputs(ops, drop, "plain")
    flips = {mode: (emulated_forward(q, k, v, mask, mode, **drop) != want_out)
             .float().mean().item() for mode in ("bf16", "split")}
    assert flips["split"] < 0.01 and flips["bf16"] > 0.1, flips
    out = emulated_forward(q, k, v, mask, "split", **drop)
    delta = (g.float() * out.float()).sum(dim=-1)
    got = emulated_dkv(q, k, v, mask, lse, delta, g, "split", **drop)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("s,rate", CASES)
def test_unrounded_emulation_equals_the_plain_versions_exactly(s, rate):
    ops, drop = _operands(s, torch.float32, seed=s + 1, rate=rate)
    for a, w in zip(_outputs(ops, drop, None), _outputs(ops, drop, "plain")):
        assert torch.equal(a, w)


# dq (flash_dq_bf16_kernel): dS goes in split, as in dk/dv


@pytest.mark.parametrize("s,rate", CASES)
def test_split_dq_stays_within_the_smoke_limit(s, rate):
    """dq from the split dS within FLASH_BF16_TOL of the unrounded plain
    dq, on the plain forward's delta and through the split forward's delta
    (the kernels' path: the backward takes the forward kernel's output)."""
    ops, drop = _operands(s, torch.bfloat16, seed=s + 4 + int(rate * 10),
                          rate=rate)
    q, k, v, mask, lse, _, g = ops
    want = port.flash_dq_plain(*ops, **drop)
    out = emulated_forward(q, k, v, mask, "split", **drop)
    delta = (g.float() * out.float()).sum(dim=-1)
    for got in (emulated_dq(*ops, "split", **drop),
                emulated_dq(q, k, v, mask, lse, delta, g, "split", **drop)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)
        assert torch.all(got[-1] == 0)  # the fully masked entry


@pytest.mark.parametrize("s,rate", CASES)
def test_split_dq_lies_no_farther_from_plain_than_one_rounding(s, rate):
    ops, drop = _operands(s, torch.bfloat16, seed=s + 5, rate=rate)
    want = port.flash_dq_plain(*ops, **drop)
    split, once = (emulated_dq(*ops, mode, **drop) for mode in ("split", "bf16"))
    assert _err(split, want) <= _err(once, want)


@pytest.mark.parametrize("s,rate", CASES)
def test_unrounded_dq_emulation_equals_plain_exactly(s, rate):
    ops, drop = _operands(s, torch.float32, seed=s + 6, rate=rate)
    assert torch.equal(emulated_dq(*ops, None, **drop),
                       port.flash_dq_plain(*ops, **drop))
