"""The bf16 lse_bwd kernel's operand rounding, held to the smoke's limit on the CPU.

The bf16 build of the per-direction backward (``lse_bwd``,
``csrc/fused_crossclr.cu``) runs its four products on tensor cores with
fp32 accumulators.  The logits A·Oᵀ and A·Aᵀ take the bf16 features as
they are (exact mma operands).  The coefficient tiles P and w·Q are formed
in fp32 registers and go into P·O and w·Q·A as a bf16 part and the bf16
rounding of the remainder, two products each ("split", about 16
significant bits).  ``lse_bwd_plain`` keeps them in fp32.

This test emulates the split on the plain algebra (``lse_bwd_plain``'s
steps, the same factored or subtract-first coefficients) and holds it to
the limit ``chip_smoke.py`` holds the kernel to, ``GRAD_BOUND`` (max
|error| within 5e-5 of the largest |entry|), at B in {64, 1000, 4096} x D
in {256, 384}, the smoke's ``DIRECTION_TAUS`` (factored at 0.03,
subtract-first at 0.01, s near 80 at 1/79), w in {0.8, 0}, both
directions; and at τ = 1/79, B = 4096 for features collapsed near one
direction, where lse passes ``SUBNORMAL_LSE`` (with w = 1) and the
factored coefficients meet a subnormal g·e^{−lse}.  The split lies no
farther from plain than one bf16 rounding of the coefficients; with no
rounding the emulation equals ``lse_bwd_plain`` exactly.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.ops import fused_crossclr as fc
from crossclr_tpu_torch.ops.fused_dual import _dots
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _smoke()
GRAD_BOUND = SMOKE.GRAD_BOUND
TAUS = SMOKE.DIRECTION_TAUS
NEG_WEIGHT = SMOKE.NEG_WEIGHT
SUBNORMAL_LSE = SMOKE.SUBNORMAL_LSE


def _operand(x: torch.Tensor, mode) -> torch.Tensor:
    """``x`` as a product's operand: rounded to bf16 once ("bf16"), or the
    kernel's bf16 hi part plus the bf16 rounding of the remainder ("split";
    the sum is exact in fp32)."""
    hi = x.to(torch.bfloat16).float()
    return hi if mode == "bf16" else hi + (x - hi).to(torch.bfloat16).float()


def coefficients(anchor, other, lse_a, lse_o, g_a, g_o, scale, w):
    """``lse_bwd_plain``'s coefficient tiles ``(P, Q)``, step for step."""
    z_ao = scale * _dots(anchor, other)
    z_aa = (w * scale) * _dots(anchor, anchor)
    if fc.factored(scale, w):
        f_a = g_a * torch.exp(-lse_a)
        f_o = g_o * torch.exp(-lse_o)
        p = torch.exp(z_ao) * (f_a + f_o.T)
        q = torch.exp(z_aa) * (f_a + f_a.T)
    else:
        p = g_a * torch.exp(z_ao - lse_a) + g_o.T * torch.exp(z_ao - lse_o.T)
        q = g_a * torch.exp(z_aa - lse_a) + g_a.T * torch.exp(z_aa - lse_a.T)
    return p, q.masked_fill(fc._self_logits(anchor, slice(None)), 0.0)


def product(anchor, other, p, q, scale, w, mode):
    """``s·(P·O + w·Q·A)``: as ``lse_bwd_plain`` (mode None), or with P and
    w·Q treated by :func:`_operand`, as the kernel takes them."""
    if mode is None:
        return scale * (p @ other.float() + w * (q @ anchor.float()))
    return scale * (_operand(p, mode) @ other.float()
                    + _operand(w * q, mode) @ anchor.float())


def _inputs(b, d, seed, dtype=torch.bfloat16, noise=0.0):
    """Unit features from numpy (collapsed near one direction u,
    ``normalize(u + noise·N(0, I))``, when ``noise`` > 0) in ``dtype``, and
    the loss's cotangents, 1/(2B) varied by up to ±50% per row."""
    rng = np.random.default_rng(seed)
    if noise:
        u = rng.standard_normal((1, d))
        u /= np.linalg.norm(u)
        v, t = (u + noise * rng.standard_normal((b, d)) for _ in range(2))
    else:
        v, t = (rng.standard_normal((b, d)) for _ in range(2))
    v, t = (torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))
            .float().to(dtype) for x in (v, t))
    g_v, g_t = (torch.from_numpy((0.5 + rng.random((b, 1))) / (2 * b)).float()
                for _ in range(2))
    return v, t, g_v, g_t


def _directions(v, t, g_v, g_t, scale, w):
    """Both directions' backward operands, with the plain lse."""
    lse_v = fc.lse_fwd_plain(v, t, scale, w)
    lse_t = fc.lse_fwd_plain(t, v, scale, w)
    return ((v, t, lse_v, lse_t, g_v, g_t), (t, v, lse_t, lse_v, g_t, g_v))


def _ratio(got, want) -> float:
    """max |error| over the largest |entry|, as chip_smoke.grad_err."""
    return ((got - want).abs().max() / want.abs().max()).item()


CASES = [(b, d, tau, w) for b in (64, 1000, 4096) for d in (256, 384)
         for tau in TAUS for w in (NEG_WEIGHT, 0.0)]


@pytest.mark.parametrize("b,d,tau,w", CASES)
def test_split_coefficients_stay_within_the_smoke_bound(b, d, tau, w):
    """Both directions: the split within GRAD_BOUND of ``lse_bwd_plain``,
    and no farther from it than one bf16 rounding of the coefficients."""
    scale = 1.0 / tau
    v, t, g_v, g_t = _inputs(b, d, seed=b + d)
    with torch.inference_mode():
        for a, o, *rest in _directions(v, t, g_v, g_t, scale, w):
            want = fc.lse_bwd_plain(a, o, *rest, scale, w)
            p, q = coefficients(a, o, *rest, scale, w)
            split = product(a, o, p, q, scale, w, "split")
            once = product(a, o, p, q, scale, w, "bf16")
            assert bool(torch.isfinite(split).all())
            assert _ratio(split, want) <= GRAD_BOUND
            assert (split - want).abs().max() <= (once - want).abs().max()


@pytest.mark.parametrize("b,d", [(64, 256), (1000, 384)])
@pytest.mark.parametrize("tau", TAUS)
def test_unrounded_emulation_equals_plain_exactly(b, d, tau):
    """With no rounding the emulation is ``lse_bwd_plain`` bit for bit (fp32
    features, both directions, both coefficient forms)."""
    scale = 1.0 / tau
    v, t, g_v, g_t = _inputs(b, d, seed=b + 1, dtype=torch.float32)
    with torch.inference_mode():
        for a, o, *rest in _directions(v, t, g_v, g_t, scale, NEG_WEIGHT):
            p, q = coefficients(a, o, *rest, scale, NEG_WEIGHT)
            got = product(a, o, p, q, scale, NEG_WEIGHT, None)
            assert torch.equal(got, fc.lse_bwd_plain(a, o, *rest, scale,
                                                     NEG_WEIGHT))


def test_split_holds_at_the_subnormal_edge():
    """τ = 1/79, B = 4096, D = 256, features collapsed near one direction
    (as a random-init tower's are): lse passes SUBNORMAL_LSE, so the
    factored coefficients take a subnormal g·e^{−lse}; the split stays
    within GRAD_BOUND of ``lse_bwd_plain`` in both directions.  w = 1: at
    B = 4096 the inter logits alone give lse <= 79 + ln 4096 = 87.32, short
    of the edge, so the intra block must count in full (w·s = 79 keeps the
    factored form)."""
    tau, b, d, w = 1.0 / 79, 4096, 256, 1.0
    scale = 1.0 / tau
    assert fc.factored(scale, w)
    v, t, g_v, g_t = _inputs(b, d, seed=11, noise=0.002)
    with torch.inference_mode():
        for a, o, *rest in _directions(v, t, g_v, g_t, scale, w):
            assert (rest[0] > SUBNORMAL_LSE).all(), rest[0].min()
            want = fc.lse_bwd_plain(a, o, *rest, scale, w)
            p, q = coefficients(a, o, *rest, scale, w)
            split = product(a, o, p, q, scale, w, "split")
            assert bool(torch.isfinite(split).all())
            assert _ratio(split, want) <= GRAD_BOUND
