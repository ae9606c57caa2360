"""The bf16 dual backward's operand rounding, candidate split and Σ coeff⊙z order, held to the smoke's limits on the CPU.

The bf16 build of the dual backward (``dual_bwd``, ``csrc/fused_dual.cu``)
runs ``csrc/loss_mma.cuh``'s mma.sync block (``bwd_block``) in its
subtract-first form: the logits take the bf16 features as they are
(exact mma operands); the coefficients ``g_r·exp(z − lse_r) + g_c·exp(z −
lse_c)`` are formed in fp32, each role's term selected away where its
keep mask drops the pair; the tiles M and w·Q go into M·X and w·Q·A as a
bf16 part and the bf16 rounding of the remainder ("split"); where B leaves
the card idle the 64-row candidate tiles split into S parts summed in
index order, times s.  Each block also sums ``ds_weight·coef·z`` over its
logits (1 for the inter logits of a video-anchor block, 0 for a text-anchor
block's, ½ for every intra logit; feature chunk 0 only), one partial per
(part, direction, row tile), and ``sum_partials_kernel`` adds them: 256
lanes each summing every 256th partial, then a halving tree.

This test emulates that on ``dual_bwd_plain``'s algebra (its coefficient
step for step) and holds it to ``chip_smoke.py``'s limits, ``GRAD_BOUND``
for dV, dT (max |error| within 5e-5 of the largest |entry|) and
``DS_RTOL`` (1e-4) for Σ coeff⊙z, at B in {64, 1000, 1024} x D in {256,
384}, τ in {0.03, 0.0125}, unpruned and with keep masks, S as the kernel
picks it on an H100.  Unrounded and unsplit, dV and dT equal
``dual_bwd_plain`` bit for bit, and the block partials' Σ coeff⊙z lies
within 1e-6 of plain's (fp32 sums in another order).  At B = 128, D = 256
it is held to the JAX package's interpreted Pallas ``_dual_bwd`` (default
tier, subtract-first) within the same limits.

The ``requires_cuda`` cases hold the kernel against ``dual_bwd_plain`` on
the card (ragged B, unaligned D, D in {256, 384, 512}, unpruned and
pruned, random and collapsed features), check two launches bit for bit
and the split the library picks.
"""

import numpy as np
import pytest
import torch
from test_torch_sym_bf16_operands import GRAD_BOUND, TILE, _inputs, _ratio
from test_torch_sym_bf16_operands import emulate as emulate_grads
from test_torch_sym_bf16_operands import mma_parts_on_h100
from test_torch_sym_fwd_bf16_operands import _smoke, collapsed

from crossclr_tpu_torch.ops import fused_dual as fd
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

DS_RTOL = _smoke().DS_RTOL
LANES = 256  # sum_partials_kernel's threads


def coefficients(v, t, scale, lse_v, lse_t, g_v, g_t, w, keep=None):
    """``dual_bwd_plain``'s coefficient tiles, step for step, with their
    logits: ``(M, Q_v, Q_t)`` (Q zero on the diagonal) and ``(z_vt, z_vv,
    z_tt)``."""
    eye = torch.eye(v.shape[0], dtype=torch.bool)
    k_v, k_t, k_vv, k_tt = fd._keeps(v, *keep) if keep else (None,) * 4

    def coeff(z, g_r, l_r, keep_r, g_c, l_c, keep_c):
        return fd._select(keep_r, g_r * torch.exp(z - l_r)) + fd._select(
            keep_c, g_c * torch.exp(z - l_c))

    z_vt = scale * fd._dots(v, t)
    z_vv = (w * scale) * fd._dots(v, v)
    z_tt = (w * scale) * fd._dots(t, t)
    m = coeff(z_vt, g_v, lse_v, k_v, g_t.T, lse_t.T, k_t)
    q_v = coeff(z_vv, g_v, lse_v, k_vv, g_v.T, lse_v.T, fd._tr(k_vv)).masked_fill(eye, 0.0)
    q_t = coeff(z_tt, g_t, lse_t, k_tt, g_t.T, lse_t.T, fd._tr(k_tt)).masked_fill(eye, 0.0)
    return (m, q_v, q_t), (z_vt, z_vv, z_tt)


def block_partials(coeffs, logits, parts: int) -> torch.Tensor:
    """Σ ds_weight·coef·z of each block (part z, direction k, row tile x)
    at index (2 z + k)·T + x: the video-anchor blocks add their inter
    logits (the text-anchor blocks' are their transposes) and half their
    intra ones, the text-anchor blocks half their intra ones."""
    (m, q_v, q_t), (z_vt, z_vv, z_tt) = coeffs, logits
    b = m.shape[0]
    tiles = -(-b // TILE)
    video = m * z_vt + 0.5 * (q_v * z_vv)
    text = 0.5 * (q_t * z_tt)
    out = torch.zeros(parts * 2 * tiles)
    for z in range(parts):
        cols = slice(z * tiles // parts * TILE, (z + 1) * tiles // parts * TILE)
        for k, terms in enumerate((video, text)):
            for x in range(tiles):
                out[(2 * z + k) * tiles + x] = terms[x * TILE:(x + 1) * TILE, cols].sum()
    return out


def sum_partials(part: torch.Tensor) -> torch.Tensor:
    """``sum_partials_kernel``'s order in fp32: lane i sums partials i,
    i + 256, ... in order, then a halving tree over the lanes."""
    buf = torch.zeros(LANES)
    for i in range(0, part.numel(), LANES):
        chunk = part[i:i + LANES]
        buf[:chunk.numel()] += chunk
    half = LANES // 2
    while half:
        buf[:half] += buf[half:2 * half]
        half //= 2
    return buf[:1]


def _case(b, d, tau, pruned, seed, dtype=torch.bfloat16):
    v, t, keep, g_v, g_t = _inputs(b, d, seed, dtype)
    keep = keep if pruned else None
    scale = torch.full((1,), 1.0 / tau)
    lse = fd.dual_fwd_plain(v, t, scale, 0.8, *(keep or ()))
    want = fd.dual_bwd_plain(v, t, scale, *lse, g_v, g_t, 0.8, *(keep or ()))
    coeffs, logits = coefficients(v, t, scale, *lse, g_v, g_t, 0.8, keep)
    return v, t, scale, coeffs, logits, want


def _ds_rel(got, want) -> float:
    return ((got - want).abs() / want.abs()).item()


CASES = [(b, d, tau, pruned) for b in (64, 1000, 1024) for d in (256, 384)
         for tau in (0.03, 0.0125) for pruned in (False, True)]


@pytest.mark.parametrize("b,d,tau,pruned", CASES)
def test_split_coefficients_and_partials_stay_within_the_smoke_limits(b, d, tau, pruned):
    """Both directions at the card's split: dV, dT within GRAD_BOUND of
    ``dual_bwd_plain``, Σ coeff⊙z from the block partials in the kernels'
    order within DS_RTOL."""
    parts = mma_parts_on_h100(b, d)
    with torch.inference_mode():
        v, t, scale, coeffs, logits, want = _case(b, d, tau, pruned, seed=b + d)
        got = emulate_grads(v, t, *coeffs, scale, 0.8, "split", parts)
        for g_, w_ in zip(got, want[:2]):
            assert bool(torch.isfinite(g_).all())
            assert _ratio(g_, w_) <= GRAD_BOUND
        ds = sum_partials(block_partials(coeffs, logits, parts))
        assert _ds_rel(ds, want[2]) <= DS_RTOL


@pytest.mark.parametrize("b,d", [(64, 256), (1000, 384)])
@pytest.mark.parametrize("tau", [0.03, 0.0125])
@pytest.mark.parametrize("pruned", [False, True])
def test_unrounded_unsplit_emulation_equals_plain(b, d, tau, pruned):
    """Unrounded and in one part, dV and dT are ``dual_bwd_plain``'s bit
    for bit (fp32 features); Σ coeff⊙z from the block partials within 1e-6
    of plain's."""
    with torch.inference_mode():
        v, t, scale, coeffs, logits, want = _case(b, d, tau, pruned, seed=b + 1,
                                                  dtype=torch.float32)
        for got, w_ in zip(emulate_grads(v, t, *coeffs, scale, 0.8, None), want[:2]):
            assert torch.equal(got, w_)
        ds = sum_partials(block_partials(coeffs, logits, 1))
        assert _ds_rel(ds, want[2]) <= 1e-6


@pytest.mark.parametrize("parts", [2, 3, 4, 16])
def test_partials_in_parts_keep_the_sum(parts):
    """Σ coeff⊙z over 2·S·T block partials (B = 1000: 16 tiles, the last
    ragged) within 1e-6 of plain's, pruned, bf16 features."""
    with torch.inference_mode():
        v, t, scale, coeffs, logits, want = _case(1000, 256, 0.03, True, seed=5)
        ds = sum_partials(block_partials(coeffs, logits, parts))
        assert _ds_rel(ds, want[2]) <= 1e-6


@pytest.mark.parametrize("pruned", [False, True])
def test_split_matches_the_interpreted_pallas_dual_bwd(pruned):
    """B = 128, D = 256, τ = 0.03, w = 0.8: the emulation (split, the
    card's two parts) against the JAX package's ``_dual_bwd`` interpreted
    at the default tier in its subtract-first form (bf16 operands, 32-row
    tiles), both fed the plain lse: dV, dT within GRAD_BOUND of the Pallas
    gradients' largest entries, Σ coeff⊙z within DS_RTOL."""
    import jax.numpy as jnp

    from crossclr_tpu.ops.fused_dual import _dual_bwd

    b, d, tau, w = 128, 256, 0.03, 0.8
    assert mma_parts_on_h100(b, d) == 2
    v, t, keep, g_v, g_t = _inputs(b, d, seed=3)
    keep = keep if pruned else None
    scale = torch.full((1,), 1.0 / tau)
    lse = fd.dual_fwd_plain(v, t, scale, w, *(keep or ()))
    coeffs, logits = coefficients(v, t, scale, *lse, g_v, g_t, w, keep)
    got = emulate_grads(v, t, *coeffs, scale, w, "split", 2)
    ds = sum_partials(block_partials(coeffs, logits, 2))
    jkv, jkt = ((jnp.asarray(k.numpy(), jnp.float32) for k in keep) if pruned
                else (jnp.zeros((1,), jnp.float32),) * 2)
    want = _dual_bwd(jnp.asarray(v.float().numpy()), jnp.asarray(t.float().numpy()),
                     jnp.asarray(scale.numpy()).reshape(1, 1), jkv, jkt,
                     *(jnp.asarray(x.numpy()) for x in (*lse, g_v, g_t)), w, 32,
                     32, True, "default", False, pruned)
    for g_, w_ in zip(got, want[:2]):
        assert _ratio(g_, torch.from_numpy(np.array(w_))) <= GRAD_BOUND
    assert _ds_rel(ds, torch.from_numpy(np.array(want[2])).reshape(1)) <= DS_RTOL


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    return torch.device("cuda")


# ragged B (one tile and a ragged last tile, split and not), D below one
# 16-feature step, unaligned D (element loads), one 256-feature chunk, two
CUDA_NS, CUDA_DS = [1, 72, 1000], [8, 48, 100, 256, 384, 512]
# (τ, collapse noise): the legs' τ, the subtract-first form's own (past the
# pruned sym gate), and collapsed features near s = 80 (lse past 86, every
# Σ coeff⊙z term of one sign)
CUDA_TAUS = ((0.03, 0.0), (0.01, 0.0), (1.0 / 79, 0.005))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("keep", [None, 0.8, 0.0])
@pytest.mark.parametrize("d", CUDA_DS)
@pytest.mark.parametrize("n", CUDA_NS)
def test_cuda_bf16_dual_bwd_matches_plain(cuda, n, d, keep):
    """The bf16 dual backward against its plain version at each case of
    CUDA_TAUS (a tensor τ): dV, dT within GRAD_BOUND, Σ coeff⊙z within
    DS_RTOL (atol 1e-6, as tests/test_torch_fused_pruned.py); unpruned,
    keep masks about 80% kept, and masks that drop every candidate but the
    positive (keep 0); two launches bit for bit; one launch count per
    call."""
    v, t, _, g_v, g_t = _inputs(n, d, seed=n + d)
    g_v, g_t = g_v.to(cuda), g_t.to(cuda)
    masks = ()
    if keep is not None:
        rng = np.random.default_rng(n)
        masks = tuple(torch.from_numpy(rng.random(n) < keep).to(cuda) for _ in range(2))
    for tau, noise in CUDA_TAUS:
        a, b = (collapsed(x, noise, seed) if noise else x
                for x, seed in ((v, 1), (t, 2)))
        a, b = a.to(cuda), b.to(cuda)
        scale = torch.full((1,), 1.0 / tau, device=cuda)
        lse = fd.dual_fwd_plain(a, b, scale, 0.8, *masks)
        args = (a, b, scale, *lse, g_v, g_t, 0.8, *masks)
        before = fd.launch_counts["dual_bwd"]
        got = fd.dual_bwd_cuda(*args)
        want = fd.dual_bwd_plain(*args)
        for g_, w_ in zip(got[:2], want[:2]):
            assert bool(torch.isfinite(g_).all())
            assert _ratio(g_.cpu(), w_.cpu()) <= GRAD_BOUND
        torch.testing.assert_close(got[2], want[2], rtol=DS_RTOL, atol=1e-6)
        again = fd.dual_bwd_cuda(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        assert fd.launch_counts["dual_bwd"] - before == 2


@pytest.mark.requires_cuda
def test_cuda_dual_bwd_split_follows_the_plan(cuda):
    """On the H100's 132 SMs the library's scratch and partial counts name
    the split this file emulates (the mma.sync block's); the fp32 build
    keeps one partial per (direction, row tile) and needs no scratch."""
    if torch.cuda.get_device_properties(cuda).multi_processor_count != 132:
        pytest.skip("the emulated split is the H100's (132 SMs)")
    lib = fd._library()
    for n, d in ((1, 256), (1000, 256), (1024, 384), (4096, 512), (65536, 256)):
        parts, tiles = mma_parts_on_h100(n, d), -(-n // TILE)
        assert lib.crossclr_dual_bwd_scratch(1, n, d, 0) == (
            2 * n * d * parts if parts > 1 else 0)
        assert lib.crossclr_dual_bwd_partials(1, n, d, 0) == 2 * parts * tiles
    assert lib.crossclr_dual_bwd_scratch(0, 1000, 256, 0) == 0
    assert lib.crossclr_dual_bwd_partials(0, 1000, 256, 0) == 2 * 16
