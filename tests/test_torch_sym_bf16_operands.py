"""The bf16 sym backward's operand rounding and candidate split, held to the smoke's limit on the CPU.

The bf16 build of the sym backward (``sym_bwd``, ``csrc/fused_dual.cu``)
runs each direction in its Hopper design (``csrc/loss_wgmma.cuh``: blocks
of 128 anchor rows, one an SM, candidate tiles of 128 rows where D <= 256
unpruned, else of 64) where D % 8 == 0 and D <= 384, else as the
per-direction backward's tensor-core block (``csrc/loss_mma.cuh``, tiles of
64): the logits take the bf16 features as they are (exact operands), the
Hopper design in one accumulator over the whole depth, the other in
16-feature steps added in fp32; the coefficient tiles M and w·Q are formed
in fp32 with the keep masks as role selects and go into M·X and w·Q·A as a
bf16 part and the bf16 rounding of the remainder ("split", about 16
significant bits), each candidate tile's product from zero and added in
fp32 in both designs; and where B leaves the card idle the candidate tiles
split into S parts (part z takes tiles [z·T/S, (z+1)·T/S)), each part's
fp32 sum written apart and the parts added in index order, times s.
``sym_bwd_plain`` keeps the coefficients in fp32 and sums in one product.

This test emulates that on the plain algebra (``sym_bwd_plain``'s steps)
and holds it to the limit ``chip_smoke.py`` holds the kernel to,
``GRAD_BOUND`` (max |error| within 5e-5 of the largest |entry|), at B in
{64, 1000, 1024} x D in {256, 384}, τ in {0.03, 0.05, 0.0125}, w in {0.8,
0}, unpruned and with keep masks, S as the kernel picks it on an H100; the
split lies no farther from plain than one bf16 rounding of the
coefficients.  With the logits summed as the Hopper design orders them
(one fp32 running sum over the depth, 16 features a step) the split stays
within the same limit.  Unrounded and unsplit, the emulation equals
``sym_bwd_plain`` bit for bit; split into S parts it stays within 1e-6 of
its largest entry for S in {2, 3, 4, 5, 16}.  At B = 128, D = 256 it is
held to the JAX package's interpreted Pallas ``_sym_bwd`` (default tier:
bf16 operands, fp32 coefficients) within ``GRAD_BOUND``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.ops import fused_dual as fd
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


GRAD_BOUND = _smoke().GRAD_BOUND
TILE = 64  # candidate rows per tile of the mma.sync block
H100_SMS = 132


def wgmma_takes(d: int) -> bool:
    """Whether the Hopper design runs at this feature count."""
    return d % 8 == 0 and d <= 384


def tile_on_h100(d: int, pruned: bool = False) -> int:
    """Candidate rows per tile: the Hopper design's 128 up to D = 256
    unpruned (64 beyond, and pruned), the mma.sync block's 64."""
    return 128 if wgmma_takes(d) and d <= 256 and not pruned else TILE


def _operand(x: torch.Tensor, mode) -> torch.Tensor:
    """``x`` as a product's operand: unrounded (None), rounded to bf16 once
    ("bf16"), or the kernel's bf16 hi part plus the bf16 rounding of the
    remainder ("split"; the sum is exact in fp32)."""
    if mode is None:
        return x
    hi = x.to(torch.bfloat16).float()
    return hi if mode == "bf16" else hi + (x - hi).to(torch.bfloat16).float()


def split_parts(tiles: int, blocks: int, slots: int) -> int:
    """``loss_mma.cuh``'s split_parts: S = 1 where the blocks fill the
    slots, else the S up to ceil(slots / blocks) (and the tiles) whose
    waves x tiles per part is least, the smallest of a tie."""
    if blocks >= slots:
        return 1
    best, best_cost = 1, tiles
    for s in range(2, min(tiles, -(-slots // blocks)) + 1):
        cost = -(-blocks * s // slots) * -(-tiles // s)
        if cost < best_cost:
            best, best_cost = s, cost
    return best


def mma_parts_on_h100(b: int, d: int) -> int:
    """The split of the mma.sync block (the dual backward's, and the sym
    backward's where its Hopper design does not run) on 132 SMs: one block
    of 64 rows per SM at each feature width but the narrowest (two)."""
    width = 32 if d <= 64 else 64 if d <= 128 else 128
    tiles = -(-b // TILE)
    return split_parts(tiles, 2 * -(-d // (2 * width)) * tiles,
                       H100_SMS * (2 if width == 32 else 1))


def parts_on_h100(b: int, d: int, pruned: bool = False) -> int:
    """The split the sym backward takes on 132 SMs: for its Hopper design
    (D % 8 == 0, D <= 384) one block of 128 anchor rows and 256 gradient
    features per SM over tiles of tile_on_h100 rows; else the mma.sync
    block's."""
    if not wgmma_takes(d):
        return mma_parts_on_h100(b, d)
    return split_parts(-(-b // tile_on_h100(d, pruned)), 2 * -(-d // 256) * -(-b // 128),
                       H100_SMS)


def chained_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` as the Hopper design orders the logits' sum: one fp32
    running sum over the depth, 16 features a step."""
    a, b = a.float(), b.float()
    out = torch.zeros(a.shape[0], b.shape[0])
    for k in range(0, a.shape[1], 16):
        out = out + a[:, k:k + 16] @ b[:, k:k + 16].T
    return out


def coefficients(v, t, lse_v, lse_t, g_v, g_t, scale, w, keep=None, dots=fd._dots):
    """``sym_bwd_plain``'s coefficient tiles, step for step: ``M`` over
    [video, text], ``Q_v`` and ``Q_t`` (zero on the diagonal), each role's
    term selected by the other index's mask; the logits from ``dots``."""
    eye = torch.eye(v.shape[0], dtype=torch.bool)
    k_v, k_t, k_vv, k_tt = fd._keeps(v, *keep) if keep else (None,) * 4
    f_v = g_v * torch.exp(-lse_v)
    f_t = g_t * torch.exp(-lse_t)
    ws = w * scale
    m = torch.exp(scale * dots(v, t)) * (fd._select(k_v, f_v)
                                         + fd._select(k_t, f_t.T))
    q_v = torch.exp(ws * dots(v, v)) * (fd._select(k_vv, f_v)
                                        + fd._select(fd._tr(k_vv), f_v.T))
    q_t = torch.exp(ws * dots(t, t)) * (fd._select(k_tt, f_t)
                                        + fd._select(fd._tr(k_tt), f_t.T))
    return m, q_v.masked_fill(eye, 0.0), q_t.masked_fill(eye, 0.0)


def emulate(v, t, m, q_v, q_t, scale, w, mode="split", parts=1, tile=TILE):
    """``(dV, dT)``: each direction's ``s·(P·O + w·Q·A)`` with P, w·Q
    treated by :func:`_operand`, the candidates in ``parts`` parts of
    ``tile``-row tiles summed in index order.  Unrounded and in one part it
    is ``sym_bwd_plain``'s own expression."""
    vf, tf = v.float(), t.float()
    out = []
    for p, o, q, a in ((m, tf, q_v, vf), (m.T, vf, q_t, tf)):
        if mode is None and parts == 1:
            out.append(scale * (p @ o + w * (q @ a)))
            continue
        tiles = -(-p.shape[0] // tile)
        hp, hq = _operand(p, mode), _operand(w * q, mode)
        total = None
        for z in range(parts):
            cols = slice(z * tiles // parts * tile, (z + 1) * tiles // parts * tile)
            part = hp[:, cols] @ o[cols] + hq[:, cols] @ a[cols]
            total = part if total is None else total + part
        out.append(scale * total)
    return tuple(out)


def _inputs(b, d, seed, dtype=torch.bfloat16):
    """Unit features from numpy in ``dtype``, their keep masks (about 80%
    kept), and the loss's cotangents, 1/(2B) varied by up to ±50% per
    row."""
    rng = np.random.default_rng(seed)
    v, t = (rng.standard_normal((b, d)) for _ in range(2))
    v, t = (torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))
            .float().to(dtype) for x in (v, t))
    keep = tuple(torch.from_numpy(rng.random(b) < 0.8) for _ in range(2))
    g_v, g_t = (torch.from_numpy((0.5 + rng.random((b, 1))) / (2 * b)).float()
                for _ in range(2))
    return v, t, keep, g_v, g_t


def _ratio(got, want) -> float:
    """max |error| over the largest |entry|, as chip_smoke.grad_err."""
    return ((got - want).abs().max() / want.abs().max()).item()


def _case(b, d, scale, w, pruned, seed, dtype=torch.bfloat16):
    v, t, keep, g_v, g_t = _inputs(b, d, seed, dtype)
    keep = keep if pruned else None
    lse = fd.sym_fwd_plain(v, t, scale, w, *(keep or ()))
    want = fd.sym_bwd_plain(v, t, *lse, g_v, g_t, scale, w, *(keep or ()))
    coeffs = coefficients(v, t, *lse, g_v, g_t, scale, w, keep)
    return v, t, coeffs, want


CASES = [(b, d, tau, w, pruned) for b in (64, 1000, 1024) for d in (256, 384)
         for tau in (0.03, 0.05, 0.0125) for w in (0.8, 0.0) for pruned in (False, True)]


@pytest.mark.parametrize("b,d,tau,w,pruned", CASES)
def test_split_coefficients_stay_within_the_smoke_bound(b, d, tau, w, pruned):
    """Both directions at the card's split: the split within GRAD_BOUND of
    ``sym_bwd_plain``, and no farther from it than one bf16 rounding of the
    coefficients."""
    scale = 1.0 / tau
    parts, tile = parts_on_h100(b, d, pruned), tile_on_h100(d, pruned)
    with torch.inference_mode():
        v, t, coeffs, want = _case(b, d, scale, w, pruned, seed=b + d)
        split = emulate(v, t, *coeffs, scale, w, "split", parts, tile)
        once = emulate(v, t, *coeffs, scale, w, "bf16", parts, tile)
        for s_, o_, w_ in zip(split, once, want):
            assert bool(torch.isfinite(s_).all())
            assert _ratio(s_, w_) <= GRAD_BOUND
            assert (s_ - w_).abs().max() <= (o_ - w_).abs().max()


def test_the_card_splits_the_mlp_legs_batch():
    """At the legs' B = 1024 the Hopper design's 16 (D = 256) or 32 (D =
    384) blocks leave most of 132 SMs idle, so the candidates (8 tiles of
    128 rows, 16 of 64 at D = 384 or pruned) split 8 or 4 ways; B = 64 has one tile, and 4096 x
    384 (128 blocks) and 65,536 rows fill the card.  The mma.sync block, at D % 8 != 0 or D > 384, keeps its
    own split: 32 blocks of 64 rows split 4 ways at 1000 x 100, two blocks
    an SM at D <= 64."""
    assert parts_on_h100(1024, 256) == 8
    assert parts_on_h100(1024, 256, pruned=True) == 8  # 16 tiles of 64
    assert parts_on_h100(1024, 384) == 4
    assert parts_on_h100(1000, 8) == 8
    assert parts_on_h100(64, 256) == 1
    assert parts_on_h100(4096, 384) == 1
    assert parts_on_h100(65536, 256) == 1
    assert parts_on_h100(1000, 100) == 4
    assert parts_on_h100(1000, 60) == 8  # two blocks per SM
    assert parts_on_h100(1024, 600) == 1


@pytest.mark.parametrize("b,d", [(64, 256), (1000, 384)])
@pytest.mark.parametrize("tau", [0.03, 0.0125])
@pytest.mark.parametrize("pruned", [False, True])
def test_chained_logits_stay_within_the_smoke_bound(b, d, tau, pruned):
    """The split at the card's parts with the logits as the Hopper design
    sums them (one fp32 chain over the depth) within GRAD_BOUND of
    ``sym_bwd_plain``, and those logits within 1e-6 of the product's."""
    scale, w = 1.0 / tau, 0.8
    with torch.inference_mode():
        v, t, keep, g_v, g_t = _inputs(b, d, seed=b + d + 2)
        keep = keep if pruned else None
        assert (chained_dots(v, t) - fd._dots(v, t)).abs().max() <= 1e-6
        lse = fd.sym_fwd_plain(v, t, scale, w, *(keep or ()))
        want = fd.sym_bwd_plain(v, t, *lse, g_v, g_t, scale, w, *(keep or ()))
        coeffs = coefficients(v, t, *lse, g_v, g_t, scale, w, keep, chained_dots)
        for g_, w_ in zip(emulate(v, t, *coeffs, scale, w, "split",
                                  parts_on_h100(b, d, pruned),
                                  tile_on_h100(d, pruned)), want):
            assert _ratio(g_, w_) <= GRAD_BOUND


@pytest.mark.parametrize("b,d", [(64, 256), (1000, 384)])
@pytest.mark.parametrize("tau", [0.03, 0.0125])
@pytest.mark.parametrize("pruned", [False, True])
def test_unrounded_emulation_equals_plain_exactly(b, d, tau, pruned):
    """With no rounding and one part the emulation is ``sym_bwd_plain`` bit
    for bit (fp32 features, both directions)."""
    scale = 1.0 / tau
    with torch.inference_mode():
        v, t, coeffs, want = _case(b, d, scale, 0.8, pruned, seed=b + 1,
                                   dtype=torch.float32)
        for got, w_ in zip(emulate(v, t, *coeffs, scale, 0.8, None), want):
            assert torch.equal(got, w_)


@pytest.mark.parametrize("parts", [2, 3, 4, 5, 16])
@pytest.mark.parametrize("pruned", [False, True])
def test_unrounded_parts_sum_to_plain(parts, pruned):
    """Unrounded, the parts added in index order stay within 1e-6 of the
    largest entry of ``sym_bwd_plain`` (fp32 sums in another order), at
    B = 1000 (16 tiles, the last ragged)."""
    scale = 1.0 / 0.03
    with torch.inference_mode():
        v, t, coeffs, want = _case(1000, 256, scale, 0.8, pruned, seed=5,
                                   dtype=torch.float32)
        for got, w_ in zip(emulate(v, t, *coeffs, scale, 0.8, None, parts), want):
            assert _ratio(got, w_) <= 1e-6


@pytest.mark.parametrize("pruned", [False, True])
def test_split_matches_the_interpreted_pallas_sym_bwd(pruned):
    """B = 256, D = 256, τ = 0.03, w = 0.8: the emulation (split, the
    card's parts: two of one 128-row tile, pruned four of one 64-row tile)
    against the JAX package's
    ``_sym_bwd`` interpreted at the default tier (bf16 operands, 32-row
    tiles), both fed the plain lse, within GRAD_BOUND of the Pallas
    gradient's largest entry."""
    import jax.numpy as jnp

    from crossclr_tpu.ops.fused_dual import _sym_bwd

    b, d, scale, w = 256, 256, 1.0 / 0.03, 0.8
    parts = parts_on_h100(b, d, pruned)
    assert parts == (4 if pruned else 2)
    v, t, keep, g_v, g_t = _inputs(b, d, seed=3)
    keep = keep if pruned else None
    lse = fd.sym_fwd_plain(v, t, scale, w, *(keep or ()))
    coeffs = coefficients(v, t, *lse, g_v, g_t, scale, w, keep)
    got = emulate(v, t, *coeffs, scale, w, "split", parts, tile_on_h100(d, pruned))
    jkv, jkt = ((jnp.asarray(k.numpy(), jnp.float32) for k in keep) if pruned
                else (None, None))
    want = _sym_bwd(jnp.asarray(v.float().numpy()), jnp.asarray(t.float().numpy()),
                    jkv, jkt, *(jnp.asarray(x.numpy()) for x in (*lse, g_v, g_t)),
                    scale, w, 32, True, "default", pruned)
    for g_, w_ in zip(got, want):
        assert _ratio(g_, torch.from_numpy(np.array(w_))) <= GRAD_BOUND
