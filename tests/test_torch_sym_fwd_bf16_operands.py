"""The bf16 sym forward's log2-unit sums and candidate split, held to the smoke's limit on the CPU.

The bf16 build of the sym forward (``sym_fwd``, ``csrc/fused_dual.cu``)
takes the bf16 features as they are (exact mma operands) and sums fp32
logits: each term is ``exp2(fma(dot, zs·log2 e, −m0·log2 e))``, the logit in
log2 units at the static shift ``m0 = max(s, w·s, 0)``, with the unpruned
intra self logit zeroed (``exp2(−m0·log2 e)``) and, pruned, a term dropped
where its keep test fails (the positive always kept, the self column
dropped).  Where B leaves the card idle the 64-row candidate tiles split
into S parts (part z takes tiles [z·T/S, (z+1)·T/S)), each part's fp32 sum
written apart, the parts added in index order, and ``lse = m0 + log``.
``sym_fwd_plain`` sums ``exp(z − m0)`` over all columns at once.

This test emulates that on the plain algebra and holds it to the limit
``chip_smoke.py`` holds the kernel to, ``LSE_TOL`` (atol = rtol = 2e-5),
at B in {64, 1000, 1024} x D in {256, 384}, τ in {0.03, 0.0125},
unpruned and pruned, with the S the kernel picks on an H100 and with
S in {2, 3, 5, 16}.  In natural units and one part the emulation lies
within 1e-6 of ``sym_fwd_plain`` (fp32 sums in another order).  At B = 128, D = 256 it is held to the JAX
package's interpreted Pallas ``_sym_fwd`` (default tier: bf16 operands)
within ``LSE_TOL``.

The ``requires_cuda`` cases hold the kernel against ``sym_fwd_plain`` on
the card (ragged B, unaligned D, D in {256, 384, 512}, unpruned and
pruned), check two launches bit for bit and the split the library picks.
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


LSE_TOL = _smoke().LSE_TOL
TILE = 64  # candidate rows per tile
H100_SMS = 132
LOG2E = 1.4426950408889634


def fwd_parts(b: int, d: int, sms: int = H100_SMS) -> int:
    """The split ``fused_dual.cu``'s split_parts picks for the sym forward:
    one block per (row tile, direction); two resident per SM where d fits
    one 256-feature chunk, one where the anchor chunks are staged too
    (their shared memory)."""
    tiles = -(-b // TILE)
    blocks = 2 * tiles
    slots = sms * (2 if d <= 256 else 1)
    if blocks >= slots:
        return 1
    best, best_cost = 1, tiles
    for s in range(2, min(tiles, -(-slots // blocks)) + 1):
        cost = -(-blocks * s // slots) * -(-tiles // s)
        if cost < best_cost:
            best, best_cost = s, cost
    return best


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _terms(dots: torch.Tensor, zs: torch.Tensor, m0_log2: torch.Tensor):
    """exp2 of the fp32 fma ``dot·(zs·log2 e) − m0·log2 e`` (one rounding:
    the fp32 product is exact in float64)."""
    x = (dots.double() * (zs * _f32(LOG2E)).double() - m0_log2.double()).float()
    return torch.exp2(x)


def emulate(v, t, scale: float, w: float, keep=None, parts: int = 1,
            log2: bool = True):
    """``(lse_v, lse_t)`` as the bf16 kernel sums them: each direction's
    terms over its own logits (``log2``: in log2 units at fp32 m0, else
    ``sym_fwd_plain``'s ``exp(z − m0)``), the candidate tiles in ``parts``
    parts, each part's fp32 row sum, added in index order."""
    b = v.shape[0]
    eye = torch.eye(b, dtype=torch.bool)
    keeps = fd._keeps(v, *keep) if keep else None
    if log2:
        s32, w32 = _f32(scale), _f32(w)
        m0 = torch.maximum(torch.maximum(s32, w32 * s32), _f32(0.0))
        m0_log2 = m0 * _f32(LOG2E)

        def terms(a, o, zs):
            return _terms(fd._dots(a, o), zs, m0_log2)

        inter, intra, self_term = s32, w32 * s32, torch.exp2(-m0_log2)
    else:
        m0 = max(scale, w * scale, 0.0)

        def terms(a, o, zs):
            return torch.exp(zs * fd._dots(a, o) - m0)

        inter, intra, self_term = scale, w * scale, torch.exp(_f32(-m0))
    out = []
    for k, (a, o) in enumerate(((v, t), (t, v))):
        e_ao, e_aa = terms(a, o, inter), terms(a, a, intra)
        if keeps is None:
            e_aa = torch.where(eye, self_term, e_aa)
        else:
            k_v, k_t, k_vv, k_tt = keeps
            e_ao = e_ao * (k_v if k == 0 else k_t.T)
            e_aa = e_aa * (k_vv if k == 0 else k_tt)
        tiles = -(-b // TILE)
        total = None
        for z in range(parts):
            cols = slice(z * tiles // parts * TILE, (z + 1) * tiles // parts * TILE)
            part = e_ao[:, cols].sum(1) + e_aa[:, cols].sum(1)
            total = part if total is None else total + part
        out.append((m0 + torch.log(total))[:, None])
    return tuple(out)


def _inputs(b, d, seed, dtype=torch.bfloat16):
    """Unit features from numpy in ``dtype`` and keep masks (about 80%
    kept)."""
    rng = np.random.default_rng(seed)
    v, t = (rng.standard_normal((b, d)) for _ in range(2))
    v, t = (torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))
            .float().to(dtype) for x in (v, t))
    keep = tuple(torch.from_numpy(rng.random(b) < 0.8) for _ in range(2))
    return v, t, keep


def _close(got, want) -> None:
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=LSE_TOL, atol=LSE_TOL)


CASES = [(b, d, tau, pruned) for b in (64, 1000, 1024) for d in (256, 384)
         for tau in (0.03, 0.0125) for pruned in (False, True)]


@pytest.mark.parametrize("b,d,tau,pruned", CASES)
def test_log2_split_sums_stay_within_the_smoke_limit(b, d, tau, pruned):
    """Both directions in log2 units at the card's split, within LSE_TOL
    of ``sym_fwd_plain``."""
    scale = 1.0 / tau
    v, t, keep = _inputs(b, d, seed=b + d)
    keep = keep if pruned else None
    with torch.inference_mode():
        want = fd.sym_fwd_plain(v, t, scale, 0.8, *(keep or ()))
        _close(emulate(v, t, scale, 0.8, keep, fwd_parts(b, d)), want)


def test_the_card_splits_the_mlp_legs_batch():
    """At the legs' B = 1024 the 32 blocks leave most of 132 SMs idle: 8
    parts where two blocks fit an SM (D = 256), 4 where one does (D =
    384); one tile, the headline's 128 blocks of one an SM, or 65,536 rows
    take one."""
    assert fwd_parts(1024, 256) == 8
    assert fwd_parts(1024, 384) == 4
    assert fwd_parts(4096, 512) == 1
    assert fwd_parts(64, 256) == 1
    assert fwd_parts(65536, 256) == 1


@pytest.mark.parametrize("b,d", [(64, 256), (1000, 384)])
@pytest.mark.parametrize("tau", [0.03, 0.0125])
@pytest.mark.parametrize("pruned", [False, True])
def test_natural_units_in_one_part_match_plain(b, d, tau, pruned):
    """In natural units and one part the emulation differs from
    ``sym_fwd_plain`` only in the order of its fp32 sums (the text
    direction's own T·Vᵀ and row sums where plain sums V·Tᵀ's columns):
    within 1e-6 (fp32 features)."""
    v, t, keep = _inputs(b, d, seed=b + 1, dtype=torch.float32)
    keep = keep if pruned else None
    want = fd.sym_fwd_plain(v, t, 1.0 / tau, 0.8, *(keep or ()))
    for g, w in zip(emulate(v, t, 1.0 / tau, 0.8, keep, log2=False), want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("parts", [2, 3, 5, 16])
@pytest.mark.parametrize("pruned", [False, True])
def test_parts_in_index_order_stay_within_the_limit(parts, pruned):
    """Natural units, the parts added in index order: within 1e-6 of
    ``sym_fwd_plain`` (fp32 sums in another order), and in log2 units
    within LSE_TOL, at B = 1000 (16 tiles, the last ragged)."""
    v, t, keep = _inputs(1000, 256, seed=5)
    keep = keep if pruned else None
    with torch.inference_mode():
        want = fd.sym_fwd_plain(v, t, 1.0 / 0.03, 0.8, *(keep or ()))
        got = emulate(v, t, 1.0 / 0.03, 0.8, keep, parts, log2=False)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
        _close(emulate(v, t, 1.0 / 0.03, 0.8, keep, parts), want)


@pytest.mark.parametrize("pruned", [False, True])
def test_split_matches_the_interpreted_pallas_sym_fwd(pruned):
    """B = 128, D = 256, τ = 0.03, w = 0.8: the emulation (log2 units,
    the card's split) against the JAX package's ``_sym_fwd`` interpreted
    at the default tier (bf16 operands, 32-row tiles) within LSE_TOL."""
    import jax.numpy as jnp

    from crossclr_tpu.ops.fused_dual import _sym_fwd

    b, d, scale, w = 128, 256, 1.0 / 0.03, 0.8
    assert fwd_parts(b, d) == 2
    v, t, keep = _inputs(b, d, seed=3)
    keep = keep if pruned else None
    got = emulate(v, t, scale, w, keep, fwd_parts(b, d))
    jkv, jkt = ((jnp.asarray(k.numpy(), jnp.float32) for k in keep) if pruned
                else (jnp.zeros((1,), jnp.float32),) * 2)
    want = _sym_fwd(jnp.asarray(v.float().numpy()), jnp.asarray(t.float().numpy()),
                    jkv, jkt, scale, w, 32, True, "default", pruned)
    _close(got, tuple(torch.from_numpy(np.array(x)) for x in want))


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
# 16-feature step of the mma, unaligned D (element loads), one 256-feature
# chunk, and two
CUDA_NS, CUDA_DS = [1, 72, 1000], [8, 48, 100, 256, 384, 512]


def collapsed(x: torch.Tensor, noise: float, seed: int) -> torch.Tensor:
    """Features near one shared unit direction u, ``normalize(u +
    noise·N(0, I))`` in x's dtype, as a random-init tower's lie."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((1, x.shape[1]))
    y = u / np.linalg.norm(u) + noise * rng.standard_normal(x.shape)
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    return torch.from_numpy(y).float().to(x.dtype).to(x.device)


# (τ, collapse noise): random features at the legs' τ and near s = 80, and
# collapsed ones there (lse past 86); pruned only where the features
# collapse or τ = 0.03, as the pruned gate 2·m0 <= 80 routes no other
# random features to the sym pair
CUDA_TAUS = ((0.03, 0.0), (1.0 / 79, 0.0), (1.0 / 79, 0.005))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("keep", [None, 0.8, 0.0])
@pytest.mark.parametrize("d", CUDA_DS)
@pytest.mark.parametrize("n", CUDA_NS)
def test_cuda_bf16_sym_fwd_matches_plain(cuda, n, d, keep):
    """The bf16 sym forward against its plain version at each case of
    CUDA_TAUS: unpruned, keep masks about 80% kept, and masks that drop
    every candidate but the positive (keep 0); two launches bit for bit;
    one launch count per call."""
    v, t, masks = _inputs(n, d, seed=n + d)
    if keep is None:
        masks = ()
    else:
        rng = np.random.default_rng(n)
        masks = tuple(torch.from_numpy(rng.random(n) < keep).to(cuda) for _ in range(2))
    for tau, noise in CUDA_TAUS:
        if masks and tau != 0.03 and not noise:
            continue
        a, b = (collapsed(x, noise, seed) if noise else x
                for x, seed in ((v, 1), (t, 2)))
        a, b = a.to(cuda), b.to(cuda)
        s = 1.0 / tau
        before = fd.launch_counts["sym_fwd"]
        got = fd.sym_fwd_cuda(a, b, s, 0.8, *masks)
        for g, w in zip(got, fd.sym_fwd_plain(a, b, s, 0.8, *masks)):
            torch.testing.assert_close(g, w, rtol=LSE_TOL, atol=LSE_TOL)
        again = fd.sym_fwd_cuda(a, b, s, 0.8, *masks)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        assert fd.launch_counts["sym_fwd"] - before == 2


@pytest.mark.requires_cuda
def test_cuda_sym_fwd_split_follows_the_plan(cuda):
    """The library's scratch names the split this file emulates, on the
    card's own SM count; the fp32 build needs none."""
    lib = fd._library()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n, d in ((1, 256), (1000, 256), (1024, 384), (4096, 512), (65536, 256)):
        parts = fwd_parts(n, d, sms)
        assert lib.crossclr_sym_fwd_scratch(1, n, d, 0) == (2 * n * parts if parts > 1 else 0)
    assert lib.crossclr_sym_fwd_scratch(0, 1000, 256, 0) == 0
