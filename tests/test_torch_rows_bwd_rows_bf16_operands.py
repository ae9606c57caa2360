"""The bf16 rows backward's operand rounding, candidate split and per-row Σ p⊙z, held to the smoke's limits on the CPU.

The bf16 build of the rows backward (``rows_bwd_rows``,
``csrc/fused_global.cu``) runs the loss kernels' anchor-gradient block
(``csrc/loss_mma.cuh``) in its rows form: the logits take the bf16
features as they are (exact mma operands); the coefficients ``p = g_r·
exp(z_inter − lse_r)`` and ``q = g_r·exp(z_intra − lse_r)`` are formed in
fp32 (0 where a keep mask drops the candidate, or on the zeroed intra
self logit, whose row is ``off + r``); the tiles p and w·q go into p·O and
w·q·A as a bf16 part and the bf16 rounding of the remainder ("split");
where ``b_loc`` leaves the card idle the 64-row candidate tiles split into
S parts (part z takes tiles [z·T/S, (z+1)·T/S)), each part's fp32 rows and
per-row ``Σ coef⊙z`` written apart and added in index order, the rows
times s.

This test emulates that on ``rows_bwd_rows_plain``'s algebra (its
coefficients step for step) and holds it to ``chip_smoke.py``'s limits:
``GRAD_BOUND`` for d anchor_rows (max |error| within 5e-5 of the largest
|entry|), ``LSE_TOL`` (atol = rtol = 2e-5) for Σ p⊙z row by row and
``DS_RTOL`` (1e-4) for its total, at B in {1000, 4096} x D in {384, 640},
anchor rows of b_loc = B/4 at offsets 0, b_loc and 3·b_loc, pruned and
not, with the S the kernel picks on an H100, and at the whole batch (b_loc
= B) for B x D in {1024 x 256, 1000 x 384}.  Unrounded, the parts added
in index order lie within 1e-6 of plain for S in {2, 3, 5, 16}.  At B =
128, D = 256 it is held to the JAX package's interpreted Pallas
``_rows_bwd`` (default tier) within the same limits.

The ``requires_cuda`` cases hold the kernel against
``rows_bwd_rows_plain`` on the card (ragged B, unaligned D, D in {256,
384, 512}, unpruned and pruned, the whole batch and its last quarter),
check two launches bit for bit and the split the library picks.
"""

import numpy as np
import pytest
import torch
from test_torch_dual_bwd_bf16_operands import DS_RTOL
from test_torch_sym_bf16_operands import GRAD_BOUND, TILE, _operand, _ratio
from test_torch_sym_fwd_bf16_operands import LSE_TOL

from crossclr_tpu_torch.ops import fused_global as fg
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

H100_SMS = 132


def rows_parts(bl: int, n: int, d: int, sms: int = H100_SMS) -> int:
    """The split ``fused_global.cu``'s rows_plan picks: one block per (64
    anchor rows, 256-feature chunk) where d > 128, one block an SM (the
    widest build's shared memory)."""
    if d <= 128:
        raise ValueError("the narrower builds' occupancy is the card's to say")
    tiles = -(-n // TILE)
    blocks = -(-d // 256) * -(-bl // TILE)
    if blocks >= sms:
        return 1
    best, best_cost = 1, tiles
    for s in range(2, min(tiles, -(-sms // blocks)) + 1):
        cost = -(-blocks * s // sms) * -(-tiles // s)
        if cost < best_cost:
            best, best_cost = s, cost
    return best


def _inputs(n, d, seed, dtype=torch.bfloat16):
    """Unit features ``[B, D]`` from numpy in ``dtype``, keep masks (about
    80% kept) and the loss's cotangents, 1/(2B) varied by up to ±50%."""
    rng = np.random.default_rng(seed)
    a, o = (rng.standard_normal((n, d)) for _ in range(2))
    a, o = (torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))
            .float().to(dtype) for x in (a, o))
    keep = tuple(torch.from_numpy(rng.random(n) < 0.8) for _ in range(2))
    g = torch.from_numpy((0.5 + rng.random((n, 1))) / (2 * n)).float()
    return a, o, keep, g


def _case(n, d, bl, off, tau, pruned, seed, dtype=torch.bfloat16):
    """The operands of anchor rows off .. off + bl, plain's lse and
    gradients, and plain's coefficients with their logits."""
    a_all, o_all, keep, g = _inputs(n, d, seed, dtype)
    rows = a_all[off:off + bl]
    g = g[off:off + bl]
    scale = torch.full((1,), 1.0 / tau)
    masks = keep if pruned else (None, None)
    args = (rows, a_all, o_all, off, scale, 0.8, *masks)
    lse = fg.rows_lse_plain(*args)
    bargs = (*args[:5], lse, g, 0.8, *masks)
    want = fg.rows_bwd_rows_plain(*bargs)
    p, q, z_inter, z_intra = fg._coefficients(*args[:5], lse, g, 0.8, *masks)
    return (o_all.float(), a_all.float(), scale), (p, q, z_inter, z_intra), want


def emulate(operands, coeffs, w, mode="split", parts=1):
    """``(d anchor_rows, ds_rows)``: each part's ``P·O + w·Q·A`` over its
    candidate tiles, P and w·Q treated by :func:`_operand`, and its rows'
    ``Σ p⊙z_inter + q⊙z_intra``, the parts added in index order, the rows
    times s."""
    o_all, a_all, scale = operands
    p, q, z_inter, z_intra = coeffs
    hp, hq = _operand(p, mode), _operand(w * q, mode)
    ds_terms = p * z_inter + q * z_intra
    tiles = -(-o_all.shape[0] // TILE)
    rows = ds = None
    for z in range(parts):
        cols = slice(z * tiles // parts * TILE, (z + 1) * tiles // parts * TILE)
        part = hp[:, cols] @ o_all[cols] + hq[:, cols] @ a_all[cols]
        part_ds = ds_terms[:, cols].sum(1, keepdim=True)
        rows = part if rows is None else rows + part
        ds = part_ds if ds is None else ds + part_ds
    return scale * rows, ds


def _check(got, want) -> None:
    """chip_smoke.rows_check's limits."""
    (g_rows, g_ds), (w_rows, w_ds) = got, want
    assert bool(torch.isfinite(g_rows).all()) and bool(torch.isfinite(g_ds).all())
    assert _ratio(g_rows, w_rows) <= GRAD_BOUND
    torch.testing.assert_close(g_ds, w_ds, rtol=LSE_TOL, atol=LSE_TOL)
    assert ((g_ds.sum() - w_ds.sum()).abs() / w_ds.sum().abs()).item() <= DS_RTOL


# (B, D, b_loc, the offset in blocks of b_loc): the emulated ranks' blocks of
# a quarter of the batch at the first, second and last rank's offset
CASES = [(n, d, n // 4, k) for n in (1000, 4096) for d in (384, 640)
         for k in (0, 1, 3)]


@pytest.mark.parametrize("pruned", [False, True])
@pytest.mark.parametrize("n,d,bl,k", CASES)
def test_split_rows_at_rank_offsets_stay_within_the_smoke_limits(n, d, bl, k, pruned):
    """Anchor rows of one emulated rank at the card's split: d anchor_rows
    within GRAD_BOUND of ``rows_bwd_rows_plain``, Σ p⊙z per row within
    LSE_TOL and in total within DS_RTOL."""
    with torch.inference_mode():
        operands, coeffs, want = _case(n, d, bl, k * bl, 0.03, pruned, seed=n + d + k)
        _check(emulate(operands, coeffs, 0.8, "split", rows_parts(bl, n, d)), want)


@pytest.mark.parametrize("n,d", [(1024, 256), (1000, 384)])
@pytest.mark.parametrize("tau", [0.03, 0.05])
@pytest.mark.parametrize("pruned", [False, True])
def test_split_rows_of_the_whole_batch_stay_within_the_smoke_limits(n, d, tau, pruned):
    """Offset 0, the anchors the whole batch (the smoke's shapes and the
    full-CrossCLR leg's 1024 rows), at the card's split."""
    with torch.inference_mode():
        operands, coeffs, want = _case(n, d, n, 0, tau, pruned, seed=n + 7)
        _check(emulate(operands, coeffs, 0.8, "split", rows_parts(n, n, d)), want)


def test_the_card_splits_the_rows():
    """At the full-CrossCLR leg's 1024 x 384 the 32 blocks split 4 ways; a
    quarter of 4096 at D = 640 (48 blocks) 2 ways; 250 rows of 1000 at D =
    384 (8 blocks) over all 16 candidate tiles."""
    assert rows_parts(1024, 1024, 384) == 4
    assert rows_parts(1024, 4096, 640) == 2
    assert rows_parts(250, 1000, 384) == 16
    assert rows_parts(64, 128, 256) == 2
    assert rows_parts(8448, 8448, 256) == 1


@pytest.mark.parametrize("parts", [2, 3, 5, 16])
@pytest.mark.parametrize("pruned", [False, True])
def test_unrounded_parts_sum_to_plain(parts, pruned):
    """Unrounded, the parts added in index order: d anchor_rows within 1e-6
    of the largest entry of ``rows_bwd_rows_plain`` and Σ p⊙z per row
    within 1e-6 (fp32 features, fp32 sums in another order), rows 250-499
    of B = 1000 (16 tiles, the last ragged)."""
    with torch.inference_mode():
        operands, coeffs, want = _case(1000, 384, 250, 250, 0.03, pruned, seed=5,
                                       dtype=torch.float32)
        rows, ds = emulate(operands, coeffs, 0.8, None, parts)
        assert _ratio(rows, want[0]) <= 1e-6
        torch.testing.assert_close(ds, want[1], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pruned", [False, True])
def test_split_matches_the_interpreted_pallas_rows_bwd(pruned):
    """B = 128, D = 256, anchor rows 64-127, τ = 0.03, w = 0.8: the
    emulation (split, the card's two parts) against the JAX package's
    ``_rows_bwd`` interpreted at the default tier (bf16 operands, 32-row
    tiles), both fed the plain lse: d anchor_rows within GRAD_BOUND, Σ p⊙z
    per row within LSE_TOL and in total within DS_RTOL."""
    import jax.numpy as jnp

    from crossclr_tpu.ops.fused_global import _rows_bwd

    n, d, bl, off, tau, w = 128, 256, 64, 64, 0.03, 0.8
    assert rows_parts(bl, n, d) == 2
    a_all, o_all, keep, g = _inputs(n, d, seed=3)
    rows, g = a_all[off:off + bl], g[off:off + bl]
    scale = torch.full((1,), 1.0 / tau)
    masks = keep if pruned else (None, None)
    args = (rows, a_all, o_all, off, scale, w, *masks)
    lse = fg.rows_lse_plain(*args)
    coeffs = fg._coefficients(*args[:5], lse, g, w, *masks)
    got = emulate((o_all.float(), a_all.float(), scale), coeffs, w, "split", 2)
    jk = ((jnp.asarray(k.numpy(), jnp.float32).reshape(1, n) for k in keep) if pruned
          else (jnp.zeros((1, 1), jnp.float32),) * 2)
    bf = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (rows, a_all, o_all)]
    d_rows, _, _, ds_rows = _rows_bwd(
        *bf, jnp.full((1, 1), off, jnp.float32), jnp.full((1, 1), 1.0 / tau, jnp.float32),
        *jk, jnp.asarray(lse.numpy()), jnp.asarray(g.numpy()), w, 32, 32, True,
        "default", pruned)
    _check(got, (torch.from_numpy(np.array(d_rows)), torch.from_numpy(np.array(ds_rows))))


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
CUDA_TAUS = (0.03, 0.01)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("keep", [None, 0.8, 0.0])
@pytest.mark.parametrize("d", CUDA_DS)
@pytest.mark.parametrize("n", CUDA_NS)
def test_cuda_bf16_rows_bwd_rows_matches_plain(cuda, n, d, keep):
    """The bf16 rows backward against its plain version at each τ of
    CUDA_TAUS, for the whole batch and for its last quarter (offset B −
    b_loc): d anchor_rows within GRAD_BOUND, Σ p⊙z per row within LSE_TOL
    and in total within DS_RTOL (atol 1e-6, as the dual backward's test);
    unpruned, keep masks about 80% kept, and masks that keep only the
    positive (keep 0); two launches bit for bit; one launch count per
    call."""
    a_all, o_all, _, g_all = _inputs(n, d, seed=n + d)
    a_all, o_all, g_all = a_all.to(cuda), o_all.to(cuda), g_all.to(cuda)
    masks = (None, None)
    if keep is not None:
        rng = np.random.default_rng(n)
        masks = tuple(torch.from_numpy(rng.random(n) < keep).to(cuda) for _ in range(2))
    for bl in sorted({n, max(1, n // 4)}):
        off = n - bl
        rows, g = a_all[off:].contiguous(), g_all[off:].contiguous()
        for tau in CUDA_TAUS:
            scale = torch.full((1,), 1.0 / tau, device=cuda)
            args = (rows, a_all, o_all, off, scale, 0.8, *masks)
            bargs = (*args[:5], fg.rows_lse_plain(*args), g, 0.8, *masks)
            before = fg.launch_counts["rows_bwd_rows"]
            got = fg.rows_bwd_rows_cuda(*bargs)
            want = fg.rows_bwd_rows_plain(*bargs)
            assert bool(torch.isfinite(got[0]).all())
            assert _ratio(got[0].cpu(), want[0].cpu()) <= GRAD_BOUND
            torch.testing.assert_close(got[1], want[1], rtol=LSE_TOL, atol=LSE_TOL)
            torch.testing.assert_close(got[1].sum(), want[1].sum(), rtol=DS_RTOL,
                                       atol=1e-6)
            again = fg.rows_bwd_rows_cuda(*bargs)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(got, again))
            assert fg.launch_counts["rows_bwd_rows"] - before == 2


@pytest.mark.requires_cuda
def test_cuda_rows_bwd_rows_split_follows_the_plan(cuda):
    """On the H100's 132 SMs the library's scratch names the split this
    file emulates, the parts' rows and their Σ p⊙z; the fp32 build needs
    none."""
    if torch.cuda.get_device_properties(cuda).multi_processor_count != H100_SMS:
        pytest.skip("the emulated split is the H100's (132 SMs)")
    lib = fg._library()
    for bl, n, d in ((1, 1, 256), (1024, 1024, 384), (1024, 4096, 640),
                     (250, 1000, 384), (8448, 8448, 256), (4096, 4096, 512)):
        parts = rows_parts(bl, n, d)
        for pruned in (0, 1):
            assert lib.crossclr_rows_bwd_rows_scratch(1, bl, n, d, pruned) == (
                parts * (bl * d + bl) if parts > 1 else 0)
    assert lib.crossclr_rows_bwd_rows_scratch(0, 1024, 1024, 384, 0) == 0
