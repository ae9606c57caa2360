"""The bf16 rows backward's candidate gradients: operand rounding, unaligned diagonal and anchor-tile split, held to the smoke's limits on the CPU.

The bf16 build of the candidates' backward (``rows_bwd_cols``,
``csrc/fused_global.cu``) runs the loss kernels' anchor-gradient block
(``csrc/loss_mma.cuh``) in its cols form, the rows form transposed: a
block owns 64 candidates of one array (``other_all`` → d other_all, or
``anchor_all`` → d anchor_all) and walks the 64-row tiles of the anchor
rows, rows ``off .. off + b_loc`` of the batch.  The logits take the bf16
features as they are (exact mma operands); the coefficients ``p = g_r·
exp(z_inter − lse_r)`` and ``q = g_r·exp(z_intra − lse_r)`` are formed in
fp32 (0 where the candidate's keep mask drops the pair, or on the zeroed
intra self logit, candidate ``off + r``); the tiles pᵀ and w·qᵀ go into
pᵀ·A_r and w·qᵀ·A_r as a bf16 part and the bf16 rounding of the remainder
("split"); where the blocks leave the card idle the anchor tiles split into
S parts (part z takes tiles [z·T/S, (z+1)·T/S)), each part's fp32 rows
written apart and added in index order, times s.

This test emulates that on ``rows_bwd_cols_plain``'s algebra (its
coefficients step for step) and holds it to ``chip_smoke.py``'s limit
``GRAD_BOUND`` (max |error| within 5e-5 of the largest |entry|, each of d
other_all and d anchor_all): at the emulated ranks' blocks of a quarter of
B in {1000, 1024} x D in {384, 640} at the first, second and last rank's
offset (aligned for 1024: 0, 256 and 768; unaligned for 1000: 250 and
750; the card's smoke holds the 4096-row ranks), pruned and
not, at the split the kernel picks on an H100; at the whole batch; and,
unrounded, with S in {2, 3, 5, 16} within 1e-6 of plain.  At B = 128, D =
256 it is held to the JAX package's interpreted Pallas ``_rows_bwd``
(default tier) within the same limit.

The ``requires_cuda`` cases hold the kernel against
``rows_bwd_cols_plain`` on the card (ragged B, unaligned D, D in {256,
384, 512, 640}, unpruned and pruned, the whole batch and its last
quarter), check two launches bit for bit and the split the library picks.
"""

import numpy as np
import pytest
import torch
from test_torch_rows_bwd_rows_bf16_operands import GRAD_BOUND, H100_SMS, _inputs
from test_torch_rows_lse_bf16_operands import TAU, W, _masks, split_parts
from test_torch_sym_bf16_operands import TILE, _operand

from crossclr_tpu_torch.ops import fused_global as fg
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def cols_parts(bl: int, n: int, d: int, sms: int = H100_SMS) -> int:
    """The split ``fused_global.cu``'s cols_plan picks: one block per (64
    candidates, array, 256-feature chunk) where d > 128, one block an SM
    (the widest build's shared memory), walking the anchor rows' tiles."""
    if d <= 128:
        raise ValueError("the narrower builds' occupancy is the card's to say")
    return split_parts(-(-bl // TILE), 2 * -(-d // 256) * -(-n // TILE), sms)


def _case(n, d, bl, off, tau, keep, seed, dtype=torch.bfloat16):
    """The anchor rows off .. off + bl, plain's candidate gradients and
    plain's coefficients."""
    a_all, o_all, _, g = _inputs(n, d, seed, dtype)
    rows, g = a_all[off:off + bl], g[off:off + bl]
    scale = torch.full((1,), 1.0 / tau)
    masks = keep if keep is not None else (None, None)
    args = (rows, a_all, o_all, off, scale, W, *masks)
    lse = fg.rows_lse_plain(*args)
    want = fg.rows_bwd_cols_plain(*args[:5], lse, g, W, *masks)
    p, q, _, _ = fg._coefficients(*args[:5], lse, g, W, *masks)
    return (rows.float(), scale), (p, q), want


def emulate(operands, coeffs, w, mode="split", parts=1):
    """``(d other_all, d anchor_all)``: each part's ``Pᵀ·A_r`` and
    ``(w·Q)ᵀ·A_r`` over its anchor tiles, P and w·Q treated by
    :func:`_operand`, the parts added in index order, times s."""
    rows, scale = operands
    p, q = coeffs
    hp, hq = _operand(p, mode), _operand(w * q, mode)
    tiles = -(-rows.shape[0] // TILE)
    d_other = d_anchor = None
    for z in range(parts):
        r = slice(z * tiles // parts * TILE, (z + 1) * tiles // parts * TILE)
        po, pa = hp[r].T @ rows[r], hq[r].T @ rows[r]
        d_other = po if d_other is None else d_other + po
        d_anchor = pa if d_anchor is None else d_anchor + pa
    return scale * d_other, scale * d_anchor


def _check(got, want, bound=GRAD_BOUND) -> None:
    """chip_smoke.grad_err's limit, for each array's gradient: an all-zero
    one (d anchor_all where only the positive is kept) exactly."""
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        err = (g - w).abs().max().item()
        assert err <= bound * max(w.abs().max().item(), 1e-30)


# (B, D, b_loc, the offset in blocks of b_loc): the emulated ranks' blocks of
# a quarter of the batch at the first, second and last rank's offset
CASES = [(n, d, n // 4, k) for n in (1000, 1024) for d in (384, 640)
         for k in (0, 1, 3)]


@pytest.mark.parametrize("keep", [None, 0.8, 0.0])
@pytest.mark.parametrize("n,d,bl,k", CASES)
def test_split_cols_at_rank_offsets_stay_within_the_smoke_limit(n, d, bl, k, keep):
    """Anchor rows of one emulated rank at the card's split: d other_all and
    d anchor_all within GRAD_BOUND of ``rows_bwd_cols_plain``; unpruned,
    keep masks about 80% kept, and masks that keep only the positive."""
    with torch.inference_mode():
        operands, coeffs, want = _case(n, d, bl, k * bl, TAU, _masks(n, keep, seed=n + k),
                                       seed=n + d + k)
        _check(emulate(operands, coeffs, W, "split", cols_parts(bl, n, d)), want)


@pytest.mark.parametrize("n,d", [(1024, 256), (1000, 384)])
@pytest.mark.parametrize("tau", [0.03, 0.05])
@pytest.mark.parametrize("keep", [None, 0.8])
def test_split_cols_of_the_whole_batch_stay_within_the_smoke_limit(n, d, tau, keep):
    """Offset 0, the anchors the whole batch (the smoke's shapes and the
    full-CrossCLR leg's 1024 rows), at the card's split."""
    with torch.inference_mode():
        operands, coeffs, want = _case(n, d, n, 0, tau, _masks(n, keep, seed=n),
                                       seed=n + 7)
        _check(emulate(operands, coeffs, W, "split", cols_parts(n, n, d)), want)


def test_the_card_splits_the_cols():
    """At the full-CrossCLR leg's 1024 x 384 the 64 blocks split 2 ways; 250
    rows of 1000 at D = 384 (64 blocks, 4 anchor tiles) 2 ways; one rank's
    1024 of 4096 (256 blocks) and 1000 x 640 (96 blocks) not at all."""
    assert cols_parts(1024, 1024, 384) == 2
    assert cols_parts(250, 1000, 384) == 2
    assert cols_parts(1024, 4096, 384) == 1
    assert cols_parts(1000, 1000, 640) == 1
    assert cols_parts(64, 128, 256) == 1
    assert cols_parts(256, 256, 256) == 4


@pytest.mark.parametrize("parts", [2, 3, 5, 16])
@pytest.mark.parametrize("keep", [None, 0.8])
def test_unrounded_parts_sum_to_plain(parts, keep):
    """Unrounded, the parts added in index order: each candidate gradient
    within 1e-6 of the largest entry of ``rows_bwd_cols_plain`` (fp32
    features, fp32 sums in another order), rows 0-999 of B = 1000 (16
    anchor tiles, the last ragged)."""
    with torch.inference_mode():
        operands, coeffs, want = _case(1000, 384, 1000, 0, TAU,
                                       _masks(1000, keep, seed=4), seed=5,
                                       dtype=torch.float32)
        _check(emulate(operands, coeffs, W, None, parts), want, 1e-6)


@pytest.mark.parametrize("off", [64, 40])
@pytest.mark.parametrize("pruned", [False, True])
def test_split_matches_the_interpreted_pallas_rows_bwd(off, pruned):
    """B = 128, D = 256, anchor rows off .. off + 64 (aligned at 64, across
    two candidate tiles at 40), τ = 0.03, w = 0.8: the emulation (split,
    the card's one part) against the candidates' gradients of the JAX
    package's ``_rows_bwd`` interpreted at the default tier (bf16 operands,
    32-row tiles), both fed the plain lse: within GRAD_BOUND."""
    import jax.numpy as jnp

    from crossclr_tpu.ops.fused_global import _rows_bwd

    n, d, bl = 128, 256, 64
    a_all, o_all, keep, g = _inputs(n, d, seed=3)
    rows, g = a_all[off:off + bl], g[off:off + bl]
    scale = torch.full((1,), 1.0 / TAU)
    masks = keep if pruned else (None, None)
    args = (rows, a_all, o_all, off, scale, W, *masks)
    lse = fg.rows_lse_plain(*args)
    p, q, _, _ = fg._coefficients(*args[:5], lse, g, W, *masks)
    got = emulate((rows.float(), scale), (p, q), W, "split", cols_parts(bl, n, d))
    jk = ((jnp.asarray(k.numpy(), jnp.float32).reshape(1, n) for k in keep) if pruned
          else (jnp.zeros((1, 1), jnp.float32),) * 2)
    bf = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (rows, a_all, o_all)]
    _, d_anchor, d_other, _ = _rows_bwd(
        *bf, jnp.full((1, 1), off, jnp.float32), jnp.full((1, 1), 1.0 / TAU, jnp.float32),
        *jk, jnp.asarray(lse.numpy()), jnp.asarray(g.numpy()), W, 32, 32, True,
        "default", pruned)
    _check(got, tuple(torch.from_numpy(np.array(x)) for x in (d_other, d_anchor)))


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
# 16-feature step, unaligned D (element loads), one, two and three
# 256-feature chunks
CUDA_NS, CUDA_DS = [1, 72, 1000], [8, 48, 100, 256, 384, 512, 640]
CUDA_TAUS = (0.03, 0.01)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("keep", [None, 0.8, 0.0])
@pytest.mark.parametrize("d", CUDA_DS)
@pytest.mark.parametrize("n", CUDA_NS)
def test_cuda_bf16_rows_bwd_cols_matches_plain(cuda, n, d, keep):
    """The bf16 candidates' backward against its plain version at each τ
    of CUDA_TAUS, for the whole batch and for its last quarter (offset B −
    b_loc, unaligned at B = 72 and 1000): d other_all and d anchor_all
    within GRAD_BOUND; unpruned, keep masks about 80% kept, and masks that
    keep only the positive (keep 0); two launches bit for bit; one launch
    count per call."""
    a_all, o_all, _, g_all = _inputs(n, d, seed=n + d)
    a_all, o_all, g_all = a_all.to(cuda), o_all.to(cuda), g_all.to(cuda)
    masks = _masks(n, keep, seed=n)
    masks = (None, None) if masks is None else tuple(m.to(cuda) for m in masks)
    for bl in sorted({n, max(1, n // 4)}):
        off = n - bl
        rows, g = a_all[off:].contiguous(), g_all[off:].contiguous()
        for tau in CUDA_TAUS:
            scale = torch.full((1,), 1.0 / tau, device=cuda)
            args = (rows, a_all, o_all, off, scale, W, *masks)
            bargs = (*args[:5], fg.rows_lse_plain(*args), g, W, *masks)
            before = fg.launch_counts["rows_bwd_cols"]
            got = fg.rows_bwd_cols_cuda(*bargs)
            _check([x.cpu() for x in got],
                   [x.cpu() for x in fg.rows_bwd_cols_plain(*bargs)])
            again = fg.rows_bwd_cols_cuda(*bargs)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(got, again))
            assert fg.launch_counts["rows_bwd_cols"] - before == 2


@pytest.mark.requires_cuda
def test_cuda_rows_bwd_cols_split_follows_the_plan(cuda):
    """On the H100's 132 SMs the library's scratch names the split this
    file emulates, both arrays' fp32 rows of each part; the fp32 build
    needs none."""
    if torch.cuda.get_device_properties(cuda).multi_processor_count != H100_SMS:
        pytest.skip("the emulated split is the H100's (132 SMs)")
    lib = fg._library()
    for bl, n, d in ((1, 1, 256), (1024, 1024, 384), (1024, 4096, 384),
                     (250, 1000, 384), (1000, 1000, 640), (256, 256, 256)):
        parts = cols_parts(bl, n, d)
        for pruned in (0, 1):
            assert lib.crossclr_rows_bwd_cols_scratch(1, bl, n, d, pruned) == (
                2 * n * d * parts if parts > 1 else 0)
    assert lib.crossclr_rows_bwd_cols_scratch(0, 1024, 1024, 384, 0) == 0
