"""The bf16 rows forward's log2-unit online sums, unaligned diagonal and candidate split, held to the smoke's limit on the CPU.

The bf16 build of the rows forward (``rows_lse``, ``csrc/fused_global.cu``)
runs the dual forward's online-logsumexp block (``csrc/loss_mma.cuh``) in
its rows form: the anchor rows are their own array ``[b_loc, D]``, rows
``off .. off + b_loc`` of the batch, against the ``B`` candidates of
``other_all`` (inter, scale s) and ``anchor_all`` (intra, w·s).  It takes
the bf16 features as they are (exact mma operands); each logit is ``x =
fp32(zs·log2 e)·dot``; unpruned, the intra logit of row r's own column
``off + r`` is zeroed (``x = 0``); pruned, an inter column is kept where
``keep_inter`` or it is the row's own, an intra one where ``keep_intra``
and it is not, an excluded logit is ``−1e9``; the columns past B are
``−inf``.  Row r's own column lies anywhere in a 64-candidate tile where
``off % 64 ≠ 0``.  Each row keeps, per half of a tile (the two warps that
share a row), a running max ``m`` (from ``−1e30``) updated once per tile
and a sum ``l`` of ``exp2(x − m)`` rescaled once per tile, the tiles in
the order O, A, O, A, ...; the halves merge in a fixed order.  Where
``b_loc`` leaves the card idle the candidate tiles split into S parts
(part z takes tiles [z·T/S, (z+1)·T/S)), each part's ``(m, l)`` written
apart and merged in index order: ``lse = ln 2·(M + log2 Σ_z l_z·2^(m_z −
M))``.  A part can hold only excluded logits where the row's positive
lies in another part; it enters as ``(−1e9, count)`` and the merge wipes
it.

This test emulates that on the plain algebra and holds it to the limit
``chip_smoke.py`` holds the kernel to, ``LSE_TOL`` (atol = rtol = 2e-5),
against ``rows_lse_plain``: at the emulated ranks' blocks of a quarter of
B in {1000, 1024} x D in {384, 640} at the first, second and last rank's
offset (aligned for 1024: 0, 256 and 768; unaligned for 1000: 250 and
750; the card's smoke holds the 4096-row ranks), unpruned,
with keep masks (about 80% kept) and with masks that keep only the
positive, at the split the kernel picks on an H100; at the whole batch;
and with S in {2, 3, 5, 16}.  In natural units and one part the emulation
lies within 1e-6 of ``rows_lse_plain`` (fp32 sums in another order).  At
B = 128, D = 256 it is held to the JAX package's interpreted Pallas
``_rows_lse_fwd`` (default tier: bf16 operands) within ``LSE_TOL``.

The ``requires_cuda`` cases hold the kernel against ``rows_lse_plain`` on
the card (ragged B, unaligned D, D in {256, 384, 512, 640}, unpruned and
pruned, the whole batch and its last quarter), check two launches bit for
bit and the split the library picks.
"""

import math

import numpy as np
import pytest
import torch
from test_torch_rows_bwd_rows_bf16_operands import H100_SMS, LSE_TOL, _inputs
from test_torch_sym_bf16_operands import TILE

from crossclr_tpu_torch.ops import fused_global as fg
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOG2E = 1.4426950408889634
MASKED = -1e9  # an excluded logit, in log2 units as in natural ones
NEG_FLOOR = -1e30  # the running max's start
HALF = TILE // 2  # candidates of a tile one warp scores
TAU, W = 0.03, 0.8


def split_parts(tiles: int, blocks: int, slots: int) -> int:
    """``loss_mma.cuh``'s split_parts: one part where the blocks fill the
    card's slots; otherwise the S up to ceil(slots / blocks) (and the
    tiles) whose waves x tiles per part is least, the smallest of a tie."""
    if blocks >= slots:
        return 1
    best, best_cost = 1, tiles
    for s in range(2, min(tiles, -(-slots // blocks)) + 1):
        cost = -(-blocks * s // slots) * -(-tiles // s)
        if cost < best_cost:
            best, best_cost = s, cost
    return best


def lse_parts(bl: int, n: int, d: int, sms: int = H100_SMS) -> int:
    """The split ``fused_global.cu``'s lse_plan picks: one block per 64
    anchor rows walking the B candidates' tiles; two resident per SM where
    d fits one 256-feature chunk (the dual forward's registers), one where
    both anchor chunks are staged too (their shared memory)."""
    return split_parts(-(-n // TILE), -(-bl // TILE), sms * (2 if d <= 256 else 1))


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _masks(n: int, keep, seed: int):
    """None (unpruned), or bool keep masks ``(keep_inter, keep_intra)``
    ``[B]`` that keep about ``keep`` of the candidates (0: only the
    positive)."""
    if keep is None:
        return None
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.random(n) < keep) for _ in range(2))


def _logits(rows, a_all, o_all, off, scale, w, keep, log2: bool):
    """The inter and intra logits ``[b_loc, B]`` as the kernel forms them
    (``log2``: fp32 ``zs·log2 e`` times the fp32 dot; else plain's
    ``zs·dot``), masked: the zeroed or dropped self logit at column ``off +
    r`` and the excluded candidates."""
    bl, n = rows.shape[0], a_all.shape[0]
    own = (off + torch.arange(bl))[:, None] == torch.arange(n)[None, :]
    s32, w32 = _f32(scale), _f32(w)
    k_inter, k_intra = keep if keep is not None else (None, None)
    out = []
    for intra, x, k in ((False, o_all, k_inter), (True, a_all, k_intra)):
        zs = w32 * s32 if intra else s32
        if log2:
            zs = zs * _f32(LOG2E)
        z = zs * (rows.float() @ x.float().T)
        if k is None:
            if intra:
                z = z.masked_fill(own, 0.0)
        else:
            kept = (k[None, :] & ~own) if intra else (k[None, :] | own)
            z = z.masked_fill(~kept, MASKED)
        out.append(z)
    return out


def _online(z_inter, z_intra, t0: int, t1: int, exp):
    """``(m, l)`` per row over candidate tiles [t0, t1): each half of each
    tile (inter, then intra) updates its running max once and rescales its
    sum once; the halves then merge, half 0 first."""
    bl, n = z_inter.shape
    tiles = -(-n // TILE)
    pad = tiles * TILE - n
    blocks = [torch.nn.functional.pad(z, (0, pad), value=-math.inf)
              .reshape(bl, tiles, 2, HALF) for z in (z_inter, z_intra)]
    m = torch.full((bl, 2), NEG_FLOOR)
    l = torch.zeros((bl, 2))
    for tile in range(t0, t1):
        for z in blocks:
            x = z[:, tile]  # [b_loc, 2 halves, 32]
            m_new = torch.maximum(m, x.amax(-1))
            l = l * exp(m - m_new) + exp(x - m_new[..., None]).sum(-1)
            m = m_new
    mm = m.amax(1)
    total = l[:, 0] * exp(m[:, 0] - mm) + l[:, 1] * exp(m[:, 1] - mm)
    return mm, total


def emulate(rows, a_all, o_all, off: int, scale: float, w: float, keep=None,
            parts: int = 1, log2: bool = True):
    """``lse [b_loc, 1]`` as the bf16 kernel sums it: the online ``(m, l)``
    of each of ``parts`` parts of the candidate tiles (``log2``: exp2 of
    log2-unit logits, else exp of natural ones), merged in index order."""
    exp = torch.exp2 if log2 else torch.exp
    z_inter, z_intra = _logits(rows, a_all, o_all, off, scale, w, keep, log2)
    tiles = -(-a_all.shape[0] // TILE)
    ms, ls = zip(*(_online(z_inter, z_intra, z * tiles // parts,
                           (z + 1) * tiles // parts, exp) for z in range(parts)))
    mm = ms[0]
    for m in ms[1:]:
        mm = torch.maximum(mm, m)
    total = torch.zeros_like(mm)
    for m, l in zip(ms, ls):
        total = total + l * exp(m - mm)
    lse = (_f32(math.log(2.0)) * (mm + torch.log2(total)) if log2
           else mm + torch.log(total))
    return lse[:, None]


def _plain(rows, a_all, o_all, off, tau, keep, w=W):
    scale = torch.full((1,), 1.0 / tau)
    return fg.rows_lse_plain(rows, a_all, o_all, off, scale, w, *(keep or ()))


def _close(got, want) -> None:
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=LSE_TOL, atol=LSE_TOL)


# (B, D, b_loc, the offset in blocks of b_loc): the emulated ranks' blocks of
# a quarter of the batch at the first, second and last rank's offset
RANK_CASES = [(n, d, n // 4, k) for n in (1000, 1024) for d in (384, 640)
              for k in (0, 1, 3)]


@pytest.mark.parametrize("keep", [None, 0.8, 0.0])
@pytest.mark.parametrize("n,d,bl,k", RANK_CASES)
def test_rank_rows_at_the_cards_split_stay_within_the_smoke_limit(n, d, bl, k, keep):
    """Anchor rows of one emulated rank, log2 units, online per tile half,
    at the card's split: within LSE_TOL of ``rows_lse_plain``."""
    a_all, o_all, _, _ = _inputs(n, d, seed=n + d + k)
    masks = _masks(n, keep, seed=n + k)
    off = k * bl
    rows = a_all[off:off + bl]
    with torch.inference_mode():
        _close(emulate(rows, a_all, o_all, off, 1.0 / TAU, W, masks, lse_parts(bl, n, d)),
               _plain(rows, a_all, o_all, off, TAU, masks))


@pytest.mark.parametrize("n,d", [(1024, 256), (1000, 384)])
@pytest.mark.parametrize("tau", [0.03, 0.0125])
@pytest.mark.parametrize("keep", [None, 0.8, 0.0])
def test_the_whole_batch_at_the_cards_split_stays_within_the_smoke_limit(n, d, tau, keep):
    """Offset 0, the anchors the whole batch (the smoke's shapes and the
    full-CrossCLR leg's 1024 rows): within LSE_TOL."""
    a_all, o_all, _, _ = _inputs(n, d, seed=n + 7)
    masks = _masks(n, keep, seed=n)
    with torch.inference_mode():
        _close(emulate(a_all, a_all, o_all, 0, 1.0 / tau, W, masks, lse_parts(n, n, d)),
               _plain(a_all, a_all, o_all, 0, tau, masks))


def test_the_card_splits_the_rows():
    """At the full-CrossCLR leg's 1024 x 384 the 16 blocks split 8 ways;
    one rank's 1024 of 4096 at D = 384 8 ways too (8 tiles a part); 250
    rows of 1000 (4 blocks) over all 16 candidate tiles; at D = 256 two
    blocks an SM."""
    assert lse_parts(1024, 1024, 384) == 8
    assert lse_parts(1024, 4096, 384) == 8
    assert lse_parts(250, 1000, 384) == 16
    assert lse_parts(1024, 1024, 256) == 16
    assert lse_parts(64, 128, 256) == 2
    assert lse_parts(8448, 8448, 512) == 1


@pytest.mark.parametrize("off", [0, 250, 750])
@pytest.mark.parametrize("keep", [None, 0.8, 0.0])
def test_natural_units_in_one_part_match_plain(off, keep):
    """In natural units and one part the online emulation differs from
    ``rows_lse_plain`` only in the order of its fp32 sums: within 1e-6
    (fp32 features), rows off .. off + 250 of B = 1000."""
    a_all, o_all, _, _ = _inputs(1000, 384, seed=off + 1, dtype=torch.float32)
    masks = _masks(1000, keep, seed=off + 2)
    rows = a_all[off:off + 250]
    got = emulate(rows, a_all, o_all, off, 1.0 / TAU, W, masks, log2=False)
    torch.testing.assert_close(got, _plain(rows, a_all, o_all, off, TAU, masks),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("parts", [2, 3, 5, 16])
@pytest.mark.parametrize("keep", [None, 0.0])
def test_parts_merged_in_index_order_stay_within_the_limit(parts, keep):
    """The parts' (m, l) merged in index order: in natural units within
    1e-6 of ``rows_lse_plain``, in log2 units within LSE_TOL, rows 250-499
    of B = 1000 (16 tiles, the last ragged; the own columns across tiles
    3-7, unaligned).  With only the positive kept, every part but the one
    holding a row's own column holds nothing but excluded logits, (m, l) =
    (−1e9, their count), which the merge must wipe."""
    a_all, o_all, _, _ = _inputs(1000, 256, seed=5)
    masks = _masks(1000, keep, seed=6)
    rows = a_all[250:500]
    with torch.inference_mode():
        want = _plain(rows, a_all, o_all, 250, TAU, masks)
        natural = emulate(rows.float(), a_all.float(), o_all.float(), 250, 1.0 / TAU, W,
                          masks, parts, log2=False)
        torch.testing.assert_close(natural, want, rtol=1e-6, atol=1e-6)
        _close(emulate(rows, a_all, o_all, 250, 1.0 / TAU, W, masks, parts), want)


@pytest.mark.parametrize("off", [64, 40])
@pytest.mark.parametrize("pruned", [False, True])
def test_split_matches_the_interpreted_pallas_rows_lse(off, pruned):
    """B = 128, D = 256, anchor rows off .. off + 64 (aligned at 64, across
    two tiles at 40), τ = 0.03, w = 0.8: the emulation (log2 units, the
    card's two parts) against the JAX package's ``_rows_lse_fwd``
    interpreted at the default tier (bf16 operands, 32-row tiles) within
    LSE_TOL."""
    import jax.numpy as jnp

    from crossclr_tpu.ops.fused_global import _rows_lse_fwd

    n, d, bl = 128, 256, 64
    assert lse_parts(bl, n, d) == 2
    a_all, o_all, keep, _ = _inputs(n, d, seed=3)
    rows = a_all[off:off + bl]
    masks = keep if pruned else None
    got = emulate(rows, a_all, o_all, off, 1.0 / TAU, W, masks, 2)
    jk = ((jnp.asarray(k.numpy(), jnp.float32).reshape(1, n) for k in keep) if pruned
          else (jnp.zeros((1, 1), jnp.float32),) * 2)
    bf = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (rows, a_all, o_all)]
    want = _rows_lse_fwd(*bf, jnp.full((1, 1), off, jnp.float32),
                         jnp.full((1, 1), 1.0 / TAU, jnp.float32), *jk, W, 32, 32, True,
                         "default", pruned)
    _close(got, torch.from_numpy(np.array(want)))


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
# (the resident anchor chunks) and three (restaged)
CUDA_NS, CUDA_DS = [1, 72, 1000], [8, 48, 100, 256, 384, 512, 640]
CUDA_TAUS = (0.03, 0.01)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("keep", [None, 0.8, 0.0])
@pytest.mark.parametrize("d", CUDA_DS)
@pytest.mark.parametrize("n", CUDA_NS)
def test_cuda_bf16_rows_lse_matches_plain(cuda, n, d, keep):
    """The bf16 rows forward against its plain version at each τ of
    CUDA_TAUS, for the whole batch and for its last quarter (offset B −
    b_loc, unaligned at B = 72 and 1000): within LSE_TOL; unpruned, keep
    masks about 80% kept, and masks that keep only the positive (keep 0);
    two launches bit for bit; one launch count per call."""
    a_all, o_all, _, _ = _inputs(n, d, seed=n + d)
    a_all, o_all = a_all.to(cuda), o_all.to(cuda)
    masks = _masks(n, keep, seed=n)
    masks = () if masks is None else tuple(m.to(cuda) for m in masks)
    for bl in sorted({n, max(1, n // 4)}):
        off = n - bl
        rows = a_all[off:].contiguous()
        for tau in CUDA_TAUS:
            scale = torch.full((1,), 1.0 / tau, device=cuda)
            args = (rows, a_all, o_all, off, scale, W, *masks)
            before = fg.launch_counts["rows_lse"]
            got = fg.rows_lse_cuda(*args)
            _close(got, fg.rows_lse_plain(*args))
            again = fg.rows_lse_cuda(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            assert fg.launch_counts["rows_lse"] - before == 2


@pytest.mark.requires_cuda
def test_cuda_rows_lse_split_follows_the_plan(cuda):
    """On the H100's 132 SMs the library's scratch names the split this
    file emulates, (m, l) of each part and row; the fp32 build needs
    none."""
    if torch.cuda.get_device_properties(cuda).multi_processor_count != H100_SMS:
        pytest.skip("the emulated split is the H100's (132 SMs)")
    lib = fg._library()
    for bl, n, d in ((1, 1, 256), (1024, 1024, 384), (1024, 4096, 384),
                     (250, 1000, 384), (1024, 1024, 256), (8448, 8448, 512),
                     (1000, 1000, 640)):
        parts = lse_parts(bl, n, d)
        for pruned in (0, 1):
            assert lib.crossclr_rows_lse_scratch(1, bl, n, d, pruned) == (
                2 * bl * parts if parts > 1 else 0)
    assert lib.crossclr_rows_lse_scratch(0, 1024, 1024, 384, 0) == 0
