"""The bf16 dual forward's log2-unit online sums and candidate split, held to the smoke's limit on the CPU.

The bf16 build of the dual forward (``dual_fwd``, ``csrc/fused_dual.cu``)
takes the bf16 features as they are (exact mma operands) and keeps an
online logsumexp in log2 units: each logit is ``x = fp32(zs·log2 e)·dot``
(``zs`` = s or w·s, the scale read from memory), unpruned the intra self
logit is zeroed (``x = 0``), pruned an excluded logit is ``−1e9`` (the
positive always kept, the self column dropped), and the columns past B are
``−inf``.  Each row keeps, per half of a 64-candidate tile (the two warps
that share a row), a running max ``m`` (from ``−1e30``) updated once per
tile and a sum ``l`` of ``exp2(x − m)`` rescaled once per tile; the halves
merge in a fixed order.  Where B leaves the card idle the candidate tiles
split into S parts (part z takes tiles [z·T/S, (z+1)·T/S)), each part's
``(m, l)`` written apart and merged in index order: ``lse = ln 2·(M +
log2 Σ_z l_z·2^(m_z − M))``.  ``dual_fwd_plain`` takes one logsumexp over
the masked ``[B, 2B]`` logits.

This test emulates that on the plain algebra and holds it to the limit
``chip_smoke.py`` holds the kernel to, ``LSE_TOL`` (atol = rtol = 2e-5),
at B in {64, 1000, 1024} x D in {256, 384, 512}, τ in {0.03, 0.0125},
unpruned, with keep masks (about 80% kept) and with masks that keep only
the positive, with the S the kernel picks on an H100 and with S in {2, 3,
5, 16}.  In natural units and one part the emulation lies within 1e-6 of
``dual_fwd_plain`` (fp32 sums in another order).  At B = 128, D = 256 it is
held to the JAX package's interpreted Pallas ``_dual_fwd`` (default tier:
bf16 operands) within ``LSE_TOL``.

The ``requires_cuda`` cases hold the kernel against ``dual_fwd_plain`` on
the card (ragged B, unaligned D, D in {256, 384, 512}, unpruned and
pruned, random and collapsed features), check two launches bit for bit and
the split the library picks.
"""

import math

import numpy as np
import pytest
import torch
from test_torch_sym_fwd_bf16_operands import LSE_TOL, TILE, _inputs, collapsed, fwd_parts

from crossclr_tpu_torch.ops import fused_dual as fd
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOG2E = 1.4426950408889634
MASKED = -1e9  # an excluded logit, in log2 units as in natural ones
NEG_FLOOR = -1e30  # the running max's start
HALF = TILE // 2  # candidates of a tile one warp scores


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _masks(b: int, keep, seed: int):
    """None (unpruned), or bool keep masks ``[B]`` that keep about
    ``keep`` of the candidates (0: only the positive)."""
    if keep is None:
        return None
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.random(b) < keep) for _ in range(2))


def _logits(a, o, scale, w, keep_inter, keep_intra, log2: bool):
    """One direction's ``[B, B]`` inter and intra logits as the kernel forms
    them (``log2``: fp32 ``zs·log2 e`` times the fp32 dot; else plain's
    ``zs·dot``), masked: the zeroed or dropped self logit and the excluded
    candidates."""
    b = a.shape[0]
    eye = torch.eye(b, dtype=torch.bool)
    s32, w32 = _f32(scale), _f32(w)
    out = []
    for intra, x, keep in ((False, o, keep_inter), (True, a, keep_intra)):
        zs = w32 * s32 if intra else s32
        if log2:
            zs = zs * _f32(LOG2E)
        z = zs * fd._dots(a, x)
        if keep is None:
            if intra:
                z = z.masked_fill(eye, 0.0)
        else:
            kept = (keep[None, :] & ~eye) if intra else (keep[None, :] | eye)
            z = z.masked_fill(~kept, MASKED)
        out.append(z)
    return out


def _online(z_inter, z_intra, t0: int, t1: int, exp):
    """``(m, l)`` per row over candidate tiles [t0, t1): each half of each
    tile (inter, then intra) updates its running max once and rescales its
    sum once; the halves then merge, half 0 first."""
    b = z_inter.shape[0]
    tiles = -(-b // TILE)
    pad = tiles * TILE - b
    blocks = [torch.nn.functional.pad(z, (0, pad), value=-math.inf)
              .reshape(b, tiles, 2, HALF) for z in (z_inter, z_intra)]
    m = torch.full((b, 2), NEG_FLOOR)
    l = torch.zeros((b, 2))
    for tile in range(t0, t1):
        for z in blocks:
            x = z[:, tile]  # [B, 2 halves, 32]
            m_new = torch.maximum(m, x.amax(-1))
            l = l * exp(m - m_new) + exp(x - m_new[..., None]).sum(-1)
            m = m_new
    mm = m.amax(1)
    total = l[:, 0] * exp(m[:, 0] - mm) + l[:, 1] * exp(m[:, 1] - mm)
    return mm, total


def emulate(v, t, scale: float, w: float, keep=None, parts: int = 1,
            log2: bool = True):
    """``(lse_v, lse_t)`` as the bf16 kernel sums them: each direction's own
    logits, the online ``(m, l)`` of each of ``parts`` parts of the
    candidate tiles (``log2``: exp2 of log2-unit logits, else exp of
    natural ones), merged in index order."""
    b = v.shape[0]
    kv, kt = keep if keep is not None else (None, None)
    exp = torch.exp2 if log2 else torch.exp
    out = []
    # video anchors prune inter candidates by kt, intra ones by kv; text
    # anchors the opposite
    for a, o, k_inter, k_intra in ((v, t, kt, kv), (t, v, kv, kt)):
        z_inter, z_intra = _logits(a, o, scale, w, k_inter, k_intra, log2)
        tiles = -(-b // TILE)
        ms, ls = zip(*(_online(z_inter, z_intra, z * tiles // parts,
                               (z + 1) * tiles // parts, exp)
                       for z in range(parts)))
        mm = ms[0]
        for m in ms[1:]:
            mm = torch.maximum(mm, m)
        total = torch.zeros(b)
        for m, l in zip(ms, ls):
            total = total + l * exp(m - mm)
        lse = (_f32(math.log(2.0)) * (mm + torch.log2(total)) if log2
               else mm + torch.log(total))
        out.append(lse[:, None])
    return tuple(out)


def _close(got, want) -> None:
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=LSE_TOL, atol=LSE_TOL)


def _plain(v, t, tau, keep):
    scale = torch.full((1,), 1.0 / tau)
    return fd.dual_fwd_plain(v, t, scale, 0.8, *(keep or ()))


CASES = [(b, d, tau, keep) for b in (64, 1000, 1024) for d in (256, 384, 512)
         for tau in (0.03, 0.0125) for keep in (None, 0.8, 0.0)]


@pytest.mark.parametrize("b,d,tau,keep", CASES)
def test_log2_online_split_stays_within_the_smoke_limit(b, d, tau, keep):
    """Both directions in log2 units, online per tile half, at the card's
    split: within LSE_TOL of ``dual_fwd_plain``."""
    v, t, _ = _inputs(b, d, seed=b + d)
    masks = _masks(b, keep, seed=b)
    with torch.inference_mode():
        _close(emulate(v, t, 1.0 / tau, 0.8, masks, fwd_parts(b, d)),
               _plain(v, t, tau, masks))


def test_the_card_splits_the_legs_batch():
    """The dual forward's grid and shared memory are the sym forward's (its
    (m, l) halves take 512 B more; two blocks an SM where D fits one chunk,
    as its launch bounds ask): 8 parts at the MLP leg's 1024 x 256, 4 at the
    full-CrossCLR leg's 1024 x 384 (two resident anchor chunks, one block an
    SM), one at the headline 4096 x 512."""
    assert fwd_parts(1024, 256) == 8
    assert fwd_parts(1024, 384) == 4
    assert fwd_parts(4096, 512) == 1
    assert fwd_parts(128, 256) == 2


@pytest.mark.parametrize("b,d", [(64, 256), (1000, 384)])
@pytest.mark.parametrize("tau", [0.03, 0.0125])
@pytest.mark.parametrize("keep", [None, 0.8, 0.0])
def test_natural_units_in_one_part_match_plain(b, d, tau, keep):
    """In natural units and one part the online emulation differs from
    ``dual_fwd_plain`` only in the order of its fp32 sums: within 1e-6
    (fp32 features)."""
    v, t, _ = _inputs(b, d, seed=b + 1, dtype=torch.float32)
    masks = _masks(b, keep, seed=b + 2)
    want = _plain(v, t, tau, masks)
    for g, w in zip(emulate(v, t, 1.0 / tau, 0.8, masks, log2=False), want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("parts", [2, 3, 5, 16])
@pytest.mark.parametrize("keep", [None, 0.0])
def test_parts_merged_in_index_order_stay_within_the_limit(parts, keep):
    """The parts' (m, l) merged in index order: in natural units within
    1e-6 of ``dual_fwd_plain``, in log2 units within LSE_TOL, at B = 1000
    (16 tiles, the last ragged).  With only the positive kept, every part
    but one holds nothing but excluded logits, (m, l) = (−1e9, their
    count), which the merge must wipe."""
    v, t, _ = _inputs(1000, 256, seed=5)
    masks = _masks(1000, keep, seed=6)
    with torch.inference_mode():
        want = _plain(v, t, 0.03, masks)
        for g, w in zip(emulate(v, t, 1.0 / 0.03, 0.8, masks, parts, log2=False),
                        want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
        _close(emulate(v, t, 1.0 / 0.03, 0.8, masks, parts), want)


@pytest.mark.parametrize("pruned", [False, True])
def test_split_matches_the_interpreted_pallas_dual_fwd(pruned):
    """B = 128, D = 256, τ = 0.03, w = 0.8: the emulation (log2 units, the
    card's two parts) against the JAX package's ``_dual_fwd`` interpreted
    at the default tier (bf16 operands, 32-row tiles) within LSE_TOL."""
    import jax.numpy as jnp

    from crossclr_tpu.ops.fused_dual import _dual_fwd

    b, d, tau, w = 128, 256, 0.03, 0.8
    v, t, keep = _inputs(b, d, seed=3)
    keep = keep if pruned else None
    got = emulate(v, t, 1.0 / tau, w, keep, fwd_parts(b, d))
    jkv, jkt = ((jnp.asarray(k.numpy(), jnp.float32) for k in keep) if pruned
                else (jnp.zeros((1,), jnp.float32),) * 2)
    scale = jnp.full((1, 1), 1.0 / tau, jnp.float32)
    want = _dual_fwd(jnp.asarray(v.float().numpy()), jnp.asarray(t.float().numpy()),
                     scale, jkv, jkt, w, 32, 32, True, "default", pruned)
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
# chunk, and two (the resident anchor chunks)
CUDA_NS, CUDA_DS = [1, 72, 1000], [8, 48, 100, 256, 384, 512]
# (τ, collapse noise): the legs' τ, a larger scale, and collapsed features
# near s = 80 (lse near 85)
CUDA_TAUS = ((0.03, 0.0), (0.01, 0.0), (1.0 / 79, 0.005))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("keep", [None, 0.8, 0.0])
@pytest.mark.parametrize("d", CUDA_DS)
@pytest.mark.parametrize("n", CUDA_NS)
def test_cuda_bf16_dual_fwd_matches_plain(cuda, n, d, keep):
    """The bf16 dual forward against its plain version at each case of
    CUDA_TAUS (a tensor τ): unpruned, keep masks about 80% kept, and masks
    that drop every candidate but the positive (keep 0); two launches bit
    for bit; one launch count per call."""
    v, t, _ = _inputs(n, d, seed=n + d)
    masks = _masks(n, keep, seed=n)
    masks = () if masks is None else tuple(m.to(cuda) for m in masks)
    for tau, noise in CUDA_TAUS:
        a, b = (collapsed(x, noise, seed) if noise else x
                for x, seed in ((v, 1), (t, 2)))
        a, b = a.to(cuda), b.to(cuda)
        scale = torch.full((1,), 1.0 / tau, device=cuda)
        before = fd.launch_counts["dual_fwd"]
        got = fd.dual_fwd_cuda(a, b, scale, 0.8, *masks)
        for g, w in zip(got, fd.dual_fwd_plain(a, b, scale, 0.8, *masks)):
            assert bool(torch.isfinite(g).all())
            torch.testing.assert_close(g, w, rtol=LSE_TOL, atol=LSE_TOL)
        again = fd.dual_fwd_cuda(a, b, scale, 0.8, *masks)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        assert fd.launch_counts["dual_fwd"] - before == 2


@pytest.mark.requires_cuda
def test_cuda_dual_fwd_split_follows_the_plan(cuda):
    """The library's scratch names the split this file emulates, (m, l) of
    each part and direction, on the card's own SM count; the fp32 build
    needs none."""
    lib = fd._library()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n, d in ((1, 256), (1000, 256), (1024, 384), (4096, 512), (65536, 256)):
        parts = fwd_parts(n, d, sms)
        for pruned in (0, 1):
            assert lib.crossclr_dual_fwd_scratch(1, n, d, pruned) == (
                4 * n * parts if parts > 1 else 0)
    assert lib.crossclr_dual_fwd_scratch(0, 1000, 256, 0) == 0
