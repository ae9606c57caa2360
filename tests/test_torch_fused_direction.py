"""The per-direction loss pair of the port (``ops/fused_crossclr.py``:
``lse_fwd`` / ``lse_bwd``) against the JAX package's per-direction Pallas
kernels, and the route that picks it.

On the CPU the port's kernels take their plain versions.  They are held
against ``_lse_fwd_kernel`` / ``_lse_bwd_kernel`` run in interpret mode:
``fused_lse_pair(..., use_pallas=True, interpret=True)`` takes them when
``dual_supported`` fails, so the tests set it to False and pin the tiles
with ``TILE_OVERRIDE``.  Inputs are made with numpy from a seed (B in
{64, 96}, D in {48, 100}); the cotangents are the loss's, 1/(2B), varied
by up to ±50% per row.

Tolerances: at ``highest`` the lse atol = rtol = 2e-5 and the gradients
rtol 1e-4, atol 1e-6 (``tests/test_fused_kernel.py``: fp32 sums in another
order); at ``default`` both packages take bf16 operands, held to the
limits of ``tests/test_torch_fused_pruned.py`` (lse atol = rtol = 2e-5,
gradients within 5e-5 of the largest entry).

The ``requires_cuda`` cases hold each CUDA kernel against its plain
version on the card, with the limits ``chip_smoke.py`` states.  jax is
imported inside the tests that need it.
"""

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.ops import fused_crossclr as fc
from crossclr_tpu_torch.ops import fused_dual as fd
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # highest
GRAD_BOUND = 5e-5  # default: max |error| / max |gradient|
TILES = (32, 32)  # the interpreted Pallas kernels' (row, column) tiles


def _features(b, d, seed=0):
    rng = np.random.default_rng(seed)
    v, t = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(2))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    return v, t


def _cotangents(b, seed=7):
    rng = np.random.default_rng(seed)
    return tuple(((0.5 + rng.random((b, 1))) / (2 * b)).astype(np.float32)
                 for _ in range(2))


def _assert_grad_close(got, want, precision):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if precision is None:
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    else:
        err = np.abs(got - want).max()
        assert err / np.abs(want).max() < GRAD_BOUND, err


def _port_pair(v, t, wv, wt, scale, w, precision):
    tv = torch.tensor(v, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    lv, lt = fc._LsePairDirections.apply(tv, tt, scale, w, precision)
    (torch.from_numpy(wv) * lv + torch.from_numpy(wt) * lt).sum().backward()
    return lv.detach().numpy(), lt.detach().numpy(), tv.grad.numpy(), tt.grad.numpy()


# --------------------------------------------------------------------------
# the plain pair against the interpreted Pallas kernels 11-12
# --------------------------------------------------------------------------


@pytest.mark.parametrize("precision", [None, "default"])
@pytest.mark.parametrize("w", [0.8, 0.0])
@pytest.mark.parametrize("tau", [0.03, 0.01])
@pytest.mark.parametrize("b,d", [(64, 48), (64, 100), (96, 48), (96, 100)])
def test_plain_pair_matches_interpreted_direction_kernels(monkeypatch, b, d, tau,
                                                          w, precision):
    """τ = 0.03 takes the factored backward, τ = 0.01 (s = 100) the
    subtract-first one; w = 0 makes every intra logit 0."""
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.ops import fused_crossclr as jfc
    from crossclr_tpu.ops import fused_dual as jfd

    monkeypatch.setattr(jfd, "dual_supported", lambda b_, d_: False)
    monkeypatch.setattr(jfc, "TILE_OVERRIDE", TILES)
    calls = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "_lse_fwd_direction"), ("bwd", "_lse_bwd_direction")):
        orig = getattr(jfc, name)

        def spy(*args, _orig=orig, _key=key, **kwargs):
            calls[_key] += 1
            return _orig(*args, **kwargs)

        monkeypatch.setattr(jfc, name, spy)

    v, t = _features(b, d, seed=b + d)
    wv, wt = _cotangents(b)

    def jax_fn(v_, t_):
        lv, lt = jfc.fused_lse_pair(v_, t_, temperature=tau, negative_weight=w,
                                    use_pallas=True, interpret=True,
                                    precision=precision)
        return jnp.sum(wv * lv) + jnp.sum(wt * lt), (lv, lt)

    (_, (jlv, jlt)), jgrads = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(v), jnp.asarray(t))
    assert calls == {"fwd": 2, "bwd": 2}  # kernels 11 and 12, each direction
    assert fc.factored(1.0 / tau, w) == (tau == 0.03)
    lv, lt, gv, gt = _port_pair(v, t, wv, wt, 1.0 / tau, w, precision)
    np.testing.assert_allclose(lv, np.asarray(jlv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lt, np.asarray(jlt), rtol=RTOL, atol=ATOL)
    _assert_grad_close(gv, jgrads[0], precision)
    _assert_grad_close(gt, jgrads[1], precision)


@pytest.mark.parametrize("tau", [0.03, 1.0 / 79])
def test_factored_and_subtract_first_forms_agree(tau):
    """Where both hold, the two backward forms are one function: the plain
    backward against its subtract-first arithmetic written out (τ = 1/79:
    s = 79, just inside the strict gate)."""
    b, d, w = 72, 40, 0.8
    v, t = (torch.from_numpy(x) for x in _features(b, d, seed=3))
    g_v, g_t = (torch.from_numpy(x) for x in _cotangents(b))
    s = 1.0 / tau
    assert fc.factored(s, w)
    lse_v, lse_t = fc.lse_fwd_plain(v, t, s, w), fc.lse_fwd_plain(t, v, s, w)
    got = fc.lse_bwd_plain(v, t, lse_v, lse_t, g_v, g_t, s, w)
    eye = torch.eye(b, dtype=torch.bool)
    z_vt, z_vv = s * (v @ t.T), (w * s) * (v @ v.T)
    p = g_v * torch.exp(z_vt - lse_v) + g_t.T * torch.exp(z_vt - lse_t.T)
    q = (g_v * torch.exp(z_vv - lse_v) + g_v.T * torch.exp(z_vv - lse_v.T)
         ).masked_fill(eye, 0.0)
    want = s * (p @ t + w * (q @ v))
    _assert_grad_close(got.numpy(), want.numpy(), None)


@pytest.mark.parametrize("tau", [0.03, 0.01])
@pytest.mark.parametrize("rows", [slice(0, 24), slice(24, 56), slice(56, 72)])
def test_plain_row_blocks_equal_the_whole(tau, rows):
    """A block of anchor rows (each against every candidate, its own intra
    logit still zeroed) is those rows of the whole plain lse and gradient,
    in both backward forms: how a batch too large for ``[B, 2B]`` logits
    is checked."""
    b, d, w = 72, 40, 0.8
    v, t = (torch.from_numpy(x) for x in _features(b, d, seed=5))
    g_v, g_t = (torch.from_numpy(x) for x in _cotangents(b))
    s = 1.0 / tau
    lse_v, lse_t = fc.lse_fwd_plain(v, t, s, w), fc.lse_fwd_plain(t, v, s, w)
    torch.testing.assert_close(fc.lse_fwd_plain(v, t, s, w, rows), lse_v[rows],
                               rtol=RTOL, atol=ATOL)
    whole = fc.lse_bwd_plain(v, t, lse_v, lse_t, g_v, g_t, s, w)
    block = fc.lse_bwd_plain(v, t, lse_v, lse_t, g_v, g_t, s, w, rows)
    _assert_grad_close(block.numpy(), whole[rows].numpy(), None)


def test_gate_is_strict():
    """The backward's own gate (``fused_crossclr.py:327``): strict ``<``,
    where the sym gate takes ``≤``."""
    assert fc.factored(79.9, 0.8) and not fc.factored(80.0, 0.8)
    assert fd.sym_supported(8, 80.0, 0.8)
    assert not fc.factored(40.0, 2.0)  # w·s = 80
    assert fc.factored(40.0, 0.0) and not fc.factored(0.0, 0.8)
    assert not fc.factored(-1.0, 0.8)


# --------------------------------------------------------------------------
# kernel 11's bf16 build: its blocked online logsumexp on the plain algebra
# --------------------------------------------------------------------------

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def _blocked_lse(anchor, other, scale, w):
    """``lse_fwd``'s bf16 kernel on the plain algebra, fp32: the logits in
    log2 units (``(s·log2 e)·a·o``, the intra diagonal zeroed, columns past
    B masked to −inf); each row's candidates in 64-wide tiles, O's tile and
    then A's, each tile's 32-candidate halves held by the two warps that
    share the row.  Each warp keeps per row a running max m over its half
    of the tile (a quad's max) and a sum l rescaled once per tile; at the
    end the two halves merge in a fixed order: ``lse = ln 2·(m + log2 l)``.
    """
    n = anchor.shape[0]
    tiles = -(-n // 64)
    a, o = anchor.float(), other.float()
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    zs = f32(scale) * LOG2E
    zw = (f32(w) * f32(scale)) * LOG2E
    inter = zs * (a @ o.T)
    intra = (zw * (a @ a.T)).masked_fill(torch.eye(n, dtype=torch.bool), 0.0)
    pad = (0, tiles * 64 - n)
    parts = [torch.nn.functional.pad(x, pad, value=-torch.inf).view(n, tiles, 64)
             for x in (inter, intra)]
    # stages in the kernel's order, (tile, part): [n, stage, half, 32]
    halves = torch.stack(parts, dim=2).reshape(n, 2 * tiles, 2, 32)
    m = torch.full((n, 2), -1e30)
    l = torch.zeros(n, 2)
    for st in range(2 * tiles):
        z = halves[:, st]
        m_new = torch.maximum(m, z.amax(dim=-1))
        l = l * torch.exp2(m - m_new) + torch.exp2(z - m_new[..., None]).sum(dim=-1)
        m = m_new
    mm = m.amax(dim=1, keepdim=True)
    total = l[:, :1] * torch.exp2(m[:, :1] - mm) + l[:, 1:] * torch.exp2(m[:, 1:] - mm)
    return LN2 * (mm + torch.log2(total))


def _bf16_features(b, d, seed, noise=0.0):
    """Unit features rounded to bf16 (kept as fp32 values), collapsed near
    one direction when ``noise`` > 0: ``normalize(u + noise·N(0, I))``."""
    rng = np.random.default_rng(seed)
    if noise:
        u = rng.standard_normal((1, d))
        x = [u / np.linalg.norm(u) + noise * rng.standard_normal((b, d)) for _ in range(2)]
    else:
        x = [rng.standard_normal((b, d)) for _ in range(2)]
    return tuple(torch.from_numpy(y / np.linalg.norm(y, axis=1, keepdims=True))
                 .to(torch.bfloat16).float() for y in x)


@pytest.mark.parametrize("tau,noise", [(0.03, 0.0), (0.01, 0.0), (1.0 / 79, 0.0),
                                       (1.0 / 79, 0.005)])
@pytest.mark.parametrize("b,d", [(64, 48), (96, 100)])
def test_blocked_lse_matches_plain_and_interpreted_kernel(b, d, tau, noise):
    """The blocked logsumexp against ``lse_fwd_plain`` and the interpreted
    ``_lse_fwd_direction`` (32 x 32 tiles), both directions, on the same
    bf16-valued features (so the JAX kernel's fp32 products see what the
    bf16 build's mma sees); lse atol = rtol = 2e-5.  τ = 1/79 on collapsed
    features puts every logit near s = 79."""
    import jax.numpy as jnp

    from crossclr_tpu.ops import fused_crossclr as jfc

    v, t = _bf16_features(b, d, seed=b + d, noise=noise)
    s, w = 1.0 / tau, 0.8
    for a, o in ((v, t), (t, v)):
        got = _blocked_lse(a, o, s, w)
        torch.testing.assert_close(got, fc.lse_fwd_plain(a, o, s, w),
                                   rtol=RTOL, atol=ATOL)
        want = jfc._lse_fwd_direction(jnp.asarray(a.numpy()), jnp.asarray(o.numpy()),
                                      s, w, 32, 32, True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if noise:
        assert float(got.min()) > 79.0  # every row past its largest logit


@pytest.mark.parametrize("b", [1, 17, 63, 65, 100, 1000])
@pytest.mark.parametrize("tau", [0.03, 1.0 / 79])
def test_blocked_lse_masks_ragged_tiles(b, tau):
    """Ragged B: the last tile's columns past B are masked (a warp half with
    none left holds m = −1e30, l = 0 and merges away), and B = 1 keeps its
    zeroed self logit; within atol = rtol = 2e-5 of the plain lse."""
    v, t = _bf16_features(b, 24, seed=b)
    for a, o in ((v, t), (t, v)):
        torch.testing.assert_close(_blocked_lse(a, o, 1.0 / tau, 0.8),
                                   fc.lse_fwd_plain(a, o, 1.0 / tau, 0.8),
                                   rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# the route
# --------------------------------------------------------------------------


def test_route_matches_the_jax_choice():
    """Per-direction exactly where the JAX ``fused_lse_pair`` takes its
    per-direction kernels — a static τ, tiles found, ``dual_supported``
    false — over a grid that straddles ``B · lane_pad(D) · 4 = 48 MiB``;
    elsewhere the pair of ``fused_dual.route``."""
    from crossclr_tpu.ops import fused_crossclr as jfc
    from crossclr_tpu.ops import fused_dual as jfd

    checked = 0
    for b in (1024, 24576, 24704, 32768, 49152, 49280, 65536, 98304):
        for d in (100, 128, 129, 256, 257, 384, 512):
            if jfc._pick_tiles(b, d) is None:
                continue
            for tau in (0.03, torch.tensor(0.03), 0.01):
                jax_per_direction = (not isinstance(tau, torch.Tensor)
                                     and not jfd.dual_supported(b, d))
                got = fc.route(b, d, tau, 0.8)
                assert (got == "per_direction") == jax_per_direction, (b, d, tau)
                if got != "per_direction":
                    assert got == fd.route(b, tau, 0.8)
                checked += 1
    assert checked > 100
    # the boundary at the MLP towers' D = 256 (and D = 129 pads to 256)
    assert fc.route(49152, 256, 0.03, 0.8) == "sym"
    assert fc.route(49280, 256, 0.03, 0.8) == "per_direction"
    assert fc.route(49280, 129, 0.03, 0.8) == "per_direction"
    assert fc.route(65536, 256, torch.tensor(0.03), 0.8) == "dual"


def test_fused_lse_pair_takes_the_route(monkeypatch):
    """With the boundary lowered so B = 64 lies past it, a float τ runs the
    per-direction pair and equals the sym pair's lse and gradients; a
    tensor τ stays on the dual pair.  CPU tensors launch nothing."""
    monkeypatch.setattr(fc, "_MAX_COL_ACC_BYTES", 1024)
    used = []
    orig = fc._LsePairDirections.apply
    monkeypatch.setattr(fc._LsePairDirections, "apply",
                        lambda *a: used.append(1) or orig(*a))
    v, t = _features(64, 48, seed=4)
    wv, wt = _cotangents(64)
    before = {**fc.launch_counts, **fd.launch_counts}
    out = []
    for fn in (fc.fused_lse_pair, fd.dual_lse_pair):
        tv = torch.tensor(v, requires_grad=True)
        tt = torch.tensor(t, requires_grad=True)
        lv, lt = fn(tv, tt, temperature=0.03, negative_weight=0.8)
        (torch.from_numpy(wv) * lv + torch.from_numpy(wt) * lt).sum().backward()
        out.append((lv.detach(), lt.detach(), tv.grad, tt.grad))
    assert used == [1]
    for a, c in zip(out[0][:2], out[1][:2]):
        torch.testing.assert_close(a, c, rtol=RTOL, atol=ATOL)
    for a, c in zip(out[0][2:], out[1][2:]):
        _assert_grad_close(a.numpy(), c.numpy(), None)
    fc.fused_lse_pair(torch.from_numpy(v), torch.from_numpy(t),
                      temperature=torch.tensor(0.03))
    assert used == [1]
    assert {**fc.launch_counts, **fd.launch_counts} == before
    with pytest.raises(ValueError, match="precision"):
        fc.fused_lse_pair(torch.from_numpy(v), torch.from_numpy(t),
                          temperature=0.03, precision="high")
    with pytest.raises(ValueError, match="CUDA"):
        fc.lse_fwd_cuda(torch.from_numpy(v), torch.from_numpy(t), 33.3, 0.8)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    return torch.device("cuda")


# both tiers (the scalar fp32 build, the bf16 tensor-core build); ragged n
# and d, each width of the bf16 build's feature chunk (64, 128, 256) and d
# past one chunk (512, 600)
CUDA_CASES = [(b, d, dtype) for b, d in [(256, 64), (200, 100), (64, 600),
                                         (1000, 100), (4096, 512)]
              for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,d,dtype", CUDA_CASES)
@pytest.mark.parametrize("tau", [0.03, 0.01, 1.0 / 79])
def test_cuda_kernels_match_plain(cuda, b, d, dtype, tau):
    """Both kernels against their plain versions, both directions, both
    backward forms (τ = 0.01 subtracts first)."""
    v, t = (torch.from_numpy(x).to(cuda, dtype) for x in _features(b, d, seed=b))
    g_v, g_t = (torch.from_numpy(x).to(cuda) for x in _cotangents(b))
    s, w = 1.0 / tau, 0.8
    before = dict(fc.launch_counts)
    for a, o, g_a, g_o in ((v, t, g_v, g_t), (t, v, g_t, g_v)):
        lse_a, lse_o = fc.lse_fwd_plain(a, o, s, w), fc.lse_fwd_plain(o, a, s, w)
        torch.testing.assert_close(fc.lse_fwd_cuda(a, o, s, w), lse_a,
                                   rtol=RTOL, atol=ATOL)
        got = fc.lse_bwd_cuda(a, o, lse_a, lse_o, g_a, g_o, s, w)
        want = fc.lse_bwd_plain(a, o, lse_a, lse_o, g_a, g_o, s, w)
        _assert_grad_close(got.cpu().numpy(), want.cpu().numpy(), "card")
    torch.cuda.synchronize()
    assert {k: fc.launch_counts[k] - before[k] for k in fc.KERNELS} == {
        "lse_fwd": 2, "lse_bwd": 2}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,d", [(1000, 100), (4096, 256)])
@pytest.mark.parametrize("tau", [0.03, 0.01])
def test_cuda_bf16_lse_bwd_repeat_launches_are_bit_identical(cuda, b, d, tau):
    """Two launches of the bf16 backward on the same inputs give the same
    bits, factored (τ = 0.03) and subtract-first (0.01): one writer per
    output element, a fixed order of sums."""
    v, t = (torch.from_numpy(x).to(cuda, torch.bfloat16)
            for x in _features(b, d, seed=b + 3))
    g_v, g_t = (torch.from_numpy(x).to(cuda) for x in _cotangents(b))
    s, w = 1.0 / tau, 0.8
    lse_v, lse_t = fc.lse_fwd_cuda(v, t, s, w), fc.lse_fwd_cuda(t, v, s, w)
    runs = [fc.lse_bwd_cuda(v, t, lse_v, lse_t, g_v, g_t, s, w) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert bool(torch.isfinite(runs[0]).all())


# the bf16 tensor-core builds of lse_fwd and sym_bwd: ragged n (one tile,
# its edges, 16 tiles), d below one 16-feature step, the element-load path
# (d % 8 != 0), one chunk, and d past one 256-feature chunk
BF16_NS, BF16_DS = [1, 17, 63, 65, 1000], [8, 100, 256, 384, 512]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d", BF16_DS)
@pytest.mark.parametrize("n", BF16_NS)
def test_cuda_bf16_lse_fwd_matches_plain(cuda, n, d):
    """The bf16 forward against its plain version, both directions, τ =
    0.03 and 1/79 (random features, and collapsed ones at 1/79); two
    launches bit for bit."""
    for tau, noise in ((0.03, 0.0), (1.0 / 79, 0.0), (1.0 / 79, 0.005)):
        v, t = (x.to(cuda, torch.bfloat16) for x in _bf16_features(n, d, n + d, noise))
        s = 1.0 / tau
        for a, o in ((v, t), (t, v)):
            got = fc.lse_fwd_cuda(a, o, s, 0.8)
            torch.testing.assert_close(got, fc.lse_fwd_plain(a, o, s, 0.8),
                                       rtol=RTOL, atol=ATOL)
            again = fc.lse_fwd_cuda(a, o, s, 0.8)
            torch.cuda.synchronize()
            assert torch.equal(got, again)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("keep", [None, 0.8, 0.0])
@pytest.mark.parametrize("d", BF16_DS)
@pytest.mark.parametrize("n", BF16_NS)
def test_cuda_bf16_sym_bwd_matches_plain(cuda, n, d, keep):
    """The bf16 sym backward against its plain version at τ = 0.03:
    unpruned, keep masks about 80% kept, and masks that drop every
    candidate but the positive (keep 0); its split count from the card's
    SMs (n = 65 and 1000 split the candidates); two launches bit for bit."""
    v, t = (x.to(cuda, torch.bfloat16) for x in _bf16_features(n, d, n + d))
    g_v, g_t = (torch.from_numpy(x).to(cuda) for x in _cotangents(n))
    masks = ()
    if keep is not None:
        rng = np.random.default_rng(n)
        masks = tuple(torch.from_numpy(rng.random(n) < keep).to(cuda) for _ in range(2))
    s, w = 1.0 / 0.03, 0.8
    lse = fd.sym_fwd_plain(v, t, s, w, *masks)
    before = fd.launch_counts["sym_bwd"]
    got = fd.sym_bwd_cuda(v, t, *lse, g_v, g_t, s, w, *masks)
    want = fd.sym_bwd_plain(v, t, *lse, g_v, g_t, s, w, *masks)
    for a, c in zip(got, want):
        _assert_grad_close(a.cpu().numpy(), c.cpu().numpy(), "card")
    again = fd.sym_bwd_cuda(v, t, *lse, g_v, g_t, s, w, *masks)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    assert fd.launch_counts["sym_bwd"] - before == 2  # one per call


@pytest.mark.requires_cuda
def test_cuda_sym_bwd_split_counts_follow_n(cuda):
    """The bf16 sym backward's scratch names its split: none where one
    tile or the blocks fill the card, parts where few row tiles leave SMs
    idle, more than one count over n; the fp32 build needs none."""
    lib = fd._library()
    split = {n: lib.crossclr_sym_bwd_scratch(1, n, 256, 0) / (2 * n * 256)
             for n in (1, 65, 1000, 65536)}
    assert split[1] == 0 and split[65536] == 0
    assert split[65] >= 2 and split[1000] >= 2 and split[1000] == int(split[1000])
    assert len(set(split.values())) >= 3
    assert lib.crossclr_sym_bwd_scratch(0, 1000, 256, 0) == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("precision", [None, "default"])
def test_cuda_fused_loss_per_direction_matches_cpu(cuda, monkeypatch, precision):
    """Past a lowered boundary the fused loss on the card launches each
    per-direction kernel twice and nothing else, and equals the CPU path."""
    from crossclr_tpu_torch.ops.fused_crossclr import cross_clr_intra_fused

    monkeypatch.setattr(fc, "_MAX_COL_ACC_BYTES", 1024)
    rng = np.random.default_rng(5)
    v, t = (rng.standard_normal((200, 72)).astype(np.float32) for _ in range(2))
    out = []
    for device in ("cpu", cuda):
        before = {**fc.launch_counts, **fd.launch_counts}
        tv = torch.tensor(v, device=device, requires_grad=True)
        tt = torch.tensor(t, device=device, requires_grad=True)
        loss = cross_clr_intra_fused(tv, tt, temperature=0.03, precision=precision)
        loss.backward()
        out.append([loss.detach().cpu(), tv.grad.cpu(), tt.grad.cpu()])
        grown = {k: x - before[k] for k, x in {**fc.launch_counts,
                                                **fd.launch_counts}.items()}
    assert grown == {k: 2 if k in fc.KERNELS else 0 for k in grown}
    cpu, gpu = out
    torch.testing.assert_close(gpu[0], cpu[0], rtol=RTOL, atol=ATOL)
    _assert_grad_close(gpu[1].numpy(), cpu[1].numpy(), "card")
    _assert_grad_close(gpu[2].numpy(), cpu[2].numpy(), "card")


@pytest.mark.requires_cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    v = torch.randn(8, 4, device=cuda)
    g = torch.zeros(8, 1, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fc.lse_fwd_cuda(v.half(), v.half(), 33.3, 0.8)
    with pytest.raises(ValueError, match="contiguous"):
        fc.lse_fwd_cuda(v.T, v.T, 33.3, 0.8)
    with pytest.raises(ValueError, match="g_o"):
        fc.lse_bwd_cuda(v, v, g, g, g, g[:4], 33.3, 0.8)
