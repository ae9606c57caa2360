"""The port's row-block kernels (``ops/fused_global.py``) against the JAX
package's.

On the CPU the port's wrappers take their plain versions.  They are held
against the JAX Pallas kernels run in interpret mode (``fused_lse_rows(...,
interpret=True)``, as ``tests/test_fused_global.py`` runs them) and
against the JAX package's jnp row-block references, case by case with that
file; ``cross_clr_fused`` against the JAX ``cross_clr_fused`` and
``cross_clr``.  Inputs are made with numpy from a seed.

Tolerances (the JAX tests' in interpret mode): lse and loss values
atol = rtol = 2e-5 (fp32 sums in another order); gradients, dτ included,
rtol 2e-4 and atol 2e-5.  The ``default`` tier casts the operands to bf16
in both packages and is held to the same limits.

The ``requires_cuda`` cases hold the three CUDA kernels against their
plain versions on the card, with the limits ``chip_smoke.py`` states.
jax is imported inside the tests that need it.
"""

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.ops import fused_global as fg
from crossclr_tpu_torch.ops.fused_global import (
    cross_clr_fused,
    fused_lse_rows,
    rows_supported,
)

ATOL = RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
B_LOC, B_GLOB = 64, 256


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _setup(seed=0, b_glob=B_GLOB, d=16):
    rng = np.random.default_rng(seed)
    return _unit(rng, b_glob, d), _unit(rng, b_glob, d)


def _masks(seed, n=B_GLOB, p=0.15):
    rng = np.random.default_rng(seed)
    return rng.random(n) > p, rng.random(n) > p


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL, err_msg=err_msg)


def _port(rows_of, v_all, t_all, offset, tau, masks=None, precision=None,
          weights=None):
    """``Σ weights · lse`` through the port (rows = ``v_all[rows_of]``, a
    separate leaf): the lse and the gradients of rows, v_all, t_all, τ."""
    v = torch.tensor(v_all, requires_grad=True)
    t = torch.tensor(t_all, requires_grad=True)
    rows = torch.tensor(v_all[rows_of], requires_grad=True)
    ttau = torch.tensor(tau, requires_grad=True) if tau is not None else 0.03
    kw = {}
    if masks is not None:
        kw = dict(keep_inter=torch.from_numpy(masks[0]),
                  keep_intra=torch.from_numpy(masks[1]))
    lse = fused_lse_rows(rows, v, t, offset, temperature=ttau,
                         precision=precision, **kw)
    w = torch.ones_like(lse) if weights is None else torch.from_numpy(weights)
    (w * lse).sum().backward()
    grads = [rows.grad.numpy(), v.grad.numpy(), t.grad.numpy()]
    if tau is not None:
        grads.append(ttau.grad.numpy())
    return lse.detach().numpy()[:, 0], grads


def _jax(rows_of, v_all, t_all, offset, tau, masks=None, precision=None,
         weights=None):
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.ops.fused_global import fused_lse_rows as jfused

    kw = {}
    if masks is not None:
        kw = dict(keep_inter=jnp.asarray(masks[0]), keep_intra=jnp.asarray(masks[1]))
    w = jnp.ones((v_all[rows_of].shape[0], 1)) if weights is None else jnp.asarray(weights)

    def f(r, va, ta, tau_):
        lse = jfused(r, va, ta, jnp.asarray(offset), temperature=tau_,
                     interpret=True, precision=precision, **kw)
        return jnp.sum(w * lse), lse

    argnums = (0, 1, 2, 3) if tau is not None else (0, 1, 2)
    (_, lse), grads = jax.value_and_grad(f, argnums=argnums, has_aux=True)(
        jnp.asarray(v_all[rows_of]), jnp.asarray(v_all), jnp.asarray(t_all),
        jnp.asarray(tau if tau is not None else 0.03, jnp.float32))
    return np.asarray(lse)[:, 0], [np.asarray(g) for g in grads]


# --------------------------------------------------------------------------
# the plain rows pair against the interpreted Pallas kernels
# --------------------------------------------------------------------------

INTERPRETED_CASES = [(block, pruned, tau) for block in (0, 1, 3)
                     for pruned in (False, True) for tau in (None, 0.07)]


@pytest.mark.parametrize("block,pruned,tau", INTERPRETED_CASES)
def test_rows_pair_matches_interpreted_kernels(block, pruned, tau):
    """lse and the three feature gradients (and dτ at a tensor τ) at row
    offsets of 0, 1 and 3 blocks, with random cotangents."""
    v_all, t_all = _setup(seed=block)
    offset = block * B_LOC
    rows_of = slice(offset, offset + B_LOC)
    masks = _masks(10 + block) if pruned else None
    weights = np.random.default_rng(5).standard_normal((B_LOC, 1)).astype(np.float32)
    got, ggot = _port(rows_of, v_all, t_all, offset, tau, masks, weights=weights)
    want, gwant = _jax(rows_of, v_all, t_all, offset, tau, masks, weights=weights)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for g, w, name in zip(ggot, gwant, ("d_rows", "d_v_all", "d_t_all", "d_tau")):
        _close(g, w, name)


@pytest.mark.parametrize("pruned", [False, True])
def test_default_tier_matches_interpreted_default_tier(pruned):
    """bf16 operands with fp32 accumulation in both packages."""
    v_all, t_all = _setup(seed=4)
    rows_of = slice(B_LOC, 2 * B_LOC)
    masks = _masks(4) if pruned else None
    got, ggot = _port(rows_of, v_all, t_all, B_LOC, 0.05, masks, "default")
    want, gwant = _jax(rows_of, v_all, t_all, B_LOC, 0.05, masks, "default")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for g, w, name in zip(ggot, gwant, ("d_rows", "d_v_all", "d_t_all", "d_tau")):
        _close(g, w, name)


# --------------------------------------------------------------------------
# the cases of tests/test_fused_global.py, against the JAX references
# --------------------------------------------------------------------------


def _ref_lse(rows, v_all, t_all, offset, temperature=0.03, negative_weight=0.8):
    """The JAX jnp row-block reference: per-row loss + positive logit."""
    import jax.numpy as jnp

    from crossclr_tpu.parallel.global_loss import local_rows_cross_clr_intra

    loss = local_rows_cross_clr_intra(
        jnp.asarray(rows), jnp.asarray(v_all), jnp.asarray(t_all), offset,
        temperature=temperature, negative_weight=negative_weight)
    pos = np.sum(rows * t_all[offset:offset + rows.shape[0]], axis=1) / temperature
    return np.asarray(loss) + pos


@pytest.mark.parametrize("block", [0, 1, 3])
def test_lse_matches_reference_at_offsets(block):
    v_all, t_all = _setup(d=32)
    offset = block * B_LOC
    rows = v_all[offset:offset + B_LOC]
    got = fused_lse_rows(torch.from_numpy(rows), torch.from_numpy(v_all),
                         torch.from_numpy(t_all), torch.tensor(offset))[:, 0]
    np.testing.assert_allclose(got.numpy(), _ref_lse(rows, v_all, t_all, offset),
                               rtol=RTOL, atol=ATOL)


def _autodiff_ref(offset, tau):
    """jax.grad of the jnp unpruned row-block lse sum (HIGHEST precision)."""
    import jax
    import jax.numpy as jnp

    def ref_sum(tau_, r, va, ta):
        hp = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
        inter = hp(r, ta.T) / tau_
        intra = 0.8 * hp(r, va.T) / tau_
        ids_r = offset + jnp.arange(r.shape[0])[:, None]
        intra = jnp.where(ids_r == jnp.arange(va.shape[0])[None, :], 0.0, intra)
        cand = jnp.concatenate([inter, intra], axis=1)
        return jnp.sum(jax.scipy.special.logsumexp(cand, axis=1))

    return jax.grad(ref_sum, argnums=(0, 1, 2, 3))


def test_three_way_gradients_match_autodiff():
    import jax.numpy as jnp

    v_all, t_all = _setup()
    offset = 2 * B_LOC
    rows_of = slice(offset, offset + B_LOC)
    _, got = _port(rows_of, v_all, t_all, offset, None)
    want = _autodiff_ref(offset, 0.03)(jnp.asarray(0.03, jnp.float32),
                                       jnp.asarray(v_all[rows_of]),
                                       jnp.asarray(v_all), jnp.asarray(t_all))
    for g, w, name in zip(got, want[1:], ("d_rows", "d_v_all", "d_t_all")):
        _close(g, w, name)


def test_traced_temperature_gradient_matches_autodiff():
    import jax.numpy as jnp

    v_all, t_all = _setup()
    offset = B_LOC
    rows_of = slice(offset, offset + B_LOC)
    _, got = _port(rows_of, v_all, t_all, offset, 0.07)
    want = _autodiff_ref(offset, 0.07)(jnp.asarray(0.07, jnp.float32),
                                       jnp.asarray(v_all[rows_of]),
                                       jnp.asarray(v_all), jnp.asarray(t_all))
    for g, w, name in zip(got, (*want[1:], want[0]),
                          ("d_rows", "d_v_all", "d_t_all", "d_tau")):
        _close(g, w, name)


def test_pruned_masks_match_jnp_reference():
    """Pruned loss rows (lse − positive) against the JAX
    ``pruned_rows_global``: value, the three feature gradients and dτ."""
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.parallel.global_loss import pruned_rows_global

    v_all, t_all = _setup()
    keep_i, keep_a = _masks(3)
    offset = 2 * B_LOC
    rows_np = v_all[offset:offset + B_LOC]

    def ref(tau, r, va, ta):
        return jnp.sum(pruned_rows_global(
            r, ta, va, jnp.asarray(keep_i), jnp.asarray(keep_a), offset,
            temperature=tau, negative_weight=0.8))

    rv, rg = jax.value_and_grad(ref, argnums=(0, 1, 2, 3))(
        jnp.asarray(0.05, jnp.float32), jnp.asarray(rows_np), jnp.asarray(v_all),
        jnp.asarray(t_all))
    tau = torch.tensor(0.05, requires_grad=True)
    r, va, ta = (torch.tensor(x, requires_grad=True) for x in (rows_np, v_all, t_all))
    lse = fused_lse_rows(r, va, ta, offset, temperature=tau,
                         keep_inter=torch.from_numpy(keep_i),
                         keep_intra=torch.from_numpy(keep_a))[:, 0]
    fv = (lse - (r * ta[offset:offset + B_LOC]).sum(dim=1) / tau).sum()
    fv.backward()
    np.testing.assert_allclose(fv.item(), float(rv), rtol=RTOL)
    for g, w, name in zip((tau.grad, r.grad, va.grad, ta.grad), rg,
                          ("d_tau", "d_rows", "d_v_all", "d_t_all")):
        _close(g.numpy(), w, name)


def _raw(seed, b, d):
    return np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)


def test_cross_clr_fused_matches_jnp():
    """The port's ``cross_clr_fused`` (the keep-mask sym/dual pair)
    against the JAX ``cross_clr`` and ``cross_clr_fused``, with raw-input
    connectivity: values and gradients."""
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.losses import cross_clr as jcross_clr
    from crossclr_tpu.ops import cross_clr_fused as jcross_clr_fused

    v, t, vi, ti = _raw(0, 64, 32), _raw(1, 64, 32), _raw(2, 64, 40), _raw(3, 64, 24)
    tv, tt = (torch.tensor(x, requires_grad=True) for x in (v, t))
    loss = cross_clr_fused(tv, tt, torch.from_numpy(vi), torch.from_numpy(ti))
    loss.backward()
    for fn in (lambda a, b: jcross_clr(a, b, vi, ti),
               lambda a, b: jcross_clr_fused(a, b, vi, ti, interpret=True)):
        rv, rg = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(t))
        np.testing.assert_allclose(loss.item(), float(rv), rtol=RTOL)
        _close(tv.grad.numpy(), rg[0], "d_v")
        _close(tt.grad.numpy(), rg[1], "d_t")


def test_pruned_mask_edge_cases():
    """All-kept masks equal the JAX pruned-jnp path; all-pruned masks leave
    only the positive (lse = positive logit), at offset 0 and at an offset
    whose fully masked tiles come before the positive's."""
    import jax.numpy as jnp

    from crossclr_tpu.parallel.global_loss import pruned_rows_global

    v_all, t_all = _setup()
    ones, zeros = np.ones(B_GLOB, bool), np.zeros(B_GLOB, bool)
    va, ta = torch.from_numpy(v_all), torch.from_numpy(t_all)
    rows = v_all[:B_LOC]
    got = fused_lse_rows(torch.from_numpy(rows), va, ta, 0,
                         keep_inter=torch.from_numpy(ones),
                         keep_intra=torch.from_numpy(ones))[:, 0]
    want = np.asarray(pruned_rows_global(
        jnp.asarray(rows), jnp.asarray(t_all), jnp.asarray(v_all),
        jnp.asarray(ones), jnp.asarray(ones), 0, temperature=0.03,
        negative_weight=0.8)) + np.sum(rows * t_all[:B_LOC], axis=1) / 0.03
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    for offset in (0, 2 * B_LOC):
        rows = v_all[offset:offset + B_LOC]
        got = fused_lse_rows(torch.from_numpy(rows), va, ta, offset,
                             keep_inter=torch.from_numpy(zeros),
                             keep_intra=torch.from_numpy(zeros))[:, 0]
        pos = np.sum(rows * t_all[offset:offset + B_LOC], axis=1) / 0.03
        np.testing.assert_allclose(got.numpy(), pos, rtol=RTOL, atol=ATOL)


def test_mask_arg_validation():
    v_all, t_all = (torch.from_numpy(x) for x in _setup())
    with pytest.raises(ValueError, match="both keep masks"):
        fused_lse_rows(v_all[:B_LOC], v_all, t_all, 0,
                       keep_inter=torch.ones(B_GLOB, dtype=torch.bool))
    with pytest.raises(ValueError, match="precision"):
        fused_lse_rows(v_all[:B_LOC], v_all, t_all, 0, precision="high")


def test_nondefault_hparams():
    v_all, t_all = _setup(d=32)
    rows = v_all[:B_LOC]
    got = fused_lse_rows(torch.from_numpy(rows), torch.from_numpy(v_all),
                         torch.from_numpy(t_all), 0, temperature=0.2,
                         negative_weight=0.3)[:, 0]
    want = _ref_lse(rows, v_all, t_all, 0, temperature=0.2, negative_weight=0.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_any_shape_is_supported():
    """The JAX package refuses shapes outside its TPU tiling (10 rows);
    the port masks edges, so they run and match the jnp reference."""
    v_all, t_all = _setup(d=32)
    rows = v_all[3:13]
    assert rows_supported(10, 256, 32)
    got = fused_lse_rows(torch.from_numpy(rows), torch.from_numpy(v_all),
                         torch.from_numpy(t_all), 3)[:, 0]
    np.testing.assert_allclose(got.numpy(), _ref_lse(rows, v_all, t_all, 3),
                               rtol=RTOL, atol=ATOL)


def test_feature_dim_not_lane_aligned():
    v_all, t_all = _setup(d=100)
    rows = v_all[:B_LOC]
    got = fused_lse_rows(torch.from_numpy(rows), torch.from_numpy(v_all),
                         torch.from_numpy(t_all), 0)[:, 0]
    np.testing.assert_allclose(got.numpy(), _ref_lse(rows, v_all, t_all, 0),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weight_norm,weight_temperature", [
    ("raw", 0.0035), ("standardized", 1.0)])
def test_cross_clr_fused_traced_temperature(weight_norm, weight_temperature):
    """d/dτ of the port's ``cross_clr_fused`` against autodiff of the JAX
    ``cross_clr``, under both weightings."""
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.losses import cross_clr as jcross_clr

    v, t = _raw(4, 64, 32), _raw(5, 64, 32)
    kw = dict(weight_norm=weight_norm, weight_temperature=weight_temperature,
              prune_percent=0.2)
    tau = torch.tensor(0.07, requires_grad=True)
    loss = cross_clr_fused(torch.from_numpy(v), torch.from_numpy(t),
                           temperature=tau, **kw)
    loss.backward()
    rv, rd = jax.value_and_grad(
        lambda x: jcross_clr(jnp.asarray(v), jnp.asarray(t), temperature=x, **kw)
    )(jnp.asarray(0.07, jnp.float32))
    np.testing.assert_allclose(loss.item(), float(rv), rtol=RTOL)
    np.testing.assert_allclose(float(tau.grad), float(rd), rtol=GRAD_RTOL)


def test_pruned_extreme_temperature_stays_finite():
    """At 1/τ = 2e4 a row whose only kept candidate, its positive, has
    cosine −1 gives a finite lse equal to the positive logit, and finite
    gradients (the −1e9 masked logit: 0 · −1e9 in the dτ sum)."""
    rng = np.random.default_rng(0)
    v = _unit(rng, 8, 16)
    zeros = torch.zeros(8, dtype=torch.bool)
    tv = torch.tensor(v, requires_grad=True)
    tau = torch.tensor(5e-5, requires_grad=True)
    lse = fused_lse_rows(tv, tv, -tv, 0, temperature=tau, keep_inter=zeros,
                         keep_intra=zeros)[:, 0]
    want = np.sum(v * -v, axis=1) / 5e-5
    assert np.all(np.isfinite(lse.detach().numpy()))
    np.testing.assert_allclose(lse.detach().numpy(), want, rtol=1e-6)
    lse.sum().backward()
    assert torch.isfinite(tv.grad).all() and torch.isfinite(tau.grad)


def test_shared_anchor_tensor_adds_both_gradients():
    """One tensor as anchor_rows AND anchor_all (offset 0, one device):
    autograd adds the rows gradient and the candidates' gradient, which
    equals the two leaves' gradients summed."""
    v_all, t_all = _setup()
    masks = _masks(8)
    rows_of = slice(0, B_GLOB)
    _, (g_rows, g_all, g_t, _) = _port(rows_of, v_all, t_all, 0, 0.05, masks)
    v = torch.tensor(v_all, requires_grad=True)
    t = torch.tensor(t_all, requires_grad=True)
    fused_lse_rows(v, v, t, 0, temperature=0.05,
                   keep_inter=torch.from_numpy(masks[0]),
                   keep_intra=torch.from_numpy(masks[1])).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), g_rows + g_all, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.grad.numpy(), g_t, rtol=1e-6, atol=1e-7)


def test_cpu_tensors_launch_nothing_and_wrappers_refuse_them():
    v_all, t_all = (torch.from_numpy(x) for x in _setup())
    before = dict(fg.launch_counts)
    fused_lse_rows(v_all[:B_LOC], v_all, t_all, 0).sum()
    cross_clr_fused(v_all, t_all)
    assert fg.launch_counts == before
    scale = torch.full((1,), 33.3)
    with pytest.raises(ValueError, match="CUDA"):
        fg.rows_lse_cuda(v_all[:B_LOC], v_all, t_all, 0, scale, 0.8)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

# lse atol = rtol = 2e-5; gradients ≤ 5e-5 of the largest entry; Σ ds_rows
# rtol 1e-4 — the kernel and its plain version see identical operands (bf16
# ones at the default tier, widened exactly) and differ only in the order
# of their fp32 sums
GRAD_BOUND = 5e-5
DS_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    return torch.device("cuda")


def _assert_grad_close(got, want):
    err = (got - want).abs().max().item()
    assert err <= GRAD_BOUND * want.abs().max().item(), err


CUDA_CASES = [(bl, n, d, off, dtype, pruned)
              for bl, n, d, off in [(64, 256, 32, 128), (100, 300, 600, 7),
                                    (200, 200, 72, 0)]
              for dtype in (torch.float32, torch.bfloat16)
              for pruned in (False, True)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bl,n,d,off,dtype,pruned", CUDA_CASES)
def test_cuda_kernels_match_plain(cuda, bl, n, d, off, dtype, pruned):
    rng = np.random.default_rng(bl + d)
    a_all, o_all = (torch.from_numpy(_unit(rng, n, d)).to(cuda, dtype)
                    for _ in range(2))
    rows = a_all[off:off + bl].contiguous()
    masks = (None, None)
    if pruned:
        masks = tuple(torch.from_numpy(m).to(cuda) for m in _masks(bl, n))
    scale = torch.full((1,), 1.0 / 0.05, device=cuda)
    args = (rows, a_all, o_all, off, scale, 0.8)
    before = dict(fg.launch_counts)
    want = fg.rows_lse_plain(*args, *masks)
    torch.testing.assert_close(fg.rows_lse_cuda(*args, *masks), want,
                               rtol=RTOL, atol=ATOL)
    g = torch.from_numpy(rng.standard_normal((bl, 1)).astype(np.float32)).to(cuda)
    bargs = (*args[:5], want, g, 0.8, *masks)
    d_rows, ds_rows = fg.rows_bwd_rows_cuda(*bargs)
    p_rows, p_ds = fg.rows_bwd_rows_plain(*bargs)
    _assert_grad_close(d_rows, p_rows)
    torch.testing.assert_close(ds_rows, p_ds, rtol=RTOL, atol=ATOL)  # row by row
    torch.testing.assert_close(ds_rows.sum(), p_ds.sum(), rtol=DS_RTOL, atol=0)
    for got, exp in zip(fg.rows_bwd_cols_cuda(*bargs), fg.rows_bwd_cols_plain(*bargs)):
        _assert_grad_close(got, exp)
    torch.cuda.synchronize()
    assert {k: fg.launch_counts[k] - before[k] for k in fg.KERNELS} == dict.fromkeys(
        fg.KERNELS, 1)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tensor_tau", [False, True])
def test_cuda_cross_clr_fused_matches_cpu(cuda, tensor_tau):
    v, t, vi, ti = _raw(6, 192, 48), _raw(7, 192, 48), _raw(8, 192, 20), _raw(9, 192, 20)
    out = []
    for device in ("cpu", cuda):
        tv, tt = (torch.tensor(x, device=device, requires_grad=True) for x in (v, t))
        tau = (torch.tensor(0.05, device=device, requires_grad=True)
               if tensor_tau else 0.05)
        loss = cross_clr_fused(tv, tt, torch.tensor(vi, device=device),
                               torch.tensor(ti, device=device), temperature=tau)
        loss.backward()
        out.append([loss.detach().cpu(), tv.grad.cpu(), tt.grad.cpu()]
                   + ([tau.grad.cpu()] if tensor_tau else []))
    cpu, gpu = out
    torch.testing.assert_close(gpu[0], cpu[0], rtol=RTOL, atol=ATOL)
    _assert_grad_close(gpu[1], cpu[1])
    _assert_grad_close(gpu[2], cpu[2])
    if tensor_tau:
        torch.testing.assert_close(gpu[3], cpu[3], rtol=DS_RTOL, atol=0)


@pytest.mark.requires_cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    v = torch.randn(8, 4, device=cuda)
    scale = torch.ones(1, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fg.rows_lse_cuda(v.half(), v.half(), v.half(), 0, scale, 0.8)
    with pytest.raises(ValueError, match="offset"):
        fg.rows_lse_cuda(v[:4], v, v, 5, scale, 0.8)
    with pytest.raises(ValueError, match="keep_inter"):
        fg.rows_lse_cuda(v, v, v, 0, scale, 0.8, torch.ones(8, device=cuda),
                         torch.ones(8, device=cuda, dtype=torch.bool))
    with pytest.raises(ValueError, match="scale"):
        fg.rows_lse_cuda(v, v, v, 0, torch.ones(1), 0.8)
