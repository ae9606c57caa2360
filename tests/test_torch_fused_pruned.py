"""The keep-mask (pruned, full-CrossCLR) branch of the port's sym and dual
loss pairs against the JAX package's.

On the CPU the port's kernels take their plain versions.  They are held
against the JAX Pallas kernels run in interpret mode with ``pruned=True``
(``_sym_lse_pair`` with a 32-row tile, and ``dual_lse_pair`` with tiles
``(32, 32)``), as ``tests/test_fused_kernel.py`` runs them; the port's
``cross_clr_fused``, which now takes this branch, against its own rows
route (``fused_lse_rows``), an independent formula of the same function.
Inputs are made with numpy from a seed (B = 64, D = 48; ragged B = 72 for
the port alone).

Tolerances (``tests/test_torch_fused_loss.py``): lse atol = rtol = 2e-5
(fp32 sums in another order); feature gradients max error ≤ 5e-5 of the
largest gradient entry; d loss / dτ rtol 1e-4.  The ``default`` tier casts
the operands to bf16 in both packages and is held to the same limits.

The ``requires_cuda`` cases hold the pruned branch of each CUDA kernel
against its plain version on the card, with the limits ``chip_smoke.py``
states.  jax is imported inside the tests that need it.
"""

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.ops import fused_dual as fd
from crossclr_tpu_torch.ops import fused_global as fg
from crossclr_tpu_torch.ops.fused_global import cross_clr_fused, fused_lse_rows

ATOL = RTOL = 2e-5
GRAD_BOUND = 5e-5  # max |error| / max |gradient|
DTAU_RTOL = 1e-4
W = 0.8


def _features(b, d, seed=0, normalize=True):
    rng = np.random.default_rng(seed)
    v, t = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(2))
    if normalize:
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        t /= np.linalg.norm(t, axis=1, keepdims=True)
    return v, t


def _masks(b, seed=11, kept=0.8):
    rng = np.random.default_rng(seed)
    return rng.random(b) < kept, rng.random(b) < kept


def _cotangents(b, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1)).astype(np.float32),
            rng.standard_normal((b, 1)).astype(np.float32))


def _assert_grad_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() + 1e-12
    assert err / scale < GRAD_BOUND, (err, scale)


def _port_pair(fn, v, t, wv, wt):
    """``Σ wv·lse_v + Σ wt·lse_t`` through a port autograd Function:
    values and feature gradients."""
    tv = torch.tensor(v, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    lv, lt = fn(tv, tt)
    (torch.from_numpy(wv) * lv + torch.from_numpy(wt) * lt).sum().backward()
    return lv.detach().numpy(), lt.detach().numpy(), tv.grad.numpy(), tt.grad.numpy()


def _torch_masks(kv, kt):
    return torch.from_numpy(kv), torch.from_numpy(kt)


# --------------------------------------------------------------------------
# the plain pruned pairs against the interpreted Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tau", [0.03, 0.05])
@pytest.mark.parametrize("precision", [None, "default"])
def test_pruned_sym_pair_matches_interpreted_sym_kernels(tau, precision):
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.ops.fused_dual import _sym_lse_pair

    b, d = 64, 48
    v, t = _features(b, d)
    kv, kt = _masks(b)
    wv, wt = _cotangents(b)
    s = 1.0 / tau
    assert fd.sym_supported(b, s, W, pruned=True)
    jkv, jkt = jnp.asarray(kv, jnp.float32), jnp.asarray(kt, jnp.float32)

    def jax_fn(v_, t_):
        lv, lt = _sym_lse_pair(v_, t_, jkv, jkt, s, W, 32, True, precision, True)
        return jnp.sum(wv * lv) + jnp.sum(wt * lt), (lv, lt)

    (_, (jlv, jlt)), jgrads = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(v), jnp.asarray(t))
    lv, lt, gv, gt = _port_pair(
        lambda a, c: fd._SymLsePair.apply(a, c, s, W, precision,
                                          *_torch_masks(kv, kt)), v, t, wv, wt)
    np.testing.assert_allclose(lv, np.asarray(jlv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lt, np.asarray(jlt), rtol=RTOL, atol=ATOL)
    _assert_grad_close(gv, jgrads[0])
    _assert_grad_close(gt, jgrads[1])


@pytest.mark.parametrize("tau", [0.03, 0.0125, 0.01])
@pytest.mark.parametrize("precision", [None, "default"])
def test_pruned_dual_pair_matches_interpreted_dual_kernels(tau, precision):
    """A tensor τ: values, feature gradients and dτ.  τ = 0.01 (s = 100)
    lies outside the pruned sym gate 2·m0 ≤ 80, τ = 0.0125 on its edge."""
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.ops.fused_dual import dual_lse_pair

    b, d = 64, 48
    v, t = _features(b, d, seed=1)
    kv, kt = _masks(b, seed=12)
    wv, wt = _cotangents(b)

    def jax_fn(v_, t_, tau_):
        lv, lt = dual_lse_pair(v_, t_, temperature=tau_, negative_weight=W,
                               interpret=True, tiles=(32, 32),
                               precision=precision, keep_video=jnp.asarray(kv),
                               keep_text=jnp.asarray(kt))
        return jnp.sum(wv * lv) + jnp.sum(wt * lt), (lv, lt)

    (_, (jlv, jlt)), jgrads = jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(v), jnp.asarray(t), jnp.asarray(tau, jnp.float32))
    ttau = torch.tensor(tau, requires_grad=True)
    scale = (1.0 / ttau).reshape(1)
    lv, lt, gv, gt = _port_pair(
        lambda a, c: fd._DualLsePair.apply(a, c, scale, W, precision,
                                           *_torch_masks(kv, kt)), v, t, wv, wt)
    np.testing.assert_allclose(lv, np.asarray(jlv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lt, np.asarray(jlt), rtol=RTOL, atol=ATOL)
    _assert_grad_close(gv, jgrads[0])
    _assert_grad_close(gt, jgrads[1])
    np.testing.assert_allclose(float(ttau.grad), float(jgrads[2]), rtol=DTAU_RTOL)


# --------------------------------------------------------------------------
# edge masks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tensor_tau", [False, True])
@pytest.mark.parametrize("b", [64, 72])
def test_all_pruned_rows_keep_only_their_positive(tensor_tau, b):
    """Every prunable candidate pruned: each row's lse is its positive
    logit s·⟨v_i, t_i⟩, finite, through sym (a float τ) and dual (a tensor
    τ) alike; the gradients stay finite (a dropped pair adds 0 to dτ)."""
    v, t = _features(b, 48, seed=2)
    none = torch.zeros(b, dtype=torch.bool)
    tv = torch.tensor(v, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    tau = torch.tensor(0.03, requires_grad=True) if tensor_tau else 0.03
    lv, lt = fd.dual_lse_pair(tv, tt, temperature=tau, negative_weight=W,
                              keep_video=none, keep_text=none)
    pos = np.sum(v * t, axis=1, keepdims=True) / 0.03
    # m0 + log(exp(z_pos − m0)) with |z_pos − m0| up to 2s ≈ 67 carries a
    # few fp32 ulps at that magnitude on the sym route
    np.testing.assert_allclose(lv.detach().numpy(), pos, rtol=1e-5, atol=5e-5)
    np.testing.assert_allclose(lt.detach().numpy(), pos, rtol=1e-5, atol=5e-5)
    (lv.sum() + lt.sum()).backward()
    assert torch.isfinite(tv.grad).all() and torch.isfinite(tt.grad).all()
    if tensor_tau:
        assert torch.isfinite(tau.grad)


@pytest.mark.parametrize("tensor_tau", [False, True])
def test_all_kept_masks_drop_the_self_column(tensor_tau):
    """All candidates kept is not the unpruned variant: the pruned intra
    self column is dropped, where the released loss keeps its exp(0) = 1.
    The port equals the JAX pruned lse and differs from its own unpruned
    lse by exactly that term."""
    import jax.numpy as jnp

    from crossclr_tpu.ops.fused_dual import dual_lse_pair as jdual

    b = 64
    v, t = _features(b, 48, seed=3)
    ones = np.ones(b, bool)
    # τ = 0.5: the row sums are small enough that fp32 lse resolves the
    # one term
    tau = torch.tensor(0.5) if tensor_tau else 0.5
    pv, pt = fd.dual_lse_pair(torch.from_numpy(v), torch.from_numpy(t),
                              temperature=tau, negative_weight=W,
                              keep_video=torch.from_numpy(ones),
                              keep_text=torch.from_numpy(ones))
    uv, ut = fd.dual_lse_pair(torch.from_numpy(v), torch.from_numpy(t),
                              temperature=tau, negative_weight=W)
    jlv, jlt = jdual(jnp.asarray(v), jnp.asarray(t), temperature=0.5,
                     negative_weight=W, interpret=True, tiles=(32, 32),
                     keep_video=jnp.asarray(ones), keep_text=jnp.asarray(ones))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jlv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jlt), rtol=RTOL, atol=ATOL)
    for pruned, unpruned in ((pv, uv), (pt, ut)):
        assert (unpruned - pruned).min() > 1e-7
        # exp(lse_unpruned) − exp(lse_pruned) = exp(0), the zeroed self logit
        np.testing.assert_allclose(
            (torch.exp(unpruned.double()) - torch.exp(pruned.double())).numpy(),
            1.0, rtol=1e-3)


def test_pruned_extreme_temperature_stays_finite():
    """At 1/τ = 2e4 (the dual route) a row whose only kept candidate, its
    positive, has cosine −1 gives a finite lse equal to the positive logit,
    and finite gradients: a dropped pair's exp is never formed (it would
    overflow) and it adds 0 · z to the dτ sum."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((8, 16)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    zeros = torch.zeros(8, dtype=torch.bool)
    tv = torch.tensor(v, requires_grad=True)
    tau = torch.tensor(5e-5, requires_grad=True)
    lv, lt = fd.dual_lse_pair(tv, -tv, temperature=tau, keep_video=zeros,
                              keep_text=zeros)
    want = np.sum(v * -v, axis=1, keepdims=True) / 5e-5
    for lse in (lv, lt):
        np.testing.assert_allclose(lse.detach().numpy(), want, rtol=1e-6)
    (lv.sum() + lt.sum()).backward()
    assert torch.isfinite(tv.grad).all() and torch.isfinite(tau.grad)


# --------------------------------------------------------------------------
# routing and gates
# --------------------------------------------------------------------------


def test_pruned_gate_matches_the_jax_package():
    """``sym_supported(..., pruned=True)`` against the JAX gate over the grid
    of ``test_gate_boundaries_match_the_jax_package`` (at a shape inside
    every JAX VMEM budget), and the 2·m0 ≤ 80 boundary itself."""
    from crossclr_tpu.ops import fused_dual as jfd

    assert fd.sym_supported(4096, 1.0 / 0.03, 0.8, pruned=True)  # 2·m0 = 66.7
    assert fd.sym_supported(4096, 40.0, 0.8, pruned=True)
    assert not fd.sym_supported(4096, 40.5, 0.8, pruned=True)
    assert fd.sym_supported(4096, 40.5, 0.8)  # the unpruned gate is s ≤ 80
    for b in (64, 1024, 4096):
        for s in (-1.0, 1e-3, 1 / 0.5, 1 / 0.07, 1 / 0.03, 40.0, 40.5, 79.0,
                  80.0, 80.5, 100.0):
            for w in (0.0, 0.8, 1.0, 1.2):
                for pruned in (False, True):
                    assert (fd.sym_supported(b, s, w, pruned=pruned)
                            == jfd.sym_supported(b, 512, s, w, pruned=pruned))


def _spy_routes(monkeypatch):
    """Record which pair and which rows kernel the loss launches."""
    routes = []
    for mod, names in ((fd, ("sym_fwd", "dual_fwd")), (fg, ("rows_lse",))):
        for name in names:
            orig = getattr(mod, name)

            def spy(*args, _orig=orig, _name=name, **kwargs):
                routes.append(_name)
                return _orig(*args, **kwargs)

            monkeypatch.setattr(mod, name, spy)
    return routes


def test_dual_lse_pair_routes_as_the_jax_package(monkeypatch):
    """A float τ inside the pruned gate takes sym; a tensor τ, or a float
    τ outside it (s = 50: 2·m0 = 100 > 80, yet inside the unpruned gate),
    takes dual."""
    routes = _spy_routes(monkeypatch)
    v, t = (torch.from_numpy(x) for x in _features(16, 8))
    kv, kt = _torch_masks(*_masks(16))
    for tau in (0.03, torch.tensor(0.03), 0.02):
        fd.dual_lse_pair(v, t, temperature=tau, keep_video=kv, keep_text=kt)
    fd.dual_lse_pair(v, t, temperature=0.02)
    assert routes == ["sym_fwd", "dual_fwd", "dual_fwd", "sym_fwd"]
    with pytest.raises(ValueError, match="both keep masks"):
        fd.dual_lse_pair(v, t, temperature=0.03, keep_text=kt)


@pytest.mark.parametrize("tau,tensor_tau,pruned", [
    (0.03, False, True), (0.03, True, True), (0.02, False, True),
    (0.02, False, False), (0.01, False, False),
])
def test_route_names_the_pair_dual_lse_pair_runs(monkeypatch, tau, tensor_tau,
                                                 pruned):
    """``fd.route`` (which ``profile_train`` reports) names the pair that
    ``dual_lse_pair`` launches for the same τ and masks."""
    routes = _spy_routes(monkeypatch)
    v, t = (torch.from_numpy(x) for x in _features(16, 8))
    masks = {}
    if pruned:
        masks = dict(zip(("keep_video", "keep_text"), _torch_masks(*_masks(16))))
    temperature = torch.tensor(tau) if tensor_tau else tau
    fd.dual_lse_pair(v, t, temperature=temperature, **masks)
    assert routes == [fd.route(16, temperature, 0.8, pruned) + "_fwd"]


def _raw(seed, b, d):
    return np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)


@pytest.mark.parametrize("tau,tensor_tau,precision,route", [
    (0.03, False, None, "sym_fwd"), (0.03, False, "default", "sym_fwd"),
    (0.03, True, None, "dual_fwd"), (0.03, True, "default", "dual_fwd"),
    (0.01, False, None, "dual_fwd"), (0.05, True, None, "dual_fwd"),
])
def test_cross_clr_fused_equals_the_rows_route(monkeypatch, tau, tensor_tau,
                                               precision, route):
    """``cross_clr_fused`` takes the sym or dual pair (never the rows
    kernels) and equals the same loss built on ``fused_lse_rows``, at a
    ragged B = 72: values, feature gradients and dτ."""
    from crossclr_tpu_torch.losses.functional import (
        connectivity_keep_and_weights,
        connectivity_scores,
        l2_normalize,
    )

    b = 72
    v, t, vi, ti = _raw(0, b, 48), _raw(1, b, 48), _raw(2, b, 40), _raw(3, b, 24)
    kw = dict(prune_percent=0.1, weight_temperature=0.0035, weight_norm="raw")

    def rows_route(v_, t_, tau_):
        vn, tn = l2_normalize(v_, dim=1), l2_normalize(t_, dim=1)
        keep_v, w_v = connectivity_keep_and_weights(
            connectivity_scores(torch.from_numpy(vi)), **kw)
        keep_t, w_t = connectivity_keep_and_weights(
            connectivity_scores(torch.from_numpy(ti)), **kw)
        rk = dict(temperature=tau_, negative_weight=W, precision=precision)
        lse_v = fused_lse_rows(vn, vn, tn, 0, keep_inter=keep_t,
                               keep_intra=keep_v, **rk)[:, 0]
        lse_t = fused_lse_rows(tn, tn, vn, 0, keep_inter=keep_v,
                               keep_intra=keep_t, **rk)[:, 0]
        pos = (vn * tn).sum(dim=1) / tau_
        return ((w_v * (lse_v - pos)).mean() + (w_t * (lse_t - pos)).mean()) / 2

    def fused(v_, t_, tau_):
        return cross_clr_fused(v_, t_, torch.from_numpy(vi), torch.from_numpy(ti),
                               temperature=tau_, negative_weight=W,
                               precision=precision, **kw)

    routes = _spy_routes(monkeypatch)
    out = []
    for fn in (fused, rows_route):
        tv, tt = (torch.tensor(x, requires_grad=True) for x in (v, t))
        ttau = torch.tensor(tau, requires_grad=True) if tensor_tau else tau
        loss = fn(tv, tt, ttau)
        loss.backward()
        out.append([loss.detach(), tv.grad, tt.grad]
                   + ([ttau.grad] if tensor_tau else []))
    assert routes == [route, "rows_lse", "rows_lse"]
    got, want = out
    np.testing.assert_allclose(got[0].item(), want[0].item(), rtol=RTOL, atol=ATOL)
    _assert_grad_close(got[1].numpy(), want[1].numpy())
    _assert_grad_close(got[2].numpy(), want[2].numpy())
    if tensor_tau:
        np.testing.assert_allclose(got[3].item(), want[3].item(), rtol=DTAU_RTOL)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

# lse atol = rtol = 2e-5; gradients ≤ 5e-5 of the largest entry; ds rtol
# 1e-4 — the kernel and its plain version see identical operands (bf16
# ones at the default tier, widened exactly) and differ only in the order
# of their fp32 sums


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    return torch.device("cuda")


CUDA_CASES = [(b, d, dtype) for b, d in [(256, 64), (200, 100), (64, 600)]
              for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,d,dtype", CUDA_CASES)
@pytest.mark.parametrize("kept", [0.8, 0.0, 1.0])
def test_cuda_pruned_kernels_match_plain(cuda, b, d, dtype, kept):
    """The pruned branch of the four kernels: sym at a static τ = 0.03,
    dual at a tensor τ of 0.01; masks about 80% kept, all pruned, all
    kept."""
    v, t = (torch.from_numpy(x).to(cuda, dtype) for x in _features(b, d, seed=b))
    g_v, g_t = (torch.from_numpy(x).to(cuda) for x in _cotangents(b))
    masks = tuple(m.to(cuda) for m in _torch_masks(*_masks(b, kept=kept)))
    s = 1.0 / 0.03
    scale = torch.full((1,), 1.0 / 0.01, device=cuda)
    before = dict(fd.launch_counts)
    want = fd.sym_fwd_plain(v, t, s, W, *masks)
    for a, c in zip(fd.sym_fwd_cuda(v, t, s, W, *masks), want):
        torch.testing.assert_close(a, c, rtol=RTOL, atol=ATOL)
    for a, c in zip(fd.sym_bwd_cuda(v, t, *want, g_v, g_t, s, W, *masks),
                    fd.sym_bwd_plain(v, t, *want, g_v, g_t, s, W, *masks)):
        _assert_grad_close(a.cpu(), c.cpu())
    want = fd.dual_fwd_plain(v, t, scale, W, *masks)
    for a, c in zip(fd.dual_fwd_cuda(v, t, scale, W, *masks), want):
        torch.testing.assert_close(a, c, rtol=RTOL, atol=ATOL)
    kg = fd.dual_bwd_cuda(v, t, scale, *want, g_v, g_t, W, *masks)
    pg = fd.dual_bwd_plain(v, t, scale, *want, g_v, g_t, W, *masks)
    _assert_grad_close(kg[0].cpu(), pg[0].cpu())
    _assert_grad_close(kg[1].cpu(), pg[1].cpu())
    torch.testing.assert_close(kg[2], pg[2], rtol=DTAU_RTOL, atol=1e-6)
    torch.cuda.synchronize()
    assert {k: fd.launch_counts[k] - before[k] for k in fd.KERNELS} == {
        "sym_fwd": 1, "sym_bwd": 1, "dual_fwd": 1, "dual_bwd": 1}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,d", [(32768, 256), (4096, 384), (1024, 256), (1000, 256),
                                 (1024, 200)])
@pytest.mark.parametrize("tau", [0.03, 0.0125])
def test_cuda_pruned_sym_bwd_matches_plain(cuda, b, d, tau):
    """The pruned bf16 sym backward at kernel 5's shapes (masks about 80%
    kept) against its plain version, two launches alike bit for bit, both
    counted under ``sym_bwd_wgmma`` where the library says they took the
    Hopper design."""
    v, t = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _features(b, d, seed=b))
    keep = tuple(m.to(cuda) for m in _torch_masks(*_masks(b)))
    g_v, g_t = (torch.from_numpy(x).to(cuda) for x in _cotangents(b))
    s = 1.0 / tau
    lse = fd.sym_fwd_plain(v, t, s, W, *keep)
    takes = fd._library().crossclr_sym_bwd_wgmma(1, v.data_ptr(), t.data_ptr(), b, d)
    before = dict(fd.launch_counts)
    got = fd.sym_bwd_cuda(v, t, *lse, g_v, g_t, s, W, *keep)
    again = fd.sym_bwd_cuda(v, t, *lse, g_v, g_t, s, W, *keep)
    torch.cuda.synchronize()
    assert {k: fd.launch_counts[k] - before[k] for k in ("sym_bwd", "sym_bwd_wgmma")} == {
        "sym_bwd": 2, "sym_bwd_wgmma": 2 * takes}
    for a, c, r in zip(got, again, fd.sym_bwd_plain(v, t, *lse, g_v, g_t, s, W, *keep)):
        assert torch.equal(a, c)
        _assert_grad_close(a.cpu(), r.cpu())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tensor_tau", [False, True])
def test_cuda_cross_clr_fused_takes_the_pair(cuda, tensor_tau):
    """On the card ``cross_clr_fused`` launches one forward and one
    backward of sym (a float τ) or dual (a tensor τ), no rows kernel, and
    equals the CPU path."""
    v, t, vi, ti = _raw(6, 200, 48), _raw(7, 200, 48), _raw(8, 200, 20), _raw(9, 200, 20)
    out = []
    for device in ("cpu", cuda):
        before = {**fd.launch_counts, **fg.launch_counts}
        tv, tt = (torch.tensor(x, device=device, requires_grad=True) for x in (v, t))
        tau = (torch.tensor(0.03, device=device, requires_grad=True)
               if tensor_tau else 0.03)
        loss = cross_clr_fused(tv, tt, torch.tensor(vi, device=device),
                               torch.tensor(ti, device=device), temperature=tau)
        loss.backward()
        out.append([loss.detach().cpu(), tv.grad.cpu(), tt.grad.cpu()]
                   + ([tau.grad.cpu()] if tensor_tau else []))
        grown = {k: x - before[k] for k, x in {**fd.launch_counts,
                                                **fg.launch_counts}.items()}
    pair = "dual" if tensor_tau else "sym"
    assert grown == {k: int(k in (f"{pair}_fwd", f"{pair}_bwd")) for k in grown}
    cpu, gpu = out
    torch.testing.assert_close(gpu[0], cpu[0], rtol=RTOL, atol=ATOL)
    _assert_grad_close(gpu[1], cpu[1])
    _assert_grad_close(gpu[2], cpu[2])
    if tensor_tau:
        torch.testing.assert_close(gpu[3], cpu[3], rtol=DTAU_RTOL, atol=0)


@pytest.mark.requires_cuda
def test_cuda_wrappers_reject_bad_keep_masks(cuda):
    v = torch.nn.functional.normalize(torch.randn(8, 4, device=cuda), dim=1)
    keep = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="both keep masks"):
        fd.sym_fwd_cuda(v, v, 33.3, W, keep, None)
    with pytest.raises(ValueError, match="keep_video"):
        fd.sym_fwd_cuda(v, v, 33.3, W, keep.float(), keep)
    with pytest.raises(ValueError, match="keep_text"):
        fd.dual_fwd_cuda(v, v, torch.ones(1, device=cuda), W, keep, keep[:4])
    with pytest.raises(ValueError, match="keep_video"):
        fd.sym_fwd_cuda(v, v, 33.3, W, keep.cpu(), keep)
