"""The port's fused CrossCLR-intra loss against the JAX package's.

On the CPU the port's kernels take their plain versions.  They are held
against the JAX Pallas kernels run in interpret mode (``_sym_lse_pair``
and ``dual_lse_pair`` with explicit tiles, as ``tests/test_fused_kernel.py``
runs them), and the port's ``cross_clr_intra_fused`` against the JAX
``cross_clr_intra_fused(use_pallas=True, interpret=True)`` and the torch
oracle of the reference loss (``tests/reference_oracle.py``).  Inputs are
made with numpy from a seed.

Tolerances (the same as the JAX kernel tests in interpret mode):
lse and loss values atol = rtol = 2e-5 (fp32 sums in another order);
feature gradients max error ≤ 5e-5 of the largest gradient entry (at
s = 80 the gradient spans many orders of magnitude); d loss / dτ
rtol 1e-4.  The ``default`` tier casts the operands to bf16 in both
packages, so it is held to the same limits against the JAX ``default``
tier, and to atol 0.05 against the fp32 oracle (bf16 operands).

The ``requires_cuda`` cases hold the four CUDA kernels against their
plain versions on the card, with the limits ``chip_smoke.py`` states.
jax is imported inside the tests that need it.
"""

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.ops import fused_dual as fd
from crossclr_tpu_torch.ops.fused_crossclr import cross_clr_intra_fused

ATOL = RTOL = 2e-5
GRAD_BOUND = 5e-5  # max |error| / max |gradient|
DTAU_RTOL = 1e-4
ORACLE_BF16_ATOL = 0.05


def _features(b, d, seed=0, normalize=True):
    rng = np.random.default_rng(seed)
    v, t = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(2))
    if normalize:
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        t /= np.linalg.norm(t, axis=1, keepdims=True)
    return v, t


def _cotangents(b, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1)).astype(np.float32),
            rng.standard_normal((b, 1)).astype(np.float32))


def _assert_grad_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max() + 1e-12
    assert err / scale < GRAD_BOUND, (err, scale)


def _port_pair(fn, v, t, wv, wt, *extra):
    """``Σ wv·lse_v + Σ wt·lse_t`` through a port autograd Function:
    values and feature gradients (plus the grads of tensor extras)."""
    tv = torch.tensor(v, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    lv, lt = fn(tv, tt, *extra)
    (torch.from_numpy(wv) * lv + torch.from_numpy(wt) * lt).sum().backward()
    return lv.detach().numpy(), lt.detach().numpy(), tv.grad.numpy(), tt.grad.numpy()


# --------------------------------------------------------------------------
# the kernel pairs (plain versions) against the interpreted Pallas kernels
# --------------------------------------------------------------------------

SYM_CASES = [(tau, w, prec) for tau, w in
             [(0.03, 0.8), (0.07, 0.0), (0.0125, 1.0), (0.07, 1.0)]
             for prec in (None, "default")]


@pytest.mark.parametrize("tau,w,precision", SYM_CASES)
def test_sym_pair_matches_interpreted_sym_kernels(tau, w, precision):
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.ops.fused_dual import _sym_lse_pair

    b, d = 64, 48
    v, t = _features(b, d)
    wv, wt = _cotangents(b)
    s = 1.0 / tau
    kd = jnp.zeros((1,), jnp.float32)

    def jax_fn(v_, t_):
        lv, lt = _sym_lse_pair(v_, t_, kd, kd, s, w, 32, True, precision, False)
        return jnp.sum(wv * lv) + jnp.sum(wt * lt), (lv, lt)

    (_, (jlv, jlt)), jgrads = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(jnp.asarray(v), jnp.asarray(t))
    lv, lt, gv, gt = _port_pair(
        lambda a, c: fd._SymLsePair.apply(a, c, s, w, precision), v, t, wv, wt)
    np.testing.assert_allclose(lv, np.asarray(jlv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lt, np.asarray(jlt), rtol=RTOL, atol=ATOL)
    _assert_grad_close(gv, jgrads[0])
    _assert_grad_close(gt, jgrads[1])


DUAL_CASES = [
    (0.03, 0.8, None, False), (0.03, 0.8, "default", False),
    (0.01, 0.8, None, False), (0.01, 1.0, "default", False),
    (0.0125, 0.0, None, False), (0.07, 1.0, None, False),
    # a static τ with pinned tiles: the JAX route takes its factored dual
    # backward, which the port's subtract-first backward must match
    (0.03, 0.8, None, True), (0.07, 0.0, "default", True),
]


@pytest.mark.parametrize("tau,w,precision,static_tau", DUAL_CASES)
def test_dual_pair_matches_interpreted_dual_kernels(tau, w, precision, static_tau):
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.ops.fused_dual import dual_lse_pair

    b, d = 64, 48
    v, t = _features(b, d, seed=1)
    wv, wt = _cotangents(b)

    def jax_fn(v_, t_, tau_):
        lv, lt = dual_lse_pair(v_, t_, temperature=tau_, negative_weight=w,
                               interpret=True, tiles=(32, 32),
                               precision=precision)
        return jnp.sum(wv * lv) + jnp.sum(wt * lt), (lv, lt)

    jv, jt = jnp.asarray(v), jnp.asarray(t)
    if static_tau:  # the JAX route picks the factored form
        (_, (jlv, jlt)), jgrads = jax.value_and_grad(
            lambda a, c: jax_fn(a, c, tau), argnums=(0, 1), has_aux=True)(jv, jt)
    else:  # a traced τ: subtract-first, with dτ
        (_, (jlv, jlt)), jgrads = jax.value_and_grad(
            jax_fn, argnums=(0, 1, 2), has_aux=True)(
                jv, jt, jnp.asarray(tau, jnp.float32))

    ttau = torch.tensor(tau, requires_grad=True)
    scale = (1.0 / ttau).reshape(1)
    lv, lt, gv, gt = _port_pair(
        lambda a, c: fd._DualLsePair.apply(a, c, scale, w, precision),
        v, t, wv, wt)
    np.testing.assert_allclose(lv, np.asarray(jlv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lt, np.asarray(jlt), rtol=RTOL, atol=ATOL)
    _assert_grad_close(gv, jgrads[0])
    _assert_grad_close(gt, jgrads[1])
    if not static_tau:
        np.testing.assert_allclose(float(ttau.grad), float(jgrads[2]),
                                   rtol=DTAU_RTOL)


def test_sym_and_dual_plain_versions_agree_on_the_static_max_path():
    """The two plain pairs are independent formulas of one function
    (constant shift vs running max; factored vs subtract-first)."""
    b, d = 50, 33  # ragged: no tile in the plain versions
    v, t = (torch.from_numpy(x) for x in _features(b, d, seed=3))
    g_v, g_t = (torch.from_numpy(x) for x in _cotangents(b))
    s, w = 1.0 / 0.05, 0.8
    sym = fd.sym_fwd_plain(v, t, s, w)
    dual = fd.dual_fwd_plain(v, t, torch.tensor(s), w)
    for a, c in zip(sym, dual):
        torch.testing.assert_close(a, c, rtol=RTOL, atol=ATOL)
    sym_g = fd.sym_bwd_plain(v, t, *sym, g_v, g_t, s, w)
    dual_g = fd.dual_bwd_plain(v, t, torch.tensor(s), *sym, g_v, g_t, w)
    for a, c in zip(sym_g, dual_g[:2]):
        _assert_grad_close(a.numpy(), c.numpy())


# --------------------------------------------------------------------------
# the fused loss, end to end, and its routing
# --------------------------------------------------------------------------

LOSS_CASES = [
    # (τ, w, tensor τ, precision)
    (0.03, 0.8, False, None), (0.03, 0.8, False, "default"),
    (0.03, 0.8, True, None), (0.03, 0.8, True, "default"),
    (0.07, 0.0, False, None), (0.07, 1.0, True, None),
    (0.0125, 1.0, False, None), (0.0125, 0.8, True, "default"),
    (0.01, 0.8, False, None), (0.01, 0.0, False, "default"),
    (0.01, 1.0, True, None),
]


@pytest.mark.parametrize("tau,w,tensor_tau,precision", LOSS_CASES)
def test_fused_loss_matches_jax_and_oracle(monkeypatch, tau, w, tensor_tau,
                                           precision):
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.ops import cross_clr_intra_fused as jax_fused
    from tests.reference_oracle import oracle_crossclr_intra

    b, d = 64, 40
    v, t = _features(b, d, seed=2, normalize=False)
    routes = []
    for name in ("sym_fwd", "dual_fwd"):
        orig = getattr(fd, name)

        def spy(*args, _orig=orig, _name=name):
            routes.append(_name)
            return _orig(*args)

        monkeypatch.setattr(fd, name, spy)

    tv = torch.tensor(v, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    ttau = torch.tensor(tau, requires_grad=True) if tensor_tau else tau
    loss = cross_clr_intra_fused(tv, tt, temperature=ttau, negative_weight=w,
                                 precision=precision)
    loss.backward()
    want_route = ("sym_fwd" if not tensor_tau and fd.sym_supported(b, 1 / tau, w)
                  else "dual_fwd")
    assert routes == [want_route]

    def jax_fn(v_, t_, tau_):
        return jax_fused(v_, t_, temperature=tau_, negative_weight=w,
                         use_pallas=True, interpret=True, precision=precision)

    jv, jt = jnp.asarray(v), jnp.asarray(t)
    if tensor_tau:
        jl, jg = jax.value_and_grad(jax_fn, argnums=(0, 1, 2))(
            jv, jt, jnp.asarray(tau, jnp.float32))
        np.testing.assert_allclose(float(ttau.grad), float(jg[2]),
                                   rtol=DTAU_RTOL)
    else:
        jl, jg = jax.value_and_grad(lambda a, c: jax_fn(a, c, tau),
                                    argnums=(0, 1))(jv, jt)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL,
                               atol=ATOL)
    _assert_grad_close(tv.grad.numpy(), jg[0])
    _assert_grad_close(tt.grad.numpy(), jg[1])

    want = float(oracle_crossclr_intra(torch.from_numpy(v), torch.from_numpy(t),
                                       temperature=tau, negative_weight=w))
    atol = ATOL if precision is None else ORACLE_BF16_ATOL
    np.testing.assert_allclose(float(loss.detach()), want, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("case", range(6))
def test_fuzz_fused_loss_matches_the_eager_loss(case):
    """Random shapes and hyperparameters, as ``tests/test_fuzz_kernels.py``
    draws them (τ in [0.02, 0.5), w in [0, 1)), through the routing and
    the autograd Functions (plain pairs on the CPU) against the eager
    loss, with that file's limits: value atol = rtol = 3e-5, gradients
    rtol 3e-4 / atol 3e-5."""
    from crossclr_tpu_torch.losses import functional as F

    r = np.random.default_rng(1000 + case)
    b = int(r.choice((1, 7, 40, 65, 130)))
    d = int(r.choice((1, 3, 33, 100)))
    tau, w = float(r.uniform(0.02, 0.5)), float(r.uniform(0.0, 1.0))
    tensor_tau = bool(case % 2)
    v, t = _features(b, d, seed=case, normalize=False)
    out = []
    for fn in (cross_clr_intra_fused, F.cross_clr_intra):
        tv = torch.tensor(v, requires_grad=True)
        tt = torch.tensor(t, requires_grad=True)
        ttau = torch.tensor(tau, requires_grad=True) if tensor_tau else tau
        loss = fn(tv, tt, temperature=ttau, negative_weight=w)
        loss.backward()
        out.append([loss.detach(), tv.grad, tt.grad]
                   + ([ttau.grad] if tensor_tau else []))
    draw = str((b, d, tau, w, tensor_tau))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=3e-5, atol=3e-5,
                               err_msg=draw)
    for a, c in zip(out[0][1:], out[1][1:]):
        np.testing.assert_allclose(a, c, rtol=3e-4, atol=3e-5, err_msg=draw)


def test_fused_gradients_leave_in_fp32_at_the_default_tier():
    v, t = (torch.tensor(x, requires_grad=True) for x in _features(16, 8))
    lv, lt = fd.dual_lse_pair(v, t, temperature=0.03, precision="default")
    (lv.sum() + lt.sum()).backward()
    assert v.grad.dtype == torch.float32 and t.grad.dtype == torch.float32
    assert fd._fetch_cast("default", v)[0].dtype == torch.bfloat16
    assert fd._fetch_cast("highest", v)[0].dtype == torch.float32


def test_gate_boundaries_match_the_jax_package():
    """The gates of ``tests/test_fused_kernel.py:258`` and ``:408``, and
    the port's numerical gate against the JAX one across a grid (at a
    shape inside every JAX VMEM budget)."""
    from crossclr_tpu.ops import fused_dual as jfd

    assert fd.sym_supported(4096, 1.0 / 0.03, 0.8)
    assert not fd.sym_supported(4096, 1.0 / 0.01, 0.8)  # s = 100 > 80
    assert not fd.sym_supported(4096, -1.0, 0.8)
    assert fd._coeff_safe(4096, 1.0 / 0.03, 0.8)
    # s = 79 passes the exp(z) bound but 79 + log(8193) > 85
    assert not fd._coeff_safe(4096, 79.0, 0.8)
    assert not fd.sym_supported(4096, 79.0, 0.8)
    assert fd._coeff_safe(8, 79.0, 0.0)
    for b in (64, 1024, 4096):  # the JAX budget gates admit these
        for s in (-1.0, 1e-3, 1 / 0.5, 1 / 0.07, 1 / 0.03, 79.0, 80.0, 80.5, 100.0):
            for w in (0.0, 0.8, 1.0, 1.2):
                assert fd.sym_supported(b, s, w) == jfd.sym_supported(b, 512, s, w)
                assert fd._coeff_safe(b, s, w) == jfd._coeff_safe(b, s, w)


def test_refusals_and_cpu_tensors_launch_nothing():
    v, t = (torch.from_numpy(x) for x in _features(8, 4))
    before = dict(fd.launch_counts)
    fd.dual_lse_pair(v, t, temperature=0.03)
    fd.dual_lse_pair(v, t, temperature=torch.tensor(0.03))
    assert fd.launch_counts == before
    keep = torch.ones(8, dtype=torch.bool)
    fd.dual_lse_pair(v, t, temperature=0.03, keep_video=keep, keep_text=keep)
    fd.dual_lse_pair(v, t, temperature=torch.tensor(0.03), keep_video=keep,
                     keep_text=keep)
    assert fd.launch_counts == before
    with pytest.raises(ValueError, match="both keep masks"):
        fd.dual_lse_pair(v, t, temperature=0.03, keep_video=keep)
    with pytest.raises(ValueError, match="precision"):
        fd.dual_lse_pair(v, t, temperature=0.03, precision="high")
    with pytest.raises(ValueError, match="CUDA"):
        fd.sym_fwd_cuda(v, t, 33.3, 0.8)


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
def test_cuda_kernels_match_plain(cuda, b, d, dtype):
    v, t = (torch.from_numpy(x).to(cuda, dtype) for x in _features(b, d, seed=b))
    g_v, g_t = (torch.from_numpy(x).to(cuda) for x in _cotangents(b))
    s, w = 1.0 / 0.03, 0.8
    scale = torch.full((1,), 1.0 / 0.01, device=cuda)
    before = dict(fd.launch_counts)
    got = fd.sym_fwd_cuda(v, t, s, w)
    want = fd.sym_fwd_plain(v, t, s, w)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=RTOL, atol=ATOL)
    for a, c in zip(fd.sym_bwd_cuda(v, t, *want, g_v, g_t, s, w),
                    fd.sym_bwd_plain(v, t, *want, g_v, g_t, s, w)):
        _assert_grad_close(a.cpu(), c.cpu())
    got = fd.dual_fwd_cuda(v, t, scale, w)
    want = fd.dual_fwd_plain(v, t, scale, w)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=RTOL, atol=ATOL)
    kg = fd.dual_bwd_cuda(v, t, scale, *want, g_v, g_t, w)
    pg = fd.dual_bwd_plain(v, t, scale, *want, g_v, g_t, w)
    _assert_grad_close(kg[0].cpu(), pg[0].cpu())
    _assert_grad_close(kg[1].cpu(), pg[1].cpu())
    torch.testing.assert_close(kg[2], pg[2], rtol=DTAU_RTOL, atol=0)
    torch.cuda.synchronize()
    assert {k: fd.launch_counts[k] - before[k] for k in fd.KERNELS} == {
        "sym_fwd": 1, "sym_bwd": 1, "dual_fwd": 1, "dual_bwd": 1}


# kernel 5 where its callers run it: podslice_train's 32,768 x 256,
# lsmdc_train's 4096 x 384 (two gradient chunks), the MLP leg's 1024 x 256,
# a ragged B and a D off the 64-feature box
@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,d", [(32768, 256), (4096, 384), (1024, 256), (1000, 256),
                                 (1024, 200)])
@pytest.mark.parametrize("tau", [0.03, 0.0125])
def test_cuda_sym_bwd_matches_plain(cuda, b, d, tau):
    """The bf16 sym backward against its plain version (GRAD_BOUND), two
    launches alike bit for bit, and both counted under ``sym_bwd_wgmma``
    where the library says they took the Hopper design (at podslice_train's
    32,768 x 256 they must)."""
    v, t = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _features(b, d, seed=b))
    g_v, g_t = (torch.from_numpy(x).to(cuda) for x in _cotangents(b))
    s, w = 1.0 / tau, 0.8
    lse = fd.sym_fwd_plain(v, t, s, w)
    takes = fd._library().crossclr_sym_bwd_wgmma(1, v.data_ptr(), t.data_ptr(), b, d)
    if (b, d) == (32768, 256):
        assert takes == 1
    before = dict(fd.launch_counts)
    got = fd.sym_bwd_cuda(v, t, *lse, g_v, g_t, s, w)
    again = fd.sym_bwd_cuda(v, t, *lse, g_v, g_t, s, w)
    torch.cuda.synchronize()
    assert {k: fd.launch_counts[k] - before[k] for k in ("sym_bwd", "sym_bwd_wgmma")} == {
        "sym_bwd": 2, "sym_bwd_wgmma": 2 * takes}
    for a, c, r in zip(got, again, fd.sym_bwd_plain(v, t, *lse, g_v, g_t, s, w)):
        assert torch.equal(a, c)
        _assert_grad_close(a.cpu(), r.cpu())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tensor_tau", [False, True])
def test_cuda_fused_loss_matches_cpu(cuda, tensor_tau):
    v, t = _features(128, 72, seed=5, normalize=False)
    grads = []
    for device in ("cpu", cuda):
        tv = torch.tensor(v, device=device, requires_grad=True)
        tt = torch.tensor(t, device=device, requires_grad=True)
        tau = torch.tensor(0.03, device=device, requires_grad=True) \
            if tensor_tau else 0.03
        loss = cross_clr_intra_fused(tv, tt, temperature=tau)
        loss.backward()
        grads.append([loss.detach().cpu(), tv.grad.cpu(), tt.grad.cpu()]
                     + ([tau.grad.cpu()] if tensor_tau else []))
    cpu, gpu = grads
    torch.testing.assert_close(gpu[0], cpu[0], rtol=RTOL, atol=ATOL)
    _assert_grad_close(gpu[1], cpu[1])
    _assert_grad_close(gpu[2], cpu[2])
    if tensor_tau:
        torch.testing.assert_close(gpu[3], cpu[3], rtol=DTAU_RTOL, atol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", range(8))
def test_cuda_fuzz_fused_loss_matches_cpu(cuda, case):
    """Random ragged shapes (D > 512 splits the backward over blocks),
    τ in [0.01, 0.5) (s > 80 takes the dual route at a float τ), w in
    [0, 1), both tiers, float and tensor τ: the kernels through the whole
    autograd path against the plain pairs on the CPU."""
    r = np.random.default_rng(2960 + case)  # a draw set with b in {1, 1000}, D > 512 and s > 80
    b = int(r.choice((1, 63, 65, 257, 1000)))
    d = int(r.choice((2, 33, 256, 513, 700)))
    tau = float(np.exp(r.uniform(np.log(0.01), np.log(0.5))))
    w = float(r.uniform(0.0, 1.0))
    tensor_tau, precision = bool(case % 2), (None, "default")[case // 4]
    v, t = _features(b, d, seed=case, normalize=False)
    out = []
    for device in ("cpu", cuda):
        tv = torch.tensor(v, device=device, requires_grad=True)
        tt = torch.tensor(t, device=device, requires_grad=True)
        ttau = (torch.tensor(tau, device=device, requires_grad=True)
                if tensor_tau else tau)
        loss = cross_clr_intra_fused(tv, tt, temperature=ttau, negative_weight=w,
                                     precision=precision)
        loss.backward()
        out.append([loss.detach().cpu(), tv.grad.cpu(), tt.grad.cpu()]
                   + ([ttau.grad.cpu()] if tensor_tau else []))
    cpu, gpu = out
    draw = (b, d, tau, w, tensor_tau, precision)
    torch.testing.assert_close(gpu[0], cpu[0], rtol=RTOL, atol=ATOL, msg=str(draw))
    _assert_grad_close(gpu[1], cpu[1])
    _assert_grad_close(gpu[2], cpu[2])
    if tensor_tau:
        torch.testing.assert_close(gpu[3], cpu[3], rtol=DTAU_RTOL, atol=0,
                                   msg=str(draw))


@pytest.mark.requires_cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    v = torch.randn(8, 4, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fd.sym_fwd_cuda(v.half(), v.half(), 33.3, 0.8)
    with pytest.raises(ValueError, match="contiguous"):
        fd.sym_fwd_cuda(v.T, v.T, 33.3, 0.8)
    with pytest.raises(ValueError, match="scale"):
        fd.dual_fwd_cuda(v, v, torch.ones(1), 0.8)  # scale on the CPU

