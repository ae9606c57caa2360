"""The port's eager losses and criterion classes against the JAX package.

``losses.functional`` and ``losses.criterion`` on the same numpy inputs
as ``crossclr_tpu.losses`` and the torch oracle of the reference loss
(``tests/reference_oracle.py``).  Tolerances: fp32 values atol = rtol =
1e-5 and gradients max error ≤ 5e-5 of the largest entry (the same
products summed in another order); float64 inputs against the float64
oracle at rtol 1e-12 (the port computes in the inputs' dtype).  jax is
imported inside the tests that compare with it.
"""

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.losses import criterion as C
from crossclr_tpu_torch.losses import functional as F

TOL = 1e-5
GRAD_BOUND = 5e-5


def _features(b=24, d=16, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, d)).astype(dtype) for _ in range(2))


def _assert_grad_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() / (np.abs(want).max() + 1e-30) < GRAD_BOUND


def _port(fn, v, t, **kw):
    tv, tt = (torch.tensor(x, requires_grad=True) for x in (v, t))
    loss = fn(tv, tt, **kw)
    loss.backward()
    return float(loss.detach()), tv.grad.numpy(), tt.grad.numpy()


@pytest.mark.parametrize("tau,w", [(0.03, 0.8), (0.07, 0.0), (0.0125, 1.0),
                                   (0.5, 0.3)])
def test_cross_clr_intra_matches_jax_and_oracle(tau, w):
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.losses import functional as JF
    from tests.reference_oracle import oracle_crossclr_intra

    v, t = _features(seed=1)
    loss, gv, gt = _port(F.cross_clr_intra, v, t, temperature=tau,
                         negative_weight=w)
    jl, (jgv, jgt) = jax.value_and_grad(
        lambda a, c: JF.cross_clr_intra(a, c, temperature=tau, negative_weight=w),
        argnums=(0, 1))(jnp.asarray(v), jnp.asarray(t))
    np.testing.assert_allclose(loss, float(jl), rtol=TOL, atol=TOL)
    _assert_grad_close(gv, jgv)
    _assert_grad_close(gt, jgt)
    want = float(oracle_crossclr_intra(torch.from_numpy(v), torch.from_numpy(t),
                                       temperature=tau, negative_weight=w))
    np.testing.assert_allclose(loss, want, rtol=TOL, atol=TOL)
    # the per-row losses, direction by direction
    rows = F.cross_clr_intra_per_row(torch.from_numpy(v), torch.from_numpy(t),
                                     temperature=tau, negative_weight=w)
    jrows = JF.cross_clr_intra_per_row(jnp.asarray(v), jnp.asarray(t),
                                       temperature=tau, negative_weight=w)
    for a, c in zip(rows, jrows):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=TOL, atol=TOL)


def test_float64_inputs_keep_the_float64_tail():
    from tests.reference_oracle import oracle_crossclr_intra

    v, t = (torch.from_numpy(x) for x in _features(seed=2, dtype=np.float64))
    got = F.cross_clr_intra(v, t, temperature=0.03, negative_weight=0.8)
    want = oracle_crossclr_intra(v, t, temperature=0.03, negative_weight=0.8)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def test_tensor_temperature_gradient_matches_jax():
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.losses import functional as JF

    v, t = _features(seed=3)
    tau = torch.tensor(0.05, requires_grad=True)
    F.cross_clr_intra(torch.from_numpy(v), torch.from_numpy(t), temperature=tau,
                      negative_weight=0.8).backward()
    jg = jax.grad(lambda s: JF.cross_clr_intra(
        jnp.asarray(v), jnp.asarray(t), temperature=s, negative_weight=0.8))(
            jnp.asarray(0.05, jnp.float32))
    np.testing.assert_allclose(float(tau.grad), float(jg), rtol=1e-4)


def test_cosine_sim_is_the_raw_dot_product():
    from crossclr_tpu.losses import functional as JF

    v, t = _features(b=5, d=7, seed=4)
    got = F.cosine_sim(torch.from_numpy(v), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, v @ t.T, rtol=TOL, atol=TOL)  # no normalization
    np.testing.assert_allclose(got, np.asarray(JF.cosine_sim(v, t)), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("tau", [0.03, 0.2])
def test_info_nce_matches_jax(tau):
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.losses import functional as JF

    v, t = _features(seed=5)
    loss, gv, gt = _port(F.info_nce, v, t, temperature=tau)
    jl, (jgv, jgt) = jax.value_and_grad(
        lambda a, c: JF.info_nce(a, c, temperature=tau), argnums=(0, 1))(
            jnp.asarray(v), jnp.asarray(t))
    np.testing.assert_allclose(loss, float(jl), rtol=TOL, atol=TOL)
    _assert_grad_close(gv, jgv)
    _assert_grad_close(gt, jgt)


@pytest.mark.parametrize("margin", [0.1, 0.5])
def test_max_margin_matches_jax_and_oracle(margin):
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.losses import functional as JF
    from tests.reference_oracle import oracle_max_margin

    v, t = _features(seed=6)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    loss, gv, gt = _port(F.max_margin, v, t, margin=margin)
    jl, (jgv, jgt) = jax.value_and_grad(
        lambda a, c: JF.max_margin(a, c, margin=margin), argnums=(0, 1))(
            jnp.asarray(v), jnp.asarray(t))
    np.testing.assert_allclose(loss, float(jl), rtol=TOL, atol=TOL)
    _assert_grad_close(gv, jgv)
    _assert_grad_close(gt, jgt)
    want = float(oracle_max_margin(torch.from_numpy(v), torch.from_numpy(t),
                                   margin=margin))
    np.testing.assert_allclose(loss, want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="paired"):
        F.max_margin(torch.from_numpy(v), torch.from_numpy(t[:-1]))


def test_criterion_classes_match_jax():
    import jax.numpy as jnp

    from crossclr_tpu.losses import criterion as JC

    v, t = _features(seed=7)
    tv, tt = torch.from_numpy(v), torch.from_numpy(t)
    jv, jt = jnp.asarray(v), jnp.asarray(t)
    for backend in ("jnp", "fused", "fused_fast"):
        port = C.CrossCLR_onlyIntraModality(temperature=0.05, negative_weight=0.7,
                                            backend=backend)
        ref = JC.CrossCLR_onlyIntraModality(temperature=0.05, negative_weight=0.7,
                                            backend=backend)
        # fused_fast: bf16 operands in both packages
        tol = 5e-3 if backend == "fused_fast" else TOL
        np.testing.assert_allclose(float(port(tv, tt)), float(ref(jv, jt)),
                                   rtol=tol, atol=tol, err_msg=backend)
    np.testing.assert_allclose(float(C.InfoNCE()(tv, tt)),
                               float(JC.InfoNCE()(jv, jt)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(C.MaxMarginCoot(margin=0.2)(tv, tt)),
                               float(JC.MaxMarginCoot(margin=0.2)(jv, jt)),
                               rtol=TOL, atol=TOL)


def test_criterion_defaults_and_refusals():
    crit = C.CrossCLR_onlyIntraModality()
    assert (crit.temperature, crit.negative_w, crit.backend) == (0.03, 0.8, "jnp")
    # the reference's vestigial parameter: registered, never in the math
    assert [n for n, _ in crit.named_parameters()] == ["logit_scale"]
    assert C.InfoNCE().temperature == 0.03 and C.MaxMarginCoot().margin == 0.1
    with pytest.raises(ValueError, match="backend"):
        C.CrossCLR_onlyIntraModality(backend="pallas")
    # the full CrossCLR criterion: the JAX class's defaults, the same
    # vestigial parameter
    full = C.CrossCLR()
    assert (full.temperature, full.negative_w, full.weight_temperature,
            full.prune_percent, full.weight_norm) == (0.03, 0.8, 0.0035, 0.1, "raw")
    assert [n for n, _ in full.named_parameters()] == ["logit_scale"]
