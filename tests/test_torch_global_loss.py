"""The port's global-negative losses (``crossclr_tpu_torch.parallel``)
against the JAX package's single-device losses on the concatenated batch.

Ranks run as processes of ``torch.multiprocessing`` (spawn) joined by a
``gloo`` group on the CPU, at world sizes 2 and 4; each rendezvous goes
through a file in the test's own ``tmp_path``, so parallel test workers
never share a port.  Every rank computes both losses on its shard, in
every route (the eager rows, the eager rows in candidate chunks of 16, and
the rows kernels' plain versions), differentiates the value it returns and
writes its value and gradients to a file; the parent joins the ranks with
a time limit that fails the test rather than hang it.

The losses must equal the JAX ``cross_clr`` / ``cross_clr_intra`` on the
concatenated batch (values atol = rtol = 2e-5), each rank's feature
gradients the JAX gradients of its shard, and the ranks' summed gradients
of a tensor temperature the JAX one (rtol 2e-4, atol 2e-5: the JAX
tests' limits).  jax is imported inside the tests that need it.
"""

import math
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from crossclr_tpu_torch.losses import functional as F
from crossclr_tpu_torch.parallel import (
    all_gather,
    global_cross_clr,
    global_cross_clr_intra,
    local_rows_cross_clr_intra,
    pruned_rows_global,
)

ATOL = RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
B, D, D_IN, TAU = 32, 16, 12, 0.05
JOIN_SECONDS = 240
# (loss, route): route None = the eager rows, an int = candidate chunks of
# that many columns, "fused" = the rows kernels (their plain versions here)
CASES = [("crossclr", None), ("crossclr", 16), ("crossclr", "fused"),
         ("crossclr_intra", None), ("crossclr_intra", "fused")]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    v, t = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
    vi, ti = (rng.standard_normal((B, D_IN)).astype(np.float32) for _ in range(2))
    return v, t, vi, ti


def _case_loss(case, v, t, vi, ti, tau, group=None):
    loss, route = case
    kw = dict(group=group, temperature=tau, use_fused=route == "fused")
    if loss == "crossclr_intra":
        return global_cross_clr_intra(v, t, **kw)
    chunk = route if isinstance(route, int) else None
    return global_cross_clr(v, t, vi, ti, candidate_chunk=chunk,
                            prune_percent=0.2, **kw)


def _rank_main(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    try:
        v, t, vi, ti = _inputs()
        shard = slice(rank * B // world, (rank + 1) * B // world)
        results = {}
        for i, case in enumerate(CASES):
            tv, tt = (torch.tensor(x[shard], requires_grad=True) for x in (v, t))
            tau = torch.tensor(TAU, requires_grad=True)
            loss = _case_loss(case, tv, tt, torch.from_numpy(vi[shard]),
                              torch.from_numpy(ti[shard]), tau)
            loss.backward()
            results.update({f"{i}_loss": loss.detach().numpy(),
                            f"{i}_dv": tv.grad.numpy(), f"{i}_dt": tt.grad.numpy(),
                            f"{i}_dtau": tau.grad.numpy()})
        np.savez(f"{out_dir}/rank{rank}.npz", **results)
    finally:
        torch.distributed.destroy_process_group()


def _run_ranks(world, tmp_path):
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp_path / "rendezvous"),
                                               str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_SECONDS
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"{world} gloo ranks did not finish in {JOIN_SECONDS} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4])
def gloo_results(request, tmp_path_factory):
    world = request.param
    return world, _run_ranks(world, tmp_path_factory.mktemp(f"gloo{world}"))


def _jax_reference(case):
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.losses import cross_clr, cross_clr_intra

    v, t, vi, ti = _inputs()
    loss, _ = case
    if loss == "crossclr_intra":
        fn = lambda a, b, tau: cross_clr_intra(a, b, temperature=tau)
    else:
        fn = lambda a, b, tau: cross_clr(a, b, vi, ti, temperature=tau,
                                         prune_percent=0.2)
    value, grads = jax.value_and_grad(fn, argnums=(0, 1, 2))(
        jnp.asarray(v), jnp.asarray(t), jnp.asarray(TAU, jnp.float32))
    return float(value), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("index", range(len(CASES)),
                         ids=[f"{loss}-{route}" for loss, route in CASES])
def test_global_losses_match_the_single_device_loss(gloo_results, index):
    world, ranks = gloo_results
    value, (dv, dt, dtau) = _jax_reference(CASES[index])
    b_loc = B // world
    for rank, res in enumerate(ranks):
        np.testing.assert_allclose(float(res[f"{index}_loss"]), value,
                                   rtol=RTOL, atol=ATOL)
        shard = slice(rank * b_loc, (rank + 1) * b_loc)
        for got, want, name in ((res[f"{index}_dv"], dv[shard], "dv"),
                                (res[f"{index}_dt"], dt[shard], "dt")):
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"rank {rank} {name}")
    np.testing.assert_allclose(sum(float(r[f"{index}_dtau"]) for r in ranks),
                               float(dtau), rtol=GRAD_RTOL, atol=GRAD_ATOL)


# --------------------------------------------------------------------------
# one rank, no process group
# --------------------------------------------------------------------------


@pytest.mark.parametrize("index", range(len(CASES)),
                         ids=[f"{loss}-{route}" for loss, route in CASES])
def test_one_rank_without_a_group_is_the_single_device_loss(index):
    """No initialised group: the world is this rank, no collective runs."""
    value, (dv, dt, dtau) = _jax_reference(CASES[index])
    v, t, vi, ti = _inputs()
    tv, tt = (torch.tensor(x, requires_grad=True) for x in (v, t))
    tau = torch.tensor(TAU, requires_grad=True)
    loss = _case_loss(CASES[index], tv, tt, torch.from_numpy(vi),
                      torch.from_numpy(ti), tau)
    loss.backward()
    np.testing.assert_allclose(loss.item(), value, rtol=RTOL, atol=ATOL)
    for got, want in ((tv.grad, dv), (tt.grad, dt), (tau.grad, dtau)):
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_all_gather_without_a_group_is_the_identity():
    x = torch.randn(4, 3)
    assert all_gather(x) is x


@pytest.mark.parametrize("offset", [0, 8, 24])
def test_local_rows_match_the_jax_row_block(offset):
    import jax.numpy as jnp

    from crossclr_tpu.parallel.global_loss import (
        local_rows_cross_clr_intra as jlocal,
    )

    v, t, _, _ = _inputs(1)
    v, t = (x / np.linalg.norm(x, axis=1, keepdims=True) for x in (v, t))
    rows = v[offset:offset + 8]
    got = local_rows_cross_clr_intra(torch.from_numpy(rows), torch.from_numpy(v),
                                     torch.from_numpy(t), offset,
                                     temperature=TAU, negative_weight=0.8)
    want = jlocal(jnp.asarray(rows), jnp.asarray(v), jnp.asarray(t), offset,
                  temperature=TAU, negative_weight=0.8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk", [None, 8, 12])
def test_pruned_rows_match_the_jax_pruned_rows(chunk):
    """Chunked (online logsumexp over a Python loop) and direct: values
    and gradients against the JAX ``pruned_rows_global``; a chunk that
    does not divide B (12) computes the block directly."""
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.parallel.global_loss import pruned_rows_global as jpruned

    v, t, _, _ = _inputs(2)
    v, t = (x / np.linalg.norm(x, axis=1, keepdims=True) for x in (v, t))
    rng = np.random.default_rng(3)
    ki, ka = rng.random(B) > 0.3, rng.random(B) > 0.3
    offset = 16
    kw = dict(temperature=TAU, negative_weight=0.8, candidate_chunk=chunk)
    rows = torch.tensor(v[offset:offset + 8], requires_grad=True)
    tt, tv = (torch.tensor(x, requires_grad=True) for x in (t, v))
    got = pruned_rows_global(rows, tt, tv, torch.from_numpy(ki),
                             torch.from_numpy(ka), offset, **kw)
    got.sum().backward()

    def ref(r, ta, va):
        return jnp.sum(jpruned(r, ta, va, jnp.asarray(ki), jnp.asarray(ka),
                               offset, **kw))

    value, grads = jax.value_and_grad(ref, argnums=(0, 1, 2))(
        jnp.asarray(v[offset:offset + 8]), jnp.asarray(t), jnp.asarray(v))
    np.testing.assert_allclose(got.sum().item(), float(value), rtol=RTOL, atol=ATOL)
    for g, w in zip((rows.grad, tt.grad, tv.grad), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_mismatched_inputs_are_refused():
    v, t, vi, _ = (torch.from_numpy(x) for x in _inputs())
    with pytest.raises(ValueError, match="both input arrays"):
        global_cross_clr(v, t, vi, None)


def test_the_global_loss_is_the_cross_clr_of_the_port():
    """On one rank the chunked global loss equals the port's eager
    ``cross_clr``, 3-D raw inputs pooled on both sides."""
    rng = np.random.default_rng(4)
    v, t = (torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
            for _ in range(2))
    vi, ti = (torch.from_numpy(rng.standard_normal((B, 3, D_IN)).astype(np.float32))
              for _ in range(2))
    got = global_cross_clr(v, t, vi, ti, candidate_chunk=8)
    want = F.cross_clr(v, t, vi, ti)
    assert math.isclose(got.item(), want.item(), rel_tol=RTOL, abs_tol=ATOL)
