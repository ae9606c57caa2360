"""The port's ring attention (``parallel.sequence_parallel_attention``)
against the JAX package's on the conftest's 8 CPU devices.

Ranks run as ``torch.multiprocessing`` (spawn) processes joined by a
``gloo`` group on the CPU, 2 and 4 of them; each world's rendezvous is a
file in its own temp directory, and the parent joins the ranks with a time
limit that fails the test rather than hang it.  One world of each size
serves every case: the first test worker that needs it spawns it under a
file lock and the others read its results.

Each case feeds the same global ``[B, H, S, Dh]`` q, k, v (and ``[B, S]``
key mask) to both packages on the same grid: ``make_mesh(n_data=1,
n_model=M)`` at M = 2 and 4, and ``make_mesh(n_data=2, n_model=2)``, whose
batch split places each data shard's rows in the global batch·head range
of the dropout mask.  Compared: the output and the gradients of
``sum(sin(out))`` with respect to q, k and v (every rank holds the global
ones), unmasked and masked, a batch entry with every key masked (zeros
out, zero gradients), dropout 0.3 at M = 4 and at 2 × 2.  Both of the
port's block implementations are held to the JAX ``"jnp"`` ring: ``"jnp"``
(the plain online softmax) and ``"flash"`` (the flash kernels' plain
versions on CPU tensors); the port's ``"flash"`` blocks also to the JAX
flash ring with its Pallas kernels interpreted, at M = 2.

Limits, the JAX package's own (``tests/test_attention.py``): values rtol =
atol = 1e-5, gradients rtol 1e-4, atol 1e-5.
"""

import fcntl
import pickle
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_SECONDS = 240
VALUE_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
B, H, S, DH = 4, 2, 16, 8
MASKED_ROW = 1  # every key of this batch entry masked
# (n_data, n_model, masked, dropout rate)
CASES = {
    "m2": (1, 2, False, 0.0),
    "m2_masked": (1, 2, True, 0.0),
    "m4_masked": (1, 4, True, 0.0),
    "m4_dropout": (1, 4, True, 0.3),
    "dpsp_dropout": (2, 2, True, 0.3),
}
IMPLS = ("jnp", "flash")
SEED = 7


def _inputs(case: str) -> tuple:
    """The case's global q, k, v and mask (None unmasked) as numpy."""
    _, _, masked, _ = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q, k, v = (rng.standard_normal((B, H, S, DH)).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        mask = (rng.random((B, S)) > 0.3).astype(np.float32)
        mask[MASKED_ROW] = 0.0
    return q, k, v, mask


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _rank_case(case: str, impl: str) -> dict:
    from crossclr_tpu_torch.parallel import make_mesh, sequence_parallel_attention

    n_data, n_model, _, rate = CASES[case]
    mesh = make_mesh(n_data=n_data, n_model=n_model)
    q, k, v, mask = (None if x is None else torch.from_numpy(x)
                     for x in _inputs(case))
    for x in (q, k, v):
        x.requires_grad_()
    out = sequence_parallel_attention(q, k, v, mask, mesh=mesh, block_impl=impl,
                                      dropout_rate=rate, dropout_seed=SEED)
    torch.sin(out).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy(),
            "coords": (mesh.data_index, mesh.model_index)}


def _rank_main(rank, world, init_file, shared):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        results = {}
        for case, (n_data, n_model, _, _) in CASES.items():
            if n_data * n_model == world:
                for impl in IMPLS:
                    results[(case, impl)] = _rank_case(case, impl)
        with open(Path(shared) / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(results, fh)
    finally:
        dist.destroy_process_group()


def _spawn(world: int, shared: Path) -> list[dict]:
    ctx = mp.start_processes(_rank_main, args=(world, str(shared / "rendezvous"),
                                               str(shared)),
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
    ranks = []
    for r in range(world):
        with open(shared / f"rank{r}.pkl", "rb") as fh:
            ranks.append(pickle.load(fh))
    return ranks


def _world(request, tmp_path_factory, world: int) -> list[dict]:
    """The ranks' results of a world, spawned once per run, whichever test
    worker comes first."""
    base = tmp_path_factory.getbasetemp()
    worker = getattr(request.config, "workerinput", None)
    root = (base.parent / f"torch_ring_{worker['testrunuid']}" if worker is not None
            else base / "torch_ring")
    shared = root / f"world{world}"
    shared.mkdir(parents=True, exist_ok=True)
    with open(root / f"world{world}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = shared / "ranks.pkl"
        if not done.exists():
            with open(done, "wb") as fh:
                pickle.dump(_spawn(world, shared), fh)
        with open(done, "rb") as fh:
            return pickle.load(fh)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

_JAX = {}


def _jax_case(case: str, block_impl: str = "jnp") -> dict:
    """The JAX ring's output and gradients of ``sum(sin(out))`` on the
    case's grid (cached per test process)."""
    key = (case, block_impl)
    if key not in _JAX:
        import jax
        import jax.numpy as jnp

        from crossclr_tpu.parallel import make_mesh, sequence_parallel_attention

        n_data, n_model, _, rate = CASES[case]
        mesh = make_mesh(n_data=n_data, n_model=n_model)
        q, k, v, mask = (None if x is None else jnp.asarray(x) for x in _inputs(case))

        def attend(q_, k_, v_):
            return sequence_parallel_attention(
                q_, k_, v_, mask, mesh=mesh, axis="model", block_impl=block_impl,
                interpret=block_impl == "flash", dropout_rate=rate,
                dropout_seed=SEED)

        @jax.jit
        def run(q_, k_, v_):  # one trace: the output and sum(sin(out))'s vjp
            out, vjp = jax.vjp(attend, q_, k_, v_)
            return out, vjp(jnp.cos(out))

        out, grads = run(q, k, v)
        _JAX[key] = {"out": np.asarray(out),
                     **{f"d{n}": np.asarray(g) for n, g in zip("qkv", grads)}}
    return _JAX[key]


def _check(got: dict, want: dict, what: str) -> None:
    np.testing.assert_allclose(got["out"], want["out"], rtol=VALUE_TOL,
                               atol=VALUE_TOL, err_msg=f"{what} out")
    for name in ("dq", "dk", "dv"):
        assert np.all(np.isfinite(got[name])), f"{what} {name}"
        np.testing.assert_allclose(got[name], want[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{what} {name}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", list(CASES))
def test_sequence_parallel_attention_matches_jax(request, tmp_path_factory, case, impl):
    """Every rank's global output and gradients equal the JAX ring's on the
    same grid; a batch entry with every key masked gives zeros in both."""
    n_data, n_model, masked, _ = CASES[case]
    ranks = _world(request, tmp_path_factory, n_data * n_model)
    want = _jax_case(case)
    for rank, res in enumerate(ranks):
        got = res[(case, impl)]
        # the grid is JAX's reshape(n_data, n_model): rank = d·M + m
        assert got["coords"] == divmod(rank, n_model)
        _check(got, want, f"{case} {impl} rank {rank}")
        if masked:
            assert np.all(got["out"][MASKED_ROW] == 0.0)
            for name in ("dq", "dk", "dv"):
                assert np.all(got[name][MASKED_ROW] == 0.0), name


def test_flash_blocks_match_the_interpreted_jax_flash_ring(request, tmp_path_factory):
    """The port's flash blocks (the kernels' plain versions) against the JAX
    ring of Pallas flash blocks, interpreted, masked, at M = 2."""
    ranks = _world(request, tmp_path_factory, 2)
    want = _jax_case("m2_masked", "flash")
    for rank, res in enumerate(ranks):
        _check(res[("m2_masked", "flash")], want, f"interpreted flash rank {rank}")


def test_dropout_is_one_devices_masks_at_dp_by_sp(request, tmp_path_factory):
    """At 2 × 2 each data shard's rows keep their global dropout masks: the
    sharded output is one device's ``mha_reference`` with the same seed,
    and differs from what rows at offset 0 would draw."""
    from crossclr_tpu_torch.ops.flash_attention import mha_reference

    _, _, _, rate = CASES["dpsp_dropout"]
    q, k, v, mask = (None if x is None else torch.from_numpy(x)
                     for x in _inputs("dpsp_dropout"))
    want = mha_reference(q, k, v, mask, dropout_rate=rate, dropout_seed=SEED).numpy()
    for res in _world(request, tmp_path_factory, 4):
        for impl in IMPLS:
            np.testing.assert_allclose(res[("dpsp_dropout", impl)]["out"], want,
                                       rtol=VALUE_TOL, atol=VALUE_TOL)
    aliased = mha_reference(q[2:], k[2:], v[2:], mask[2:], dropout_rate=rate,
                            dropout_seed=SEED).numpy()
    assert not np.allclose(aliased, want[2:], atol=1e-3)


def test_rotation_packs_and_unpacks_every_block():
    """A rotation's message: each tensor at an aligned offset of one byte
    buffer, read back in its dtype and shape; a ring of one rank moves
    nothing and names no transport."""
    from crossclr_tpu_torch.parallel.ring_attention import (
        _ALIGN, _pack, _Ring, _unpack, transport)

    parts = [torch.randn(3, 5), torch.randn(2, 7).to(torch.bfloat16),
             torch.arange(6, dtype=torch.float32).reshape(2, 3)]
    flat, layout = _pack(parts)
    assert flat.dtype == torch.uint8
    assert all(offset % _ALIGN == 0 for offset, *_ in layout)
    for got, want in zip(_unpack(flat.clone(), layout), parts):
        assert got.dtype == want.dtype and torch.equal(got, want)
    ring = _Ring(None, torch.device("cpu"))
    assert (ring.n, ring.me, ring.staged) == (1, 0, False)
    assert transport(None, "cuda") == "none"
