"""The port's data × model step (``training.Trainer`` on a
``parallel.make_mesh(n_data, n_model)`` grid with ``attention="ring"``
towers) against the JAX ``Trainer`` on ``make_mesh(n_data, n_model)`` over
the conftest's 8 CPU devices, and the grid itself.

Ranks run as ``torch.multiprocessing`` (spawn) processes joined by a
``gloo`` group on the CPU: 2 of them as a 1 × 2 grid, 4 as 2 × 2.  Each
world's rendezvous is a file in its own temp directory, the parent joins
the ranks with a time limit, and one world of each size serves every case
(the first test worker that needs it spawns it under a file lock).

Both packages start from the same Flax parameters (the JAX trainer's
init on the grid, moved into the port by ``utils.params.state_dict_from_flax``
through flash towers: the ring towers share their names) and take the same
3 global batches of 8 ragged rows (transformer towers of width 16, two
heads, one layer, fp32, video S = 8, text S = 6); rank ``d·M + m`` steps
on rows ``d·8/D ..`` of each batch, as the JAX grid's data shard ``d``
does, and runs sequence shard ``m``.  The port's towers run both of its
block implementations (``auto``: the plain blocks on the CPU; ``flash``:
the flash kernels' plain versions) against the JAX ``auto`` ring.

Limits, ``tests/test_torch_data_parallel.py``'s: the loss per step rtol =
atol = 2e-5, ``grad_norm`` rtol 1e-3, the parameters after 3 steps atol
2e-5, except ``*.key.bias`` at lr × steps: its true gradient is 0 and what
either package computes is rounding noise that AdamW turns into steps of
the learning rate (``tests/test_torch_train_transformer.py``).

Dropout cannot be held to the JAX trainer (its seeds come from
``jax.random``); the port's ring run with attention dropout 0.2 is held to
the port's one-device run of flash towers on the whole batches with the
same seeds, at the same limits: no rank is folded into the seed and each
data shard's rows keep their global masks.
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

from crossclr_tpu_torch.data import SyntheticPairs, epoch_batches
from crossclr_tpu_torch.models.encoders import DualEncoder, TowerConfig
from crossclr_tpu_torch.parallel import make_mesh
from crossclr_tpu_torch.training import TrainConfig, Trainer
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

JOIN_SECONDS = 240
B, STEPS, DV, DT, SV, ST = 8, 3, 12, 10, 8, 6
LOSS_RTOL = LOSS_ATOL = 2e-5
NORM_RTOL = 1e-3
PARAM_ATOL = 2e-5
BASE = dict(loss="crossclr_intra", learning_rate=1e-3, warmup_steps=1,
            total_steps=20, temperature=0.1)
KEY_BIAS_ATOL = BASE["learning_rate"] * STEPS
GRIDS = {2: (1, 2), 4: (2, 2)}  # world: (n_data, n_model)
IMPLS = ("auto", "flash")
DROPOUT = 0.2


def _tower(cls, dtype, input_dim, seq_len, **kw):
    return cls(kind="transformer", input_dim=input_dim, embed_dim=16, hidden_dim=24,
               num_layers=1, num_heads=2, max_seq_len=seq_len, dtype=dtype, **kw)


def _towers(attention="ring", **kw):
    return (_tower(TowerConfig, torch.float32, DV, SV, attention=attention, **kw),
            _tower(TowerConfig, torch.float32, DT, ST, attention=attention, **kw))


def _batches():
    data = SyntheticPairs(num_pairs=B * STEPS, video_dim=DV, text_dim=DT,
                          video_seq_len=SV, text_seq_len=ST, variable_lengths=True,
                          seed=0)
    return list(epoch_batches(data, B, shuffle=False))


def _flash_module():
    return DualEncoder(*_towers("flash"))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _run(trainer, init, rows) -> dict:
    state = trainer.init_state(init)
    losses, norms = [], []
    for batch in _batches():
        state, m = trainer.train_step(state, {k: v[rows] for k, v in batch.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": norms,
            "params": {k: v.numpy().copy() for k, v in state.model.state_dict().items()}}


def _rank_cases(world: int, shared: Path) -> dict:
    n_data, n_model = GRIDS[world]
    mesh = make_mesh(n_data=n_data, n_model=n_model)
    b_loc = B // n_data
    rows = slice(mesh.data_index * b_loc, (mesh.data_index + 1) * b_loc)
    init = torch.load(shared / "init.pt")
    out = {"coords": (mesh.data_index, mesh.model_index),
           "groups": (None if mesh.data_group is None else dist.get_world_size(mesh.data_group),
                      dist.get_world_size(mesh.model_group))}
    for impl in IMPLS:
        trainer = Trainer(*_towers(ring_block_impl=impl), TrainConfig(**BASE),
                          device="cpu", mesh=mesh)
        out[impl] = _run(trainer, init, rows)
        out[f"{impl}|flags"] = (trainer.world, trainer.rank, trainer.n_model,
                                trainer.use_global)
    trainer = Trainer(*_towers(dropout=DROPOUT), TrainConfig(**BASE), device="cpu",
                      mesh=mesh)
    out["dropout"] = _run(trainer, init, rows)
    return out


def _rank_main(rank, world, init_file, shared):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        results = _rank_cases(world, Path(shared))
        with open(Path(shared) / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(results, fh)
    finally:
        dist.destroy_process_group()


def _start(world: int, shared: Path):
    return mp.start_processes(_rank_main, args=(world, str(shared / "rendezvous"),
                                                str(shared)),
                              nprocs=world, join=False, start_method="spawn")


def _join(ctx, world: int, shared: Path) -> list[dict]:
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


def _jax_trainer(world: int):
    import jax.numpy as jnp

    from crossclr_tpu.models import TowerConfig as JTowerConfig
    from crossclr_tpu.parallel import make_mesh as jmake_mesh
    from crossclr_tpu.training import TrainConfig as JTrainConfig
    from crossclr_tpu.training import Trainer as JTrainer

    n_data, n_model = GRIDS[world]
    return JTrainer(_tower(JTowerConfig, jnp.float32, DV, SV, attention="ring"),
                    _tower(JTowerConfig, jnp.float32, DT, ST, attention="ring"),
                    JTrainConfig(**BASE), mesh=jmake_mesh(n_data=n_data, n_model=n_model))


def _flax_to_port(tree) -> dict:
    import jax

    from crossclr_tpu_torch.utils.params import state_dict_from_flax

    return state_dict_from_flax(jax.device_get(tree), _flash_module())


def _world(request, tmp_path_factory, world: int):
    """``(the ranks' results, the JAX run)`` of a world: the ranks spawned
    once per run, whichever test worker comes first, from the JAX trainer's
    init on the same grid; the JAX run's losses, grad_norms and final
    parameters, taken while the ranks run, cached beside them."""
    base = tmp_path_factory.getbasetemp()
    worker = getattr(request.config, "workerinput", None)
    root = (base.parent / f"torch_sp_{worker['testrunuid']}" if worker is not None
            else base / "torch_sp")
    shared = root / f"world{world}"
    shared.mkdir(parents=True, exist_ok=True)
    with open(root / f"world{world}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = shared / "ranks.pkl"
        if not done.exists():
            batches = _batches()
            jt = _jax_trainer(world)
            state = jt.init_state(batches[0]["video"], batches[0]["text"])
            torch.save(_flax_to_port(state.params), shared / "init.pt")
            ctx = _start(world, shared)
            losses, norms = [], []
            try:
                for batch in batches:
                    state, m = jt.train_step(state, batch)
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
            finally:
                ranks = _join(ctx, world, shared)
            want = {"loss": losses, "grad_norm": norms,
                    "params": {k: v.numpy() for k, v in
                               _flax_to_port(state.params).items()}}
            with open(done, "wb") as fh:
                pickle.dump((ranks, want), fh)
        with open(done, "rb") as fh:
            ranks, want = pickle.load(fh)
    return ranks, want, shared


def _assert_run(got: dict, want: dict, what: str) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                               atol=LOSS_ATOL, err_msg=f"{what} loss")
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=NORM_RTOL,
                               err_msg=f"{what} grad_norm")
    assert got["params"].keys() == want["params"].keys()
    for k, v in got["params"].items():
        atol = KEY_BIAS_ATOL if k.endswith("key.bias") else PARAM_ATOL
        np.testing.assert_allclose(v, want["params"][k], rtol=0, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("world", list(GRIDS))
def test_ring_step_matches_the_jax_grid_step(request, tmp_path_factory, world, impl):
    """Every rank's loss and grad_norm per step equal the JAX step's on the
    same grid (the full batch's loss: no global-negative route past one
    model rank), and every rank ends on the JAX parameters."""
    ranks, want, _ = _world(request, tmp_path_factory, world)
    n_data, n_model = GRIDS[world]
    for rank, res in enumerate(ranks):
        assert res["coords"] == divmod(rank, n_model)
        assert res["groups"] == (None if n_data == 1 else n_data, n_model)
        assert res[f"{impl}|flags"] == (n_data, rank // n_model, n_model, False)
        _assert_run(res[impl], want, f"{impl} rank {rank}")


@pytest.mark.parametrize("world", list(GRIDS))
def test_ring_dropout_is_the_one_device_flash_run(request, tmp_path_factory, world):
    """Attention dropout on the grid drops what one device with flash
    towers drops on the whole batch: the same losses, grad_norms and
    parameters (and a run that differs from dropout off)."""
    ranks, want, shared = _world(request, tmp_path_factory, world)
    trainer = Trainer(*_towers("flash", dropout=DROPOUT), TrainConfig(**BASE),
                      device="cpu")
    assert trainer.mesh is None
    alone = _run(trainer, torch.load(shared / "init.pt"), slice(None))
    for rank, res in enumerate(ranks):
        _assert_run(res["dropout"], alone, f"dropout rank {rank}")
        assert not np.allclose(res["dropout"]["loss"], res["auto"]["loss"], rtol=1e-4)


def test_mesh_without_a_group_and_its_refusals():
    """One rank without a group: the 1 × 1 grid with no groups (JAX's
    one-device mesh), under the DCN layouts too; a grid that does not
    cover the ranks is refused; a ring tower without a mesh raises."""
    mesh = make_mesh()
    assert (mesh.n_data, mesh.n_model, mesh.data_index, mesh.model_index) == (1, 1, 0, 0)
    assert mesh.data_group is None and mesh.model_group is None
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="not divisible by model axis 2"):
        make_mesh(n_model=2)
    with pytest.raises(ValueError, match="must cover"):
        make_mesh(n_data=2)
    for kw in ({"dcn": 1}, {"granule": "process"},
               {"dcn": 1, "granule": "contiguous"}):
        dcn = make_mesh(**kw)
        assert (dcn.n_data, dcn.n_model, dcn.data_group) == (1, 1, None)
    with pytest.raises(ValueError, match="attention='ring' needs a mesh"):
        Trainer(*_towers(), TrainConfig(**BASE), device="cpu").init_state()
    # at 1 x 1 the ring is one block: flash towers' values on the same weights
    init = _flash_module().state_dict()
    ring = Trainer(*_towers(), TrainConfig(**BASE), device="cpu", mesh=mesh)
    flash = Trainer(*_towers("flash"), TrainConfig(**BASE), device="cpu")
    batch = _batches()[0]
    for a, b in zip(ring.encode(ring.init_state(init), batch),
                    flash.encode(flash.init_state(init), batch)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
