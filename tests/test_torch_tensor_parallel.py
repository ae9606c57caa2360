"""The port's tensor parallelism (``training.Trainer`` on a
``parallel.make_mesh(n_data, n_model)`` grid with towers split over the
model axis) against the JAX ``Trainer`` on ``make_mesh(n_data=4,
n_model=2)`` over the conftest's 8 CPU devices, and the DCN layouts
against the JAX ``make_mesh``.

Ranks run as ``torch.multiprocessing`` (spawn) processes joined by a
``gloo`` group on the CPU: 2 of them as a 1 × 2 grid, 4 as a 2 × 2 grid
laid out by ``granule="slice"`` with ``GROUP_RANK = rank % 2`` (granule 0
holds ranks 0 and 2: the grid is ``[[0, 2], [1, 3]]``, not the plain
``d·M + m``).  Each world's rendezvous is a file in its own temp
directory, the parent joins the ranks with a time limit, and one world of
each size serves every case (the first test worker that needs it spawns
it under a file lock and takes the references while the ranks run).

Both packages start from the same Flax parameters (the JAX trainer's init,
whole, moved into the port by ``utils.params.state_dict_from_flax``; the
port cuts its slices) and take the same 3 global batches of 8 rows (fp32;
MLP towers 12 / 10 → 32 → 16 with two blocks, so ``fc1_1`` stays whole;
transformer towers of width 16, two heads, one layer, video hidden 24 >
16 (``Dense_0`` column-parallel) and text hidden 8 < 16 (``Dense_0``
row-parallel), video S = 8, text S = 6, ragged; xla attention where JAX is
the reference, which demotes flash to xla on a mesh).  Data shard ``d`` steps on
rows ``d·8/D ..`` of each batch, as the JAX grid's data shard ``d`` does.

Limits, ``tests/test_training.py::test_tensor_parallel_step_matches_single_device``'s
and ``tests/test_zero1.py``'s: the loss per step rtol 1e-5, ``grad_norm``
rtol 1e-4, the parameters after 3 steps atol 1e-5, except ``*.key.bias``
at lr × steps: its true gradient is 0 and what either package computes is
rounding noise that AdamW turns into steps of the learning rate
(``tests/test_torch_sequence_parallel.py``).  Dropout cannot be held to the
JAX trainer (its seeds come from ``jax.random``): the port's grid with
attention dropout 0.3 is held to the port's one process of flash towers
on the whole batches, at the same limits.
"""

import fcntl
import os
import pickle
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from crossclr_tpu_torch.data import SyntheticPairs, epoch_batches
from crossclr_tpu_torch.models.encoders import DualEncoder, TowerConfig
from crossclr_tpu_torch.ops.flash_attention import dropout_keep_mask
from crossclr_tpu_torch.parallel import Mesh, make_mesh
from crossclr_tpu_torch.parallel.mesh import grid_layout
from crossclr_tpu_torch.training import CheckpointManager, TrainConfig, Trainer
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

JOIN_SECONDS = 240
B, STEPS, DV, DT, SV, ST = 8, 3, 12, 10, 8, 6
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
PARAM_ATOL = 1e-5
BASE = dict(loss="crossclr_intra", learning_rate=1e-3, warmup_steps=1,
            total_steps=20, temperature=0.1)
KEY_BIAS_ATOL = BASE["learning_rate"] * STEPS
DROPOUT = 0.3
# (n_data, n_model) of each world
GRIDS = {2: (1, 2), 4: (2, 2)}
# the cases each world runs, by name: (towers, train config overrides)
CASES = {
    2: {"mlp": ("mlp", {}), "tf": ("xla", {"embedding_chunk": 4}),
        "drop": ("drop", {}), "mixed": ("mixed", {})},
    4: {"zero1": ("mlp", {"zero1": True})},
}


def _towers(cls, dtype, kind: str):
    """The towers of a case: ``mlp``, ``flash`` or ``xla`` transformers,
    ``drop`` (flash, dropout 0.3) or ``mixed`` (a ring video tower beside
    a flash text tower, dropout 0.3)."""
    if kind == "mlp":
        return tuple(cls(kind="mlp", input_dim=d, embed_dim=16, hidden_dim=32,
                         dtype=dtype) for d in (DV, DT))
    attention = {"drop": "flash", "mixed": "flash"}.get(kind, kind)
    drop = {"dropout": DROPOUT} if kind in ("drop", "mixed") else {}
    video = cls(kind="transformer", input_dim=DV, embed_dim=16, hidden_dim=24,
                num_layers=1, num_heads=2, max_seq_len=SV, dtype=dtype,
                attention="ring" if kind == "mixed" else attention, **drop)
    text = cls(kind="transformer", input_dim=DT, embed_dim=16, hidden_dim=8,
               num_layers=1, num_heads=2, max_seq_len=ST, dtype=dtype,
               attention=attention, **drop)
    return video, text


def _batches(kind: str):
    if kind == "mlp":
        data = SyntheticPairs(num_pairs=B * STEPS, video_dim=DV, text_dim=DT, seed=0)
    else:
        data = SyntheticPairs(num_pairs=B * STEPS, video_dim=DV, text_dim=DT,
                              video_seq_len=SV, text_seq_len=ST,
                              variable_lengths=True, seed=0)
    return list(epoch_batches(data, B, shuffle=False))


def _port_module(kind: str) -> DualEncoder:
    return DualEncoder(*_towers(TowerConfig, torch.float32,
                                "flash" if kind == "mixed" else kind),
                       mesh=None)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _run(trainer, init, rows, kind: str) -> dict:
    """3 steps from ``init`` on ``rows`` of each batch: the losses,
    grad_norms and the whole parameters after them (a collective)."""
    state = trainer.init_state(init)
    losses, norms = [], []
    for batch in _batches(kind):
        state, m = trainer.train_step(state, {k: v[rows] for k, v in batch.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    full = trainer.checkpoint_state(state)
    return {"loss": losses, "grad_norm": norms,
            "params": {k: v.numpy().copy() for k, v in full.model.state_dict().items()},
            "local": {k: tuple(v.shape) for k, v in state.model.state_dict().items()},
            "mu": {k: tuple(v.shape) for k, v in state.opt_state["mu"].items()}}


def _rank_cases(world: int, shared: Path) -> dict:
    n_data, n_model = GRIDS[world]
    mesh = make_mesh(n_data=n_data, n_model=n_model)
    b_loc = B // n_data
    rows = slice(mesh.data_index * b_loc, (mesh.data_index + 1) * b_loc)
    out = {"coords": (mesh.data_index, mesh.model_index)}
    for name, (kind, cfg) in CASES[world].items():
        trainer = Trainer(*_towers(TowerConfig, torch.float32, kind),
                          TrainConfig(**{**BASE, **cfg}), device="cpu", mesh=mesh)
        out[name] = _run(trainer, torch.load(shared / f"init_{kind}.pt"), rows, kind)
        out[f"{name}|flags"] = (trainer.tensor_parallel, trainer.use_global)
    if world == 2:  # a one-process checkpoint resumed on the grid
        trainer = Trainer(*_towers(TowerConfig, torch.float32, "mlp"),
                          TrainConfig(**BASE), device="cpu", mesh=mesh)
        state = trainer.init_state()
        state = trainer.restored_state(CheckpointManager(shared / "ckpt").restore(
            trainer.checkpoint_state(state)))
        step = state.step
        _, m = trainer.train_step(state, {k: v[rows] for k, v in
                                          _batches("mlp")[2].items()})
        out["resumed"] = (step, float(m["loss"]))
    return out


def _rank_main(rank, world, init_file, shared):
    torch.set_num_threads(1)
    if world == 4:  # two nodes, each holding ranks of both parities
        os.environ["GROUP_RANK"] = str(rank % 2)
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


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jax_trainer(kind: str, cfg: dict, mesh):
    import jax.numpy as jnp

    from crossclr_tpu.models import TowerConfig as JTowerConfig
    from crossclr_tpu.training import TrainConfig as JTrainConfig
    from crossclr_tpu.training import Trainer as JTrainer

    return JTrainer(*_towers(JTowerConfig, jnp.float32, kind),
                    JTrainConfig(**{**BASE, **cfg}), mesh=mesh)


def _jax_kind(kind: str) -> str:
    """The JAX towers a case is held to: xla for every transformer (the
    JAX trainer demotes flash to xla on a mesh; their parameter names, and
    so their init, differ), dropout off."""
    return "mlp" if kind == "mlp" else "xla"


def _flax_to_port(tree, kind: str) -> dict:
    import jax

    from crossclr_tpu_torch.utils.params import state_dict_from_flax

    return state_dict_from_flax(jax.device_get(tree), _port_module(kind))


def _jax_run(kind: str, cfg: dict, mesh) -> tuple[dict, dict]:
    """``(init, run)``: the JAX trainer's init as a state_dict of the
    port's ``kind`` towers and its 3 steps' losses, grad_norms and final
    parameters."""
    jt = _jax_trainer(_jax_kind(kind), cfg, mesh)
    batches = _batches(kind)
    state = jt.init_state(batches[0]["video"], batches[0]["text"])
    init = _flax_to_port(state.params, kind)
    losses, norms = [], []
    for batch in batches:
        state, m = jt.train_step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return init, {"loss": losses, "grad_norm": norms,
                  "params": {k: v.numpy() for k, v in
                             _flax_to_port(state.params, kind).items()}}


def _port_alone(kind: str, cfg: dict, init) -> dict:
    """The port's one-process run of a case's towers (flash in place of a
    ring tower) on the whole batches."""
    trainer = Trainer(*_towers(TowerConfig, torch.float32,
                               "drop" if kind == "mixed" else kind),
                      TrainConfig(**{**BASE, **cfg}), device="cpu")
    assert trainer.mesh is None
    return _run(trainer, init, slice(None), kind)


def _world(request, tmp_path_factory, world: int):
    """``(the ranks' results, the references)`` of a world: the ranks
    spawned once per run, whichever test worker comes first; the JAX runs
    (on ``make_mesh(4, 2)`` and, at world 2, on one device) and the port's
    one-process dropout runs taken while the ranks run, cached beside
    them."""
    from crossclr_tpu.parallel import make_mesh as jmake_mesh

    base = tmp_path_factory.getbasetemp()
    worker = getattr(request.config, "workerinput", None)
    root = (base.parent / f"torch_tp_{worker['testrunuid']}" if worker is not None
            else base / "torch_tp")
    shared = root / f"world{world}"
    shared.mkdir(parents=True, exist_ok=True)
    with open(root / f"world{world}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = shared / "ranks.pkl"
        if not done.exists():
            inits, params = {}, {}
            for kind, _ in CASES[world].values():  # the JAX runs' init
                if _jax_kind(kind) not in params:
                    jt = _jax_trainer(_jax_kind(kind), {}, None)
                    batch = _batches(kind)[0]
                    params[_jax_kind(kind)] = jt.init_state(
                        batch["video"], batch["text"]).params
                inits[kind] = _flax_to_port(params[_jax_kind(kind)], kind)
                torch.save(inits[kind], shared / f"init_{kind}.pt")
            want = {}
            if world == 2:  # the one-process checkpoint the grid resumes
                trainer = Trainer(*_towers(TowerConfig, torch.float32, "mlp"),
                                  TrainConfig(**BASE), device="cpu")
                state = trainer.init_state()
                for batch in _batches("mlp")[:2]:
                    state, _ = trainer.train_step(state, batch)
                CheckpointManager(shared / "ckpt").save(2, state)
                _, m = trainer.train_step(state, _batches("mlp")[2])
                want["resumed"] = (2, float(m["loss"]))
                want["nodrop"] = _port_alone("flash", {}, inits["drop"])
            ctx = _start(world, shared)
            try:
                mesh = jmake_mesh(n_data=4, n_model=2)
                for name, (kind, cfg) in CASES[world].items():
                    if kind in ("drop", "mixed"):
                        want[name] = _port_alone(kind, cfg, inits[kind])
                        continue
                    want[name] = {"grid": _jax_run(kind, cfg, mesh)[1]}
                    if world == 2:
                        want[name]["one"] = _jax_run(kind, cfg, None)[1]
            finally:
                ranks = _join(ctx, world, shared)
            with open(done, "wb") as fh:
                pickle.dump((ranks, want), fh)
        with open(done, "rb") as fh:
            ranks, want = pickle.load(fh)
    return ranks, want


def _assert_run(got: dict, want: dict, what: str) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                               err_msg=f"{what} loss")
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=NORM_RTOL,
                               err_msg=f"{what} grad_norm")
    assert got["params"].keys() == want["params"].keys()
    for k, v in got["params"].items():
        atol = KEY_BIAS_ATOL if k.endswith("key.bias") else PARAM_ATOL
        np.testing.assert_allclose(v, want["params"][k], rtol=0, atol=atol,
                                   err_msg=f"{what} {k}")


# ---------------------------------------------------------------------------
# the shards, without processes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mlp", "flash", "xla"])
def test_shards_are_the_jax_tp_trainers_addressable_shards(kind):
    """At each model coordinate of ``make_mesh(4, 2)``, the port's slice of
    every parameter (shape and values) is the JAX TP trainer's addressable
    shard there, moved into the torch layout; the rule's whole leaves stay
    whole (``fc1_1`` of the MLP's second block among them).  The shards
    are placed as the trainer places its state (``_state_specs``, then
    ``device_put`` on the mesh) from its one-device init, which is the
    same values without the mesh init's compile."""
    import jax
    from jax.sharding import NamedSharding

    from crossclr_tpu.parallel import make_mesh as jmake_mesh
    from crossclr_tpu_torch.utils.params import state_dict_from_flax

    mesh = jmake_mesh(n_data=4, n_model=2)
    batch = _batches(kind)[0]
    params = _jax_trainer(_jax_kind(kind), {}, None).init_state(
        batch["video"], batch["text"]).params
    specs, _ = _jax_trainer(kind, {}, mesh)._state_specs(params)
    params = jax.tree.map(lambda v, spec: jax.device_put(v, NamedSharding(mesh, spec)),
                          params, specs)
    whole = _flax_to_port(params, kind)
    for m in range(2):
        device = mesh.devices[0, m]

        def local(leaf):
            return next(np.asarray(s.data) for s in leaf.addressable_shards
                        if s.device == device)

        port = DualEncoder(*_towers(TowerConfig, torch.float32, kind),
                           mesh=Mesh(4, 2, 0, m))
        # strict: every slice's shape is the port module's own
        want = state_dict_from_flax(jax.tree.map(local, params), port)
        got = port.shard_state_dict(whole)
        assert got.keys() == want.keys()
        for k, v in got.items():
            np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
        split = {k for k, d in port.tp_dims.items() if d is not None}
        assert split, "no parameter split"
        if kind == "mlp":
            assert "video_tower.fc1.weight" in split
            assert "video_tower.fc1_1.weight" not in split
            assert "video_tower.skip.bias" not in split


def test_indivisible_widths_are_refused():
    """A width the model axis does not divide is refused, naming it."""
    mesh = Mesh(1, 3, 0, 0)
    mlp = TowerConfig(kind="mlp", input_dim=12, embed_dim=18, hidden_dim=32)
    with pytest.raises(ValueError, match="hidden_dim 32 is not divisible by n_model 3"):
        DualEncoder(mlp, mlp, mesh=mesh)
    heads = TowerConfig(kind="transformer", input_dim=12, embed_dim=24,
                        hidden_dim=48, num_heads=2, attention="flash")
    with pytest.raises(ValueError, match="num_heads 2 is not divisible by n_model 3"):
        DualEncoder(heads, heads, mesh=mesh)
    # a ring tower keeps its weights whole
    ring = TowerConfig(kind="transformer", input_dim=12, embed_dim=16,
                       hidden_dim=32, num_heads=2, attention="ring")
    assert not any(d is not None for d in
                   DualEncoder(ring, ring, mesh=Mesh(1, 2, 0, 0)).tp_dims.values())


def test_keep_mask_of_local_heads_is_a_slice_of_the_whole():
    """The plain keep mask of a rank's heads (``head_count``,
    ``head_offset``) is, bit for bit, its slice of the whole-head mask, at
    any batch·head offset."""
    b, h, s = 3, 8, 11
    for bh_offset in (0, 5 * h):
        whole = dropout_keep_mask(b, h, s, 1234, 0.3, bh_offset=bh_offset)
        for n in (2, 4):
            hl = h // n
            for m in range(n):
                part = dropout_keep_mask(b, hl, s, 1234, 0.3, bh_offset=bh_offset,
                                         head_count=h, head_offset=m * hl)
                assert torch.equal(part, whole[:, m * hl:(m + 1) * hl])
    assert torch.equal(dropout_keep_mask(b, h, s, 9, 0.5, head_count=h),
                       dropout_keep_mask(b, h, s, 9, 0.5))


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mlp", "tf"])
def test_tp_step_matches_the_jax_grid_and_one_device(request, tmp_path_factory, name):
    """1 × 2: every rank's loss and grad_norm per step, and the whole
    parameters after 3 steps, are the JAX TP step's on ``make_mesh(4, 2)``
    and the JAX one-device step's; the transformer's through the two-pass
    step (``embedding_chunk`` 4 of 8 rows)."""
    ranks, want = _world(request, tmp_path_factory, 2)
    for rank, res in enumerate(ranks):
        assert res["coords"] == (0, rank)
        assert res[f"{name}|flags"] == (True, False)
        _assert_run(res[name], want[name]["grid"], f"{name} rank {rank} vs the JAX grid")
        _assert_run(res[name], want[name]["one"], f"{name} rank {rank} vs one device")
        key, shape = {"mlp": ("video_tower.fc1.weight", (16, DV)),
                      "tf": ("video_tower.block_0.MultiHeadDotProductAttention_0."
                             "query.weight", (8, 16))}[name]
        assert res[name]["local"][key] == shape  # a slice: half the rows


@pytest.mark.parametrize("name", ["drop", "mixed"])
def test_tp_dropout_is_the_one_device_flash_run(request, tmp_path_factory, name):
    """Attention dropout 0.3 under tensor parallelism (and beside a ring
    tower) drops what one process of flash towers drops on the whole
    batch: the same losses, grad_norms and parameters."""
    ranks, want = _world(request, tmp_path_factory, 2)
    for rank, res in enumerate(ranks):
        _assert_run(res[name], want[name], f"{name} rank {rank}")
    # the same towers without dropout: another run
    assert not np.allclose(want[name]["loss"], want["nodrop"]["loss"], rtol=1e-4)


def test_one_process_checkpoint_resumes_on_the_grid(request, tmp_path_factory):
    """A checkpoint of one process restores at 1 × 2 (cut into slices) and
    the next step's loss is the one process's."""
    ranks, want = _world(request, tmp_path_factory, 2)
    step, loss = want["resumed"]
    for res in ranks:
        assert res["resumed"][0] == step
        np.testing.assert_allclose(res["resumed"][1], loss, rtol=1e-5)


def test_zero1_tp_step_on_a_permuted_dcn_grid(request, tmp_path_factory):
    """2 × 2 laid out by granule (``[[0, 2], [1, 3]]``) with ZeRO-1: the
    moments are each rank's slice cut again over the data group, and the
    step is the JAX ZeRO-1 TP step's on ``make_mesh(4, 2)``."""
    ranks, want = _world(request, tmp_path_factory, 4)
    assert [res["coords"] for res in ranks] == [(0, 0), (1, 0), (0, 1), (1, 1)]
    for rank, res in enumerate(ranks):
        got = res["zero1"]
        local, mu = got["local"]["video_tower.fc1.weight"], got["mu"]["video_tower.fc1.weight"]
        assert local == (16, DV) and mu == (16, DV // 2), (local, mu)
        _assert_run(got, want["zero1"]["grid"], f"zero1 rank {rank}")


# ---------------------------------------------------------------------------
# the DCN layouts
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Stub:
    id: int
    slice_index: int
    process_index: int = 0
    platform: str = "cpu"
    device_kind: str = "cpu"


def _jax_grid(devs, n_model, **kw):
    from crossclr_tpu.parallel.mesh import make_mesh as jmake_mesh

    return jmake_mesh(n_model=n_model, devices=devs, **kw).devices


LAYOUTS = [  # (slice ids, process ids, n_model, make_mesh keywords)
    ([i // 4 for i in range(8)], None, 2, {}),
    ([0] * 8, None, 2, {}),
    ([i // 4 for i in range(8)], None, 2, {"dcn": 2, "granule": "contiguous"}),
    ([i % 2 for i in range(4)], None, 2, {}),
    ([1 - i // 4 for i in range(8)], None, 2, {}),
    ([i // 2 for i in range(8)], None, 1, {}),
    ([i // 4 for i in range(8)], None, 4, {"dcn": 2}),
    ([0] * 8, [i // 4 for i in range(8)], 2, {"granule": "process"}),
    ([0] * 8, [i // 2 for i in range(8)], 2, {"granule": "process", "dcn": 4}),
    ([i // 4 for i in range(8)], None, 2, {"dcn": 1}),
]


@pytest.mark.parametrize("slices, processes, n_model, kw", LAYOUTS)
def test_grid_layout_is_the_jax_layout(slices, processes, n_model, kw):
    """``grid_layout`` on the ranks' granule ids gives the JAX
    ``make_mesh(devices=stubs)`` grid of ids."""
    devs = [_Stub(i, s, i if processes is None else processes[i])
            for i, s in enumerate(slices)]
    want = np.vectorize(lambda d: d.id)(_jax_grid(devs, n_model, **kw))
    granule = kw.get("granule", "slice")
    ids = [d.process_index if granule == "process" else d.slice_index for d in devs]
    got = grid_layout(ids, len(devs) // n_model, n_model, kw.get("dcn", "auto"),
                      granule)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_model, kw, match", [
    (2, {"dcn": 3}, "DCN granules"),
    (2, {"dcn": 3, "granule": "contiguous"}, "divisible"),
    (1, {"granule": "contiguous"}, "explicit dcn"),
    (2, {"granule": "node"}, "granule must be"),
])
def test_grid_layout_refuses_as_jax_does(n_model, kw, match):
    devs = [_Stub(i, i // 4) for i in range(8)]
    with pytest.raises(ValueError, match=match):
        _jax_grid(devs, n_model, **kw)
    with pytest.raises(ValueError, match=match):
        grid_layout([d.slice_index for d in devs], 8 // n_model, n_model,
                    kw.get("dcn", "auto"), kw.get("granule", "slice"))


def test_coordinates_are_places_in_ascending_rank_groups():
    """torch numbers a group's members by global rank, so a rank's
    coordinates on a DCN grid are its places in its column and its row;
    a grid whose groups would disagree on them is refused."""
    from crossclr_tpu_torch.parallel.mesh import _coordinates

    # granule 1 holds ranks 0-3, granule 0 ranks 4-7: the data axis runs
    # granule 0 first, the groups number their members by rank
    grid = grid_layout([1 - i // 4 for i in range(8)], 4, 2)
    assert grid.tolist() == [[4, 5], [6, 7], [0, 1], [2, 3]]
    assert [_coordinates(grid, r) for r in range(8)] == [
        (0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1), (3, 0), (3, 1)]
    with pytest.raises(ValueError, match="ascending rank"):
        _coordinates(np.array([[0, 3], [1, 2]]), 0)
