"""The port's data-parallel step (``training.Trainer`` under a
``torch.distributed`` group) against the JAX ``Trainer`` on
``make_mesh(n_data=P)`` over the conftest's 8 CPU devices.

Ranks run as ``torch.multiprocessing`` (spawn) processes joined by a
``gloo`` group on the CPU, at world sizes 2 and 4; each world's
rendezvous is a file in its own temp directory, so parallel test workers
never share a port, and the parent joins the ranks with a time limit that
fails the test rather than hang it.  One world of each size serves every
case: the first test worker that needs it spawns it under a file lock and
the others read its results.

Both packages start from the same Flax parameters (moved into the port by
``utils.params.state_dict_from_flax``) and take the same global batches of
32 rows (MLP towers 24 / 20 → 32 → 16, fp32); rank r steps on rows
``r·32/P ..`` of each, as the mesh's device r does.  Covered: the four
global-negative losses (the ``_fused`` ones through the rows kernels'
plain versions), learnable τ once, ``global_negatives=False`` (every rank
scores the gathered batch), the two-pass step at half the local batch,
and ``zero1`` with an EMA.

Limits, the JAX package's own: the loss per step rtol = atol = 2e-5 and
``grad_norm`` rtol 1e-3 (``tests/test_training.py``'s mesh steps against
one device); the parameters after 3 steps atol 2e-5
(``tests/test_torch_train.py``'s port-vs-JAX limit); ZeRO-1 against the
replicated step rtol = atol = 2e-6 (``tests/test_zero1.py``), its
checkpoint's moments against the JAX moments atol 2e-5.

Also here: a ZeRO-1 checkpoint restored at world size 1; the flash-dropout
towers' masks per rank (different ranks draw different masks, pass 3
redraws pass 1's, one rank draws the one-device seeds); the train CLI on
two ranks (rank 0 alone writes the CSV and the checkpoints; a resumed run
ends on the uninterrupted run's parameters and moments, bit for bit);
``parallel.initialize_multihost`` and its refusals.
"""

import fcntl
import pickle
import socket
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from crossclr_tpu_torch.data import SyntheticPairs, epoch_batches
from crossclr_tpu_torch.models.encoders import DualEncoder, TowerConfig
from crossclr_tpu_torch.training import CheckpointManager, TrainConfig, Trainer
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
B, DV, DT, HIDDEN, EMBED, STEPS = 32, 24, 20, 32, 16, 3
LOSS_RTOL = LOSS_ATOL = 2e-5
NORM_RTOL = 1e-3
PARAM_ATOL = 2e-5
ZERO1_TOL = 2e-6
JOIN_SECONDS = 240
BASE = dict(learning_rate=1e-3, warmup_steps=1, total_steps=20, temperature=0.1)
CASES = {
    "crossclr_intra": dict(loss="crossclr_intra"),
    "crossclr_intra_fused": dict(loss="crossclr_intra_fused"),
    "crossclr": dict(loss="crossclr", prune_percent=0.2),
    "crossclr_fused": dict(loss="crossclr_fused", prune_percent=0.2),
    "learnable": dict(loss="crossclr_intra_fused", learnable_temperature=True,
                      learning_rate=1e-2),
    "local": dict(loss="crossclr_intra", global_negatives=False),
    "two_pass": dict(loss="crossclr_intra_fused", embedding_chunk="half"),
    "zero1": dict(loss="crossclr_intra", zero1=True, ema_decay=0.9),
    "replicated": dict(loss="crossclr_intra", ema_decay=0.9),
}
JAX_CASES = [c for c in CASES if c != "replicated"]
# the tiny flash-dropout towers of tests/test_torch_grad_cache.py
DROP_TOWER = dict(kind="transformer", embed_dim=16, hidden_dim=24, num_layers=1,
                  num_heads=2, attention="flash", dropout=0.1, dtype=torch.float32)
DROP_ROWS = 4  # each rank's batch; the two-pass step in chunks of 2
# the podslice config narrowed as tests/test_torch_no_jax.py does
CLI_OPTIONS = ["--config", str(REPO / "configs" / "podslice_32k.json"),
               "--device", "cpu", "--steps", "4"]
CLI_OVERRIDES = [  # after every option (argparse)
    "video_tower.input_dim=12", "text_tower.input_dim=10",
    "video_tower.embed_dim=8", "text_tower.embed_dim=8",
    "video_tower.hidden_dim=16", "text_tower.hidden_dim=16",
    "data.source=synthetic", "data.num_pairs=72", "data.video_dim=12",
    "data.text_dim=10", "data.batch_size=32", "train.embedding_chunk=8",
    "train.warmup_steps=1", "train.steps_per_call=2", "eval_every=2",
]


def _case_cfg(name: str, world: int) -> dict:
    cfg = {**BASE, **CASES[name]}
    if cfg.get("embedding_chunk") == "half":
        cfg["embedding_chunk"] = B // world // 2
    return cfg


def _tower(cls, dtype, input_dim):
    return cls(kind="mlp", input_dim=input_dim, embed_dim=EMBED,
               hidden_dim=HIDDEN, dtype=dtype)


def _batches():
    data = SyntheticPairs(num_pairs=B * STEPS, video_dim=DV, text_dim=DT, seed=0)
    return list(epoch_batches(data, B, shuffle=False))


def _drop_trainer(**cfg):
    return Trainer(TowerConfig(input_dim=12, max_seq_len=8, **DROP_TOWER),
                   TowerConfig(input_dim=10, max_seq_len=6, **DROP_TOWER),
                   TrainConfig(**BASE, loss="crossclr_intra_fused", **cfg),
                   device="cpu")


def _drop_batch():
    data = SyntheticPairs(num_pairs=16, video_dim=12, text_dim=10, video_seq_len=8,
                          text_seq_len=6, variable_lengths=True, seed=1)
    return next(iter(epoch_batches(data, 16)))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _rank_cases(rank: int, world: int, shared: Path) -> dict:
    out = {}
    b_loc = B // world
    rows = slice(rank * b_loc, (rank + 1) * b_loc)
    batches = _batches()
    for name in CASES:
        cfg = _case_cfg(name, world)
        trainer = Trainer(_tower(TowerConfig, torch.float32, DV),
                          _tower(TowerConfig, torch.float32, DT),
                          TrainConfig(**cfg), device="cpu")
        init = torch.load(shared / f"init_{cfg.get('learnable_temperature', False)}.pt")
        state = trainer.init_state(init)
        passes = []
        encode_chunks = trainer.encode_chunks
        trainer.encode_chunks = lambda *a: passes.append(1) or encode_chunks(*a)
        for batch in batches:
            state, m = trainer.train_step(state, {k: v[rows] for k, v in batch.items()})
            out.setdefault(f"{name}|loss", []).append(float(m["loss"]))
            out.setdefault(f"{name}|grad_norm", []).append(float(m["grad_norm"]))
        out[f"{name}|passes"] = len(passes)
        out[f"{name}|params"] = {k: v.numpy().copy()
                                 for k, v in state.model.state_dict().items()}
        if state.opt_state["mu"]:
            out[f"{name}|mu_shapes"] = {k: tuple(v.shape)
                                        for k, v in state.opt_state["mu"].items()}
        if name in ("zero1", "replicated"):
            full = trainer.checkpoint_state(state)  # every rank: a collective
            if rank == 0:
                CheckpointManager(shared / f"ckpt_{name}").save(STEPS, full)
            out[f"{name}|ema"] = {k: v.numpy().copy() for k, v in state.ema.items()}
    return out


def _rank_dropout(rank: int) -> dict:
    """Flash-dropout towers: pass 1's and pass 3's embeddings of each chunk
    (the two-pass step on this rank's rows) and this rank's step-0
    embeddings of the SAME rows on every rank."""
    out = {}
    batch = _drop_batch()
    trainer = _drop_trainer(embedding_chunk=DROP_ROWS // 2)
    state = trainer.init_state()
    calls = []
    hook = state.model.register_forward_hook(
        lambda module, args, res: calls.append(
            (torch.is_grad_enabled(), tuple(x.detach().clone() for x in res))))
    rows = slice(rank * DROP_ROWS, (rank + 1) * DROP_ROWS)
    _, metrics = trainer.train_step(state, {k: v[rows] for k, v in batch.items()})
    hook.remove()
    out["drop|loss"] = float(metrics["loss"])
    out["drop|grad_flags"] = [g for g, _ in calls]
    out["drop|pass1"] = [[x.numpy() for x in res] for _, res in calls[:2]]
    out["drop|pass3"] = [[x.numpy() for x in res] for _, res in calls[2:]]
    same = tuple(None if x is None else x[:DROP_ROWS]
                 for x in trainer.step_inputs(batch))
    state.step = 0
    with torch.no_grad():
        out["drop|same_rows"] = [x.numpy() for x in trainer.step_model(state)(*same)]
    return out


def _rank_cli(rank: int, shared: Path) -> dict:
    """The train CLI on this group: 4 steps straight, then 2 steps and a
    resume to 4, then a run that rank 1 alone is sent SIGTERM in (during
    its first step); and a stop flag raised on rank 1 alone."""
    import signal

    from crossclr_tpu_torch import train

    out = {}
    train_step = Trainer.train_step

    def signalled_step(self, state, batch):
        if state.step == 0:
            signal.raise_signal(signal.SIGTERM)  # train.main's handler
        return train_step(self, state, batch)

    for run, extra in (("straight", []), ("resumed", ["--stop-after", "2"]),
                       ("resumed", []), ("preempted", [])):
        if run == "preempted" and rank == 1:
            Trainer.train_step = signalled_step
        try:
            rc = train.main([*CLI_OPTIONS, "--metrics-csv",
                             str(shared / f"cli_{run}_{rank}.csv"), *extra,
                             *CLI_OVERRIDES, f"checkpoint_dir={shared / f'cli_{run}'}"])
        finally:
            Trainer.train_step = train_step
        out.setdefault("cli|rc", []).append(rc)
    trainer = _drop_trainer()
    out["cli|any_rank"] = [trainer.any_rank(rank == 1), trainer.any_rank(False)]
    return out


def _rank_main(rank, world, init_file, shared):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        shared = Path(shared)
        results = _rank_cases(rank, world, shared)
        results.update(_rank_dropout(rank))
        if world == 2:
            results.update(_rank_cli(rank, shared))
        with open(shared / f"rank{rank}.pkl", "wb") as fh:
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


def _jax_init(learnable: bool) -> dict:
    """The JAX trainer's initial parameters as the port's state_dict."""
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.models import TowerConfig as JTowerConfig
    from crossclr_tpu.training import TrainConfig as JTrainConfig
    from crossclr_tpu.training import Trainer as JTrainer
    from crossclr_tpu_torch.utils.params import state_dict_from_flax

    jt = JTrainer(_tower(JTowerConfig, jnp.float32, DV),
                  _tower(JTowerConfig, jnp.float32, DT),
                  JTrainConfig(**BASE, learnable_temperature=learnable))
    batch = _batches()[0]
    params = jax.device_get(jt.init_state(batch["video"], batch["text"]).params)
    return state_dict_from_flax(params, _module())


def _module():
    return DualEncoder(_tower(TowerConfig, torch.float32, DV),
                       _tower(TowerConfig, torch.float32, DT))


def _shared_dir(request, tmp_path_factory) -> Path:
    """A directory every test worker of this run sees."""
    base = tmp_path_factory.getbasetemp()
    worker = getattr(request.config, "workerinput", None)
    if worker is not None:
        return base.parent / f"torch_dp_{worker['testrunuid']}"
    return base / "torch_dp"


def _world(request, tmp_path_factory, world: int):
    """``(P, the ranks' results, their directory)``: spawned once per run
    for each world size, whichever test worker comes first."""
    shared = _shared_dir(request, tmp_path_factory) / f"world{world}"
    shared.mkdir(parents=True, exist_ok=True)
    with open(shared.parent / f"world{world}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = shared / "ranks.pkl"
        if not done.exists():
            for learnable in (False, True):
                torch.save(_jax_init(learnable), shared / f"init_{learnable}.pt")
            ranks = _spawn(world, shared)
            with open(done, "wb") as fh:
                pickle.dump(ranks, fh)
        with open(done, "rb") as fh:
            ranks = pickle.load(fh)
    return world, ranks, shared


@pytest.fixture(scope="module", params=[2, 4])
def world(request, tmp_path_factory):
    return _world(request, tmp_path_factory, request.param)


@pytest.fixture(scope="module")
def two_ranks(request, tmp_path_factory):
    return _world(request, tmp_path_factory, 2)


# ---------------------------------------------------------------------------
# against the JAX mesh step
# ---------------------------------------------------------------------------


def _jax_run(name: str, world: int):
    """The JAX trainer on ``make_mesh(n_data=world)``: each step's loss and
    grad_norm, and the final state."""
    import jax.numpy as jnp

    from crossclr_tpu.models import TowerConfig as JTowerConfig
    from crossclr_tpu.parallel import make_mesh
    from crossclr_tpu.training import TrainConfig as JTrainConfig
    from crossclr_tpu.training import Trainer as JTrainer

    batches = _batches()
    jt = JTrainer(_tower(JTowerConfig, jnp.float32, DV),
                  _tower(JTowerConfig, jnp.float32, DT),
                  JTrainConfig(**_case_cfg(name, world)), mesh=make_mesh(n_data=world))
    state = jt.init_state(batches[0]["video"], batches[0]["text"])
    losses, norms = [], []
    for batch in batches:
        state, m = jt.train_step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, state


def _flax_to_port(tree) -> dict:
    import jax

    from crossclr_tpu_torch.utils.params import state_dict_from_flax

    return {k: v.numpy() for k, v in
            state_dict_from_flax(jax.device_get(tree), _module()).items()}


def _adam_moments(opt_state):
    """``(mu, nu)`` trees of the optax chain's Adam state."""
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return node.mu, node.nu
        if isinstance(node, tuple):
            stack.extend(node)
    raise AssertionError("no Adam state in the optax state")


def _assert_params(got: dict, want: dict, atol: float, rtol: float = 0.0, what=""):
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", JAX_CASES)
def test_step_matches_the_jax_mesh_step(world, name):
    """Every rank's loss and grad_norm per step equal the JAX mesh step's,
    and every rank ends on the JAX parameters."""
    world, ranks, shared = world
    losses, norms, jstate = _jax_run(name, world)
    want = _flax_to_port(jstate.params)
    for rank, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{name}|loss"], losses, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=f"rank {rank} loss")
        np.testing.assert_allclose(res[f"{name}|grad_norm"], norms, rtol=NORM_RTOL,
                                   err_msg=f"rank {rank} grad_norm")
        _assert_params(res[f"{name}|params"], want, PARAM_ATOL, what=f"rank {rank}")
    if name == "two_pass":
        assert all(res[f"{name}|passes"] == STEPS for res in ranks)
    if name == "learnable":
        assert ranks[0][f"{name}|params"]["logit_scale"] != 0.0
    if name == "zero1":  # the moments are this rank's rows
        shapes = ranks[0][f"{name}|mu_shapes"]
        assert shapes["video_tower.fc1.weight"] == (HIDDEN // world, DV)
        assert shapes["logit_scale"] == ()
        mu, nu = _adam_moments(jstate.opt_state)
        _, ckpt = _checkpoints(shared)
        for got, tree in ((ckpt["opt_state"]["mu"], mu), (ckpt["opt_state"]["nu"], nu)):
            _assert_params({k: v.numpy() for k, v in got.items()},
                           _flax_to_port(tree), PARAM_ATOL, what="moment")


def _checkpoints(shared: Path) -> list[dict]:
    """The replicated and the ZeRO-1 runs' checkpoints after ``STEPS``."""
    return [torch.load(shared / f"ckpt_{name}" / f"step_{STEPS}.pt",
                       weights_only=True) for name in ("replicated", "zero1")]


def test_zero1_equals_the_replicated_step_and_its_checkpoint_restores_at_one_rank(world):
    """ZeRO-1 ends on the replicated run's parameters and EMA; its
    checkpoint holds the replicated checkpoint's full moments, and it
    restores into a one-device trainer, which steps on as the replicated
    checkpoint's does."""
    world, ranks, shared = world
    for res in ranks:
        _assert_params(res["zero1|params"], res["replicated|params"], ZERO1_TOL,
                       ZERO1_TOL, "zero1 params")
        _assert_params(res["zero1|ema"], res["replicated|ema"], ZERO1_TOL,
                       ZERO1_TOL, "zero1 ema")
    rep, z1 = _checkpoints(shared)
    assert z1["opt_state"]["count"] == rep["opt_state"]["count"] == STEPS
    for key in ("mu", "nu"):
        _assert_params({k: v.numpy() for k, v in z1["opt_state"][key].items()},
                       {k: v.numpy() for k, v in rep["opt_state"][key].items()},
                       ZERO1_TOL, ZERO1_TOL, key)
    batch = _batches()[0]
    after = []
    for name in ("replicated", "zero1"):
        trainer = Trainer(_tower(TowerConfig, torch.float32, DV),
                          _tower(TowerConfig, torch.float32, DT),
                          TrainConfig(**_case_cfg(name, world)), device="cpu")
        assert trainer.world == 1 and not trainer.zero1
        state = CheckpointManager(shared / f"ckpt_{name}").restore(trainer.init_state())
        assert state.step == STEPS
        state, _ = trainer.train_step(state, batch)
        after.append({k: v.numpy() for k, v in state.model.state_dict().items()})
    _assert_params(after[1], after[0], ZERO1_TOL, ZERO1_TOL, "restored step")


# ---------------------------------------------------------------------------
# dropout, the CLI, the launcher
# ---------------------------------------------------------------------------


def test_ranks_draw_their_own_dropout_masks_and_pass_three_redraws_them(world):
    world, ranks, _ = world
    for res in ranks:
        assert np.isfinite(res["drop|loss"])
        assert res["drop|grad_flags"] == [False, False, True, True]
        for first, again in zip(res["drop|pass1"], res["drop|pass3"]):
            for a, b in zip(first, again):
                np.testing.assert_array_equal(a, b)
    # the same rows under each rank's seed: the masks differ by rank, and
    # one process reseeded with that rank draws them again
    same = [res["drop|same_rows"] for res in ranks]
    assert not np.array_equal(same[0][0], same[1][0])
    trainer = _drop_trainer()
    state = trainer.init_state()
    rows = tuple(None if x is None else x[:DROP_ROWS]
                 for x in trainer.step_inputs(_drop_batch()))
    model = state.model.train()
    for rank, emb in enumerate(same):
        model.reseed_dropout(0, 0, rank=rank)
        with torch.no_grad():
            for a, b in zip(model(*rows), emb):
                np.testing.assert_array_equal(a.numpy(), b)


def test_one_rank_draws_the_one_device_masks():
    """Without a group the rank is not folded in: the seed is the
    one-device ``(seed << 32) + step``."""
    trainer = _drop_trainer(seed=3)
    state = trainer.init_state()
    state.step = 5
    assert trainer.world == 1
    assert trainer.step_model(state).dropout_gen.initial_seed() == (3 << 32) + 5


def test_cli_on_two_ranks(two_ranks):
    """Rank 0 alone writes the metrics CSV and the checkpoints; a run
    stopped after 2 steps and resumed ends on the uninterrupted run's
    parameters and moments, bit for bit; a SIGTERM on rank 1 alone stops
    both ranks at the same boundary with one preemption checkpoint; a stop
    flag on one rank is seen by both."""
    import csv

    _, ranks, shared = two_ranks
    for res in ranks:
        assert res["cli|rc"] == [0, 0, 0, 0]
        assert res["cli|any_rank"] == [True, False]
    assert [p.name for p in (shared / "cli_preempted").iterdir()] == ["step_2.pt"]
    with open(shared / "cli_preempted_0.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert [int(r["step"]) for r in rows] == [2]  # no eval after the stop
    for run in ("straight", "resumed"):
        assert (shared / f"cli_{run}_0.csv").exists()
        assert not (shared / f"cli_{run}_1.csv").exists()
        assert sorted(p.name for p in (shared / f"cli_{run}").iterdir()) == [
            "step_2.pt", "step_4.pt"]
    with open(shared / "cli_resumed_0.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert [int(r["step"]) for r in rows if r.get("loss")] == [2, 4]
    assert [int(r["step"]) for r in rows if r.get("eval/v2t/R@1")] == [2, 4]
    a, b = (torch.load(shared / f"cli_{run}" / "step_4.pt", weights_only=True)
            for run in ("straight", "resumed"))
    assert a["step"] == b["step"] == 4
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for key in ("mu", "nu"):
        for k in a["opt_state"][key]:
            assert torch.equal(a["opt_state"][key][k], b["opt_state"][key][k]), k
    # full moments in the checkpoint although zero1 sharded them
    assert a["opt_state"]["mu"]["video_tower.fc1.weight"].shape == (16, 12)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_multihost(monkeypatch):
    """No launcher: nothing starts.  A launcher's one-rank world starts a
    gloo group on the CPU, once; a world the launcher left incomplete
    raises; the world size must divide the batch."""
    from crossclr_tpu_torch.parallel import (
        host_local_batch_size,
        initialize_multihost,
        is_multihost,
    )

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_multihost("cpu") is False
    assert not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="LOCAL_RANK, MASTER_ADDR, MASTER_PORT"):
        initialize_multihost("cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        assert initialize_multihost("cpu") is True
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert initialize_multihost("cpu") is True  # idempotent
        assert not is_multihost()
        assert host_local_batch_size(6) == 6
        trainer = _drop_trainer()
        assert trainer.group is not None and trainer.world == 1
        assert not trainer.use_global
    finally:
        dist.destroy_process_group()


def test_ring_attention_is_refused_with_global_negatives(monkeypatch):
    """As the JAX step refuses it (``trainer.py:811-819``), past one rank."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    ring = TowerConfig(kind="transformer", input_dim=12, embed_dim=16,
                       hidden_dim=24, num_layers=1, num_heads=2, attention="ring")
    with pytest.raises(ValueError, match="attention='ring'"):
        Trainer(ring, ring, TrainConfig(loss="crossclr_intra"), device="cpu")
    trainer = Trainer(ring, ring, TrainConfig(loss="crossclr_intra",
                                              global_negatives=False),
                      device="cpu")
    assert trainer.world == 2 and not trainer.use_global
    with pytest.raises(ValueError, match="not divisible by 2 hosts"):
        from crossclr_tpu_torch.parallel import host_local_batch_size

        host_local_batch_size(5)


def test_a_hosts_ranks_share_the_page_locked_share(monkeypatch):
    """The train stream's two page-locked chunks must fit the rank's part of
    half the host's memory: the share over the host's ranks, checked
    before anything is allocated (here a CUDA device is never touched)."""
    from crossclr_tpu_torch.data import datasets

    data = SyntheticPairs(num_pairs=64, video_dim=DV, text_dim=DT, seed=0)
    ring = datasets.TRAIN_RING * datasets.chunk_nbytes(data, 16, 1)
    # the ring fits half of this host alone, not a quarter of it
    monkeypatch.setattr(datasets, "host_memory_bytes", lambda: 3 * ring)
    with pytest.raises(ValueError, match="shared by 2 rank"):
        datasets.train_stream(data, 16, 1, device="cuda", host_ranks=2)
