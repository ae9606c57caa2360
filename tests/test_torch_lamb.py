"""The port's LAMB (``training.LAMB``, ``TrainConfig.optimizer="lamb"``)
against the JAX trainer's ``optax.lamb`` chain.

One process: 5 steps of MLP towers (fp32, 24 / 20 → 32 → 16, batch 32)
from the same Flax parameters, with a clip that bites (``clip_norm``
0.05), a learnable τ (``logit_scale`` starts at 0, as every bias starts at
0: zero parameters, where the trust ratio is 1) and weight decay.  Limits,
``tests/test_torch_train.py``'s fp32 ones: loss and grad_norm rtol 1e-5,
the parameters atol 2e-5.

Two ranks: LAMB under ZeRO-1 on a ``gloo`` group of 2 spawned CPU
processes (the trust ratio's norms summed over the data group's shards)
against ``tests/test_zero1.py::test_zero1_matches_replicated``'s LAMB case,
the JAX trainer on ``make_mesh(8, 1)`` with ``zero1`` (64 rows, 24 / 16 →
64 → 32, τ 0.03, lr 3e-3, 4 steps on one batch): the loss per step rtol
1e-5, the parameters atol 2e-5.  The world is spawned once per run, under
a file lock, and joined with a time limit.
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
from crossclr_tpu_torch.training import LAMB, TrainConfig, Trainer

JOIN_SECONDS = 240
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
ONE = dict(optimizer="lamb", learnable_temperature=True, clip_norm=0.05,
           learning_rate=1e-2, warmup_steps=2, total_steps=20, temperature=0.1,
           weight_decay=0.01)
# tests/test_zero1.py's _run and its lamb case
Z_B, Z_DV, Z_DT, Z_STEPS = 64, 24, 16, 4
ZERO1 = dict(loss="crossclr_intra", optimizer="lamb", temperature=0.03,
             learning_rate=3e-3, warmup_steps=2, total_steps=Z_STEPS, seed=0)
RANKS = 2


def _mlp(cls, dtype, input_dim, embed=16, hidden=32):
    return cls(kind="mlp", input_dim=input_dim, embed_dim=embed, hidden_dim=hidden,
               dtype=dtype)


def _to_port(tree, module) -> dict:
    import jax

    from crossclr_tpu_torch.utils.params import state_dict_from_flax

    return state_dict_from_flax(jax.device_get(tree), module)


def test_lamb_five_steps_match_the_jax_trainer():
    import jax.numpy as jnp

    from crossclr_tpu.models import TowerConfig as JTowerConfig
    from crossclr_tpu.training import TrainConfig as JTrainConfig
    from crossclr_tpu.training import Trainer as JTrainer

    data = SyntheticPairs(num_pairs=32 * 5, video_dim=24, text_dim=20, seed=0)
    batches = list(epoch_batches(data, 32))
    jt = JTrainer(_mlp(JTowerConfig, jnp.float32, 24), _mlp(JTowerConfig, jnp.float32, 20),
                  JTrainConfig(**ONE))
    jstate = jt.init_state(batches[0]["video"], batches[0]["text"])
    pt = Trainer(_mlp(TowerConfig, torch.float32, 24), _mlp(TowerConfig, torch.float32, 20),
                 TrainConfig(**ONE), device="cpu")
    assert isinstance(pt.optimizer, LAMB)
    module = DualEncoder(pt.video_cfg, pt.text_cfg)
    pstate = pt.init_state(_to_port(jstate.params, module))
    assert float(pstate.model.logit_scale.detach()) == 0.0
    for batch in batches:
        jstate, jm = jt.train_step(jstate, batch)
        pstate, pm = pt.train_step(pstate, batch)
        for key in ("loss", "grad_norm", "logit_scale"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=key)
        assert float(jm["grad_norm"]) > ONE["clip_norm"]  # the clip bites
    want = _to_port(jstate.params, module)
    got = pstate.model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    assert float(pstate.model.logit_scale.detach()) != 0.0


def test_lamb_trust_ratio_is_one_where_a_norm_is_zero():
    """A zero parameter (or a zero update) takes the Adam step itself."""
    opt = LAMB(TrainConfig(optimizer="lamb", learning_rate=1.0, warmup_steps=0,
                           total_steps=10, weight_decay=0.0, clip_norm=1e9))
    params = {"zero": torch.zeros(3), "w": torch.tensor([3.0, 4.0, 0.0])}
    state = opt.init(params)
    grads = {"zero": torch.tensor([1.0, -1.0, 0.0]), "w": torch.tensor([1.0, 0.0, 0.0])}
    opt.update(params, grads, state)
    # Adam's first step is ±1 (eps aside); the zero leaf moves by it whole,
    # the other by ‖p‖/‖u‖ = 5 / 1 times it
    torch.testing.assert_close(params["zero"], torch.tensor([-1.0, 1.0, 0.0]),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(params["w"], torch.tensor([-2.0, 4.0, 0.0]),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# LAMB under ZeRO-1 on two ranks
# ---------------------------------------------------------------------------


def _zero1_batch():
    rng = np.random.default_rng(0)
    return {"video": rng.standard_normal((Z_B, Z_DV)).astype(np.float32),
            "text": rng.standard_normal((Z_B, Z_DT)).astype(np.float32)}


def _zero1_towers(cls, dtype):
    return (_mlp(cls, dtype, Z_DV, 32, 64), _mlp(cls, dtype, Z_DT, 32, 64))


def _rank_main(rank, init_file, shared):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=RANKS)
    try:
        shared = Path(shared)
        trainer = Trainer(*_zero1_towers(TowerConfig, torch.float32),
                          TrainConfig(**ZERO1, zero1=True), device="cpu")
        state = trainer.init_state(torch.load(shared / "init.pt"))
        b_loc = Z_B // RANKS
        batch = {k: v[rank * b_loc:(rank + 1) * b_loc] for k, v in _zero1_batch().items()}
        losses = []
        for _ in range(Z_STEPS):
            state, m = trainer.train_step(state, batch)
            losses.append(float(m["loss"]))
        out = {"loss": losses, "zero1": trainer.zero1,
               "sharded": sum(d is not None for d in trainer._shard_dims.values()),
               "params": {k: v.numpy().copy() for k, v in state.model.state_dict().items()}}
        with open(shared / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def _zero1_world(request, tmp_path_factory):
    """The ranks' results and the JAX ZeRO-1 LAMB run, spawned once per
    run (the JAX run taken while the ranks run)."""
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.models import TowerConfig as JTowerConfig
    from crossclr_tpu.parallel import data_sharding, make_mesh
    from crossclr_tpu.training import TrainConfig as JTrainConfig
    from crossclr_tpu.training import Trainer as JTrainer

    base = tmp_path_factory.getbasetemp()
    worker = getattr(request.config, "workerinput", None)
    shared = (base.parent / f"torch_lamb_{worker['testrunuid']}" if worker is not None
              else base / "torch_lamb")
    shared.mkdir(parents=True, exist_ok=True)
    with open(shared.parent / f"{shared.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = shared / "ranks.pkl"
        if not done.exists():
            mesh = make_mesh(n_data=8, n_model=1)
            jt = JTrainer(*_zero1_towers(JTowerConfig, jnp.float32),
                          JTrainConfig(**ZERO1, zero1=True), mesh=mesh)
            batch = {k: jnp.asarray(v) for k, v in _zero1_batch().items()}
            state = jt.init_state(batch["video"][:2], batch["text"][:2])
            module = DualEncoder(*_zero1_towers(TowerConfig, torch.float32))
            torch.save(_to_port(state.params, module), shared / "init.pt")
            ctx = mp.start_processes(_rank_main, args=(str(shared / "rendezvous"),
                                                       str(shared)),
                                     nprocs=RANKS, join=False, start_method="spawn")
            try:
                batch = {k: jax.device_put(v, data_sharding(mesh))
                         for k, v in batch.items()}
                losses = []
                for _ in range(Z_STEPS):
                    state, m = jt.train_step(state, batch)
                    losses.append(float(m["loss"]))
                want = {"loss": losses,
                        "params": {k: v.numpy() for k, v in
                                   _to_port(state.params, module).items()}}
                deadline = time.monotonic() + JOIN_SECONDS
                while not ctx.join(timeout=5):
                    if time.monotonic() > deadline:
                        pytest.fail(f"{RANKS} gloo ranks did not finish in "
                                    f"{JOIN_SECONDS} s")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                        p.join(10)
            ranks = []
            for r in range(RANKS):
                with open(shared / f"rank{r}.pkl", "rb") as fh:
                    ranks.append(pickle.load(fh))
            with open(done, "wb") as fh:
                pickle.dump((ranks, want), fh)
        with open(done, "rb") as fh:
            return pickle.load(fh)


def test_lamb_under_zero1_matches_the_jax_zero1_step(request, tmp_path_factory):
    ranks, want = _zero1_world(request, tmp_path_factory)
    for rank, res in enumerate(ranks):
        assert res["zero1"] and res["sharded"] > 0
        np.testing.assert_allclose(res["loss"], want["loss"], rtol=LOSS_RTOL,
                                   err_msg=f"rank {rank} loss")
        for k, v in res["params"].items():
            np.testing.assert_allclose(v, want["params"][k], rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"rank {rank} {k}")
