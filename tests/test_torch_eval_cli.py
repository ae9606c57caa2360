"""The port's eval CLI (``crossclr_tpu_torch.eval.main``) against the JAX
package's (``crossclr_tpu.eval.main``) on the same weights.

A JAX trainer's state (MLP towers 24 / 16 → 32 → 16, fp32, EMA decay 0.5,
the EMA moved off the params by seeded noise, step 3) over 64 synthetic
pairs is saved as an Orbax checkpoint for the JAX CLI, and its params and EMA cross into a port checkpoint
through ``utils.params.state_dict_from_flax``.  Both CLIs then run on the
held-out split (6 rows) with the live tower and on all 64 rows with the
EMA.  Held: the
ranking metrics (R@K, MdR, MnR) equal, the ``--embeddings-output`` arrays
within 1e-5 abs (fp32 towers summing in another order), the ``--topk``
indices equal and their scores within 1e-5, and each package's
``serve --corpus-emb`` reading the other's dump.
"""

import fcntl
import json

import numpy as np
import pytest
import torch

from crossclr_tpu_torch import eval as teval
from crossclr_tpu_torch import serve as tserve
from crossclr_tpu_torch.models import DualEncoder
from crossclr_tpu_torch.training import CheckpointManager, Trainer
from crossclr_tpu_torch.utils import config as tconfig
from crossclr_tpu_torch.utils.params import state_dict_from_flax

ATOL = 1e-5
STEP = 3
OVERRIDES = [
    "data.num_pairs=64", "data.batch_size=16", "data.video_dim=24",
    "data.text_dim=16",
    "video_tower.input_dim=24", "video_tower.embed_dim=16",
    "video_tower.hidden_dim=32", "video_tower.dtype=float32",
    "text_tower.input_dim=16", "text_tower.embed_dim=16",
    "text_tower.hidden_dim=32", "text_tower.dtype=float32",
    "train.ema_decay=0.5", "train.learning_rate=0.01", "train.warmup_steps=1",
]
# (split, ema): the held-out rows with the live tower, all rows with the EMA
RUNS = [("eval", False), ("all", True)]
METRIC_KEYS = [f"{d}/{m}" for d in ("v2t", "t2v")
               for m in ("R@1", "R@5", "R@10", "MdR", "MnR")]


def _jax_checkpoint(path):
    """The JAX trainer's state at step ``STEP``, its EMA moved off the
    params (a train step's compile would dominate the file's time), saved
    with Orbax; returns its params and EMA as host trees."""
    import jax
    import numpy as np

    from crossclr_tpu.data import dataset_from_config, epoch_batches
    from crossclr_tpu.training import CheckpointManager as JCheckpointManager
    from crossclr_tpu.training import Trainer as JTrainer
    from crossclr_tpu.utils import config as jconfig

    cfg = jconfig.apply_overrides(jconfig.ExperimentConfig(), OVERRIDES)
    dataset, _ = dataset_from_config(cfg.data)
    trainer = JTrainer(cfg.video_tower, cfg.text_tower, cfg.train, mesh=None)
    batch = next(epoch_batches(dataset, 16, shuffle=False))
    state = trainer.init_state(batch["video"], batch["text"])
    rng = np.random.default_rng(1)
    ema = jax.tree.map(
        lambda p: p + rng.standard_normal(p.shape).astype(p.dtype) * 0.05,
        jax.device_get(state.params))
    state = state.replace(step=STEP, ema_params=ema)
    mngr = JCheckpointManager(path)
    mngr.save(STEP, state, wait=True)
    mngr.close()
    return jax.device_get(state.params), ema


def _port_checkpoint(path, params, ema):
    cfg = tconfig.apply_overrides(tconfig.ExperimentConfig(), OVERRIDES)
    trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, "cpu")
    module = DualEncoder(cfg.video_tower, cfg.text_tower)
    state = trainer.init_state(state_dict_from_flax(params, module))
    state.ema = state_dict_from_flax(ema, module)
    state.step = STEP
    CheckpointManager(path).save(STEP, state)


def _flags(run_dir, split, ema):
    tag = f"{split}_{'ema' if ema else 'live'}"
    flags = ["--split", split, "--output", str(run_dir / f"{tag}.json"),
             "--embeddings-output", str(run_dir / f"{tag}_emb.npz"),
             "--topk", "3", "--topk-output", str(run_dir / f"{tag}_topk.npz")]
    return tag, flags + (["--ema"] if ema else [])


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """Both CLIs on every run of ``RUNS``: ``(root, {tag: [jax dir, port
    dir]})``.  Made once per test run, by whichever test worker comes
    first, under a file lock; the others read the files."""
    from crossclr_tpu import eval as jeval

    base = tmp_path_factory.getbasetemp()
    worker = getattr(request.config, "workerinput", None)
    root = (base.parent / f"torch_eval_cli_{worker['testrunuid']}"
            if worker is not None else base / "torch_eval_cli")
    root.mkdir(parents=True, exist_ok=True)
    out = {f"{s}_{'ema' if e else 'live'}": [root / "jax", root / "port"]
           for s, e in RUNS}
    with open(root.parent / f"{root.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (root / "done").exists():
            return root, out
        params, ema = _jax_checkpoint(root / "jax_ckpt")
        _port_checkpoint(root / "port_ckpt", params, ema)
        for pkg, main, extra in (
            ("jax", jeval.main, []),
            ("port", teval.main, ["--device", "cpu"]),
        ):
            run_dir = root / pkg
            run_dir.mkdir(exist_ok=True)
            for split, use_ema in RUNS:
                _, flags = _flags(run_dir, split, use_ema)
                rc = main([*flags, *extra, "--checkpoint-dir",
                           str(root / f"{pkg}_ckpt"), *OVERRIDES])
                assert rc == 0
        (root / "done").touch()
    return root, out


@pytest.mark.parametrize("split,ema", RUNS)
def test_metrics_match_the_jax_cli(runs, split, ema):
    _, out = runs
    tag = f"{split}_{'ema' if ema else 'live'}"
    jdir, tdir = out[tag]
    want = json.loads((jdir / f"{tag}.json").read_text())
    got = json.loads((tdir / f"{tag}.json").read_text())
    assert set(got) == set(want)
    for key in METRIC_KEYS:
        assert got[key] == want[key], key
    assert got["split"] == split and got["step"] == STEP
    assert got["rows"] == want["rows"] == (6 if split == "eval" else 64)
    assert got.get("ema", False) is ema


@pytest.mark.parametrize("split,ema", RUNS)
def test_embeddings_and_topk_dumps_match_the_jax_cli(runs, split, ema):
    _, out = runs
    tag = f"{split}_{'ema' if ema else 'live'}"
    jdir, tdir = out[tag]
    with np.load(jdir / f"{tag}_emb.npz") as jz, np.load(tdir / f"{tag}_emb.npz") as tz:
        assert sorted(tz.files) == sorted(jz.files) == [
            "ema", "ids", "split", "step", "text", "video"]
        for key in ("video", "text"):
            assert tz[key].dtype == np.float32
            np.testing.assert_allclose(tz[key], jz[key], rtol=0, atol=ATOL)
        for key in ("ids", "step", "split", "ema"):
            np.testing.assert_array_equal(tz[key], jz[key])
        assert bool(tz["ema"]) is ema and int(tz["step"]) == STEP
    with np.load(jdir / f"{tag}_topk.npz") as jz, np.load(tdir / f"{tag}_topk.npz") as tz:
        assert sorted(tz.files) == sorted(jz.files)
        np.testing.assert_array_equal(tz["indices"], jz["indices"])
        assert tz["indices"].dtype == jz["indices"].dtype
        np.testing.assert_allclose(tz["scores"], jz["scores"], rtol=0, atol=ATOL)
        assert str(tz["queries"]) == "text"


def test_each_package_serves_the_others_dump(runs):
    """``serve --corpus-emb``: the port serves the JAX CLI's dump and the
    JAX service the port's; the step and the EMA flag carry over, and the
    two services answer alike."""
    from crossclr_tpu import serve as jserve
    from crossclr_tpu.data import SyntheticPairs
    from crossclr_tpu.utils import config as jconfig

    root, out = runs
    jdir, tdir = out["all_ema"]
    cfg = tconfig.apply_overrides(tconfig.ExperimentConfig(), OVERRIDES)
    jcfg = jconfig.apply_overrides(jconfig.ExperimentConfig(), OVERRIDES)
    port = tserve.build_service(cfg, str(root / "port_ckpt"), "video",
                                corpus_emb_path=str(jdir / "all_ema_emb.npz"),
                                use_ema=True, strict_index=True, device="cpu")
    jax_svc = jserve.build_service(jcfg, str(root / "jax_ckpt"), "video",
                                   corpus_emb_path=str(tdir / "all_ema_emb.npz"),
                                   use_ema=True, strict_index=True)
    assert port.index_step == jax_svc.index_step == STEP
    assert not port.index_stale and not port.index_tower_mismatch
    with np.load(jdir / "all_ema_emb.npz") as z:
        np.testing.assert_array_equal(port.corpus_emb.numpy(), z["video"])
    queries = SyntheticPairs(num_pairs=64, video_dim=24, text_dim=16).text[:4]
    got, want = port.search(queries, k=3), jax_svc.search(queries, k=3)
    assert got["indices"] == want["indices"]
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=ATOL)
    # a live tower against the EMA dump is flagged, and refused strictly
    live = tserve.build_service(cfg, str(root / "port_ckpt"), "video",
                                corpus_emb_path=str(jdir / "all_ema_emb.npz"),
                                device="cpu")
    assert live.index_tower_mismatch
    with pytest.raises(SystemExit, match="EMA/live flavor"):
        tserve.build_service(cfg, str(root / "port_ckpt"), "video",
                             corpus_emb_path=str(jdir / "all_ema_emb.npz"),
                             strict_index=True, device="cpu")


def test_random_params_and_the_missing_checkpoint(tmp_path, capsys):
    """``--random-params`` skips the restore (step 0, the train seed's
    weights); without it and without a checkpoint directory the CLI stops
    with the JAX package's message; ``--step`` picks a step; the launcher's
    ranks are refused."""
    assert teval.main(["--split", "all", "--random-params", "--device", "cpu",
                       *OVERRIDES]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["rows"] == 64 and metrics["step"] == 0
    assert "ema" not in metrics
    with pytest.raises(SystemExit, match="no checkpoint: pass --checkpoint-dir"):
        teval.main(["--device", "cpu", *OVERRIDES])

    cfg = tconfig.apply_overrides(tconfig.ExperimentConfig(), OVERRIDES)
    trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, "cpu")
    mngr = CheckpointManager(tmp_path / "ckpt")
    for step in (1, 2):
        state = trainer.init_state()
        state.step = step
        mngr.save(step, state)
    assert teval.main(["--device", "cpu", "--step", "1", "--checkpoint-dir",
                       str(tmp_path / "ckpt"), *OVERRIDES]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["step"] == 1
    with pytest.raises(FileNotFoundError):
        teval.main(["--device", "cpu", "--step", "7", "--checkpoint-dir",
                    str(tmp_path / "ckpt"), *OVERRIDES])


def test_sharded_eval_is_refused_under_a_launcher(monkeypatch):
    """Sharded eval is ported (``tests/test_torch_sharded_retrieval.py``
    runs it on gloo ranks); a launcher that sets ``WORLD_SIZE`` without
    its rendezvous is refused with the variables it missed."""
    for var in ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="RANK, LOCAL_RANK, MASTER_ADDR"):
        teval.main(["--random-params", "--device", "cpu", *OVERRIDES])


def test_embeddings_round_trip_through_the_module_entry(tmp_path):
    """``python -m crossclr_tpu_torch.eval`` runs as a module."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-m", "crossclr_tpu_torch.eval", "--random-params",
         "--device", "cpu", "--embeddings-output", str(tmp_path / "e.npz"),
         *OVERRIDES],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(repo)),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["rows"] == 6
    with np.load(tmp_path / "e.npz") as z:
        assert z["video"].shape == (6, 16) and not bool(z["ema"])
        assert torch.isfinite(torch.from_numpy(z["text"])).all()
