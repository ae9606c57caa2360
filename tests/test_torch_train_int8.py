"""Training from an int8 feature store: the port against the JAX trainer,
against itself on host-dequantized floats, and pre-stacked against single
steps.

Small MLP towers (inputs 24 / 20, hidden 32, embed 16, batch 16) on a
store written by ``data.quantize.quantize_features``.  Tolerances are
``tests/test_torch_train.py``'s for fp32 towers: the loss and the gradient
norm of each step at rtol 1e-5, every parameter after 5 steps at atol
2e-5 (the same arithmetic summed in another order).  The port's own runs
(int8 against host-dequantized fp32, ``steps_per_call=2`` pre-stacked
against 1) must agree exactly: the device dequantization is one fp32
multiply, as numpy's, and the pre-stacked chunk holds the same batches.
"""

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.data import (
    FeaturePairDataset,
    SyntheticPairs,
    epoch_batches,
    infinite_batches,
    prefetch_to_device,
    quantize_features,
    stacked_chunks,
)
from crossclr_tpu_torch.models.encoders import DualEncoder, TowerConfig
from crossclr_tpu_torch.training import TrainConfig, Trainer
from crossclr_tpu_torch.utils.params import state_dict_from_flax

BASE = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20, temperature=0.1)
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5


def _tower(cls, input_dim, dtype=torch.float32):
    return cls(kind="mlp", input_dim=input_dim, embed_dim=16, hidden_dim=32,
               dtype=dtype)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """The payload paths of an int8 store of 80 synthetic pairs."""
    tmp = tmp_path_factory.mktemp("int8")
    data = SyntheticPairs(num_pairs=80, video_dim=24, text_dim=20, seed=0)
    paths = []
    for name in ("video", "text"):
        q, scale = quantize_features(getattr(data, name))
        np.save(tmp / f"{name}.npy", q)
        np.save(tmp / f"{name}_scale.npy", scale)
        paths.append(tmp / f"{name}.npy")
    return paths


def _port(**cfg):
    return Trainer(_tower(TowerConfig, 24), _tower(TowerConfig, 20),
                   TrainConfig(**{**BASE, **cfg}), device="cpu")


def test_int8_store_five_steps_match_the_jax_trainer(store):
    import jax
    import jax.numpy as jnp

    from crossclr_tpu.data import FeaturePairDataset as JDataset
    from crossclr_tpu.data import epoch_batches as jax_batches
    from crossclr_tpu.models import TowerConfig as JTowerConfig
    from crossclr_tpu.training import TrainConfig as JTrainConfig
    from crossclr_tpu.training import Trainer as JTrainer

    jbatches = list(jax_batches(JDataset(*store, dtype="int8"), 16, seed=3))
    tbatches = list(epoch_batches(FeaturePairDataset(*store, dtype="int8"), 16, seed=3))
    assert len(jbatches) == len(tbatches) == 5
    for a, b in zip(jbatches, tbatches):
        assert a.keys() == b.keys() == {"video", "text", "video_scale", "text_scale"}
        for k in a:
            assert np.array_equal(a[k], b[k])
    jt = JTrainer(_tower(JTowerConfig, 24, jnp.float32),
                  _tower(JTowerConfig, 20, jnp.float32), JTrainConfig(**BASE))
    jstate = jt.init_state(jbatches[0]["video"], jbatches[0]["text"])
    pt = _port()
    module = DualEncoder(pt.video_cfg, pt.text_cfg)
    pstate = pt.init_state(state_dict_from_flax(jax.device_get(jstate.params), module))
    for jb, tb in zip(jbatches, tbatches):
        jstate, jm = jt.train_step(jstate, jb)
        pstate, pm = pt.train_step(pstate, tb)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=LOSS_RTOL,
                                       err_msg=key)
    want = state_dict_from_flax(jax.device_get(jstate.params), module)
    got = pstate.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    jv, _ = jt.encode(jstate, jbatches[0])
    pv, _ = pt.encode(pstate, tbatches[0])
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=0, atol=PARAM_ATOL)


def test_int8_training_equals_host_dequantized_floats(store):
    """Full CrossCLR, so the connectivity reads the dequantized inputs too:
    the int8 batch (dequantized on the device) and the host-dequantized
    fp32 batch give the same losses, parameters and embeddings exactly."""
    batches = list(epoch_batches(FeaturePairDataset(*store, dtype="int8"), 16, seed=1))
    floats = [{k: batch[k].astype(np.float32) * batch[f"{k}_scale"][:, None]
               for k in ("video", "text")} for batch in batches]
    runs = []
    for stream in (batches[:3], floats[:3]):
        trainer = _port(loss="crossclr")
        state = trainer.init_state()
        losses = []
        for batch in stream:
            state, metrics = trainer.train_step(state, batch)
            losses.append(float(metrics["loss"]))
        runs.append((losses, state.model.state_dict(), trainer.encode(state, stream[0])))
    (la, pa, ea), (lb, pb, eb) = runs
    assert la == lb
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert all(torch.equal(x, y) for x, y in zip(ea, eb))


def test_int8_prestacked_two_steps_per_call_match_single_steps(store):
    data = FeaturePairDataset(*store, dtype="int8")
    stacked = _port(steps_per_call=2)
    it = prefetch_to_device(stacked_chunks(data, 16, 2, seed=2, reuse_buffers=4),
                            size=1, device="cpu")
    try:
        sa, _ = stacked.fit(stacked.init_state(), it, steps=6, log_every=2,
                            prestacked=True)
    finally:
        it.close()
    single = _port()
    sb, _ = single.fit(single.init_state(), infinite_batches(data, 16, seed=2), steps=6)
    assert sa.step == sb.step == 6
    for (k, p), q in zip(sa.model.state_dict().items(), sb.model.state_dict().values()):
        assert torch.equal(p, q), k


def test_int8_store_serves_like_its_dequantized_floats(store, tmp_path):
    """``build_service``'s corpus encode (``eval._encode_split``) reads the
    int8 store and equals the encode of a fp32 store of the
    host-dequantized values."""
    from crossclr_tpu_torch.serve import build_service
    from crossclr_tpu_torch.utils.config import ExperimentConfig, apply_overrides

    data = FeaturePairDataset(*store, dtype="int8")
    for name in ("video", "text"):
        x = getattr(data, name).astype(np.float32) * getattr(data, f"{name}_scale")[:, None]
        np.save(tmp_path / f"{name}.npy", x)
    towers = ["video_tower.input_dim=24", "text_tower.input_dim=20",
              "video_tower.embed_dim=16", "text_tower.embed_dim=16",
              "video_tower.hidden_dim=32", "text_tower.hidden_dim=32",
              "data.source=files", "data.batch_size=32"]
    corpora = []
    for paths, dtype in ((store, "int8"), ((tmp_path / "video.npy", tmp_path / "text.npy"),
                                           "float32")):
        cfg = apply_overrides(ExperimentConfig(), [
            *towers, f"data.video_path={paths[0]}", f"data.text_path={paths[1]}",
            f"data.features_dtype={dtype}"])
        service = build_service(cfg, None, "video", random_params=True, device="cpu")
        corpora.append(service.corpus_emb)
    assert corpora[0].shape == (80, 16)
    assert torch.equal(corpora[0], corpora[1])
