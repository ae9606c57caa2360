"""The port's numpy data pipeline and config loader against the JAX
package's: arrays bit-equal, batch order equal, configs equal field by
field."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from crossclr_tpu.data import datasets as jdata
from crossclr_tpu.utils import config as jconfig
from crossclr_tpu_torch.data import datasets as tdata
from crossclr_tpu_torch.models import TowerConfig
from crossclr_tpu_torch.utils import config as tconfig

CONFIGS = sorted((Path(__file__).parent.parent / "configs").glob("*.json"))


@pytest.mark.parametrize("kw", [
    dict(num_pairs=40, video_dim=12, text_dim=10),
    dict(num_pairs=24, video_dim=12, text_dim=10, video_seq_len=6,
         text_seq_len=5),
    dict(num_pairs=24, video_dim=12, text_dim=10, video_seq_len=6,
         text_seq_len=5, variable_lengths=True, seed=3),
], ids=["pooled", "sequence", "variable_lengths"])
def test_synthetic_pairs_bit_equal(kw):
    j, t = jdata.SyntheticPairs(**kw), tdata.SyntheticPairs(**kw)
    for name in ("video", "text", "video_mask", "text_mask"):
        a, b = getattr(j, name), getattr(t, name)
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("shuffle,drop", [(True, True), (False, False)])
def test_epoch_batches_same_order(shuffle, drop):
    kw = dict(num_pairs=37, video_dim=4, text_dim=3, video_seq_len=5,
              text_seq_len=4, variable_lengths=True)
    jd, td = jdata.SyntheticPairs(**kw), tdata.SyntheticPairs(**kw)
    args = dict(seed=7, epoch=2, shuffle=shuffle, drop_remainder=drop)
    jb = list(jdata.epoch_batches(jd, 8, **args))
    tb = list(tdata.epoch_batches(td, 8, **args))
    assert len(jb) == len(tb) == (4 if drop else 5)
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_feature_store_fp32_and_bf16_bit_equal(tmp_path):
    import ml_dtypes

    rng = np.random.default_rng(0)
    video = rng.standard_normal((6, 3, 4)).astype(np.float32)
    text = rng.standard_normal((6, 5)).astype(np.float32)
    mask = np.ones((6, 3), np.float32)
    np.save(tmp_path / "v.npy", video)
    np.save(tmp_path / "t.npy", text)
    np.save(tmp_path / "m.npy", mask)
    np.save(tmp_path / "vb.npy", video.astype(ml_dtypes.bfloat16).view(np.uint16))
    np.save(tmp_path / "tb.npy", text.astype(ml_dtypes.bfloat16).view(np.uint16))

    paths = (tmp_path / "v.npy", tmp_path / "t.npy")
    j = jdata.FeaturePairDataset(*paths, video_mask_path=tmp_path / "m.npy")
    t = tdata.FeaturePairDataset(*paths, video_mask_path=tmp_path / "m.npy")
    np.testing.assert_array_equal(j.video, t.video)
    np.testing.assert_array_equal(j.video_mask, t.video_mask)

    bpaths = (tmp_path / "vb.npy", tmp_path / "tb.npy")
    jb = jdata.FeaturePairDataset(*bpaths, dtype="bfloat16")
    tb = tdata.FeaturePairDataset(*bpaths, dtype="bfloat16")
    assert jb.video.tobytes() == tb.video.tobytes()
    assert jb.text.tobytes() == tb.text.tobytes()
    with pytest.raises(ValueError, match="bf16"):
        tdata.FeaturePairDataset(*bpaths)  # 2-byte records need the dtype
    with pytest.raises(ValueError, match="not int8"):
        tdata.FeaturePairDataset(*paths, dtype="int8")  # a float store, as JAX


def _same_fields(jobj, tobj, path=""):
    jf = [f.name for f in dataclasses.fields(jobj)]
    tf = [f.name for f in dataclasses.fields(tobj)]
    # the port's TowerConfig adds its "mla_moe" kind's fields after the JAX
    # ones (tests/test_torch_encoders.py names them); every other config
    # has the JAX fields alone
    extra = tf[len(jf):] if isinstance(tobj, TowerConfig) else []
    assert tf == jf + extra, path
    for name in jf:
        a, b = getattr(jobj, name), getattr(tobj, name)
        if dataclasses.is_dataclass(a):
            _same_fields(a, b, f"{path}{name}.")
        elif name == "dtype":
            assert a.__name__ == str(b).removeprefix("torch."), path + name
        else:
            assert a == b, path + name


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_load_config_matches_field_by_field(path):
    _same_fields(jconfig.load_config(path), tconfig.load_config(path))


def test_defaults_match_field_by_field():
    _same_fields(jconfig.ExperimentConfig(), tconfig.ExperimentConfig())


def test_apply_overrides_behaves_the_same():
    overrides = [
        "video_tower.attention=flash", "text_tower.dtype=float32",
        "data.num_pairs=128", "data.variable_lengths=true",
        "train.loss_precision=default", "train.seed=5", "name=x",
    ]
    _same_fields(
        jconfig.apply_overrides(jconfig.ExperimentConfig(), overrides),
        tconfig.apply_overrides(tconfig.ExperimentConfig(), overrides),
    )
    for bad, err in (("data.nope=1", KeyError), ("nosection.x=1", KeyError),
                     ("data.num_pairs", ValueError)):
        for mod in (jconfig, tconfig):
            with pytest.raises(err):
                mod.apply_overrides(mod.ExperimentConfig(), [bad])
