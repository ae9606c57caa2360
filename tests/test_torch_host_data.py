"""The port's host data path against the JAX package's: the native gather,
fp32 → bf16, int8 quantization, int8 and bf16 feature stores, HostShard
and the stacked chunks, bit for bit on the same numpy inputs."""

import threading

import numpy as np
import pytest
import torch

from crossclr_tpu.data import datasets as jdata
from crossclr_tpu.data import native_io as jio
from crossclr_tpu.data import quantize as jq
from crossclr_tpu_torch.data import datasets as tdata
from crossclr_tpu_torch.data import native_io as tio
from crossclr_tpu_torch.data import quantize as tq


def _bits(x):
    """An array's raw bits, bf16 payloads (ml_dtypes or uint16) alike."""
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 and x.dtype.kind != "i" else x


def _idx(n, k, seed=1):
    return np.sort(np.random.default_rng(seed).choice(n, k, replace=False))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "uint8"])
@pytest.mark.parametrize("shape", [(300, 24), (300, 5, 7)], ids=["2d", "3d"])
def test_gather_rows_equals_jax(dtype, shape):
    import ml_dtypes

    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 50
    if dtype == "bfloat16":
        src_j = x.astype(ml_dtypes.bfloat16)
        src_t = src_j.view(np.uint16)  # the port's bf16 store
    else:
        src_j = src_t = x.astype(dtype)
    idx = _idx(shape[0], 77)
    got = tio.gather_rows(src_t, idx)
    want = jio.gather_rows(src_j, idx)
    assert got.flags.c_contiguous and got.dtype == src_t.dtype
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(tio.gather_rows_plain(src_t, idx)), _bits(want))


def test_gather_rows_memmap_out_and_threads(tmp_path):
    x = np.random.default_rng(2).standard_normal((257, 3, 11)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    mm = np.load(tmp_path / "x.npy", mmap_mode="r")
    idx = np.array([256, 0, 3, 3, 100], dtype=np.int32)  # unsorted, repeated
    out = np.empty((5, 3, 11), np.float32)
    for threads in (1, 3, 16):
        got = tio.gather_rows(mm, idx, threads=threads, out=out)
        assert got is out
        assert np.array_equal(out, jio.gather_rows(mm, idx))
    with pytest.raises(ValueError, match="out must be"):
        tio.gather_rows(mm, idx, out=np.empty((5, 3, 11), np.float64))
    with pytest.raises(ValueError, match="out must be"):
        tio.gather_rows(mm, idx, out=np.empty((5, 3, 22), np.float32)[:, :, ::2])
    with pytest.raises(IndexError):
        tio.gather_rows(mm, np.array([257]))


def test_gather_rows_strided_views_equal_jax():
    """HostShard's [p::P] row views keep the native path; views strided
    inside a row (and 1-D scales) take numpy's; both equal the JAX gather."""
    x = np.random.default_rng(3).standard_normal((90, 6, 4)).astype(np.float32)
    idx = _idx(30, 12)
    for view in (x[1::3], x[::3, :, ::2], x[:, 2], x[:, 0, 0]):
        view = view[:30]
        assert np.array_equal(tio.gather_rows(view, idx), jio.gather_rows(view, idx))
    assert tio.gather_rows(x[1::3][:30], idx).flags.c_contiguous


def test_gather_rows_concurrent_callers():
    """Callers on several threads share the one native pool: each gets its
    own rows (the pool serializes their epochs)."""
    x = np.random.default_rng(4).standard_normal((2000, 64)).astype(np.float32)
    idxs = [_idx(2000, 500, seed=s) for s in range(8)]
    want = [jio.gather_rows(x, i) for i in idxs]
    got = [None] * len(idxs)

    def run(k):
        for _ in range(20):
            got[k] = tio.gather_rows(x, idxs[k])

    threads = [threading.Thread(target=run, args=(k,)) for k in range(len(idxs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_f32_to_bf16_bit_equal_to_jax():
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.standard_normal(4000).astype(np.float32) * 1e3,
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-45,
                  3.4e38, 1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8], np.float32),
        np.array([0x7F800001, 0xFFC00001, 0x3F808000, 0x3F818000],
                 np.uint32).view(np.float32),  # NaN payloads, ties to even
    ]).reshape(2, -1)
    got = tio.f32_to_bf16(x)
    assert got.dtype == np.uint16 and got.shape == x.shape
    assert np.array_equal(got, jio.f32_to_bf16(x).view(np.uint16))


def _features(seed=6):
    x = np.random.default_rng(seed).standard_normal((9, 4, 5)).astype(np.float32)
    x[2] = 0.0  # an all-zero row: scale 1
    x[5] = 1e-42  # a denormal row: the scale floor
    x[7, 0, 0] = 300.0
    return x


def test_symmetric_int8_rows_and_quantize_features_equal_jax():
    x = _features()
    q, s = tq.quantize_features(x)
    jq_, js = jq.quantize_features(x)
    assert q.dtype == np.int8 and s.dtype == np.float32 and s.shape == (9,)
    assert np.array_equal(q, jq_) and np.array_equal(s, js)
    assert s[2] == 1.0 and s[5] == np.float32(1e-12)
    flat = x.reshape(9, -1)
    q2, s2 = tq.symmetric_int8_rows(flat)
    assert np.array_equal(q2, jq.symmetric_int8_rows(flat)[0])
    assert np.array_equal(s2, jq.symmetric_int8_rows(flat)[1])
    for bad in (np.nan, np.inf):
        y = x.copy()
        y[3, 1, 1] = bad
        with pytest.raises(ValueError, match=r"non-finite values in rows \[3\]"):
            tq.quantize_features(y)
    with pytest.raises(ValueError, match="expected"):
        tq.quantize_features(np.zeros(4, np.float32))


@pytest.mark.parametrize("stacked", [False, True], ids=["batch", "chunk"])
def test_dequantize_batch_equals_jax(stacked):
    x = _features()
    q, s = tq.quantize_features(x)
    t = np.random.default_rng(7).standard_normal((9, 3)).astype(np.float32)
    qt, st = tq.quantize_features(t)
    batch = {"video": q, "text": qt, "video_scale": s, "text_scale": st,
             "video_mask": np.ones((9, 4), np.float32)}
    if stacked:
        batch = {k: np.stack([v, v[::-1]]) for k, v in batch.items()}
    got = tq.dequantize_batch({k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in batch.items()})
    want = jq.dequantize_batch(batch)
    assert set(got) == set(want) == {"video", "text", "video_mask"}
    for k in want:
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    plain = {"video": torch.ones(2, 3)}
    assert tq.dequantize_batch(plain) is plain


def _write_stores(tmp_path):
    """int8 (``*_q.npy`` and scales) and bf16 (``*_b.npy``) stores of ragged
    synthetic sequences, with their masks (``*_m.npy``)."""
    import ml_dtypes

    data = tdata.SyntheticPairs(num_pairs=24, video_dim=6, text_dim=5,
                                video_seq_len=3, text_seq_len=2,
                                variable_lengths=True, seed=2)
    for name in ("video", "text"):
        x = getattr(data, name)
        q, s = tq.quantize_features(x)
        np.save(tmp_path / f"{name}_q.npy", q)
        np.save(tmp_path / f"{name}_q_scale.npy", s)
        np.save(tmp_path / f"{name}_b.npy", x.astype(ml_dtypes.bfloat16).view(np.uint16))
        np.save(tmp_path / f"{name}_m.npy", getattr(data, f"{name}_mask"))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_feature_store_arrays_equal_jax(tmp_path, dtype):
    _write_stores(tmp_path)
    suffix = "q" if dtype == "int8" else "b"
    paths = (tmp_path / f"video_{suffix}.npy", tmp_path / f"text_{suffix}.npy")
    masks = dict(video_mask_path=tmp_path / "video_m.npy",
                 text_mask_path=tmp_path / "text_m.npy")
    j = jdata.FeaturePairDataset(*paths, dtype=dtype, **masks)
    t = tdata.FeaturePairDataset(*paths, dtype=dtype, **masks)
    for name in ("video", "text", "video_mask", "text_mask", "video_scale",
                 "text_scale"):
        a, b = getattr(j, name, None), getattr(t, name)
        if a is None:
            assert b is None, name
            continue
        assert np.array_equal(_bits(a), _bits(b)), name
    jb = list(jdata.epoch_batches(j, 8, seed=1))
    tb = list(tdata.epoch_batches(t, 8, seed=1))
    assert len(jb) == len(tb) == 3
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(_bits(a[k]), _bits(b[k])), k


def test_int8_store_refusals_match_jax(tmp_path):
    """The refusals of ``crossclr_tpu/data/datasets.py:213-270``, each
    raised by both packages with the same message."""
    x = np.random.default_rng(2).standard_normal((8, 4)).astype(np.float32)
    q, s = tq.quantize_features(x)
    np.save(tmp_path / "q.npy", q)
    np.save(tmp_path / "f.npy", x)
    cases = [
        ((tmp_path / "q.npy",) * 2, {}, "int8 payloads"),
        ((tmp_path / "q.npy",) * 2, dict(dtype="int8"), "no scale file"),
        ((tmp_path / "f.npy",) * 2, dict(dtype="int8"), "not int8"),
    ]
    for paths, kw, match in cases:
        for mod in (jdata, tdata):
            with pytest.raises(ValueError, match=match):
                mod.FeaturePairDataset(*paths, **kw)
    np.save(tmp_path / "q_scale.npy", s[:4])  # the wrong length
    for mod in (jdata, tdata):
        with pytest.raises(ValueError, match=r"must be float32 \[8\]"):
            mod.FeaturePairDataset(tmp_path / "q.npy", tmp_path / "q.npy", dtype="int8")
    np.save(tmp_path / "q_scale.npy", s.astype(np.float64))
    for mod in (jdata, tdata):
        with pytest.raises(ValueError, match="float64"):
            mod.FeaturePairDataset(tmp_path / "q.npy", tmp_path / "q.npy", dtype="int8")


def _pair(cls_mod, **kw):
    return cls_mod.SyntheticPairs(**{**dict(num_pairs=50, video_dim=8, text_dim=6,
                                            video_seq_len=3, text_seq_len=2,
                                            variable_lengths=True, seed=3), **kw})


def _same_chunks(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("p,count", [(0, 3), (2, 3), (1, 4)])
def test_host_shard_equals_jax(p, count):
    j = jdata.HostShard(_pair(jdata), p, count)
    t = tdata.HostShard(_pair(tdata), p, count)
    assert len(j) == len(t) == 50 // count
    for name in ("video", "text", "video_mask", "text_mask"):
        assert np.array_equal(getattr(j, name), getattr(t, name))
    _same_chunks(next(jdata.epoch_batches(j, 4, seed=2)),
                 next(tdata.epoch_batches(t, 4, seed=2)))


def test_stack_batches_equals_jax():
    jd, td = _pair(jdata), _pair(tdata)
    jit = jdata.stack_batches(jdata.epoch_batches(jd, 8, seed=4), 4)
    tit = tdata.stack_batches(tdata.epoch_batches(td, 8, seed=4), 4)
    chunks = list(zip(jit, tit))
    assert [c[0]["video"].shape[0] for c in chunks] == [4, 2]  # the partial tail
    for a, b in chunks:
        _same_chunks(a, b)


@pytest.mark.parametrize("n,reuse,start", [(4, 0, 0), (4, 3, 0), (1, 2, 0),
                                           (3, 4, 7), (2, 0, 11)])
def test_stacked_chunks_equal_jax(n, reuse, start):
    """With and without the ring, resumed at ``start_step``, over epoch
    wraps (6 batches an epoch): the JAX chunks bit for bit, and the port's
    own stack of its infinite batches."""
    jd, td = _pair(jdata), _pair(tdata)
    jit = jdata.stacked_chunks(jd, 8, n, seed=7, start_step=start, reuse_buffers=reuse)
    tit = tdata.stacked_chunks(td, 8, n, seed=7, start_step=start, reuse_buffers=reuse)
    ref = tdata.stack_batches(tdata.infinite_batches(td, 8, seed=7, start_step=start), n)
    for _ in range(5):
        got = next(tit)
        _same_chunks(got, next(jit))
        _same_chunks(got, next(ref))


def test_stacked_chunks_refusals():
    td = _pair(tdata)
    for bad in (-1, 1):
        with pytest.raises(ValueError, match="reuse_buffers"):
            next(tdata.stacked_chunks(td, 8, 2, reuse_buffers=bad))
    with pytest.raises(ValueError, match="exceeds"):
        next(tdata.stacked_chunks(td, 64, 2))
