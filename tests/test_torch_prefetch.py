"""The port's prefetcher (``data.prefetch_to_device``) and the train CLI's
stream (``data.train_stream``) on the CPU, and the trainer's stacked-chunk
budget (``train.max_stacked_bytes``).  The CUDA path (page-locked ring,
side stream, events) is held by chip_smoke.py's data phase; the one case
here that needs a card checks its pageable refusal."""

import time

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.data import (
    DevicePrefetcher,
    SyntheticPairs,
    infinite_batches,
    prefetch_to_device,
    stack_batches,
    stacked_chunks,
    train_stream,
)
from crossclr_tpu_torch.data import datasets
from crossclr_tpu_torch.models.encoders import TowerConfig
from crossclr_tpu_torch.training import TrainConfig, Trainer


def _data():
    return SyntheticPairs(num_pairs=40, video_dim=6, text_dim=5, video_seq_len=3,
                          text_seq_len=2, variable_lengths=True, seed=1)


def _same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
        assert np.array_equal(got[k].numpy(), v), k


@pytest.mark.parametrize("size", [1, 3])
def test_same_batches_in_order(size):
    """One-batch chunks through a ring of 2, unstacked: the stream of
    ``infinite_batches``, in order, across epoch wraps (5 batches an
    epoch)."""
    data = _data()
    chunks = stacked_chunks(data, 8, 1, seed=4, reuse_buffers=2)
    it = prefetch_to_device(({k: v[0] for k, v in c.items()} for c in chunks),
                            size=size, device="cpu")
    want = infinite_batches(data, 8, seed=4)
    try:
        for _ in range(12):
            _same(next(it), next(want))
    finally:
        it.close()
    assert len(it.stats["gather_ms"]) >= 12 and len(it.stats["wait_ms"]) == 12
    assert it.stats["h2d_ms"] == []  # no copy to a device on the CPU


def test_yielded_batch_survives_two_ring_wraps():
    """A chunk the consumer still holds is a private copy: ring reuse (a
    ring of 2, four more draws) never rewrites it."""
    data = _data()
    it = prefetch_to_device(stacked_chunks(data, 8, 2, seed=5, reuse_buffers=2),
                            size=1, device="cpu")
    want = stacked_chunks(data, 8, 2, seed=5)  # fresh arrays
    try:
        first = next(it)
        snapshot = {k: v.clone() for k, v in first.items()}
        rest = [next(it) for _ in range(4)]
    finally:
        it.close()
    _same(first, next(want))
    for k in snapshot:
        assert torch.equal(first[k], snapshot[k])
    for got in rest:
        _same(got, next(want))


def test_bf16_payload_arrives_as_bfloat16():
    import ml_dtypes

    x = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    payload = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    it = prefetch_to_device(iter([{"video": payload}]), device="cpu")
    got = next(it)["video"]
    it.close()
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), x.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_worker_exception_is_raised_in_the_consumer():
    def batches():
        yield {"video": np.zeros(2, np.float32)}
        raise KeyError("store went away")

    it = prefetch_to_device(batches(), device="cpu")
    assert next(it)["video"].shape == (2,)
    with pytest.raises(KeyError, match="store went away"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    it.close()
    assert not it._thread.is_alive()


def test_end_of_stream_and_close_joins_the_worker():
    it = prefetch_to_device(iter([{"x": np.ones(3)}] * 3), size=1, device="cpu")
    assert len(list(it)) == 3
    blocked = prefetch_to_device(infinite_batches(_data(), 8), size=1, device="cpu")
    next(blocked)
    deadline = time.monotonic() + 10
    while blocked._queue.empty() and time.monotonic() < deadline:
        time.sleep(0.01)  # the worker now waits on a full queue
    blocked.close(timeout=10)
    assert not blocked._thread.is_alive()
    with pytest.raises(StopIteration):
        next(blocked)
    it.close()
    assert not it._thread.is_alive()


def test_dead_worker_is_noticed(monkeypatch):
    monkeypatch.setattr(DevicePrefetcher, "POLL_S", 0.05)
    it = prefetch_to_device(iter([]), device="cpu")
    it._thread.join(timeout=10)
    it._queue.get_nowait()  # the sentinel, lost: the worker said nothing
    with pytest.raises(RuntimeError, match="died"):
        next(it)
    it.close()


def test_refusals():
    with pytest.raises(NotImplementedError, match="#16"):
        prefetch_to_device(iter([]), sharding=object())
    with pytest.raises(ValueError, match="unsupported device"):
        prefetch_to_device(iter([]), device="meta")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_pageable_batch_is_refused_on_the_card(cuda):
    it = prefetch_to_device(iter([{"x": np.ones(8, np.float32)}]), device=cuda)
    with pytest.raises(ValueError, match="pageable"):
        next(it)
    it.close()


def _trainer(**cfg):
    tower = dict(kind="mlp", embed_dim=8, hidden_dim=16)
    return Trainer(TowerConfig(input_dim=6, **tower), TowerConfig(input_dim=5, **tower),
                   TrainConfig(warmup_steps=1, total_steps=10, **cfg), device="cpu")


def _pooled(n=40):
    return SyntheticPairs(num_pairs=n, video_dim=6, text_dim=5, seed=2)


def test_max_stacked_bytes_guard():
    """A chunk over the budget raises before any step; 0 disables the
    guard; unset, the CPU budget is 2 GiB."""
    chunk = next(stacked_chunks(_pooled(), 8, 2))
    nbytes = sum(v.nbytes for v in chunk.values())
    tight = _trainer(max_stacked_bytes=nbytes - 1)
    state = tight.init_state()
    with pytest.raises(ValueError, match="over the .* chunk budget"):
        tight.train_steps(state, chunk)
    assert state.step == 0
    for budget in (nbytes, 0):
        t = _trainer(max_stacked_bytes=budget)
        state, metrics = t.train_steps(t.init_state(), chunk)
        assert state.step == 2 and metrics["loss"].shape == ()
    assert _trainer().stacked_budget() == 2 << 30
    with pytest.raises(ValueError, match="limit 3"):
        _trainer().train_steps(_trainer().init_state(), chunk, limit=3)


def test_prestacked_fit_trims_the_last_chunk():
    """fit(prestacked=True) over prefetched chunks of 3 runs 7 steps as
    3 + 3 + 1, the same parameters as 7 single steps."""
    data = _pooled()
    a = _trainer(steps_per_call=3)
    it = prefetch_to_device(stacked_chunks(data, 8, 3, seed=1, reuse_buffers=4),
                            size=1, device="cpu")
    try:
        sa, hist = a.fit(a.init_state(), it, steps=7, log_every=100, prestacked=True)
    finally:
        it.close()
    b = _trainer()
    sb, _ = b.fit(b.init_state(), infinite_batches(data, 8, seed=1), steps=7)
    assert sa.step == sb.step == 7 and hist[-1]["step"] == 7
    for (k, p), q in zip(sa.model.state_dict().items(), sb.model.state_dict().values()):
        assert torch.equal(p, q), k


@pytest.mark.parametrize("n,start", [(1, 0), (3, 0), (2, 7)])
def test_train_stream_is_the_host_stream(n, start):
    """The train CLI's stream: the batches of ``infinite_batches`` resumed
    at ``start``, unstacked when n = 1, else stacked n to a chunk; a held
    chunk stays intact across five draws (two and a half wraps of its ring
    of two)."""
    data = _data()
    it = train_stream(data, 8, n, device="cpu", seed=4, start_step=start)
    want = infinite_batches(data, 8, seed=4, start_step=start)
    if n > 1:
        want = stack_batches(want, n)
    try:
        first = next(it)
        snapshot = {k: v.clone() for k, v in first.items()}
        rest = [next(it) for _ in range(5)]
    finally:
        it.close()
    assert not it._thread.is_alive()
    _same(first, next(want))
    for k in snapshot:
        assert torch.equal(first[k], snapshot[k])
    for got in rest:
        _same(got, next(want))


def test_train_stream_refuses_before_allocating(monkeypatch):
    """A stacked chunk over the budget, and on a card a ring over the
    host's lockable share, are refused before any buffer is allocated (no
    card is touched here); one-batch chunks are not held to the chunk
    budget."""
    data = _pooled()
    nbytes = datasets.chunk_nbytes(data, 8, 2)
    assert nbytes == sum(v.nbytes for v in next(stacked_chunks(data, 8, 2)).values())
    with pytest.raises(ValueError, match="over the .* chunk budget"):
        train_stream(data, 8, 2, device="cpu", max_chunk_bytes=nbytes - 1)
    it = train_stream(data, 8, 1, device="cpu", max_chunk_bytes=1)
    assert next(it)["video"].shape == (8, 6)
    it.close()
    monkeypatch.setattr(datasets, "host_memory_bytes", lambda: 4 * nbytes - 1)
    monkeypatch.setattr(datasets, "_pinned_empty", None)  # never reached
    with pytest.raises(ValueError, match="would lock"):
        train_stream(data, 8, 2, device="cuda")


def test_resident_batches_are_bounded():
    """With ``size=1`` the worker stages one batch beyond the consumer's
    and no more, however long the consumer takes (it may have gathered the
    next on the host)."""
    it = prefetch_to_device(infinite_batches(_data(), 8), size=1, device="cpu")
    try:
        next(it)
        time.sleep(0.3)
        assert len(it.stats["bytes"]) == 2  # the consumer's and the queued one
        assert len(it.stats["gather_ms"]) <= 3
        next(it)
        time.sleep(0.3)
        assert len(it.stats["bytes"]) == 3
    finally:
        it.close()


def test_train_cli_refuses_an_oversized_chunk(tmp_path):
    """train.py refuses a stacked chunk over ``train.max_stacked_bytes``
    with a message, before its first step."""
    from crossclr_tpu_torch import train

    with pytest.raises(SystemExit, match="chunk budget"):
        train.main([
            "--device", "cpu", "--steps", "4",
            "--metrics-csv", str(tmp_path / "metrics.csv"),
            "video_tower.input_dim=6", "text_tower.input_dim=5",
            "video_tower.embed_dim=8", "text_tower.embed_dim=8",
            "video_tower.hidden_dim=16", "text_tower.hidden_dim=16",
            "data.num_pairs=64", "data.video_dim=6", "data.text_dim=5",
            "data.batch_size=8", "train.steps_per_call=2", "eval_every=2",
            "train.max_stacked_bytes=1",
        ])
