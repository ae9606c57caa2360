"""Serving what the port trains: checkpoint restore in ``build_service``,
``/reload``, ``--ema``, ``--strict-index`` and micro-batching.

Mirrors ``tests/test_serve.py``'s restore, reload, EMA and batching cases
on the port, on the CPU, at tiny widths (MLP towers 24 / 16 → 32 → 16,
fp32, 48 synthetic pairs).  Also here: the slice as a whole on the
transformer towers with flash attention (train 2 steps → eval → serve →
train 2 more → ``POST /reload``), and serving the ZeRO-1 checkpoint that
two gloo ranks of ``tests/test_torch_data_parallel.py`` wrote.  Every HTTP
call and thread join has its own timeout.
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from crossclr_tpu_torch import eval as teval
from crossclr_tpu_torch.data import SyntheticPairs, dataset_from_config, epoch_batches
from crossclr_tpu_torch.serve import _make_handler, _MicroBatcher, build_service
from crossclr_tpu_torch.training import CheckpointManager, Trainer
from crossclr_tpu_torch.utils.config import ExperimentConfig, apply_overrides

WAIT_S = 60  # every HTTP call and thread join
TINY = [
    "data.num_pairs=48", "data.batch_size=16", "data.video_dim=24",
    "data.text_dim=16", "video_tower.input_dim=24", "video_tower.embed_dim=16",
    "video_tower.hidden_dim=32", "video_tower.dtype=float32",
    "text_tower.input_dim=16", "text_tower.embed_dim=16",
    "text_tower.hidden_dim=32", "text_tower.dtype=float32",
    "train.learning_rate=0.01", "train.warmup_steps=1",
]


def _cfg(*extra):
    return apply_overrides(ExperimentConfig(), [*TINY, *extra])


def _queries(n=2):
    return SyntheticPairs(num_pairs=48, video_dim=24, text_dim=16, seed=0).text[:n]


def _trained(cfg, ckpt, steps=(0,)):
    """A trainer, its first batch, and its state saved at each of
    ``steps`` (training in between)."""
    dataset, _ = dataset_from_config(cfg.data)
    trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, "cpu")
    batch = next(iter(epoch_batches(dataset, 16, shuffle=False)))
    state = trainer.init_state()
    mngr = CheckpointManager(ckpt)
    for step in steps:
        while state.step < step:
            state, _ = trainer.train_step(state, batch)
        mngr.save(step, state)
    return trainer, batch, state


def _advance(trainer, batch, state, ckpt, steps):
    for _ in range(steps):
        state, _ = trainer.train_step(state, batch)
    CheckpointManager(ckpt).save(state.step, state)
    return state


class _Server:
    def __init__(self, service):
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(service))
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def post(self, path, payload=None, raw=None):
        req = urllib.request.Request(
            self.url + path, data=raw if raw is not None else json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def get(self, path):
        with urllib.request.urlopen(self.url + path, timeout=WAIT_S) as resp:
            return resp.status, json.loads(resp.read())

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(WAIT_S)
        assert not self.thread.is_alive()


def test_reload_picks_up_checkpoints_written_after_startup(tmp_path):
    """``reload`` restores a checkpoint that a separate training job wrote
    after the service started: queries use the new tower, the corpus is
    re-encoded (equal to a service built fresh at that step), an explicit
    step goes back; a service without a checkpoint directory refuses."""
    cfg, ckpt = _cfg(), tmp_path / "ckpt"
    trainer, batch, state = _trained(cfg, ckpt)
    service = build_service(cfg, str(ckpt), "video", device="cpu")
    assert service.step == 0 and service.state.opt_state is None
    before = service.search(_queries(), k=3)

    state = _advance(trainer, batch, state, ckpt, 3)
    assert service.reload() == 3 and service.step == service.index_step == 3
    after = service.search(_queries(), k=3)
    assert before["scores"] != after["scores"]
    fresh = build_service(cfg, str(ckpt), "video", device="cpu")
    assert torch.equal(service.corpus_emb, fresh.corpus_emb)
    assert fresh.search(_queries(), k=3) == after

    assert service.reload(step=0) == 0
    assert service.search(_queries(), k=3) == before
    with pytest.raises(FileNotFoundError):
        service.reload(step=7)
    assert service.step == 0  # a failed reload swaps nothing

    none_svc = build_service(cfg, None, "video", random_params=True, device="cpu")
    with pytest.raises(RuntimeError, match="no checkpoint directory"):
        none_svc.reload()
    with pytest.raises(SystemExit, match="no checkpoint: pass --checkpoint-dir"):
        build_service(cfg, None, "video", device="cpu")


def test_reload_with_precomputed_corpus_flags_stale_index(tmp_path):
    """``/reload`` on a ``--corpus-emb`` service keeps the precomputed
    index (only the query tower moves), and the reply and ``/healthz`` say
    that the index is stale."""
    cfg, ckpt = _cfg(), tmp_path / "ckpt"
    trainer, batch, state = _trained(cfg, ckpt)
    emb = tmp_path / "emb.npz"
    assert teval.main(["--split", "all", "--device", "cpu", "--checkpoint-dir",
                       str(ckpt), "--embeddings-output", str(emb), *TINY]) == 0
    service = build_service(cfg, str(ckpt), "video", corpus_emb_path=str(emb),
                            device="cpu")
    assert service.index_step == 0 and not service.index_stale
    frozen = service.corpus_emb.clone()

    state = _advance(trainer, batch, state, ckpt, 2)
    server = _Server(service)
    try:
        status, body = server.post("/reload", {})
        assert status == 200
        assert body["step"] == 2 and body["index_step"] == 0
        assert "refresh the --corpus-emb dump" in body["warning"]
        assert torch.equal(service.corpus_emb, frozen)
        status, health = server.get("/healthz")
        assert health["step"] == 2 and health["index_step"] == 0
        assert health["index_stale"] is True
    finally:
        server.close()


def test_reload_endpoint_over_http(tmp_path):
    """``POST /reload``: 200 with the step (and the index's), 400 for a
    step that does not exist and for a service with no checkpoint
    directory; a malformed body is a 400 and no failed search; a search
    fault answers 500 and counts as a failed search."""
    cfg, ckpt = _cfg(), tmp_path / "ckpt"
    trainer, batch, state = _trained(cfg, ckpt)
    service = build_service(cfg, str(ckpt), "video", device="cpu")
    server = _Server(service)
    try:
        _advance(trainer, batch, state, ckpt, 1)
        assert server.post("/reload", {}) == (
            200, {"status": "ok", "step": 1, "index_step": 1})
        assert server.get("/healthz")[1]["step"] == 1
        status, body = server.post("/reload", {"step": 99})
        assert status == 400 and "FileNotFoundError" in body["error"]
        status, body = server.post("/reload", {"step": "x"})
        assert status == 400 and "ValueError" in body["error"]
        status, _ = server.post("/reload", raw=b"{not json")
        assert status == 400
        assert server.get("/metrics")[1]["search_errors"] == 0
        assert server.post("/reload", {"step": 0})[1]["step"] == 0

        def fault(*a):
            raise RuntimeError("device fault")

        service._dispatch = fault
        status, body = server.post("/search", {"features": _queries().tolist(), "k": 2})
        assert status == 500 and "device fault" in body["error"]
        assert server.get("/metrics")[1]["search_errors"] == 1
    finally:
        server.close()

    random_svc = build_service(cfg, None, "video", random_params=True, device="cpu")
    server = _Server(random_svc)
    try:
        status, body = server.post("/reload", {})
        assert status == 400 and "no checkpoint directory" in body["error"]
    finally:
        server.close()


def test_ema_serving_and_the_flavour_checks(tmp_path):
    """``use_ema``: queries and the corpus use the EMA parameters; a dump
    of the other flavour is flagged (``index_tower_mismatch``, in
    /healthz too) and refused under ``strict_index``, which also refuses a
    step mismatch; a reload keeps serving the EMA."""
    cfg, ckpt = _cfg("train.ema_decay=0.5"), tmp_path / "ckpt"
    trainer, batch, state = _trained(cfg, ckpt, steps=(3,))
    ema = build_service(cfg, str(ckpt), "video", use_ema=True, device="cpu")
    live = build_service(cfg, str(ckpt), "video", device="cpu")
    assert ema.search(_queries(3), k=4)["scores"] != live.search(_queries(3), k=4)["scores"]
    dataset, _ = dataset_from_config(cfg.data)
    v_ema, _ = teval._encode_split(trainer, trainer.ema_state(state), dataset, 16)
    torch.testing.assert_close(ema.corpus_emb, v_ema, rtol=0, atol=1e-6)

    dumps = {}
    for flavour, flags in (("live", []), ("ema", ["--ema"])):
        dumps[flavour] = str(tmp_path / f"{flavour}.npz")
        assert teval.main(["--split", "all", "--device", "cpu", *flags,
                           "--checkpoint-dir", str(ckpt), "--embeddings-output",
                           dumps[flavour], *TINY, "train.ema_decay=0.5"]) == 0
    mismatched = build_service(cfg, str(ckpt), "video", use_ema=True,
                               corpus_emb_path=dumps["live"], device="cpu")
    assert mismatched.index_tower_mismatch
    server = _Server(mismatched)
    try:
        assert server.get("/healthz")[1]["index_tower_mismatch"] is True
    finally:
        server.close()
    for use_ema, dump in ((True, dumps["ema"]), (False, dumps["live"])):
        ok = build_service(cfg, str(ckpt), "video", use_ema=use_ema,
                           corpus_emb_path=dump, strict_index=True, device="cpu")
        assert not ok.index_tower_mismatch and not ok.index_stale
    for use_ema, dump in ((True, dumps["live"]), (False, dumps["ema"])):
        with pytest.raises(SystemExit, match="EMA/live flavor"):
            build_service(cfg, str(ckpt), "video", use_ema=use_ema,
                          corpus_emb_path=dump, strict_index=True, device="cpu")
    _advance(trainer, batch, state, ckpt, 1)
    with pytest.raises(SystemExit, match="step mismatch"):
        build_service(cfg, str(ckpt), "video", use_ema=True,
                      corpus_emb_path=dumps["ema"], strict_index=True, device="cpu")
    assert ema.reload() == 4
    fresh = build_service(cfg, str(ckpt), "video", use_ema=True, device="cpu")
    assert torch.equal(ema.corpus_emb, fresh.corpus_emb)
    with pytest.raises(ValueError, match="no EMA"):
        build_service(_cfg(), None, "video", random_params=True, use_ema=True,
                      device="cpu")


def test_micro_batching_coalesces_and_matches_serial():
    """``batch_window_ms``: concurrent searches share dispatches; each
    requester gets exactly its rows and its k, as the serial service
    answers (indices equal, scores within 1e-6)."""
    cfg = _cfg()
    plain = build_service(cfg, None, "video", random_params=True, device="cpu")
    batched = build_service(cfg, None, "video", random_params=True, device="cpu",
                            batch_window_ms=100.0)
    queries = SyntheticPairs(num_pairs=48, video_dim=24, text_dim=16, seed=0).text
    try:
        base = batched._dispatch_count
        n_req = 6
        results = [None] * n_req
        barrier = threading.Barrier(n_req, timeout=WAIT_S)

        def worker(i):
            barrier.wait()
            results[i] = batched.search(queries[2 * i:2 * i + 2], k=2 + i % 3)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_req)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
            assert not t.is_alive()
        for i in range(n_req):
            want = plain.search(queries[2 * i:2 * i + 2], k=2 + i % 3)
            assert results[i]["indices"] == want["indices"], f"request {i}"
            np.testing.assert_allclose(results[i]["scores"], want["scores"],
                                       rtol=0, atol=1e-6)
        coalesced = batched._dispatch_count - base
        assert coalesced < n_req, f"no coalescing: {coalesced} dispatches"
        assert batched.stats()["search_dispatches"] == coalesced
        # the k=0 contract bypasses the batcher
        assert batched.search(queries[:1], k=0) == plain.search(queries[:1], k=0)
    finally:
        batched._batcher.close()
    assert not batched._batcher._worker.is_alive()


def test_concurrent_http_clients_share_dispatches():
    """``serve.ServiceHTTPServer`` behind a 5 ms window: 16 HTTP clients
    (more threads than cores, a short switch interval) released together
    all get 200 and the serial answers, in fewer dispatches than requests;
    its listen backlog takes them all (the default of 5 resets some)."""
    import sys

    from crossclr_tpu_torch.serve import ServiceHTTPServer

    cfg = _cfg()
    plain = build_service(cfg, None, "video", random_params=True, device="cpu")
    batched = build_service(cfg, None, "video", random_params=True, device="cpu",
                            batch_window_ms=5.0)
    queries = SyntheticPairs(num_pairs=48, video_dim=24, text_dim=16, seed=0).text
    httpd = ServiceHTTPServer(("127.0.0.1", 0), batched)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/search"
    n = 16
    answers = [None] * n
    gate = threading.Barrier(n, timeout=WAIT_S)

    def client(i):
        gate.wait()
        req = urllib.request.Request(
            url, data=json.dumps({"features": queries[2 * i:2 * i + 2].tolist(),
                                  "k": 3}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            answers[i] = (resp.status, json.loads(resp.read()))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
        httpd.shutdown()
        httpd.server_close()
        batched._batcher.close()
    for i, answer in enumerate(answers):
        assert answer is not None and answer[0] == 200, f"client {i}"
        want = plain.search(queries[2 * i:2 * i + 2], k=3)
        assert answer[1]["indices"] == want["indices"], f"client {i}"
        np.testing.assert_allclose(answer[1]["scores"], want["scores"], rtol=0,
                                   atol=1e-6)
    assert batched.stats()["search_dispatches"] < n
    assert batched.stats()["search_requests"] == n


def test_micro_batcher_error_propagation_and_close():
    """A failing dispatch reaches every coalesced waiter; ``close`` joins
    the worker and a closed batcher refuses new requests."""
    calls = {"n": 0}

    def boom(features, mask, k):
        calls["n"] += 1
        raise RuntimeError("device on fire")

    b = _MicroBatcher(boom, window_ms=50.0, max_batch=8)
    errs = [None, None]

    def worker(i):
        try:
            b.submit(np.zeros((1, 4), np.float32), None, 2)
        except RuntimeError as e:
            errs[i] = str(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive()
    assert errs == ["device on fire", "device on fire"]
    assert 1 <= calls["n"] <= 2
    b.close()
    assert not b._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.zeros((1, 4), np.float32), None, 2)


# the transformer towers with flash attention, narrowed as
# tests/test_torch_no_jax.py narrows configs/lsmdc_transformer.json
FLASH = [
    "video_tower.attention=flash", "text_tower.attention=flash",
    "video_tower.input_dim=12", "text_tower.input_dim=10",
    "video_tower.embed_dim=8", "text_tower.embed_dim=8",
    "video_tower.hidden_dim=16", "text_tower.hidden_dim=16",
    "video_tower.num_layers=1", "text_tower.num_layers=1",
    "video_tower.num_heads=2", "text_tower.num_heads=2",
    "data.source=synthetic", "data.num_pairs=64", "data.video_dim=12",
    "data.text_dim=10", "data.video_seq_len=5", "data.text_seq_len=4",
    "data.variable_lengths=true", "data.batch_size=16",
    "train.warmup_steps=1", "train.steps_per_call=2", "train.ema_decay=0.9",
    "eval_every=2",
]


def test_train_eval_serve_train_reload(tmp_path, capsys):
    """The slice on the CPU: the train CLI (2 steps) → the eval CLI → a
    service from the checkpoint → the train CLI resumed to 4 steps →
    ``POST /reload``: the step advances, the corpus is re-encoded to what
    a fresh service at step 4 holds, and the eval CLI's embeddings are
    the service's corpus (live and EMA)."""
    from pathlib import Path

    from crossclr_tpu_torch import train
    from crossclr_tpu_torch.utils.config import load_config

    config = str(Path(__file__).resolve().parent.parent / "configs"
                 / "lsmdc_transformer.json")
    overrides = [*FLASH, f"checkpoint_dir={tmp_path / 'ckpt'}"]
    cfg = apply_overrides(load_config(config), overrides)
    run = ["--config", config, "--device", "cpu"]
    assert train.main([*run, "--steps", "2", *overrides]) == 0
    assert teval.main([*run, "--split", "all", "--embeddings-output",
                       str(tmp_path / "emb.npz"), *overrides]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["step"] == 2 and metrics["rows"] == 64
    assert all(np.isfinite(v) for k, v in metrics.items() if "/" in k)

    ckpt = cfg.checkpoint_dir
    service = build_service(cfg, ckpt, "video", device="cpu")
    with np.load(tmp_path / "emb.npz") as z:
        np.testing.assert_allclose(service.corpus_emb.numpy(), z["video"],
                                   rtol=0, atol=1e-6)
    data, _ = dataset_from_config(cfg.data)
    feats, mask = data.text[:3], data.text_mask[:3]
    before = service.search(feats, mask, k=5)

    assert train.main([*run, "--steps", "4", *overrides]) == 0
    server = _Server(service)
    try:
        assert server.post("/reload", {}) == (
            200, {"status": "ok", "step": 4, "index_step": 4})
        status, out = server.post("/search", {"features": feats.tolist(),
                                              "mask": mask.tolist(), "k": 5})
        assert status == 200 and out["scores"] != before["scores"]
    finally:
        server.close()
    fresh = build_service(cfg, ckpt, "video", device="cpu")
    assert torch.equal(service.corpus_emb, fresh.corpus_emb)
    assert fresh.search(feats, mask, k=5)["indices"] == out["indices"]
    ema = build_service(cfg, ckpt, "video", device="cpu", use_ema=True)
    assert not torch.equal(ema.corpus_emb, fresh.corpus_emb)


def test_serves_the_zero1_checkpoint_of_two_gloo_ranks(request, tmp_path_factory):
    """The podslice config's checkpoint that the train CLI wrote on two
    gloo ranks (ZeRO-1: full moments gathered into it) loads at one rank:
    the service starts at its step, answers, and reloads an earlier one."""
    from test_torch_data_parallel import CLI_OPTIONS, CLI_OVERRIDES, _world
    from crossclr_tpu_torch.utils.config import load_config

    _, ranks, shared = _world(request, tmp_path_factory, 2)
    assert all(res["cli|rc"] == [0, 0, 0, 0] for res in ranks)
    cfg = apply_overrides(load_config(CLI_OPTIONS[1]), CLI_OVERRIDES)
    assert cfg.train.zero1
    ckpt = shared / "cli_straight"
    service = build_service(cfg, str(ckpt), "video", device="cpu")
    assert service.step == 4 and service.corpus_rows == 72
    saved = torch.load(ckpt / "step_4.pt", weights_only=True)
    for name, p in service.state.model.named_parameters():
        assert torch.equal(p.detach(), saved["model"][name]), name
    data, _ = dataset_from_config(cfg.data)
    out = service.search(data.text[:2], k=3)
    assert np.asarray(out["indices"]).shape == (2, 3)
    assert service.reload(step=2) == 2
