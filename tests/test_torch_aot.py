"""Exported serving artifacts (``crossclr_tpu_torch/aot.py``): export →
file → load → search with no config, checkpoint or model code on the load
side, held to the live service (``tests/test_aot.py``'s cases, on the
port), plus the JAX artifact on the same Flax weights and the flash
operator in the exported graph.

Config: ``tests/test_aot.py``'s (MLP towers 24/16 → 32 → 16 over 48
synthetic rows; transformer towers with 2 heads and S = 4 for the masked
cases, ``attention="flash"``), fp32, on the CPU, where the exported flash
operator runs its plain version.  Limits: ``tests/test_aot.py``'s (scores
within 2e-6 of the live service's, the int8 index bit for bit), and 1e-5
against the JAX artifact (``tests/test_torch_serve.py``'s port-vs-JAX
limit).
"""

import json
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.aot import SearchArtifact, export_search, save_artifact
from crossclr_tpu_torch.data import SyntheticPairs
from crossclr_tpu_torch.serve import build_service
from crossclr_tpu_torch.utils.config import (
    DataConfig,
    ExperimentConfig,
    apply_overrides,
    save_config,
)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent
ATOL = 2e-6
SEQ_OVERRIDES = [
    "video_tower.kind=transformer", "video_tower.input_dim=24",
    "video_tower.embed_dim=16", "video_tower.hidden_dim=32",
    "video_tower.num_heads=2", "video_tower.max_seq_len=4",
    "video_tower.dtype=float32", "video_tower.attention=flash",
    "text_tower.kind=transformer", "text_tower.input_dim=16",
    "text_tower.embed_dim=16", "text_tower.hidden_dim=32",
    "text_tower.num_heads=2", "text_tower.max_seq_len=4",
    "text_tower.dtype=float32", "text_tower.attention=flash",
]


def _tiny_cfg(**data_kw):
    data_kw = {"num_pairs": 48, **data_kw}
    cfg = ExperimentConfig(data=DataConfig(
        batch_size=16, video_dim=24, text_dim=16, **data_kw
    ))
    return apply_overrides(cfg, [
        "video_tower.input_dim=24", "video_tower.embed_dim=16",
        "video_tower.hidden_dim=32", "video_tower.dtype=float32",
        "text_tower.input_dim=16", "text_tower.embed_dim=16",
        "text_tower.hidden_dim=32", "text_tower.dtype=float32",
    ])


def _seq_cfg():
    cfg = ExperimentConfig(data=DataConfig(
        num_pairs=48, batch_size=16, video_dim=24, text_dim=16,
        video_seq_len=4, text_seq_len=4,
    ))
    return apply_overrides(cfg, SEQ_OVERRIDES)


def _seq_data():
    return SyntheticPairs(num_pairs=48, video_dim=24, text_dim=16,
                          video_seq_len=4, text_seq_len=4, seed=0)


def _service(cfg=None, **kw):
    return build_service(cfg or _tiny_cfg(), None, "video", random_params=True,
                         device="cpu", **kw)


def _queries(n=5):
    return SyntheticPairs(num_pairs=48, video_dim=24, text_dim=16, seed=0).text[:n]


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    """The MLP service and its exported artifact (k = 6, with ids), shared
    by the cases that only read them."""
    service = _service()
    blob, meta, corpus = export_search(service, k=6)
    path = str(tmp_path_factory.mktemp("mlp") / "art.npz")
    save_artifact(path, blob, meta, corpus, ids=[f"clip{i}" for i in range(48)])
    return service, meta, path


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """The flash-transformer service and its artifact (k = 4, masked
    queries of 4 x 16), shared likewise."""
    service = _service(_seq_cfg())
    blob, meta, corpus = export_search(service, k=4, query_shape=(4, 16))
    path = str(tmp_path_factory.mktemp("seq") / "seq.npz")
    save_artifact(path, blob, meta, corpus)
    return service, meta, path, blob


def _assert_same(got, want, atol=ATOL):
    assert got["indices"] == want["indices"]
    np.testing.assert_allclose(np.asarray(got["scores"]),
                               np.asarray(want["scores"]), atol=atol, rtol=0)


def test_artifact_matches_service_across_batch_sizes(mlp):
    """One export serves any batch size (symbolic b), results equal the
    live service; ids ride along; smaller k slices the sorted columns."""
    service, meta, path = mlp
    assert meta["k"] == 6 and meta["corpus_rows"] == 48
    assert meta["query_side"] == "text" and not meta["with_mask"]
    assert meta["platforms"] == ["cpu"]

    art = SearchArtifact.load(path)
    q = _queries(5)
    for n in (1, 3, 5):  # no export again between batch sizes
        got = art.search(q[:n])
        _assert_same(got, service.search(q[:n], k=6))
        assert got["ids"][0][0] == f"clip{got['indices'][0][0]}"

    # single-query convenience + k slicing
    one = art.search(q[0], k=2)
    assert np.asarray(one["indices"]).shape == (1, 2)
    assert one["indices"][0] == got["indices"][0][:2]

    with pytest.raises(ValueError, match="outside"):
        art.search(q[:1], k=7)
    with pytest.raises(ValueError, match="pooled"):
        art.search(q[:1], mask=np.ones((1, 4), np.float32))
    # the program runs on the device type it was exported on only
    with pytest.raises(ValueError, match="exported on cpu"):
        SearchArtifact.load(path, device="cuda")


def test_artifact_sequence_tower_with_mask(seq):
    """Masked sequence queries: the artifact signature carries the mask
    and matches the service for full and partial masks."""
    service, meta, path, _ = seq
    assert meta["with_mask"]
    art = SearchArtifact.load(path)

    q = np.asarray(_seq_data().text[:3], np.float32)
    mask = np.ones((3, 4), np.float32)
    mask[:, 2:] = 0.0
    for m in (None, mask):
        _assert_same(art.search(q, mask=m), service.search(q, m, k=4))


def test_artifact_int8_index(tmp_path):
    """An int8 index exports and matches the int8 service bitwise
    (integer accumulation)."""
    service = _service(corpus_dtype="int8")
    blob, meta, corpus = export_search(service, k=3)
    assert meta["index_dtype"] == "int8"
    assert corpus[0].dtype == np.int8  # the index keeps its storage dtype
    path = str(tmp_path / "q8.npz")
    save_artifact(path, blob, meta, corpus)
    art = SearchArtifact.load(path)
    q = _queries(4)
    got = art.search(q)
    want = service.search(q, k=3)
    assert got["indices"] == want["indices"]
    np.testing.assert_array_equal(np.asarray(got["scores"]),
                                  np.asarray(want["scores"]))


def test_export_refuses_sharded_corpus():
    """A sharded service (its index spread over a group's ranks) is
    refused; ``tests/test_torch_sharded_retrieval.py`` builds real ones."""
    service = _service()
    service.group = object()  # what build_service(shard_corpus=True) sets
    with pytest.raises(ValueError, match="sharded"):
        export_search(service, k=3)


def test_export_cli_roundtrip(tmp_path):
    """``python -m crossclr_tpu_torch.export_serving`` writes a loadable
    artifact with ids."""
    from crossclr_tpu_torch.export_serving import main as export_main

    cfg_path = tmp_path / "cfg.json"
    save_config(_tiny_cfg(), str(cfg_path))
    out = tmp_path / "art.npz"
    rc = export_main([
        "--config", str(cfg_path), "--random-params", "--device", "cpu",
        "--k", "4", "--output", str(out),
    ])
    assert rc == 0 and out.exists()
    art = SearchArtifact.load(str(out))
    assert art.meta["k"] == 4 and art.meta["corpus_rows"] == 48
    assert json.dumps(art.meta)  # meta stays JSON-serializable
    res = art.search(_queries(2))
    assert np.asarray(res["indices"]).shape == (2, 4)
    s = np.asarray(res["scores"])
    assert np.all(np.isfinite(s)) and np.all(s[:, :-1] >= s[:, 1:])
    # a precomputed index from another step than the tower's is refused
    np.savez(tmp_path / "emb.npz", video=np.ones((48, 16), np.float32),
             step=np.int64(3))
    with pytest.raises(SystemExit, match="refusing to export"):
        export_main(["--config", str(cfg_path), "--random-params", "--device",
                     "cpu", "--corpus-emb", str(tmp_path / "emb.npz"),
                     "--output", str(tmp_path / "stale.npz")])


def test_artifact_bf16_index_stays_bf16(tmp_path):
    """A bf16 service exports a bf16 index (stored as a uint16 view in the
    npz, not folded into the program) and matches the live bf16 service."""
    service = _service(corpus_dtype="bfloat16")
    blob, meta, corpus = export_search(service, k=3)
    assert meta["index_dtype"] == "bfloat16"
    assert meta["corpus_dtypes"] == ["bfloat16"]
    path = str(tmp_path / "bf16.npz")
    save_artifact(path, blob, meta, corpus)
    with np.load(path, allow_pickle=False) as npz:
        assert npz["corpus_0"].dtype == np.uint16  # view storage
        np.testing.assert_array_equal(
            npz["corpus_0"], service.corpus_emb.view(torch.int16).numpy().view(np.uint16))

    # the index is not in the program: its size does not grow with the
    # corpus (the parameters are its only constants)
    big = _service(_tiny_cfg(num_pairs=480), corpus_dtype="bfloat16")
    blob_big, _, corpus_big = export_search(big, k=3)
    assert corpus_big[0].nbytes == 10 * corpus[0].nbytes
    assert abs(len(blob_big) - len(blob)) < 2000

    art = SearchArtifact.load(path)
    assert art._corpus[0].dtype == torch.bfloat16
    q = _queries(4)
    _assert_same(art.search(q), service.search(q, k=3))


def test_artifact_single_query_mask_convenience(seq):
    """A 1-D mask expands alongside a single (S, D) query, as the live
    service's search does."""
    service, _, path, _ = seq
    art = SearchArtifact.load(path)

    q1 = np.asarray(_seq_data().text[0], np.float32)  # (S, D) single query
    m1 = np.asarray([1, 1, 0, 0], np.float32)  # (S,) single mask
    assert art.search(q1, mask=m1, k=3)["indices"] == service.search(q1, m1, k=3)["indices"]


def test_artifact_http_service_matches_live(mlp):
    """``serve --artifact``'s surface: an ArtifactService answers /search
    with the live service's results, /healthz and /metrics work, and
    /reload is refused (400: artifacts are immutable)."""
    from crossclr_tpu_torch.serve import ArtifactService, ServiceHTTPServer

    service, _, path = mlp
    art_service = ArtifactService(SearchArtifact.load(path))
    assert art_service.corpus_rows == 48 and art_service.is_artifact
    httpd = ServiceHTTPServer(("127.0.0.1", 0), art_service)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path_, payload):
        req = urllib.request.Request(
            url + path_, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        try:
            with urllib.request.urlopen(req) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        with urllib.request.urlopen(url + "/healthz") as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["artifact"] is True
        assert health["corpus_rows"] == 48
        assert health["corpus_side"] == "video"
        assert health["query_side"] == "text"

        q = _queries(3)
        code, got = post("/search", {"features": q.tolist(), "k": 6})
        assert code == 200
        _assert_same(got, service.search(q, k=6))
        assert got["ids"][0][0] == f"clip{got['indices'][0][0]}"

        # k above the baked width clamps; k=0 keeps the empty-lists contract
        code, clamped = post("/search", {"features": q.tolist(), "k": 99})
        assert code == 200 and len(clamped["indices"][0]) == 6
        code, empty = post("/search", {"features": q.tolist(), "k": 0})
        assert code == 200 and empty["indices"] == [[], [], []]
        assert empty["ids"] == [[], [], []]

        code, _ = post("/search", {"features": "nope"})
        assert code == 400

        code, rejected = post("/reload", {})
        assert code == 400 and "immutable" in rejected["error"]

        with urllib.request.urlopen(url + "/metrics") as resp:
            metrics = json.loads(resp.read())
        assert metrics["search_requests"] == 4
        assert metrics["search_errors"] == 1
        assert metrics["search_dispatches"] == 2  # k=0 and malformed skip
        assert "latency_ms" in metrics
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_serve_cli_artifact(mlp):
    """``python -m crossclr_tpu_torch.serve --artifact art.npz`` starts with
    no config or checkpoint and serves until SIGTERM; every flag of the
    JAX CLI's conflict list is refused before anything loads."""
    from crossclr_tpu_torch.serve import main as serve_main

    _, _, path = mlp

    for extra in (["--config", "c.json"], ["--checkpoint-dir", "d"],
                  ["--corpus-emb", "e.npz"], ["--shard-corpus"], ["--ema"],
                  ["--random-params"], ["--strict-index"], ["--batch-size", "4"],
                  ["--batch-window-ms", "2"], ["--corpus", "text"],
                  ["--corpus-dtype", "int8"], ["data.batch_size=4"]):
        with pytest.raises(SystemExit, match="self-contained"):
            serve_main(["--artifact", path, *extra])

    proc = subprocess.Popen(
        [sys.executable, "-m", "crossclr_tpu_torch.serve", "--artifact", path,
         "--port", "0"],
        cwd=REPO, stderr=subprocess.PIPE, text=True,
    )
    watchdog = threading.Timer(120, proc.kill)
    watchdog.start()
    try:
        while True:
            line = proc.stderr.readline()
            if "serving" in line:
                banner = line
                break
            if line == "" or proc.poll() is not None:
                raise AssertionError(
                    f"server died before readiness: {proc.communicate()[1]}"
                )
        assert "serving 48 video rows" in banner
        assert "AOT artifact" in banner
        proc.send_signal(signal.SIGTERM)
        _, rest = proc.communicate(timeout=60)
        assert proc.returncode == 0, rest
        assert "server stopped" in rest
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()


def test_artifact_matches_jax_artifact(tmp_path):
    """The same Flax weights (``utils.params.state_dict_from_flax``) through
    the JAX package's artifact and the port's, masked sequence queries:
    the same indices, scores within 1e-5."""
    import jax

    from crossclr_tpu import aot as jaot
    from crossclr_tpu import serve as jserve
    from crossclr_tpu.utils import config as jconfig
    from crossclr_tpu_torch.models import DualEncoder
    from crossclr_tpu_torch.utils.params import state_dict_from_flax

    overrides = [o for o in SEQ_OVERRIDES if "attention" not in o]
    jcfg = jconfig.apply_overrides(jconfig.ExperimentConfig(data=jconfig.DataConfig(
        num_pairs=48, batch_size=16, video_dim=24, text_dim=16,
        video_seq_len=4, text_seq_len=4)), overrides)
    jsvc = jserve.build_service(jcfg, None, "video", random_params=True)
    jblob, jmeta, jcorpus = jaot.export_search(jsvc, k=5, query_shape=(4, 16))
    jaot.save_artifact(str(tmp_path / "jax.npz"), jblob, jmeta, jcorpus)

    cfg = _seq_cfg()
    sd = state_dict_from_flax(jax.device_get(jsvc.state.params),
                              DualEncoder(cfg.video_tower, cfg.text_tower))
    service = build_service(cfg, None, "video", device="cpu", state_dict=sd)
    blob, meta, corpus = export_search(service, k=5, query_shape=(4, 16))
    save_artifact(str(tmp_path / "port.npz"), blob, meta, corpus)
    for key in ("version", "k", "query_side", "corpus_side", "corpus_rows",
                "query_shape", "with_mask", "step", "index_dtype", "corpus_dtypes"):
        assert meta[key] == jmeta[key], key

    q = np.asarray(_seq_data().text[:6], np.float32)
    mask = np.ones((6, 4), np.float32)
    mask[::2, 3:] = 0.0
    want = jaot.SearchArtifact.load(str(tmp_path / "jax.npz")).search(q, mask)
    got = SearchArtifact.load(str(tmp_path / "port.npz")).search(q, mask)
    _assert_same(got, want, atol=1e-5)


def test_exported_graph_holds_the_flash_operator(seq):
    """The flash towers' attention is captured as ``crossclr::flash_fwd``
    (kernel 1's operator; its CUDA implementation launches the kernel),
    once per layer, with a symbolic batch; a tower of attention='xla'
    exports no such node."""
    import io

    blob = seq[3]
    program = torch.export.load(io.BytesIO(blob))
    calls = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert calls.count("crossclr.flash_fwd.default") == 2  # num_layers
    (b,) = {str(n.meta["val"].shape[0]) for n in program.graph.nodes
            if n.op == "placeholder" and n.name == "features"}
    assert not b.isdigit()  # the batch stays symbolic

    xla = _service(apply_overrides(_seq_cfg(), ["text_tower.attention=xla"]))
    blob, _, _ = export_search(xla, k=3, query_shape=(4, 16))
    assert b"crossclr.flash_fwd" not in blob


@pytest.mark.parametrize("masked", [False, True])
def test_flash_operator_fake_matches_its_cpu_implementation(masked):
    """``torch.library.opcheck`` of ``crossclr::flash_fwd`` on the
    ``[B, S, H, Dh] -> [B, H, S, Dh]`` transpose view the towers hand it
    under no-grad: the fake implementation's shapes, dtypes and strides
    are the real (contiguous) outputs', for the batch the export makes
    symbolic too."""
    import crossclr_tpu_torch.ops  # noqa: F401  (registers the operator)

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 5, 2, 8, generator=g).transpose(1, 2) for _ in range(3))
    assert not q.is_contiguous()
    mask = (torch.arange(5) < torch.tensor([[5], [3]])).float() if masked else None
    torch.library.opcheck(torch.ops.crossclr.flash_fwd.default,
                          (q, k, v, mask, 8 ** -0.5, 0.0, 0, 0, 0, 0, 2, 0))
