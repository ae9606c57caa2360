"""The serving slice as a whole: the port's service against the JAX
service on the same weights, and the port's HTTP surface.

Config: transformer towers with attention="flash" (inputs 24/16, E=16, 4
heads, 2 layers, S=8/6, fp32) over 64 synthetic rows with ragged lengths.
The JAX service is built with random params under the 8-device CPU mesh
of ``tests/conftest.py``, where its trainer runs the towers with
attention="xla" (same values; the flash-specific comparison lives in
``test_torch_flash_attention.py`` and ``test_torch_encoders.py``).  Its
params cross over through ``state_dict_from_flax``.  Tolerance: fp32,
atol 1e-5 on corpus embeddings and scores.
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest

from crossclr_tpu import serve as jserve
from crossclr_tpu.utils import config as jconfig
from crossclr_tpu_torch import serve as tserve
from crossclr_tpu_torch.data import SyntheticPairs
from crossclr_tpu_torch.evaluation import similarity_matrix
from crossclr_tpu_torch.models import DualEncoder
from crossclr_tpu_torch.utils import config as tconfig
from crossclr_tpu_torch.utils.params import state_dict_from_flax

ATOL = 1e-5
OVERRIDES = [
    "video_tower.kind=transformer", "text_tower.kind=transformer",
    "video_tower.attention=flash", "text_tower.attention=flash",
    "video_tower.input_dim=24", "text_tower.input_dim=16",
    "video_tower.embed_dim=16", "text_tower.embed_dim=16",
    "video_tower.hidden_dim=32", "text_tower.hidden_dim=32",
    "video_tower.num_heads=4", "text_tower.num_heads=4",
    "video_tower.num_layers=2", "text_tower.num_layers=2",
    "video_tower.max_seq_len=8", "text_tower.max_seq_len=6",
    "video_tower.dtype=float32", "text_tower.dtype=float32",
    "data.num_pairs=64", "data.video_dim=24", "data.text_dim=16",
    "data.video_seq_len=8", "data.text_seq_len=6",
    "data.variable_lengths=true", "data.batch_size=16",
]


def _port_cfg():
    return tconfig.apply_overrides(tconfig.ExperimentConfig(), OVERRIDES)


def _data():
    return SyntheticPairs(num_pairs=64, video_dim=24, text_dim=16,
                          video_seq_len=8, text_seq_len=6,
                          variable_lengths=True)


@pytest.fixture(scope="module")
def services():
    jcfg = jconfig.apply_overrides(jconfig.ExperimentConfig(), OVERRIDES)
    jsvc = jserve.build_service(jcfg, None, "video", random_params=True)
    cfg = _port_cfg()
    sd = state_dict_from_flax(
        jax.device_get(jsvc.state.params),
        DualEncoder(cfg.video_tower, cfg.text_tower),
    )
    tsvc = tserve.build_service(cfg, None, "video", device="cpu",
                                state_dict=sd)
    return jsvc, tsvc


@pytest.fixture(scope="module")
def server(services):
    _, tsvc = services
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tserve._make_handler(tsvc))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield tsvc, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _post(url, payload, path="/search"):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req) as resp:
        return resp.status, json.loads(resp.read())


def _get(url, path):
    with urllib.request.urlopen(url + path) as resp:
        return resp.status, json.loads(resp.read())


def test_corpus_embeddings_match_jax(services):
    jsvc, tsvc = services
    assert tsvc.corpus_rows == jsvc.corpus_rows == 64
    np.testing.assert_allclose(
        tsvc.corpus_emb.numpy(), np.asarray(jsvc.corpus_emb),
        rtol=0, atol=ATOL,
    )


def test_search_matches_jax(services):
    jsvc, tsvc = services
    data = _data()
    feats, mask = data.text[:5], data.text_mask[:5]
    jout = jsvc.search(feats, mask, k=5)
    tout = tsvc.search(feats, mask, k=5)
    assert tout["indices"] == jout["indices"]
    np.testing.assert_allclose(tout["scores"], jout["scores"], rtol=0,
                               atol=ATOL)
    # top-1 is the argmax of the cosine similarity to the corpus
    q = tsvc.trainer.encode_modality(tsvc.state, "text", feats, mask)
    sim = similarity_matrix(q, tsvc.corpus_emb)
    assert [r[0] for r in tout["indices"]] == sim.argmax(dim=1).tolist()


def test_healthz_and_unported_paths(server):
    _, url = server
    status, body = _get(url, "/healthz")
    assert status == 200
    assert body == {
        "status": "ok", "corpus_rows": 64, "corpus_side": "video",
        "query_side": "text", "step": 0, "index_step": 0,
    }
    # weights handed in as a state_dict: no checkpoint directory to reload
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, {}, path="/reload")
    assert e.value.code == 400
    assert "no checkpoint directory" in json.loads(e.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(url, "/nope")
    assert e.value.code == 404


def test_search_round_trip_and_errors(server):
    service, url = server
    data = _data()
    status, out = _post(url, {"features": data.text[:3].tolist(),
                              "mask": data.text_mask[:3].tolist(), "k": 4})
    assert status == 200
    assert np.asarray(out["indices"]).shape == (3, 4)
    for row in out["scores"]:
        assert row == sorted(row, reverse=True)
    direct = service.search(data.text[:3], data.text_mask[:3], k=4)
    assert out["indices"] == direct["indices"]

    # k beyond the corpus clamps to a full ranking; k=0 answers empty lists
    status, out = _post(url, {"features": data.text[0].tolist(), "k": 500})
    assert sorted(out["indices"][0]) == list(range(64))
    status, out = _post(url, {"features": data.text[:2].tolist(), "k": 0})
    assert out["indices"] == [[], []] and out["scores"] == [[], []]

    for bad in ({"k": 2}, {"features": [[0.0] * 7], "k": 2}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, bad)
        assert e.value.code == 400
        assert "error" in json.loads(e.value.read())


def test_metrics_count_requests_and_malformed_bodies(server):
    service, url = server
    data = _data()
    before = _get(url, "/metrics")[1]
    for _ in range(3):
        _post(url, {"features": data.text[:2].tolist(), "k": 2})
    req = urllib.request.Request(
        url + "/search", data=b"{not json",
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400
    status, after = _get(url, "/metrics")
    assert status == 200
    assert after["search_requests"] - before["search_requests"] == 4
    assert after["search_errors"] - before["search_errors"] == 1
    assert after["search_dispatches"] - before["search_dispatches"] == 3
    assert after["latency_ms"]["p50"] > 0
    assert after["corpus_rows"] == 64


def test_bf16_index_and_refused_options():
    cfg = _port_cfg()
    svc = tserve.build_service(cfg, None, "video", random_params=True,
                               device="cpu", corpus_dtype="bfloat16")
    assert str(svc.corpus_emb.dtype) == "torch.bfloat16"
    out = svc.search(_data().text[:2], _data().text_mask[:2], k=3)
    assert np.asarray(out["indices"]).shape == (2, 3)

    with pytest.raises(SystemExit, match="--random-params"):
        tserve.build_service(cfg, None, "video", device="cpu")
    # --artifact and --shard-corpus are ported (tests/test_torch_aot.py,
    # tests/test_torch_sharded_retrieval.py): an artifact takes no model
    # flags, and one process cannot shard the index
    with pytest.raises(SystemExit, match="self-contained; drop --random-params"):
        tserve.main(["--artifact", "a.npz", "--random-params"])
    with pytest.raises(SystemExit, match="needs more than one rank"):
        tserve.main(["--shard-corpus", "--random-params", "--device", "cpu",
                     *OVERRIDES])


def test_precomputed_corpus_index(tmp_path):
    """``--corpus-emb``: the index, ids and step come from the npz; a
    step that disagrees with the query tower is flagged, and refused
    under ``strict_index``."""
    cfg = _port_cfg()
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((10, 16)).astype(np.float32)
    ids = [f"clip{i}" for i in range(10)]
    path = tmp_path / "emb.npz"
    np.savez(path, video=emb, ids=np.asarray(ids), step=np.int64(0))
    svc = tserve.build_service(cfg, None, "video", random_params=True,
                               device="cpu", corpus_emb_path=str(path))
    np.testing.assert_array_equal(svc.corpus_emb.numpy(), emb)
    assert svc.corpus_rows == 10 and svc.index_step == 0
    assert not svc.index_stale
    out = svc.search(_data().text[:1], _data().text_mask[:1], k=3)
    assert out["ids"] == [[ids[i] for i in out["indices"][0]]]

    np.savez(path, video=emb, step=np.int64(7))
    svc = tserve.build_service(cfg, None, "video", random_params=True,
                               device="cpu", corpus_emb_path=str(path))
    assert svc.index_stale and svc.ids is None
    with pytest.raises(SystemExit, match="strict-index"):
        tserve.build_service(cfg, None, "video", random_params=True,
                             device="cpu", corpus_emb_path=str(path),
                             strict_index=True)
    np.savez(path, video=emb[:, :8])
    with pytest.raises(SystemExit, match="expected"):
        tserve.build_service(cfg, None, "video", random_params=True,
                             device="cpu", corpus_emb_path=str(path))
