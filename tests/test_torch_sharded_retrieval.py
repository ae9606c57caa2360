"""The port's row-sharded index (``evaluation.shard_corpus``,
``sharded_retrieve_topk``, ``retrieval_metrics(group=)``), the sharded
service (``serve --shard-corpus``) and the sharded eval CLI, against the
JAX package's ``sharded_retrieve_topk`` and ``retrieval_metrics(mesh=)``
on a mesh of as many of the conftest's CPU devices, and against the port
in one process.

Ranks run as ``torch.multiprocessing`` (spawn) processes joined by a gloo
group on the CPU, at world sizes 2 and 3; each world is spawned once per
run (under a file lock, its rendezvous a file in its own directory) and
runs every case, and the tests read its results.  JAX is imported inside
the tests only, so the ranks never load it.

Limits, the JAX package's own (``tests/test_retrieval.py``,
``tests/test_serve.py``): fp32 scores within 2e-6 of the dense ones and
indices a valid top-k under a float64 reference (products of other
shapes may swap exact ties); the int8 index's indices exactly, exact ties
included (integer products are exact, so its ties are real ties), its
scores bit for bit against the port's dense int8 search and within 3 ulp
of JAX's; the metrics within rtol 1e-6.  Also here: ``retrieve_topk``'s order on exact
ties (fp32 duplicate rows and the int8 index, several query chunks)
against JAX, and a one-rank group bit for bit against the dense search.
"""

import fcntl
import json
import os
import pickle
import signal
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from crossclr_tpu_torch import evaluation as tev
from crossclr_tpu_torch.utils import config as tconfig
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

JOIN_SECONDS = 240
ATOL = 2e-6
# name: (corpus rows, k, seed, planted duplicates)
TOPK_CASES = {
    "divisible": (60, 5, 0, False),
    "ragged": (53, 10, 1, False),
    "k_exceeds_rows_per_shard": (64, 40, 2, False),
    "exact_ties": (48, 12, 3, True),
    "k_clamps_to_corpus": (24, 24, 4, False),
}
INT8_CASES = {"even": (64, 5, 5, False), "ragged": (53, 10, 6, False),
              "ties": (48, 20, 7, True)}
# name: (rows, seed, query_chunk)
METRIC_CASES = {"even": (64, 0, 16), "ragged_rows_and_chunk": (53, 1, 8)}
SERVE_OVERRIDES = [
    "video_tower.input_dim=24", "video_tower.embed_dim=16",
    "video_tower.hidden_dim=32", "video_tower.dtype=float32",
    "text_tower.input_dim=16", "text_tower.embed_dim=16",
    "text_tower.hidden_dim=32", "text_tower.dtype=float32",
    "data.num_pairs=48", "data.batch_size=16", "data.video_dim=24",
    "data.text_dim=16",
]
SERVE_KS = (1, 3, 10, 48)


def _corpus(nc: int, seed: int, ties: bool, nq: int = 7, d: int = 12):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    c = rng.standard_normal((nc, d)).astype(np.float32)
    if ties:  # exact duplicates within and across shard boundaries
        c[nc // 2:] = c[: nc - nc // 2]
    return q, c


def _pair(n: int, seed: int, d: int = 10):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    t = (0.6 * v + 0.8 * rng.standard_normal((n, d))).astype(np.float32)
    return v, t


def _serve_cfg():
    return tconfig.apply_overrides(tconfig.ExperimentConfig(), SERVE_OVERRIDES)


def _queries(n: int = 5):
    from crossclr_tpu_torch.data import SyntheticPairs

    return SyntheticPairs(num_pairs=48, video_dim=24, text_dim=16, seed=0).text[:n]


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _rank_index(rank: int, world: int) -> dict:
    out = {}
    for name, (nc, k, seed, ties) in TOPK_CASES.items():
        q, c = _corpus(nc, seed, ties)
        placed = tev.shard_corpus(c)
        assert placed.shape == (-(-nc // world), c.shape[1])
        s, i = tev.sharded_retrieve_topk(torch.from_numpy(q), placed, k=k, n_real=nc)
        out[f"topk/{name}"] = (s.numpy(), i.numpy())
    for name, (nc, k, seed, ties) in INT8_CASES.items():
        q, c = _corpus(nc, seed, ties, d=16)
        placed = tev.shard_corpus(tev.quantize_corpus(c))
        assert placed.values.dtype == torch.int8
        assert placed.scales.shape[0] == placed.values.shape[0] == -(-nc // world)
        # padded rows: value 0 and scale 0
        lo, hi = tev.row_block(nc, rank, world)
        assert not placed.values[hi - lo:].any() and not placed.scales[hi - lo:].any()
        s, i = tev.sharded_retrieve_topk(torch.from_numpy(q), placed, k=k, n_real=nc)
        out[f"int8/{name}"] = (s.numpy(), i.numpy())
    for name, (n, seed, chunk) in METRIC_CASES.items():
        v, t = _pair(n, seed)
        rows = slice(*tev.row_block(n, rank, world))
        out[f"metrics/{name}"] = tev.retrieval_metrics(
            torch.from_numpy(v[rows]), torch.from_numpy(t[rows]),
            query_chunk=chunk, group=dist.group.WORLD)
    if world == 2:  # a one-rank group is the dense search, bit for bit
        solo = dist.new_group([0])
        if rank == 0:
            q, c = _corpus(53, 8, False)
            for index in (torch.from_numpy(c), tev.quantize_corpus(c)):
                got = tev.sharded_retrieve_topk(torch.from_numpy(q),
                                                tev.shard_corpus(index, solo),
                                                k=9, group=solo)
                want = tev.retrieve_topk(torch.from_numpy(q), index, k=9)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
            out["solo"] = True
    return out


def _fail_twice(svc, rank: int, world: int) -> None:
    """The service's first search fails in the last rank's encode, its
    second in rank 0's, as a batch out of device memory would."""
    encode, calls = svc.trainer.encode_modality, []

    def failing(*args, **kw):
        calls.append(None)
        if (len(calls), rank) in ((1, world - 1), (2, 0)):
            raise RuntimeError(f"injected failure on rank {rank}")
        return encode(*args, **kw)

    svc.trainer.encode_modality = failing


def _rank_serve(rank: int, world: int, shared: Path) -> dict:
    """The sharded service through build_service (fp32 and int8, encoded
    and precomputed index), then through main() over HTTP with /reload
    and a SIGTERM on rank 0."""
    from crossclr_tpu_torch import serve as tserve

    out = {}
    cfg = _serve_cfg()
    q = _queries()
    for name, kw in (("fp32", {}), ("int8", {"corpus_dtype": "int8"}),
                     ("precomputed", {"corpus_emb_path": str(shared / "emb.npz")})):
        svc = tserve.build_service(cfg, None, "video", random_params=True,
                                   device="cpu", shard_corpus=True, **kw)
        assert svc.corpus_rows == 48
        if name == "fp32":
            _fail_twice(svc, rank, world)
        if rank:
            svc.follow()
            continue
        if name == "fp32":  # two searches that fail, then the good ones
            failed = []
            for _ in range(2):
                with pytest.raises(RuntimeError) as err:
                    svc.search(q, k=3)
                failed.append(str(err.value))
            out["serve/failed"] = failed
        out[f"serve/{name}"] = {k: svc.search(q, k=k) for k in SERVE_KS}
        out[f"serve/{name}/k0"] = svc.search(q, k=0)
        svc.close()

    # main(): rank 0 listens; a helper thread searches, reloads and stops it
    args = ["--shard-corpus", "--device", "cpu", "--port", "0",
            "--checkpoint-dir", str(shared / "ckpt"), *SERVE_OVERRIDES]
    if rank:
        assert tserve.main(args) == 0
        return out
    ready, address = threading.Event(), []

    class Server(tserve.ServiceHTTPServer):
        def __init__(self, addr, service):
            super().__init__(addr, service)
            address.append(self.server_address)
            ready.set()

    tserve.ServiceHTTPServer = Server
    replies = {}

    def client():
        ready.wait(60)
        url = f"http://127.0.0.1:{address[0][1]}"

        def post(path, payload):
            req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                         method="POST")
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        try:
            replies["before"] = post("/search", {"features": q.tolist(), "k": 5})
            replies["reload"] = post("/reload", {"step": 1})
            replies["after"] = post("/search", {"features": q.tolist(), "k": 5})
            replies["missing"] = post("/reload", {"step": 7})
            with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
                replies["health"] = json.loads(resp.read())
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    thread = threading.Thread(target=client)
    thread.start()
    assert tserve.main(args) == 0
    thread.join()
    out["http"] = replies
    return out


def _rank_eval(rank: int, shared: Path) -> dict:
    from crossclr_tpu_torch import eval as teval

    teval.main(["--random-params", "--device", "cpu", "--split", "all",
                "--topk", "5", "--topk-output", str(shared / "topk.npz"),
                "--embeddings-output", str(shared / "eval_emb.npz"),
                "--output", str(shared / "metrics.json"), *SERVE_OVERRIDES])
    return {}


def _rank_main(rank, world, init_file, shared):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        shared = Path(shared)
        results = _rank_index(rank, world)
        results.update(_rank_serve(rank, world, shared))
        results.update(_rank_eval(rank, shared))
        with open(shared / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(results, fh)
    finally:
        dist.destroy_process_group()


def _prepare(shared: Path) -> None:
    """What the ranks read: a precomputed index and two checkpoints."""
    from crossclr_tpu_torch.training import CheckpointManager, Trainer

    cfg = _serve_cfg()
    rng = np.random.default_rng(11)
    np.savez(shared / "emb.npz", video=rng.standard_normal((48, 16)).astype(np.float32),
             step=np.int64(0))
    trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, "cpu")
    state = trainer.init_state()
    mngr = CheckpointManager(shared / "ckpt")
    for step in (1, 2):
        state.step = step
        mngr.save(step, state)
        with torch.no_grad():  # step 2's towers differ from step 1's
            for p in state.model.parameters():
                p.mul_(-0.5)


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


def _shared_dir(request, tmp_path_factory) -> Path:
    """A directory every test worker of this run sees."""
    base = tmp_path_factory.getbasetemp()
    worker = getattr(request.config, "workerinput", None)
    if worker is not None:
        return base.parent / f"torch_shard_{worker['testrunuid']}"
    return base / "torch_shard"


def _world(request, tmp_path_factory, world: int):
    """``(P, the ranks' results, their directory)``: spawned once per run
    for each world size, whichever test worker comes first."""
    shared = _shared_dir(request, tmp_path_factory) / f"world{world}"
    shared.mkdir(parents=True, exist_ok=True)
    with open(shared.parent / f"world{world}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = shared / "ranks.pkl"
        if not done.exists():
            _prepare(shared)
            with open(done, "wb") as fh:
                pickle.dump(_spawn(world, shared), fh)
        with open(done, "rb") as fh:
            ranks = pickle.load(fh)
    return world, ranks, shared


@pytest.fixture(scope="module", params=[2, 3])
def world(request, tmp_path_factory):
    return _world(request, tmp_path_factory, request.param)


@pytest.fixture(scope="module")
def two_ranks(request, tmp_path_factory):
    return _world(request, tmp_path_factory, 2)


def _mesh(world: int):
    import jax

    from crossclr_tpu.parallel import make_mesh

    return make_mesh(n_data=world, devices=jax.devices()[:world])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _assert_topk_equivalent(q, c, k, got_s, got_i, want_s, want_i):
    """``tests/test_retrieval.py``'s check: scores within fp32 noise of the
    reference's, the indices a duplicate-free top-k under a float64
    reference, and the scores these rows' similarities."""
    np.testing.assert_allclose(got_s, want_s, atol=ATOL, rtol=0)
    qn = q.astype(np.float64) / np.linalg.norm(q, axis=1, keepdims=True)
    cn = c.astype(np.float64) / np.linalg.norm(c, axis=1, keepdims=True)
    sim = qn @ cn.T
    for r in range(got_i.shape[0]):
        assert len(set(got_i[r].tolist())) == k, "duplicate index in top-k"
        sel = np.sort(sim[r, got_i[r]])[::-1]
        np.testing.assert_allclose(sel, np.sort(sim[r, want_i[r]])[::-1], atol=ATOL)
        np.testing.assert_allclose(np.sort(got_s[r])[::-1], sel, atol=ATOL)


@pytest.mark.parametrize("name", list(TOPK_CASES))
def test_sharded_topk_matches_jax(world, name):
    import jax.numpy as jnp

    from crossclr_tpu.evaluation import retrieve_topk, shard_corpus, sharded_retrieve_topk

    p, ranks, _ = world
    nc, k, seed, ties = TOPK_CASES[name]
    q, c = _corpus(nc, seed, ties)
    got_s, got_i = ranks[0][f"topk/{name}"]
    for other in ranks[1:]:  # every rank returns the merged result
        np.testing.assert_array_equal(other[f"topk/{name}"][1], got_i)
    k_eff = min(k, nc)
    assert got_i.shape == (len(q), k_eff) and int(got_i.max()) < nc
    mesh = _mesh(p)
    js, ji = sharded_retrieve_topk(jnp.asarray(q), shard_corpus(c, mesh), k=k,
                                   mesh=mesh, n_real=nc)
    ds, di = retrieve_topk(jnp.asarray(q), jnp.asarray(c), k=k)
    for want_s, want_i in ((js, ji), (ds, di)):
        _assert_topk_equivalent(q, c, k_eff, got_s, got_i, np.asarray(want_s),
                                np.asarray(want_i))
    if not ties:  # well-separated scores: the very indices
        np.testing.assert_array_equal(got_i, np.asarray(ji))


@pytest.mark.parametrize("name", list(INT8_CASES))
def test_sharded_int8_index_matches_jax(world, name):
    """Integer products are exact, so the sharded int8 search equals the
    port's dense int8 search bit for bit, and gives the JAX package's
    dense and sharded int8 searches' indices, the order of exact ties
    (lowest global index first) included; its scores lie within 3 ulp of
    JAX's (a query's scale may differ by one ulp,
    ``tests/test_torch_int8_index.py``)."""
    import jax.numpy as jnp

    from crossclr_tpu.evaluation import quantize_corpus, retrieve_topk, sharded_retrieve_topk

    p, ranks, _ = world
    nc, k, seed, ties = INT8_CASES[name]
    q, c = _corpus(nc, seed, ties, d=16)
    got_s, got_i = ranks[0][f"int8/{name}"]
    dense_s, dense_i = tev.retrieve_topk(torch.from_numpy(q), tev.quantize_corpus(c), k=k)
    np.testing.assert_array_equal(got_i, dense_i.numpy())
    np.testing.assert_array_equal(got_s, dense_s.numpy())
    qc = quantize_corpus(c)
    for want_s, want_i in (retrieve_topk(jnp.asarray(q), qc, k=k),
                           sharded_retrieve_topk(jnp.asarray(q), qc, k=k, mesh=_mesh(p))):
        np.testing.assert_array_equal(got_i, np.asarray(want_i))
        np.testing.assert_array_max_ulp(got_s, np.asarray(want_s), maxulp=3)


@pytest.mark.parametrize("name", list(METRIC_CASES))
def test_sharded_metrics_match_jax(world, name):
    import jax.numpy as jnp

    from crossclr_tpu.evaluation import retrieval_metrics

    p, ranks, _ = world
    n, seed, chunk = METRIC_CASES[name]
    v, t = _pair(n, seed)
    got = ranks[0][f"metrics/{name}"]
    assert all(r[f"metrics/{name}"] == got for r in ranks[1:])
    want = retrieval_metrics(jnp.asarray(v), jnp.asarray(t), query_chunk=chunk,
                             mesh=_mesh(p))
    dense = tev.retrieval_metrics(torch.from_numpy(v), torch.from_numpy(t))
    assert set(got) == set(want) == set(dense)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
        if "R@" in key:  # ranks are exact partial counts
            assert got[key] == dense[key], key


def test_one_rank_group_is_the_dense_search(two_ranks):
    """A group of rank 0 alone, made inside the two-rank world: its
    sharded search equals ``retrieve_topk`` bit for bit (fp32 and int8;
    checked in the rank)."""
    assert two_ranks[1][0]["solo"]


# ---------------------------------------------------------------------------
# the sharded service and the sharded eval CLI against one process
# ---------------------------------------------------------------------------


def _assert_same_search(got: dict, want: dict):
    assert got["indices"] == want["indices"]
    np.testing.assert_allclose(np.asarray(got["scores"]), np.asarray(want["scores"]),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["fp32", "int8", "precomputed"])
def test_shard_corpus_service_matches_single_device(world, name):
    """``tests/test_serve.py``'s sharded cases: 48 rows over P ranks, the
    fp32 and int8 indexes and a precomputed one, against the service in
    one process; padded rows never surface, k=0 keeps its contract."""
    from crossclr_tpu_torch import serve as tserve

    _, ranks, shared = world
    kw = {"fp32": {}, "int8": {"corpus_dtype": "int8"},
          "precomputed": {"corpus_emb_path": str(shared / "emb.npz")}}[name]
    plain = tserve.build_service(_serve_cfg(), None, "video", random_params=True,
                                 device="cpu", **kw)
    q = _queries()
    for k, got in ranks[0][f"serve/{name}"].items():
        _assert_same_search(got, plain.search(q, k=k))
        assert max(max(row) for row in got["indices"]) < 48
    assert ranks[0][f"serve/{name}/k0"] == plain.search(q, k=0)


def test_shard_corpus_service_survives_failed_searches(world):
    """A search that fails on a following rank, then one that fails on
    rank 0, raise on rank 0 and leave every rank serving: the searches
    after them (``test_shard_corpus_service_matches_single_device``'s
    fp32 answers) still equal one process's."""
    _, ranks, _ = world
    assert ranks[0]["serve/failed"] == ["search failed on another rank",
                                        "injected failure on rank 0"]
    assert "serve/fp32" in ranks[0]


def test_shard_corpus_cli_reloads_and_stops_on_sigterm(world):
    """``serve --shard-corpus`` over HTTP: searches equal one process's,
    /reload restores step 1 on every rank (a missing step is refused, the
    service keeps its checkpoint), and SIGTERM on rank 0 stopped every
    rank (the spawn joined)."""
    from crossclr_tpu_torch import serve as tserve

    _, ranks, shared = world
    http = ranks[0]["http"]
    plain = tserve.build_service(_serve_cfg(), str(shared / "ckpt"), "video",
                                 device="cpu")
    q = _queries()
    assert http["before"][0] == 200
    _assert_same_search(http["before"][1], plain.search(q, k=5))
    assert http["reload"] == (200, {"status": "ok", "step": 1, "index_step": 1})
    plain.reload(1)
    assert http["after"][0] == 200
    _assert_same_search(http["after"][1], plain.search(q, k=5))
    assert http["after"][1]["indices"] != http["before"][1]["indices"]
    assert http["missing"][0] == 400
    assert http["health"]["step"] == 1 and http["health"]["corpus_rows"] == 48


def test_sharded_eval_cli_matches_one_process(world, tmp_path, capsys):
    from crossclr_tpu_torch import eval as teval

    _, _, shared = world
    assert teval.main(["--random-params", "--device", "cpu", "--split", "all",
                       "--topk", "5", "--topk-output", str(tmp_path / "topk.npz"),
                       "--embeddings-output", str(tmp_path / "emb.npz"),
                       *SERVE_OVERRIDES]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = json.loads((shared / "metrics.json").read_text())
    assert got["rows"] == want["rows"] == 48
    for key, value in want.items():
        if "R@" in key or not isinstance(value, float):
            assert got[key] == value, key
        else:
            np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-6, err_msg=key)
    with np.load(shared / "eval_emb.npz") as a, np.load(tmp_path / "emb.npz") as b:
        for side in ("video", "text"):
            np.testing.assert_allclose(a[side], b[side], atol=1e-5, rtol=0)
    with np.load(shared / "topk.npz") as a, np.load(tmp_path / "topk.npz") as b:
        np.testing.assert_array_equal(a["indices"], b["indices"])
        np.testing.assert_allclose(a["scores"], b["scores"], atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the dense search's order on exact ties
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index", ["fp32", "int8"])
def test_retrieve_topk_breaks_exact_ties_as_jax(index):
    """Exact ties resolve to the lowest corpus index, as ``lax.top_k``
    does, at every query chunk: half the corpus duplicates the other
    half, so every query's top-k is made of tied pairs."""
    import jax.numpy as jnp

    from crossclr_tpu.evaluation import quantize_corpus, retrieve_topk

    rng = np.random.default_rng(12)
    q = rng.standard_normal((5, 8)).astype(np.float32)
    c = rng.standard_normal((64, 8)).astype(np.float32)
    c[32:] = c[:32]
    jc = jnp.asarray(c) if index == "fp32" else quantize_corpus(c)
    tc = torch.from_numpy(c) if index == "fp32" else tev.quantize_corpus(c)
    for chunk in (1, 2, 5):
        want_s, want_i = retrieve_topk(jnp.asarray(q), jc, k=12, query_chunk=chunk)
        got_s, got_i = tev.retrieve_topk(torch.from_numpy(q), tc, k=12,
                                         query_chunk=chunk)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-6, rtol=0)
        # both members of a tied pair: the lower index first
        assert (got_i[:, 0::2] < 32).all() and (got_i[:, 1::2] == got_i[:, 0::2] + 32).all()


def test_topk_order_key_decodes_scores_exactly():
    """``evaluation.topk`` gives back the scores bit for bit in
    ``lax.top_k``'s order, negative ones, −inf and ties of +0 and −0
    included."""
    s = torch.tensor([[0.5, -0.0, -1.5, float("-inf"), 0.0, 0.5, -1e-30, 3e38]])
    got_s, got_i = tev.topk(s, 8)
    assert got_i.tolist() == [[7, 0, 5, 1, 4, 6, 2, 3]]
    assert torch.equal(got_s.view(torch.int32), s[0, got_i[0]][None].view(torch.int32))


@pytest.mark.parametrize("k", [1, 7, 10, 33])
def test_topk_ties_across_the_kth_score_match_jax(k):
    """Scores drawn from a few values, so tie groups straddle the k-th
    score and are larger than k: ``evaluation.topk`` picks and orders as
    ``lax.top_k`` does, with and without an index."""
    import jax

    rng = np.random.default_rng(14 + k)
    s = rng.integers(-3, 4, size=(6, 300)).astype(np.float32) / 4
    s[0] = 0.25  # 300 equally close rows: one tie group
    want_s, want_i = jax.lax.top_k(s, k)
    got_s, got_i = tev.topk(torch.from_numpy(s), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    index = 1000 + 3 * torch.arange(300)
    np.testing.assert_array_equal(tev.topk(torch.from_numpy(s), k, index)[1].numpy(),
                                  1000 + 3 * np.asarray(want_i))


def test_encode_corpus_matches_jax():
    """``encode_corpus`` collects one modality of every batch in order, as
    the JAX package's does, and refuses an unknown side or no batches."""
    import jax.numpy as jnp

    from crossclr_tpu.evaluation import encode_corpus as jencode

    rng = np.random.default_rng(13)
    batches = [{"video": rng.standard_normal((n, 4)).astype(np.float32),
                "text": rng.standard_normal((n, 3)).astype(np.float32)}
               for n in (5, 2, 7)]

    def port(b):
        return torch.from_numpy(b["video"]) * 2, torch.from_numpy(b["text"]) + 1

    def jax_(b):
        return jnp.asarray(b["video"]) * 2, jnp.asarray(b["text"]) + 1

    for side in ("video", "text"):
        np.testing.assert_array_equal(tev.encode_corpus(port, batches, side=side).numpy(),
                                      np.asarray(jencode(jax_, batches, side=side)))
    with pytest.raises(ValueError, match="side"):
        tev.encode_corpus(port, batches, side="audio")
    with pytest.raises(ValueError, match="no batches"):
        tev.encode_corpus(port, [])
