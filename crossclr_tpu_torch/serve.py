"""Retrieval serving: ``python -m crossclr_tpu_torch.serve``.

Counterpart of ``crossclr_tpu/serve.py``: restore a checkpoint that
``crossclr_tpu_torch.train`` (or the import CLI,
``crossclr_tpu_torch.import_torch_checkpoint``) wrote, encode one modality
of the dataset as the corpus (held on the device), and answer
nearest-neighbour search over HTTP with the same surface:

  GET  /healthz   → {"status": "ok", "corpus_rows": N, "step": S, ...}
  GET  /metrics   → request/error counts + recent /search latency
                    percentiles (p50/p95/p99 over a 512-request window)
  POST /search    → body {"features": [[...], ...], "k": 10}: raw
                    QUERY-modality features ([B, D] pooled or [B, S, D]
                    sequences, optional "mask": [B, S]); returns
                    {"indices", "scores", "ids"?}
  POST /reload    → body {"step": N?}: restore the latest (or the given)
                    checkpoint of the serving directory and re-derive the
                    corpus index, without restarting the process

``--ema`` serves the EMA parameters; ``--corpus-emb`` serves an index
that either package's ``eval --embeddings-output`` wrote (checked against
the query tower's step and EMA/live flavour; ``--strict-index`` refuses a
mismatch); ``--corpus-dtype`` stores the index in bfloat16 or int8
(``evaluation.QuantizedCorpus``, scored int8 x int8 -> int32);
``--batch-window-ms`` coalesces concurrent searches into one dispatch.
The corpus encode reads fp32, bf16 and int8 feature stores
(``data.features_dtype``) through the native gather.

``--artifact`` serves an exported search artifact (``aot.py``, written by
``python -m crossclr_tpu_torch.export_serving``) over the same surface
with no config, model code or checkpoint; /reload is refused.

``--shard-corpus`` row-shards the index over a launcher's ranks
(``torchrun``; two at least): rank r encodes and holds rows ``[r·per,
(r+1)·per)`` (``evaluation.row_block``), rank 0 alone listens, and every
search is one dispatch of all ranks: rank 0 broadcasts a header (the
operation, the query shape, whether a mask comes, k) and the queries,
each rank encodes them and keeps its top-k, every rank votes that it
did, and the O(k) winners are merged (``evaluation.local_candidates``,
``merge_candidates``); a search that fails on any rank fails on all of
them, and each keeps serving.  /reload restores and re-encodes on every
rank; SIGTERM on rank 0 stops every rank.

Example:
  python -m crossclr_tpu_torch.serve --config configs/lsmdc_transformer.json \\
      --checkpoint-dir /tmp/lsmdc --corpus video --port 8777 \\
      video_tower.attention=flash text_tower.attention=flash
  torchrun --nproc_per_node=2 -m crossclr_tpu_torch.serve --shard-corpus \\
      --config configs/lsmdc_transformer.json --checkpoint-dir /tmp/lsmdc
  python -m crossclr_tpu_torch.serve --artifact search.npz --port 8777
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch
import torch.distributed as dist

_CORPUS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "int8": torch.int8}


class _ServiceStats:
    """Request counts and a bounded window of recent /search latencies,
    under their own lock so a metrics read never waits on the device."""

    _dispatch_count: int = 0

    def __init__(self):
        self._stats_lock = threading.Lock()
        self._search_count = 0
        self._error_count = 0
        self._latencies = collections.deque(maxlen=512)

    def record_search(self, seconds: float | None, ok: bool) -> None:
        with self._stats_lock:
            self._search_count += 1
            if not ok:
                self._error_count += 1
            if seconds is not None:
                self._latencies.append(seconds)

    def stats(self) -> dict:
        with self._stats_lock:
            lats = sorted(self._latencies)
            out = {
                "search_requests": self._search_count,
                "search_errors": self._error_count,
                # under micro-batching (--batch-window-ms) this trails
                # search_requests by the coalescing factor
                "search_dispatches": self._dispatch_count,
            }
        if lats:
            pick = lambda q: lats[  # noqa: E731
                min(len(lats) - 1, int(q * len(lats)))
            ]
            out["latency_ms"] = {
                "p50": round(pick(0.50) * 1e3, 2),
                "p95": round(pick(0.95) * 1e3, 2),
                "p99": round(pick(0.99) * 1e3, 2),
                "window": len(lats),
            }
        return out


# the operations of a sharded dispatch, the first word of its header
_NOOP, _SEARCH, _RELOAD, _STOP = range(4)
# an idle sharded service's rank 0 sends a no-op this often, so the other
# ranks' wait for the next header never reaches the group's time limit
KEEPALIVE_SECONDS = 60.0


class RetrievalService(_ServiceStats):
    """Towers + encoded corpus on the device + the query → top-k path.

    ``corpus_side``: which modality is indexed ("video" or "text");
    queries are the OTHER modality's raw features, encoded by its tower.
    Device work (searches and reloads) is serialized with a lock.

    ``group``: the index is row-sharded over this ``torch.distributed``
    group; ``corpus_emb`` is then this rank's :func:`evaluation.row_block`
    of the ``corpus_rows`` rows.  Rank 0 answers the requests and every
    other rank runs :meth:`follow`.
    """

    def __init__(self, trainer, state, corpus_emb, corpus_side: str,
                 ids: list[str] | None = None,
                 index_step: int | None = None,
                 corpus_dtype: torch.dtype = torch.float32,
                 group=None, corpus_rows: int | None = None):
        super().__init__()
        self.trainer = trainer
        self.state = state
        self.group = group
        # the real row count (before any shard padding): it clamps k and is
        # what /healthz reports
        self.corpus_rows = int(corpus_emb.shape[0] if corpus_rows is None
                               else corpus_rows)
        # bfloat16 storage halves the index (scoring still runs in fp32);
        # int8 quarters it (see _place_corpus)
        self.corpus_dtype = corpus_dtype
        self.corpus_emb = self._place_corpus(corpus_emb)
        self.corpus_side = corpus_side
        self.query_side = "text" if corpus_side == "video" else "video"
        self.query_cfg = (
            trainer.text_cfg if corpus_side == "video" else trainer.video_cfg
        )
        self.ids = ids
        self.step = int(state.step)
        # the checkpoint step the index was ENCODED at (None: unknown, a
        # --corpus-emb dump without one); when it differs from self.step
        # the index and the query tower disagree, which /healthz and every
        # /reload reply say
        self.index_step = index_step
        self._lock = threading.Lock()
        self._last_dispatch = time.monotonic()

    # set by build_service when a checkpoint directory was restored:
    # (step | None) -> (restored state, corpus embeddings (this rank's rows
    # when sharded) or None to keep the index, index_step)
    _reloader = None
    # set by build_service: a precomputed index encoded with the other
    # tower flavour (EMA vs live) than the one answering queries, which
    # the step comparison cannot see
    index_tower_mismatch: bool = False
    # set by build_service (single-query convenience reshaping)
    _query_ndim: int = 2
    _batcher = None
    _keepalive = None

    def _place_corpus(self, corpus_emb):
        """The index on the trainer's device in its storage dtype; int8
        rows are L2-normalized and quantized on the host
        (``evaluation.quantize_corpus``).  A sharded index is this rank's
        rows zero-padded to ``ceil(corpus_rows / P)`` (a padded int8 row
        has value 0 and scale 0)."""
        from .evaluation import pad_block, quantize_corpus
        from .training.trainer import to_tensor

        dev = self.trainer.device
        if self.corpus_dtype == torch.int8:
            index = quantize_corpus(corpus_emb)
        else:
            index = to_tensor(corpus_emb, dev if self.group is None else "cpu",
                              self.corpus_dtype)
        if self.group is not None:
            index = pad_block(index, self.corpus_rows, self.group)
        return index.to(dev)

    def reload(self, step: int | None = None) -> int:
        """Swap in the latest (or the given) checkpoint without restarting:
        restore it, then re-encode the corpus (or keep a precomputed
        ``--corpus-emb`` index, whose step then trails), all under the
        device lock, so a search never sees half a swap.  Sharded, every
        rank restores and re-encodes its rows, and the swap happens on
        every rank or on none.  Returns the restored step."""
        if self._reloader is None:
            raise RuntimeError(
                "service has no checkpoint directory to reload from "
                "(started with --random-params?)"
            )
        with self._lock:
            if self.group is not None:
                self._send(_RELOAD, arg=-1 if step is None else step)
            self._reload_here(step)
        if self.index_stale:
            print(
                f"warning: /reload restored step {self.step} but the "
                f"precomputed corpus index is from step {self.index_step} "
                "— re-run `eval --embeddings-output` (or serve without "
                "--corpus-emb) to refresh the index",
                file=sys.stderr,
            )
        return self.step

    def _reload_here(self, step: int | None) -> None:
        """This rank's part of :meth:`reload`, under the lock."""
        try:
            new = self._reloader(step)
            err = None
        except Exception as e:  # noqa: BLE001 — every rank must vote
            new, err = None, e
        if self.group is not None:
            failed = torch.tensor([int(err is not None)])
            dist.all_reduce(failed, group=self._host_group())
            if err is None and int(failed):
                err = RuntimeError("reload failed on another rank; the "
                                   "service keeps its checkpoint")
        if err is not None:
            raise err
        new_state, corpus, self.index_step = new
        self.state = new_state
        if corpus is not None:
            self.corpus_emb = self._place_corpus(corpus)
        self.step = int(new_state.step)

    @property
    def index_stale(self) -> bool:
        """True when the corpus index provably predates the query tower."""
        return self.index_step is not None and self.index_step != self.step

    def _check_query(self, features: np.ndarray, mask) -> None:
        cfg = self.query_cfg
        want = 3 if cfg.kind == "transformer" else 2
        if features.ndim != want or features.shape[-1] != cfg.input_dim:
            raise ValueError(
                f"{self.query_side} queries must be "
                f"{'[B, S, D]' if want == 3 else '[B, D]'} with D = "
                f"{cfg.input_dim}, got {list(features.shape)}"
            )
        if want == 3 and features.shape[1] > cfg.max_seq_len:
            raise ValueError(
                f"sequence length {features.shape[1]} exceeds "
                f"max_seq_len {cfg.max_seq_len}"
            )
        if mask is not None and mask.shape != features.shape[:2]:
            raise ValueError(
                f"mask must be {list(features.shape[:2])}, got "
                f"{list(mask.shape)}"
            )

    def _dispatch(self, features, mask, k: int):
        """fp32 ``[b, ...]`` features → ``(scores [b, k], indices [b, k])``
        numpy; ``k`` pre-clamped to ``[1, corpus_rows]``.  Sharded, the
        other ranks are sent the dispatch first."""
        with self._lock:
            self._dispatch_count += 1
            if self.group is not None:
                self._send(_SEARCH, features, mask, k)
            return self._search_here(features, mask, k)

    def _search_here(self, features, mask, k: int):
        """This rank's part of a search, under the lock.  Sharded, every
        rank votes before the merge, so an error on any rank (an encode
        or a score block out of memory) raises on every rank and each of
        them keeps serving."""
        from .evaluation import local_candidates, merge_candidates, retrieve_topk

        try:
            q = self.trainer.encode_modality(
                self.state, self.query_side, features, mask
            )
            with torch.inference_mode():
                if self.group is None:
                    scores, idx = retrieve_topk(q, self.corpus_emb, k=k)
                    return scores.cpu().numpy(), idx.cpu().numpy()
                cands = local_candidates(q, self.corpus_emb, k=k, group=self.group,
                                         n_real=self.corpus_rows)
            err = None
        except Exception as e:  # noqa: BLE001 — every rank must vote
            if self.group is None:
                raise
            err = e
        failed = torch.tensor([int(err is not None)])
        dist.all_reduce(failed, group=self._host_group())
        if err is not None:
            raise err
        if int(failed):
            raise RuntimeError("search failed on another rank")
        with torch.inference_mode():
            scores, idx = merge_candidates(*cands, k=k, group=self.group)
        return scores.cpu().numpy(), idx.cpu().numpy()

    # -- the sharded dispatch ------------------------------------------------

    def _host_group(self):
        """The group's host-side twin: the group itself on gloo, else a
        gloo group of its ranks (made once, on every rank alike)."""
        if dist.get_backend(self.group) == "gloo":
            return self.group
        if getattr(self, "_gloo", None) is None:
            self._gloo = dist.new_group(backend="gloo")
        return self._gloo

    def _send(self, op: int, features=None, mask=None, arg: int = 0) -> None:
        """Rank 0: the header ``[op, b, S (0 for pooled), D, mask?, arg]``,
        then the queries and the mask, to every rank."""
        self._last_dispatch = time.monotonic()
        shape = () if features is None else features.shape
        b, d = (shape[0], shape[-1]) if shape else (0, 0)
        s = shape[1] if len(shape) == 3 else 0
        header = torch.tensor([op, b, s, d, int(mask is not None), arg])
        group = self._host_group()
        dist.broadcast(header, 0, group=group)
        if op == _SEARCH:
            dist.broadcast(torch.from_numpy(np.ascontiguousarray(features)), 0,
                           group=group)
            if mask is not None:
                dist.broadcast(torch.from_numpy(np.ascontiguousarray(mask)), 0,
                               group=group)

    def follow(self) -> None:
        """Every rank but 0: take part in each dispatch rank 0 sends until
        it sends the stop."""
        group = self._host_group()
        while True:
            header = torch.zeros(6, dtype=torch.int64)
            dist.broadcast(header, 0, group=group)
            op, b, s, d, has_mask, arg = (int(x) for x in header)
            if op == _STOP:
                return
            if op == _RELOAD:
                with self._lock:
                    try:
                        self._reload_here(None if arg < 0 else arg)
                    except Exception as e:  # noqa: BLE001 — rank 0 reports
                        print(f"reload failed: {e}", file=sys.stderr)
            elif op == _SEARCH:
                features = torch.empty((b, s, d) if s else (b, d))
                dist.broadcast(features, 0, group=group)
                mask = None
                if has_mask:
                    mask = torch.empty((b, s))
                    dist.broadcast(mask, 0, group=group)
                with self._lock:
                    try:
                        self._search_here(features.numpy(),
                                          None if mask is None else mask.numpy(), arg)
                    except Exception as e:  # noqa: BLE001 — rank 0 reports
                        print(f"search failed: {e}", file=sys.stderr)

    def start_keepalive(self, interval: float = KEEPALIVE_SECONDS) -> None:
        """Rank 0 of a sharded service: send a no-op whenever ``interval``
        seconds pass without a dispatch."""
        stop = threading.Event()

        def run():
            while not stop.wait(interval / 4):
                with self._lock:
                    if time.monotonic() - self._last_dispatch >= interval:
                        self._send(_NOOP)

        self._keepalive = (stop, threading.Thread(target=run, daemon=True))
        self._keepalive[1].start()

    def close(self) -> None:
        """Stop the batcher and the keepalive; sharded, send every other
        rank the stop."""
        if self._batcher is not None:
            self._batcher.close()
        if self._keepalive is not None:
            self._keepalive[0].set()
            self._keepalive[1].join()
        if self.group is not None and dist.get_rank(self.group) == 0:
            with self._lock:
                self._send(_STOP)

    def search(self, features, mask=None, k: int = 10):
        features = np.asarray(features, np.float32)
        if features.ndim == self._query_ndim - 1:
            features = features[None]  # single query convenience
        if mask is not None:
            mask = np.asarray(mask, np.float32)
            if mask.ndim == 1:
                mask = mask[None]
        self._check_query(features, mask)
        k = int(min(k, self.corpus_rows))
        if k <= 0:
            # the k=0 contract: empty per-query result lists, no dispatch
            empty = [[] for _ in range(features.shape[0])]
            out = {"indices": empty, "scores": [[] for _ in empty]}
            if self.ids is not None:
                out["ids"] = [[] for _ in empty]
            return out
        if self._batcher is not None:
            scores, idx = self._batcher.submit(features, mask, k)
        else:
            scores, idx = self._dispatch(features, mask, k)
        out = {"indices": idx.tolist(), "scores": scores.tolist()}
        if self.ids is not None:
            out["ids"] = [[self.ids[j] for j in row] for row in idx.tolist()]
        return out

    def enable_batching(self, window_ms: float = 2.0, max_batch: int = 64):
        """Coalesce concurrent searches into shared device dispatches
        (see :class:`_MicroBatcher`).  Call once, before serving."""
        self._batcher = _MicroBatcher(
            self._dispatch, window_ms=window_ms, max_batch=max_batch
        )


class ArtifactService(_ServiceStats):
    """Serve an exported :class:`~crossclr_tpu_torch.aot.SearchArtifact`
    over the same HTTP surface as the live service (/search, /healthz,
    /metrics) with no model code, config or checkpoint.  An artifact is
    immutable: /reload is refused; export again and restart to take new
    weights.  ``k`` is clamped to the k fixed at export (a smaller k takes
    the first columns, as the live service clamps to the corpus)."""

    is_artifact = True
    index_step = None
    index_stale = False
    index_tower_mismatch = False

    def __init__(self, artifact):
        super().__init__()
        self.artifact = artifact
        meta = artifact.meta
        self.corpus_rows = int(meta["corpus_rows"])
        self.corpus_side = meta["corpus_side"]
        self.query_side = meta["query_side"]
        self.step = int(meta["step"])
        self.k_max = int(meta["k"])
        self.corpus_dtype = _CORPUS_DTYPES[meta["index_dtype"]]
        self.ids = artifact.ids
        # one dispatch at a time, as the live service's device lock
        self._lock = threading.Lock()

    def search(self, features, mask=None, k: int = 10):
        features = np.asarray(features, np.float32)
        k = int(min(k, self.k_max))
        if k <= 0:  # the k=0 contract: empty per-query result lists
            n = (
                features.shape[0]
                if features.ndim > len(self.artifact.meta["query_shape"])
                else 1
            )
            out = {"indices": [[] for _ in range(n)],
                   "scores": [[] for _ in range(n)]}
            if self.ids is not None:
                out["ids"] = [[] for _ in range(n)]
            return out
        with self._lock:
            self._dispatch_count += 1
            return self.artifact.search(features, mask=mask, k=k)

    def reload(self, step: int | None = None) -> int:
        raise RuntimeError(
            "artifact services are immutable — re-export "
            "(python -m crossclr_tpu_torch.export_serving) and restart to "
            "pick up new weights"
        )

    def close(self) -> None:
        pass


class _MicroBatcher:
    """Coalesce concurrent search dispatches into one device call.

    Every dispatch pays the towers' launches and the device lock whatever
    its rows, so N concurrent clients would pay N dispatches back to back.
    Batching collects compatible requests (the same feature trailing
    shape and mask width) for a short window and runs ONE dispatch at the
    group's largest k, then hands each requester its rows and first k
    columns (top-k is sorted descending, so a k=5 answer is the first 5
    columns of a k=8 one).

    A solitary request pays at most ``window_ms`` extra latency: the
    window keeps collecting only while it is open and compatible requests
    may still arrive.
    """

    def __init__(self, dispatch, window_ms: float = 2.0,
                 max_batch: int = 64):
        self._dispatch = dispatch
        self._window = window_ms / 1e3
        self._max = max_batch
        self._cv = threading.Condition()
        self._queue: list[dict] = []
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, features, mask, k: int):
        item = {
            "f": features, "m": mask, "k": k,
            "done": threading.Event(), "out": None, "err": None,
        }
        with self._cv:
            if self._stop:
                raise RuntimeError("batcher is closed")
            self._queue.append(item)
            self._cv.notify()
        item["done"].wait()
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def close(self):
        """Stop taking requests, finish the queued ones, join the worker."""
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._worker.join(timeout=5)

    @staticmethod
    def _key(item):
        m = item["m"]
        return (item["f"].shape[1:], None if m is None else m.shape[1])

    def _take_group(self):
        """Pop one request, then collect compatible ones until the window
        closes, the group fills, or only incompatible requests remain."""
        first = self._queue.pop(0)
        group = [first]
        key = self._key(first)
        deadline = time.perf_counter() + self._window
        while len(group) < self._max:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            matched = False
            for i, it in enumerate(self._queue):
                if self._key(it) == key:
                    group.append(self._queue.pop(i))
                    matched = True
                    break
            if not matched:
                if self._queue:
                    break  # only incompatible requests: dispatch this group
                self._cv.wait(timeout=remaining)
                if self._stop:
                    break
        return group

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop and not self._queue:
                    return
                group = self._take_group()
            try:
                feats = np.concatenate([g["f"] for g in group])
                masks = None
                if group[0]["m"] is not None:
                    masks = np.concatenate([g["m"] for g in group])
                k_max = max(g["k"] for g in group)
                scores, idx = self._dispatch(feats, masks, k_max)
                off = 0
                for g in group:
                    b = g["f"].shape[0]
                    g["out"] = (
                        scores[off:off + b, :g["k"]],
                        idx[off:off + b, :g["k"]],
                    )
                    off += b
            except Exception as e:  # noqa: BLE001 — deliver to every waiter
                for g in group:
                    g["err"] = e
            finally:
                for g in group:
                    g["done"].set()


def _make_handler(service: RetrievalService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/metrics":
                return self._reply(
                    200,
                    {
                        **service.stats(),
                        "corpus_rows": service.corpus_rows,
                        "step": service.step,
                    },
                )
            if self.path != "/healthz":
                return self._reply(404, {"error": "unknown path"})
            health = {
                "status": "ok",
                "corpus_rows": service.corpus_rows,
                "corpus_side": service.corpus_side,
                "query_side": service.query_side,
                "step": service.step,
            }
            if getattr(service, "is_artifact", False):
                health["artifact"] = True
            if service.corpus_dtype != torch.float32:
                health["corpus_dtype"] = str(service.corpus_dtype).removeprefix(
                    "torch."
                )
            if service.index_step is not None:
                health["index_step"] = service.index_step
            if service.index_stale:
                health["index_stale"] = True
            if service.index_tower_mismatch:
                health["index_tower_mismatch"] = True
            self._reply(200, health)

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, TypeError) as e:
                if self.path == "/search":
                    # malformed JSON is still a failed search request
                    service.record_search(None, ok=False)
                return self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            # per-path client errors: a device or runtime fault on /search
            # answers 500; /reload's RuntimeError (no checkpoint directory)
            # and FileNotFoundError (no such step) are the request's fault
            if self.path == "/search":
                client_errors = (KeyError, ValueError, TypeError)
                run = lambda: service.search(  # noqa: E731
                    req["features"], req.get("mask"), req.get("k", 10)
                )
            elif self.path == "/reload":
                client_errors = (
                    KeyError, ValueError, TypeError, RuntimeError,
                    FileNotFoundError,
                )

                def run():
                    step = req.get("step")
                    out = {
                        "status": "ok",
                        "step": service.reload(
                            None if step is None else int(step)
                        ),
                    }
                    if service.index_step is not None:
                        out["index_step"] = service.index_step
                    if service.index_stale:
                        out["warning"] = (
                            "corpus index was encoded at step "
                            f"{service.index_step}; queries now use the "
                            f"step-{service.step} tower — refresh the "
                            "--corpus-emb dump"
                        )
                    return out
            else:
                return self._reply(404, {"error": "unknown path"})
            is_search = self.path == "/search"
            t0 = time.perf_counter()
            try:
                out = run()
            except client_errors as e:
                if is_search:
                    service.record_search(None, ok=False)
                return self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001 — device/runtime fault
                if is_search:
                    service.record_search(None, ok=False)
                return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            if is_search:
                service.record_search(time.perf_counter() - t0, ok=True)
            self._reply(200, out)

    return Handler


class ServiceHTTPServer(ThreadingHTTPServer):
    """The service's HTTP surface on ``address``, one thread a request.

    Its listen backlog is 128: at the default of 5 the kernel resets
    connections once more clients connect at the same moment (16
    clients posting single-row transformer queries saw resets), which is
    the traffic ``--batch-window-ms`` exists for.  Handler threads are not
    daemons, so ``server_close()`` joins the requests in flight."""

    request_queue_size = 128
    daemon_threads = False

    def __init__(self, address, service: RetrievalService):
        super().__init__(address, _make_handler(service))


def build_service(cfg, checkpoint_dir: str | None, corpus_side: str,
                  batch_size: int | None = None,
                  random_params: bool = False,
                  corpus_emb_path: str | None = None,
                  use_ema: bool = False,
                  corpus_dtype: str | None = None,
                  batch_window_ms: float | None = None,
                  strict_index: bool = False,
                  device: str | torch.device = "cuda",
                  state_dict=None,
                  shard_corpus: bool = False) -> RetrievalService:
    """Construct the service: dataset → trainer → restore → encode corpus.

    Weights come from the latest checkpoint of ``checkpoint_dir`` (a
    ZeRO-1 checkpoint of a multi-rank run loads here at one rank: it holds
    full moments, which serving drops), or are seeded random from
    ``train.seed`` (``random_params``), or come from ``state_dict`` (e.g.
    ``utils.params.state_dict_from_flax`` of a JAX trainer's params).
    ``use_ema``: queries, and the corpus unless ``corpus_emb_path`` is
    given, are encoded with the EMA parameters (``train.ema_decay`` must
    be set, so the checkpoint carries them).  ``corpus_emb_path``: an
    ``.npz`` written by either package's ``eval --embeddings-output``,
    served instead of encoding the corpus at startup.

    ``shard_corpus``: row-shard the index over the default process group
    (two ranks at least; every rank calls this): each rank encodes, or
    cuts from the ``.npz``, only its :func:`evaluation.row_block` of the
    corpus.  Results equal the one-device service's up to the products'
    rounding in the scores (``evaluation.sharded_retrieve_topk``).
    """
    from .data import RowSubset, dataset_from_config
    from .eval import _encode_split
    from .evaluation import row_block
    from .training import CheckpointManager, Trainer

    if corpus_dtype is None:
        corpus_dtype = "float32"
    if corpus_dtype not in _CORPUS_DTYPES:
        raise SystemExit(f"unknown corpus dtype {corpus_dtype!r}")
    group = None
    if shard_corpus:
        if not (dist.is_initialized() and dist.get_world_size() > 1):
            raise SystemExit(
                "--shard-corpus needs more than one rank: start the service "
                "under a launcher (torchrun --nproc_per_node=P)"
            )
        group = dist.group.WORLD

    # dataset_from_config also validates the ids manifest against the
    # store, so a stale manifest fails at startup, not mid-request
    dataset, ids = dataset_from_config(cfg.data)
    trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, device)
    batch_size = min(batch_size or cfg.data.batch_size, len(dataset))

    def restore(step: int | None):
        state = trainer.init_state()
        state = trainer.restored_state(
            CheckpointManager(checkpoint_dir).restore(state, step))
        state.opt_state = None  # serving needs the model and the EMA only
        return trainer.ema_state(state) if use_ema else state

    restored = not random_params and state_dict is None
    if restored:
        if not checkpoint_dir:
            raise SystemExit(
                "no checkpoint: pass --checkpoint-dir / set it in the "
                "config, or use --random-params"
            )
        state = restore(None)
    else:
        state = trainer.init_state(state_dict)
        if use_ema:
            state = trainer.ema_state(state)

    def block(n: int) -> tuple[int, int]:  # this rank's rows of the index
        return row_block(n, dist.get_rank(group), dist.get_world_size(group))

    def encode(state):  # the corpus rows this process indexes
        rows = dataset if group is None else RowSubset(dataset, *block(len(dataset)))
        if len(rows) == 0:
            dim = (cfg.video_tower if corpus_side == "video" else cfg.text_tower).embed_dim
            return torch.zeros((0, dim))
        v, t = _encode_split(trainer, state, rows, min(batch_size, len(rows)))
        return v if corpus_side == "video" else t

    tower_mismatch = False
    if corpus_emb_path is not None:
        with np.load(corpus_emb_path, allow_pickle=False) as npz:
            corpus_emb = np.asarray(npz[corpus_side], np.float32)
            npz_ids = [str(i) for i in npz["ids"]] if "ids" in npz else []
            npz_step = int(npz["step"]) if "step" in npz else None
            npz_ema = bool(npz["ema"]) if "ema" in npz else None
        embed_dim = (
            cfg.video_tower if corpus_side == "video" else cfg.text_tower
        ).embed_dim
        if corpus_emb.ndim != 2 or corpus_emb.shape[1] != embed_dim:
            raise SystemExit(
                f"--corpus-emb {corpus_emb_path}: '{corpus_side}' has shape "
                f"{corpus_emb.shape}, expected [rows, {embed_dim}] for this "
                "config's towers"
            )
        step_mismatch = npz_step is not None and npz_step != state.step
        if step_mismatch:
            print(
                f"warning: --corpus-emb was encoded at step {npz_step} but "
                f"the query tower is step {state.step} — the index and the "
                "query tower may disagree",
                file=sys.stderr,
            )
        # the step comparison cannot see an EMA/live flavour mismatch:
        # the same step, genuinely different towers
        tower_mismatch = npz_ema is not None and npz_ema != use_ema
        if tower_mismatch:
            print(
                "warning: --corpus-emb was encoded with the "
                f"{'EMA' if npz_ema else 'live'} tower but this service "
                f"queries with the {'EMA' if use_ema else 'live'} tower "
                "— index and query tower disagree (re-export with "
                f"{'--ema' if use_ema else 'no --ema'}, or flip serve's "
                "--ema flag)",
                file=sys.stderr,
            )
        if strict_index and (step_mismatch or tower_mismatch):
            raise SystemExit(
                "--strict-index: the precomputed corpus index disagrees "
                "with the query tower "
                f"({'step' if step_mismatch else 'EMA/live flavor'} "
                "mismatch — see the warning above); re-export the index "
                "or drop --strict-index to serve anyway"
            )
        if npz_ids:
            ids = npz_ids  # row-aligned with the precomputed index
        elif ids is not None and len(ids) != corpus_emb.shape[0]:
            print(
                f"warning: dropping the ids manifest ({len(ids)} entries) — "
                f"--corpus-emb indexes {corpus_emb.shape[0]} rows and "
                "carries no ids of its own",
                file=sys.stderr,
            )
            ids = None
        index_step = npz_step
        n_rows = corpus_emb.shape[0]
        if group is not None:
            corpus_emb = corpus_emb[slice(*block(n_rows))]
    else:
        n_rows = len(dataset)
        corpus_emb = encode(state)
        index_step = state.step

    service = RetrievalService(
        trainer, state, corpus_emb, corpus_side, ids, index_step=index_step,
        corpus_dtype=_CORPUS_DTYPES[corpus_dtype], group=group,
        corpus_rows=n_rows,
    )
    if group is not None:
        service._host_group()  # made now, on every rank alike
    service.index_tower_mismatch = tower_mismatch
    query_feats = dataset.text if corpus_side == "video" else dataset.video
    service._query_ndim = query_feats.ndim
    if batch_window_ms is not None:
        service.enable_batching(window_ms=batch_window_ms)

    if restored:
        def reloader(step):
            # the checkpoint directory is read afresh each time, so a
            # reload sees steps that a separate training job wrote after
            # startup
            new_state = restore(step)
            if corpus_emb_path is not None:
                # a precomputed index is kept: only the query tower moves,
                # and the index's step stays, so the mismatch is reported
                return new_state, None, service.index_step
            return new_state, encode(new_state), new_state.step

        service._reloader = reloader
    return service


def main(argv: list[str] | None = None) -> int:
    from .utils.config import ExperimentConfig, apply_overrides, load_config

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="checkpoint directory (default: the config's "
                    "checkpoint_dir); /reload reads it afresh")
    ap.add_argument(
        "--corpus",
        choices=("video", "text"),
        default="video",
        help="modality to index; queries are the other modality",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device of the towers and the index (default cuda, "
        "cuda:LOCAL_RANK under a launcher; pass cpu explicitly to serve on "
        "the CPU)",
    )
    ap.add_argument(
        "--corpus-emb",
        default=None,
        help=".npz from `eval --embeddings-output`: serve this precomputed "
        "index instead of encoding the corpus at startup",
    )
    ap.add_argument(
        "--shard-corpus",
        action="store_true",
        help="row-shard the index over a launcher's ranks (two at least): "
        "the servable corpus grows with the ranks instead of one card's "
        "memory; rank 0 listens",
    )
    ap.add_argument(
        "--ema",
        action="store_true",
        help="serve with the EMA parameters (requires train.ema_decay in "
        "the config so checkpoints carry them)",
    )
    ap.add_argument(
        "--corpus-dtype",
        choices=("float32", "bfloat16", "int8"),
        default="float32",
        help="index storage dtype: bfloat16 halves the index (scoring "
        "still runs in fp32); int8 quarters it (per-row symmetric "
        "quantization, scored int8 x int8 -> int32; cosine scores move "
        "by about 1e-2 at most)",
    )
    ap.add_argument(
        "--batch-window-ms",
        type=float,
        default=None,
        help="coalesce concurrent /search requests arriving within this "
        "window into one device dispatch; a solitary request pays at "
        "most this much extra latency",
    )
    ap.add_argument(
        "--strict-index",
        action="store_true",
        help="refuse to start when a --corpus-emb index disagrees with "
        "the query tower (step or EMA/live flavour) instead of serving "
        "with a warning",
    )
    ap.add_argument("--random-params", action="store_true")
    ap.add_argument(
        "--artifact",
        default=None,
        help=".npz from `python -m crossclr_tpu_torch.export_serving`: "
        "serve the exported artifact directly, loading no config, model "
        "code or checkpoint; /reload is refused (artifacts are immutable)",
    )
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    if args.artifact is not None:
        conflicts = [
            flag
            for flag, given in (
                ("--config", args.config),
                ("--checkpoint-dir", args.checkpoint_dir),
                ("--corpus-emb", args.corpus_emb),
                ("--shard-corpus", args.shard_corpus),
                ("--ema", args.ema),
                ("--random-params", args.random_params),
                ("--strict-index", args.strict_index),
                ("--batch-size", args.batch_size),
                ("--batch-window-ms", args.batch_window_ms),
                # default-valued flags: another value asks for something
                # the artifact cannot change
                ("--corpus", args.corpus != "video" and args.corpus),
                (
                    "--corpus-dtype",
                    args.corpus_dtype != "float32" and args.corpus_dtype,
                ),
                ("overrides", args.overrides),
            )
            if given
        ]
        if conflicts:
            raise SystemExit(
                f"--artifact is self-contained; drop {', '.join(conflicts)} "
                "(corpus/index/tower choices were baked at export time)"
            )
        from .aot import SearchArtifact

        device = None if args.device == "cuda" else args.device
        service = ArtifactService(SearchArtifact.load(args.artifact, device))
        return _serve(service, args.host, args.port, "AOT artifact")

    from .parallel.multihost import initialize_multihost, rank_device

    own_group = not dist.is_initialized()
    grouped = initialize_multihost(args.device) if args.shard_corpus else False
    if not args.shard_corpus and int(os.environ.get("WORLD_SIZE", 1)) > 1:
        raise SystemExit("under a launcher's ranks the service shards its "
                         "index: pass --shard-corpus")
    try:
        cfg = load_config(args.config) if args.config else ExperimentConfig()
        if args.overrides:
            cfg = apply_overrides(cfg, args.overrides)
        service = build_service(
            cfg,
            args.checkpoint_dir or cfg.checkpoint_dir,
            args.corpus,
            batch_size=args.batch_size,
            random_params=args.random_params,
            corpus_emb_path=args.corpus_emb,
            use_ema=args.ema,
            corpus_dtype=args.corpus_dtype,
            batch_window_ms=args.batch_window_ms,
            strict_index=args.strict_index,
            device=rank_device(args.device) if grouped else args.device,
            shard_corpus=args.shard_corpus,
        )
        if grouped and dist.get_rank() != 0:
            service.follow()  # until rank 0 sends the stop
            return 0
        if grouped:
            service.start_keepalive()
        how = f"device {service.trainer.device}" + (
            f", index sharded over {dist.get_world_size()} ranks"
            if grouped else "")
        return _serve(service, args.host, args.port, how)
    finally:
        if grouped and own_group:
            dist.destroy_process_group()


def _serve(service, host: str, port: int, how: str) -> int:
    """Answer HTTP requests until SIGTERM (or ^C), then finish the requests
    in flight and close the service."""
    httpd = ServiceHTTPServer((host, port), service)

    # graceful SIGTERM: stop accepting, finish in-flight requests, exit 0.
    # shutdown() must run off the serving thread.
    def _on_term(signum, frame):
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    import signal

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:  # non-main thread (tests): leave handlers alone
        pass

    print(
        f"serving {service.corpus_rows} {service.corpus_side} rows on "
        f"http://{host}:{httpd.server_address[1]} "
        f"(queries: raw {service.query_side} features, {how})",
        file=sys.stderr,
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
    print("server stopped", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
