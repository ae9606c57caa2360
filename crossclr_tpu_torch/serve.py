"""Retrieval serving: ``python -m crossclr_tpu_torch.serve``.

Counterpart of ``crossclr_tpu/serve.py`` on one device: restore a
checkpoint that ``crossclr_tpu_torch.train`` (or the import CLI,
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

Not ported yet, and refused with a message rather than ignored:
``--shard-corpus`` (the row-sharded index) and ``--artifact`` (AOT
artifact serving).

Example:
  python -m crossclr_tpu_torch.serve --config configs/lsmdc_transformer.json \\
      --checkpoint-dir /tmp/lsmdc --corpus video --port 8777 \\
      video_tower.attention=flash text_tower.attention=flash
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .training.trainer import to_tensor

_CORPUS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "int8": torch.int8}


def _not_ported(what: str) -> SystemExit:
    return SystemExit(
        f"{what} is not ported to crossclr_tpu_torch yet; use "
        "python -m crossclr_tpu.serve for it"
    )


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


class RetrievalService(_ServiceStats):
    """Towers + encoded corpus on one device + the query → top-k path.

    ``corpus_side``: which modality is indexed ("video" or "text");
    queries are the OTHER modality's raw features, encoded by its tower.
    Device work (searches and reloads) is serialized with a lock.
    """

    def __init__(self, trainer, state, corpus_emb, corpus_side: str,
                 ids: list[str] | None = None,
                 index_step: int | None = None,
                 corpus_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trainer = trainer
        self.state = state
        self.corpus_rows = int(corpus_emb.shape[0])
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

    # set by build_service when a checkpoint directory was restored:
    # (step | None) -> (restored state, corpus embeddings or None to keep
    # the index, index_step)
    _reloader = None
    # set by build_service: a precomputed index encoded with the other
    # tower flavour (EMA vs live) than the one answering queries, which
    # the step comparison cannot see
    index_tower_mismatch: bool = False
    # set by build_service (single-query convenience reshaping)
    _query_ndim: int = 2
    _batcher = None

    def _place_corpus(self, corpus_emb):
        """The index on the trainer's device in its storage dtype; int8
        rows are L2-normalized and quantized on the host
        (``evaluation.quantize_corpus``)."""
        if self.corpus_dtype == torch.int8:
            from .evaluation import quantize_corpus

            return quantize_corpus(corpus_emb).to(self.trainer.device)
        return to_tensor(corpus_emb, self.trainer.device, self.corpus_dtype)

    def reload(self, step: int | None = None) -> int:
        """Swap in the latest (or the given) checkpoint without restarting:
        restore it, then re-encode the corpus (or keep a precomputed
        ``--corpus-emb`` index, whose step then trails), all under the
        device lock, so a search never sees half a swap.  Returns the
        restored step."""
        if self._reloader is None:
            raise RuntimeError(
                "service has no checkpoint directory to reload from "
                "(started with --random-params?)"
            )
        with self._lock:
            new_state, corpus, self.index_step = self._reloader(step)
            self.state = new_state
            if corpus is not None:
                self.corpus_rows = int(corpus.shape[0])
                self.corpus_emb = self._place_corpus(corpus)
            self.step = int(new_state.step)
        if self.index_stale:
            print(
                f"warning: /reload restored step {self.step} but the "
                f"precomputed corpus index is from step {self.index_step} "
                "— re-run `eval --embeddings-output` (or serve without "
                "--corpus-emb) to refresh the index",
                file=sys.stderr,
            )
        return self.step

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
        numpy; ``k`` pre-clamped to ``[1, corpus_rows]``."""
        from .evaluation import retrieve_topk

        with self._lock:
            self._dispatch_count += 1
            q = self.trainer.encode_modality(
                self.state, self.query_side, features, mask
            )
            with torch.inference_mode():
                scores, idx = retrieve_topk(q, self.corpus_emb, k=k)
            return scores.cpu().numpy(), idx.cpu().numpy()

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
                  state_dict=None) -> RetrievalService:
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
    """
    from .data import dataset_from_config
    from .eval import _encode_split
    from .training import CheckpointManager, Trainer

    if corpus_dtype is None:
        corpus_dtype = "float32"
    if corpus_dtype not in _CORPUS_DTYPES:
        raise SystemExit(f"unknown corpus dtype {corpus_dtype!r}")

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
    else:
        v_emb, t_emb = _encode_split(trainer, state, dataset, batch_size)
        corpus_emb = v_emb if corpus_side == "video" else t_emb
        index_step = state.step

    service = RetrievalService(
        trainer, state, corpus_emb, corpus_side, ids, index_step=index_step,
        corpus_dtype=_CORPUS_DTYPES[corpus_dtype],
    )
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
            v, t = _encode_split(trainer, new_state, dataset, batch_size)
            return new_state, v if corpus_side == "video" else t, new_state.step

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
        help="torch device of the towers and the index (default cuda; "
        "pass cpu explicitly to serve on the CPU)",
    )
    ap.add_argument(
        "--corpus-emb",
        default=None,
        help=".npz from `eval --embeddings-output`: serve this precomputed "
        "index instead of encoding the corpus at startup",
    )
    ap.add_argument("--shard-corpus", action="store_true",
                    help="not ported yet (refused)")
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
    ap.add_argument("--artifact", default=None,
                    help="not ported yet (refused)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    for flag, given in (
        ("--artifact (AOT artifact serving)", args.artifact),
        ("--shard-corpus (row-sharded index)", args.shard_corpus),
    ):
        if given:
            raise _not_ported(flag)

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
        device=args.device,
    )
    httpd = ServiceHTTPServer((args.host, args.port), service)

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
        f"http://{args.host}:{httpd.server_address[1]} "
        f"(queries: raw {service.query_side} features, device "
        f"{service.trainer.device})",
        file=sys.stderr,
    )
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if service._batcher is not None:
            service._batcher.close()
    print("server stopped", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
