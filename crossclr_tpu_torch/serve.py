"""Retrieval serving: ``python -m crossclr_tpu_torch.serve``.

Counterpart of ``crossclr_tpu/serve.py`` on one device: build the towers,
encode one modality of the dataset as the corpus (held on the device),
and answer nearest-neighbour search over HTTP with the same surface:

  GET  /healthz   → {"status": "ok", "corpus_rows": N, "step": S, ...}
  GET  /metrics   → request/error counts + recent /search latency
                    percentiles (p50/p95/p99 over a 512-request window)
  POST /search    → body {"features": [[...], ...], "k": 10}: raw
                    QUERY-modality features ([B, D] pooled or [B, S, D]
                    sequences, optional "mask": [B, S]); returns
                    {"indices", "scores", "ids"?}

Not ported yet, and refused with a message rather than ignored:
checkpoint restore (``--checkpoint-dir``, ``/reload``), ``--ema``,
``--shard-corpus``, ``--corpus-dtype int8``, ``--batch-window-ms`` and
``--artifact``.  Weights are seeded random (``--random-params``) or handed
to :func:`build_service` as a state_dict.  The corpus encode reads fp32,
bf16 and int8 feature stores (``data.features_dtype``) through the native
gather, an int8 batch dequantized on the device; the int8 INDEX
(``--corpus-dtype int8``) is a different thing and stays refused.

Example:
  python -m crossclr_tpu_torch.serve --config configs/lsmdc_transformer.json \\
      --random-params --corpus video --port 8777 \\
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

_CORPUS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    Device work is serialized with a lock.
    """

    index_tower_mismatch: bool = False

    def __init__(self, trainer, state, corpus_emb, corpus_side: str,
                 ids: list[str] | None = None,
                 index_step: int | None = None,
                 corpus_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trainer = trainer
        self.state = state
        self.corpus_rows = int(corpus_emb.shape[0])
        # bfloat16 storage halves the index; scoring still runs in fp32
        self.corpus_dtype = corpus_dtype
        self.corpus_emb = to_tensor(corpus_emb, trainer.device, corpus_dtype)
        self.corpus_side = corpus_side
        self.query_side = "text" if corpus_side == "video" else "video"
        self.query_cfg = (
            trainer.text_cfg if corpus_side == "video" else trainer.video_cfg
        )
        self.ids = ids
        self.step = int(state.step)
        self.index_step = index_step
        self._lock = threading.Lock()

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
        scores, idx = self._dispatch(features, mask, k)
        out = {"indices": idx.tolist(), "scores": scores.tolist()}
        if self.ids is not None:
            out["ids"] = [[self.ids[j] for j in row] for row in idx.tolist()]
        return out

    # set by build_service (single-query convenience reshaping)
    _query_ndim: int = 2


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
            if self.path == "/reload":
                return self._reply(501, {"error": (
                    "/reload needs checkpoint restore, which is not ported "
                    "to crossclr_tpu_torch yet"
                )})
            if self.path != "/search":
                return self._reply(404, {"error": "unknown path"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, TypeError) as e:
                # malformed JSON is still a failed search request
                service.record_search(None, ok=False)
                return self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            t0 = time.perf_counter()
            try:
                out = service.search(
                    req["features"], req.get("mask"), req.get("k", 10)
                )
            except (KeyError, ValueError, TypeError) as e:
                service.record_search(None, ok=False)
                return self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001 — device/runtime fault
                service.record_search(None, ok=False)
                return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            service.record_search(time.perf_counter() - t0, ok=True)
            self._reply(200, out)

    return Handler


def build_service(cfg, checkpoint_dir: str | None, corpus_side: str,
                  batch_size: int | None = None,
                  random_params: bool = False,
                  corpus_emb_path: str | None = None,
                  corpus_dtype: str | None = None,
                  strict_index: bool = False,
                  device: str | torch.device = "cuda",
                  state_dict=None) -> RetrievalService:
    """Construct the service: dataset → trainer → weights → encode corpus.

    Weights are seeded random from ``train.seed`` (``random_params``) or
    loaded from ``state_dict`` (e.g. ``utils.params.state_dict_from_flax``
    of a JAX trainer's params).  ``corpus_emb_path``: an ``.npz`` written
    by the JAX ``eval --embeddings-output``, served instead of encoding
    the corpus at startup.
    """
    from .data import dataset_from_config
    from .eval import _encode_split
    from .training import Trainer

    if checkpoint_dir:
        raise _not_ported("checkpoint restore (--checkpoint-dir)")
    if not random_params and state_dict is None:
        raise SystemExit(
            "no weights: checkpoint restore is not ported to "
            "crossclr_tpu_torch yet; use --random-params"
        )
    if corpus_dtype in (None, "float32", "bfloat16"):
        index_dtype = _CORPUS_DTYPES[corpus_dtype or "float32"]
    elif corpus_dtype == "int8":
        raise _not_ported("--corpus-dtype int8")
    else:
        raise SystemExit(f"unknown corpus dtype {corpus_dtype!r}")

    dataset, ids = dataset_from_config(cfg.data)
    trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, device)
    batch_size = min(batch_size or cfg.data.batch_size, len(dataset))
    state = trainer.init_state()
    if state_dict is not None:
        state.model.load_state_dict(state_dict, strict=True)

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
        # this service always queries with the live tower
        tower_mismatch = bool(npz_ema)
        if tower_mismatch:
            print(
                "warning: --corpus-emb was encoded with the EMA tower but "
                "this service queries with the live tower",
                file=sys.stderr,
            )
        if strict_index and (step_mismatch or tower_mismatch):
            raise SystemExit(
                "--strict-index: the precomputed corpus index disagrees "
                "with the query tower (see the warning above)"
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
        corpus_dtype=index_dtype,
    )
    service.index_tower_mismatch = tower_mismatch
    query_feats = dataset.text if corpus_side == "video" else dataset.video
    service._query_ndim = query_feats.ndim
    return service


def main(argv: list[str] | None = None) -> int:
    from .utils.config import ExperimentConfig, apply_overrides, load_config

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="not ported yet (refused)")
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
    ap.add_argument("--ema", action="store_true",
                    help="not ported yet (refused)")
    ap.add_argument(
        "--corpus-dtype",
        choices=("float32", "bfloat16", "int8"),
        default="float32",
        help="index storage dtype: bfloat16 halves the index (scoring "
        "still runs in fp32); int8 is not ported yet (refused)",
    )
    ap.add_argument("--batch-window-ms", type=float, default=None,
                    help="not ported yet (refused)")
    ap.add_argument(
        "--strict-index",
        action="store_true",
        help="refuse to start when a --corpus-emb index disagrees with "
        "the query tower instead of serving with a warning",
    )
    ap.add_argument("--random-params", action="store_true")
    ap.add_argument("--artifact", default=None,
                    help="not ported yet (refused)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    for flag, given in (
        ("--artifact (AOT artifact serving)", args.artifact),
        ("--shard-corpus (row-sharded index)", args.shard_corpus),
        ("--ema (EMA parameters)", args.ema),
        ("--batch-window-ms (micro-batching)", args.batch_window_ms),
        ("--corpus-dtype int8 (quantized index)", args.corpus_dtype == "int8"),
    ):
        if given:
            raise _not_ported(flag)

    cfg = load_config(args.config) if args.config else ExperimentConfig()
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    service = build_service(
        cfg,
        args.checkpoint_dir,
        args.corpus,
        batch_size=args.batch_size,
        random_params=args.random_params,
        corpus_emb_path=args.corpus_emb,
        corpus_dtype=args.corpus_dtype,
        strict_index=args.strict_index,
        device=args.device,
    )
    httpd = ThreadingHTTPServer((args.host, args.port), _make_handler(service))
    # non-daemon handler threads: server_close() joins in-flight requests
    httpd.daemon_threads = False

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
    print("server stopped", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
