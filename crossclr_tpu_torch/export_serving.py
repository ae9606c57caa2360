"""Export a serving artifact: ``python -m crossclr_tpu_torch.export_serving``.

Counterpart of ``scripts/export_serving.py``.  Builds the service that
``python -m crossclr_tpu_torch.serve`` would (config + checkpoint +
encoded or precomputed corpus index), then writes its query → top-k path,
the query tower's parameters included, as one ``.npz`` through
``torch.export`` (see ``crossclr_tpu_torch/aot.py``).  A consumer loads
it with ``crossclr_tpu_torch.aot.SearchArtifact.load(path)`` or serves it
with ``serve --artifact``: no config, checkpoint or model code.  The
program runs on the device type it was exported on (``--device``, which
takes the place of the JAX script's ``--platforms``).

Example:
  python -m crossclr_tpu_torch.export_serving --config cfg.json \\
      --checkpoint-dir ckpts --corpus video --k 16 --query-shape 96,768 \\
      --output search_artifact.npz
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    from .aot import export_search, save_artifact
    from .serve import build_service
    from .utils.config import ExperimentConfig, apply_overrides, load_config

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--corpus", choices=("video", "text"), default="video")
    ap.add_argument("--k", type=int, default=16,
                    help="top-k baked into the artifact (requests may ask "
                    "for any smaller k)")
    ap.add_argument("--output", required=True, help="artifact .npz path")
    ap.add_argument("--corpus-emb", default=None,
                    help="precomputed index .npz (eval --embeddings-output)")
    ap.add_argument("--corpus-dtype",
                    choices=("float32", "bfloat16", "int8"),
                    default="float32")
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--device", "--platforms", dest="device", default="cuda",
                    help="the device the program is exported on and runs on "
                    "(default cuda; pass cpu explicitly for a CPU artifact)")
    ap.add_argument("--query-shape", default=None,
                    help="per-query trailing feature shape: D for pooled "
                    "(the default, from the query tower's input_dim) or "
                    "S,D for sequence queries (adds a [b, S] mask to the "
                    "artifact signature)")
    ap.add_argument("--random-params", action="store_true")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

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
        device=args.device,
    )
    if service.index_stale or service.index_tower_mismatch:
        raise SystemExit(
            "refusing to export: the corpus index disagrees with the query "
            "tower (see the warnings above) — re-export the index first"
        )
    query_shape = (
        tuple(int(d) for d in args.query_shape.split(","))
        if args.query_shape else None
    )
    blob, meta, corpus = export_search(service, k=args.k,
                                       query_shape=query_shape)
    save_artifact(args.output, blob, meta, corpus, ids=service.ids)
    print(
        f"wrote {args.output}: k={meta['k']}, {meta['corpus_rows']} "
        f"{meta['corpus_side']} rows ({meta['index_dtype']} index), "
        f"queries={meta['query_side']}, platforms={meta['platforms']}, "
        f"step={meta['step']}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
