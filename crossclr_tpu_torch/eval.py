"""CLI retrieval evaluation: ``python -m crossclr_tpu_torch.eval``.

Counterpart of ``crossclr_tpu/eval.py``: restore a checkpoint that
``crossclr_tpu_torch.train`` (or
``crossclr_tpu_torch.import_torch_checkpoint``) wrote, encode a split with
the dual towers, print the bidirectional retrieval metrics (R@K, MdR,
MnR) as one JSON line, and optionally dump the embeddings (the ``.npz``
that either package's ``serve --corpus-emb`` reads) and top-k retrievals.
Batches are gathered by the native thread pool (``data.epoch_batches``);
fp32, bf16 and int8 stores encode alike, an int8 batch dequantized on the
device by ``Trainer.encode``.

Under a launcher's ranks (``torchrun``: ``RANK``, ``WORLD_SIZE``, ...) the
ranks join one group (``parallel.initialize_multihost``) and each encodes
its ``evaluation.row_block`` of the split; the metrics rank each
direction's gathered queries against the corpus rows where they lie
(``retrieval_metrics(group=)``, the JAX CLI's ranking over its mesh) and
``--topk`` merges each rank's winners (``sharded_retrieve_topk``).  Rank 0
alone prints and writes the dumps (the embeddings gathered to it).

Examples:
  python -m crossclr_tpu_torch.eval --config cfg.json --checkpoint-dir ckpt
  python -m crossclr_tpu_torch.eval --config cfg.json --split all \\
      --embeddings-output emb.npz
  python -m crossclr_tpu_torch.eval --config cfg.json --topk 10 \\
      --topk-queries text --topk-output retrievals.npz
  torchrun --nproc_per_node=2 -m crossclr_tpu_torch.eval --config cfg.json \\
      --checkpoint-dir ckpt
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from .data import epoch_batches


def _encode_split(trainer, state, data, batch_size: int):
    """Encode every row of ``data`` in aligned batches -> ``(v_emb,
    t_emb)``, fp32 tensors on the trainer's device."""
    v_parts, t_parts = [], []
    for batch in epoch_batches(
        data, batch_size, shuffle=False, drop_remainder=False
    ):
        v, t = trainer.encode(state, batch)
        v_parts.append(v)
        t_parts.append(t)
    return torch.cat(v_parts), torch.cat(t_parts)


def main(argv: list[str] | None = None) -> int:
    from .parallel.multihost import initialize_multihost, rank_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None, help="ExperimentConfig JSON path")
    ap.add_argument(
        "--checkpoint-dir",
        default=None,
        help="override config.checkpoint_dir (required via one or the other "
        "unless --random-params)",
    )
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument(
        "--split",
        choices=("eval", "all"),
        default="eval",
        help="'eval' = the same held-out rows the train CLI excludes from "
        "the train stream; 'all' = the full dataset",
    )
    ap.add_argument("--batch-size", type=int, default=None,
                    help="encode batch size (default: data.batch_size)")
    ap.add_argument("--ks", default="1,5,10", help="comma-separated recall cutoffs")
    ap.add_argument("--topk", type=int, default=None,
                    help="also compute top-k retrievals per query")
    ap.add_argument(
        "--topk-queries",
        choices=("video", "text"),
        default="text",
        help="query modality for --topk (text = t2v retrieval)",
    )
    ap.add_argument("--topk-output", default=None, help=".npz path for --topk")
    ap.add_argument(
        "--embeddings-output",
        default=None,
        help=".npz path for the encoded split's embeddings (keys: video, "
        "text, ids, step, split, ema) — feed it to `serve --corpus-emb` to "
        "start the service without re-encoding the corpus",
    )
    ap.add_argument("--output", default=None, help="write metrics JSON here too")
    ap.add_argument(
        "--ema",
        action="store_true",
        help="encode with the EMA parameters (requires train.ema_decay in "
        "the config so the checkpoint carries them)",
    )
    ap.add_argument(
        "--random-params",
        action="store_true",
        help="skip checkpoint restore (smoke tests / baselines)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, cuda:LOCAL_RANK under a "
                    "launcher; pass cpu explicitly to evaluate on the CPU)")
    ap.add_argument("overrides", nargs="*", help="section.key=value overrides")
    args = ap.parse_args(argv)

    own_group = not dist.is_initialized()
    grouped = initialize_multihost(args.device)
    try:
        return _evaluate(args, rank_device(args.device) if grouped else args.device,
                         dist.group.WORLD if grouped else None)
    finally:
        if grouped and own_group:
            dist.destroy_process_group()


def _evaluate(args, device, group) -> int:
    """The run of :func:`main` on ``device``; ``group``: the launcher's
    ranks, None for one process."""
    from .data import RowSubset, dataset_from_config, train_eval_split
    from .evaluation import (
        gather_row_blocks,
        pad_block,
        retrieval_metrics,
        retrieve_topk,
        row_block,
        sharded_retrieve_topk,
    )
    from .training import CheckpointManager, Trainer
    from .utils.config import ExperimentConfig, apply_overrides, load_config

    cfg = load_config(args.config) if args.config else ExperimentConfig()
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)

    dataset, ids = dataset_from_config(cfg.data)
    if args.split == "eval" and cfg.data.eval_fraction > 0:
        # the train CLI's split arithmetic, so these are exactly the rows
        # its train stream never saw (eval_fraction=0 disables the holdout
        # there, so 'eval' is the full dataset)
        n_eval = max(int(len(dataset) * cfg.data.eval_fraction), 1)
        if n_eval >= len(dataset):
            raise SystemExit(
                f"data.eval_fraction {cfg.data.eval_fraction} leaves no "
                f"train rows (dataset has {len(dataset)})"
            )
        _, data = train_eval_split(dataset, n_eval)
        if ids is not None:
            ids = ids[:n_eval]  # eval = the FIRST n_eval rows
    else:
        data = dataset

    trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, device)
    batch_size = args.batch_size or min(cfg.data.batch_size, len(data))
    n = len(data)
    lead = group is None or dist.get_rank(group) == 0
    if group is not None:  # this rank's rows of the split
        world = dist.get_world_size(group)
        data = RowSubset(data, *row_block(n, dist.get_rank(group), world))
    state = trainer.init_state()
    ckpt_dir = args.checkpoint_dir or cfg.checkpoint_dir
    if not args.random_params:
        if not ckpt_dir:
            raise SystemExit(
                "no checkpoint: pass --checkpoint-dir / set "
                "checkpoint_dir in the config, or use --random-params"
            )
        state = trainer.restored_state(
            CheckpointManager(ckpt_dir).restore(state, step=args.step))
    state.opt_state = None  # encoding needs the model and the EMA only
    if args.ema:
        state = trainer.ema_state(state)

    if len(data):
        v_emb, t_emb = _encode_split(trainer, state, data,
                                     min(batch_size, len(data)))
    else:  # a rank past the last row (more ranks than blocks of rows)
        v_emb = torch.zeros((0, cfg.video_tower.embed_dim), device=trainer.device)
        t_emb = torch.zeros((0, cfg.text_tower.embed_dim), device=trainer.device)
    v_loc, t_loc = v_emb, t_emb
    if group is not None and (args.embeddings_output or args.topk is not None):
        v_emb, t_emb = (gather_row_blocks(x, n, group) for x in (v_loc, t_loc))

    ks = tuple(int(k) for k in args.ks.split(","))
    metrics = retrieval_metrics(v_loc, t_loc, ks=ks, group=group)
    metrics.update(
        {"split": args.split, "rows": n, "step": int(state.step)}
    )
    if args.ema:
        metrics["ema"] = True
    line = json.dumps(metrics)
    if lead:
        print(line)
        if args.output:
            with open(args.output, "w") as f:
                f.write(line + "\n")

    if args.embeddings_output and lead:
        np.savez(
            args.embeddings_output,
            video=v_emb.cpu().numpy(),
            text=t_emb.cpu().numpy(),
            ids=np.asarray(ids if ids is not None else [], dtype=str),
            step=int(state.step),
            split=args.split,
            # which tower flavour encoded this dump: serve compares it with
            # its own --ema flag
            ema=bool(args.ema),
        )
        print(
            f"wrote {v_emb.shape[0]} x {v_emb.shape[1]} embeddings "
            f"(both modalities) to {args.embeddings_output}",
            file=sys.stderr,
        )

    if args.topk is not None:
        text = args.topk_queries == "text"
        q = t_emb if text else v_emb
        with torch.inference_mode():
            if group is None:
                scores, idx = retrieve_topk(q, v_emb if text else t_emb,
                                            k=args.topk)
            else:  # the gathered queries against this rank's rows
                c_loc = pad_block(v_loc if text else t_loc, n, group)
                scores, idx = sharded_retrieve_topk(q, c_loc, k=args.topk,
                                                    group=group, n_real=n)
        if args.topk_output and lead:
            np.savez(
                args.topk_output,
                scores=scores.cpu().numpy(),
                # the JAX CLI's dtype (lax.top_k's indices)
                indices=idx.cpu().numpy().astype(np.int32),
                queries=args.topk_queries,
            )
            print(
                f"wrote top-{int(scores.shape[1])} retrievals for "
                f"{int(scores.shape[0])} {args.topk_queries} queries to "
                f"{args.topk_output}",
                file=sys.stderr,
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
