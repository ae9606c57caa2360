"""Training CLI: ``python -m crossclr_tpu_torch.train``, on one device or
one process per rank.

Counterpart of ``crossclr_tpu/train.py``: data → dual encoders →
CrossCLR loss → AdamW → retrieval eval on a held-out split → checkpoints,
from an ExperimentConfig JSON plus ``section.key=value`` overrides.  Every
``eval_every`` steps the eval split is encoded and scored (``eval/R@1``
…), a checkpoint is saved (``checkpoint_dir``), and with
``train.keep_best_metric`` the best one is kept under
``<checkpoint_dir>/best``.  A run resumes from the latest checkpoint; on
SIGTERM or SIGINT it stops at the next dispatch boundary and checkpoints.

The data path is the JAX CLI's, in ``data.train_stream``: the native
thread pool gathers each chunk into a ring of two reused host buffers
(page-locked on a CUDA device), and a worker thread copies the next chunks
to the device on its own stream while the step runs.  With
``train.steps_per_call > 1`` dividing ``eval_every``, a chunk is the
``[n, B, ...]`` stack of one dispatch's batches (one prefetched ahead),
refused before anything is allocated when it exceeds the trainer's
``max_stacked_bytes`` budget; else one batch (two ahead).  fp32, bf16 and
int8 stores train; an int8 batch is dequantized on the device.

Data parallelism: under ``torchrun`` (or any launcher that sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) the
ranks join one group before any device is used
(``parallel.initialize_multihost``: ``nccl`` on ``--device cuda``, which
means ``cuda:LOCAL_RANK``; ``gloo`` on ``--device cpu``).  Each rank
reads its ``data.HostShard`` of the train split at the local batch ``data.batch_size / P`` and runs the data-parallel step
(``training.Trainer``).  Rank 0 alone writes the metrics CSV and echoes,
prints the resume and preemption notes, encodes the eval split and saves
the checkpoints (the best ones too) while the others wait at a barrier;
every rank restores the same checkpoint (its step broadcast from rank 0)
and continues the exact batch sequence.  A SIGTERM or SIGINT on any rank
stops every rank at the same dispatch boundary: the flag is all-reduced
before each dispatch.  The group is destroyed on exit.  Without a
launcher the run is the one-device run.

The model axis: ``--n-model M`` lays the ranks out as the JAX package's
``make_mesh(n_data=P/M, n_model=M, dcn=--mesh-dcn,
granule=--mesh-granule)`` grid (``parallel.make_mesh``; by default rank
``d·M + m``; a DCN layout keeps each model group inside one node and runs
the data axis node by node).  The M ranks of a model group read the same
rows (``HostShard`` by the data coordinate, local batch ``data.batch_size
/ (P/M)``).  An ``attention="ring"`` transformer tower runs one sequence
shard a rank through the ring with replicated weights; every other tower
(flash and xla transformers, MLPs) is split tensor-parallel over the
group, each rank holding its slices of the weights (``training.Trainer``).
Rank 0 alone writes and checkpoints (whole tensors: its model group's
slices joined); every rank of its model group encodes the eval split with
it (the ring and the split towers need them all), the other model groups
wait at the barrier.  A checkpoint restores on any grid, and in one
process for the serve and eval CLIs.

Tooling: ``--profile-dir`` traces the first train chunk on rank 0
(``utils.profiling.trace``: a ``torch.profiler`` Chrome trace of the host
operators and the card's kernels); ``--tensorboard-dir`` streams rank 0's
metrics to TensorBoard event files (``tensorboardX``, or
``torch.utils.tensorboard`` with the ``tensorboard`` package; refused with
the missing package's name when neither is installed);
``--save-config PATH`` writes the resolved config as JSON and exits.

Examples:
  python -m crossclr_tpu_torch.train --config configs/youcook2_mlp.json \\
      data.source=synthetic data.num_pairs=16384 --steps 300
  python -m crossclr_tpu_torch.train --config configs/lsmdc_transformer.json \\
      --steps 60 video_tower.attention=flash text_tower.attention=flash \\
      video_tower.dropout=0.1 text_tower.dropout=0.1 data.source=synthetic \\
      data.num_pairs=4096 data.video_dim=512 data.text_dim=768 \\
      data.video_seq_len=64 data.text_seq_len=96 \\
      data.variable_lengths=true data.batch_size=1024 \\
      checkpoint_dir=/tmp/lsmdc
  python -m crossclr_tpu_torch.train --config configs/podslice_32k.json \\
      --steps 8 data.source=synthetic data.num_pairs=73000 \\
      data.video_dim=512 data.text_dim=384 data.batch_size=65536 \\
      train.warmup_steps=2 checkpoint_dir=/tmp/podslice
  python -m crossclr_tpu_torch.train --device cpu --steps 50 \\
      data.batch_size=64 data.num_pairs=512
  torchrun --nproc_per_node=4 -m crossclr_tpu_torch.train \\
      --config configs/podslice_32k.json --steps 8 data.source=synthetic \\
      data.num_pairs=36500 data.video_dim=512 data.text_dim=384 \\
      train.warmup_steps=2 checkpoint_dir=/tmp/podslice
  torchrun --nproc_per_node=2 -m crossclr_tpu_torch.train \\
      --config configs/lsmdc_transformer.json --n-model 2 --steps 5 \\
      video_tower.attention=ring text_tower.attention=ring \\
      data.source=synthetic data.num_pairs=1200 data.video_dim=512 \\
      data.text_dim=768 data.video_seq_len=64 data.text_seq_len=96 \\
      data.batch_size=1024 checkpoint_dir=/tmp/lsmdc_ring
  torchrun --nproc_per_node=4 -m crossclr_tpu_torch.train \\
      --config configs/lsmdc_transformer.json --n-model 2 --steps 5 \\
      video_tower.attention=flash text_tower.attention=flash \\
      video_tower.dropout=0.1 text_tower.dropout=0.1 train.optimizer=lamb \\
      train.zero1=true data.source=synthetic data.num_pairs=1200 \\
      data.video_dim=512 data.text_dim=768 data.video_seq_len=64 \\
      data.text_seq_len=96 data.batch_size=1024 checkpoint_dir=/tmp/lsmdc_tp

The podslice config trains through the GradCache two-pass step
(``train.embedding_chunk``); past one rank through its global negatives
and ZeRO-1 (``zero1``), both inert on one device, as in the JAX trainer
without a mesh.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import signal
import sys
from pathlib import Path


def chunk_steps(cfg) -> int:
    """The steps one host chunk stacks: ``train.steps_per_call`` when it
    divides ``eval_every`` (every ``fit`` runs ``eval_every`` steps or the
    final tail, so a larger chunk would fall out of step across eval
    boundaries), else 1."""
    spc = cfg.train.steps_per_call
    return spc if spc > 1 and cfg.eval_every % spc == 0 else 1


def main(argv: list[str] | None = None) -> int:
    from .utils.config import (
        ExperimentConfig,
        apply_overrides,
        load_config,
        save_config,
    )

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None, help="ExperimentConfig JSON path")
    ap.add_argument("--steps", type=int, default=None, help="override total steps")
    ap.add_argument(
        "--stop-after", type=int, default=None,
        help="run at most this many steps THIS invocation, then checkpoint "
        "and exit; the LR schedule keeps train.total_steps as its horizon",
    )
    ap.add_argument("--metrics-csv", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass cpu explicitly "
                    "to train on the CPU)")
    ap.add_argument("--tensorboard-dir", default=None,
                    help="also stream scalar metrics to TensorBoard event "
                    "files here (needs tensorboardX or tensorboard)")
    ap.add_argument("--n-model", type=int, default=1,
                    help="ranks of the model axis: attention='ring' towers "
                    "shard each sequence over them, every other tower its "
                    "weights (tensor parallelism)")
    ap.add_argument("--mesh-dcn", default="auto",
                    help="DCN granule count: 'auto' counts the nodes, an "
                    "integer forces it (each model group stays inside one "
                    "granule; only the data axis crosses them)")
    ap.add_argument("--mesh-granule", choices=("slice", "process", "contiguous"),
                    default="slice",
                    help="what a DCN granule is: 'slice' the node "
                    "(GROUP_RANK, else the hostname), 'process' the rank, "
                    "'contiguous' --mesh-dcn equal blocks of ranks")
    ap.add_argument("--save-config", default=None,
                    help="write the resolved config (JSON) here and exit")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the first train "
                    "chunk (host operators and the card's kernels) here")
    ap.add_argument("overrides", nargs="*", help="section.key=value overrides")
    args = ap.parse_args(argv)

    if args.tensorboard_dir:  # refused before any work when it cannot write
        from .utils.logging import _summary_writer

        try:
            _summary_writer()
        except RuntimeError as e:
            raise SystemExit(f"--tensorboard-dir: {e}") from e

    cfg = load_config(args.config) if args.config else ExperimentConfig()
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    if cfg.train.eval_with_ema and cfg.train.ema_decay is None:
        raise SystemExit(
            "train.eval_with_ema requires train.ema_decay (the state "
            "carries no EMA to evaluate with)"
        )
    if args.steps is not None:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, total_steps=args.steps)
        )
    if args.save_config:
        save_config(cfg, args.save_config)
        print(f"wrote {args.save_config}")
        return 0

    # the launcher's ranks join one group before any device is used
    import torch.distributed as dist

    from .parallel.mesh import make_mesh
    from .parallel.multihost import initialize_multihost, rank_device

    own_group = not (dist.is_available() and dist.is_initialized())
    grouped = initialize_multihost(args.device)
    try:
        try:  # every rank lays out the same grid (1 x 1 without a group)
            mesh = make_mesh(n_model=args.n_model, granule=args.mesh_granule,
                             dcn=args.mesh_dcn if args.mesh_dcn == "auto"
                             else int(args.mesh_dcn))
        except ValueError as e:
            raise SystemExit(f"--n-model {args.n_model}: {e}") from e
        return _train(cfg, args, rank_device(args.device) if grouped else args.device,
                      mesh)
    finally:
        if grouped and own_group:
            dist.destroy_process_group()


def _train(cfg, args, device, mesh) -> int:
    """The run of :func:`main` on ``device``, after the group and its grid
    (if any)."""
    from .data import HostShard, dataset_from_config, train_eval_split, train_stream
    from .eval import _encode_split
    from .evaluation import retrieval_metrics
    from .training import CheckpointManager, Trainer
    from .utils import MetricsWriter
    from .utils.profiling import trace as profiler_trace

    # -- data: eval rows are held out of the train stream --------------------
    dataset, _ = dataset_from_config(cfg.data)
    try:  # a width the model axis does not divide is refused here
        trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, device, mesh)
        state = trainer.init_state()
    except ValueError as e:
        raise SystemExit(str(e)) from e
    rank, world = trainer.rank, trainer.world  # the data coordinate and axis
    lead = trainer.global_rank == 0  # writes, echoes and checkpoints
    evaluates = rank == 0  # the lead's model group: its towers need them all
    if cfg.data.eval_fraction > 0:
        n_eval = max(int(len(dataset) * cfg.data.eval_fraction), 1)
        if n_eval >= len(dataset):
            raise SystemExit(
                f"data.eval_fraction {cfg.data.eval_fraction} leaves no train "
                f"rows (dataset has {len(dataset)})"
            )
        train_data, eval_data = train_eval_split(dataset, n_eval)
    else:
        train_data = eval_data = dataset
        if lead:
            print("data.eval_fraction=0: no held-out split; eval/R@K measures "
                  "memorization of training rows", file=sys.stderr)
    batch_size = cfg.data.batch_size
    if batch_size % world:
        raise SystemExit(f"data.batch_size: global batch {batch_size} not "
                         f"divisible by {world} data shards")
    local_batch = batch_size // world
    # the ranks on this host share its page-locked memory (torchrun's
    # LOCAL_WORLD_SIZE; one rank a host without it)
    host_ranks = (int(os.environ.get("LOCAL_WORLD_SIZE", 1))
                  if trainer.world_group is not None else 1)
    if world > 1:  # this data shard's rows p::P, the same length on every rank
        train_data = HostShard(train_data, rank, world)
    if len(train_data) < local_batch:
        raise SystemExit(
            f"{len(train_data)} train rows < data.batch_size {batch_size}"
            + (f" / {world} ranks" if world > 1 else "")
        )

    ckpt = CheckpointManager(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    best_ckpt = None
    if ckpt is not None and cfg.train.keep_best_metric:
        best_ckpt = CheckpointManager(
            Path(cfg.checkpoint_dir) / "best", max_to_keep=1,
            best_metric=cfg.train.keep_best_metric,
        )

    def latest_step() -> int:  # rank 0's newest checkpoint, -1 for none
        step = ckpt.latest_step() if lead else None
        return trainer.broadcast_int(-1 if step is None else step)

    if ckpt is not None and (latest := latest_step()) >= 0:
        # a checkpoint holds whole towers: restored into them, then cut
        state = trainer.restored_state(
            ckpt.restore(trainer.checkpoint_state(state), latest))
        if lead:
            print(f"resumed from step {state.step}", file=sys.stderr)

    writer = (MetricsWriter(args.metrics_csv, tensorboard_dir=args.tensorboard_dir)
              if lead else MetricsWriter(echo=False))
    stop_requested = {"flag": False}

    def _on_signal(signum, frame):
        stop_requested["flag"] = True
        print(f"signal {signum}: stopping at the next step boundary "
              "(checkpoint + clean exit)", file=sys.stderr)

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:  # not the main thread (tests): leave them alone
            pass

    def should_stop() -> bool:  # the same answer on every rank
        return trainer.any_rank(stop_requested["flag"])

    steps = cfg.train.total_steps
    done = state.step
    if args.stop_after is not None:
        steps = min(steps, done + args.stop_after)
    n = chunk_steps(cfg)
    prestacked = n > 1
    spc = cfg.train.steps_per_call
    if spc > 1 and not prestacked and lead:
        print(f"train.steps_per_call={spc} does not divide eval_every="
              f"{cfg.eval_every}; host-side chunk pre-stacking disabled "
              f"(fit still runs {spc} steps per dispatch)", file=sys.stderr)
    it = None
    try:
        try:  # a resumed run continues the exact batch sequence
            it = train_stream(train_data, local_batch, n, device=trainer.device,
                              seed=cfg.data.seed, start_step=done,
                              max_chunk_bytes=trainer.stacked_budget(),
                              host_ranks=host_ranks)
        except ValueError as e:  # the chunk or its host ring is too large
            raise SystemExit(str(e)) from e
        first_chunk = True
        while done < steps:
            # rank 0 traces the first chunk: its first dispatch and the
            # steady steps, a bounded file
            profiling = bool(args.profile_dir) and first_chunk and lead
            with (profiler_trace(args.profile_dir) if profiling
                  else contextlib.nullcontext()):
                try:
                    state, _ = trainer.fit(
                        state, it, steps=min(cfg.eval_every, steps - done),
                        log_every=cfg.log_every, writer=writer,
                        should_stop=should_stop, prestacked=prestacked,
                    )
                except FloatingPointError as e:
                    # a poisoned state is not checkpointed: the last good
                    # checkpoint is the recovery point
                    raise SystemExit(f"aborted: {e}") from e
            if profiling:
                print(f"profiler trace written to {args.profile_dir}",
                      file=sys.stderr)
            first_chunk = False
            done = state.step
            # under ZeRO-1 every rank takes part in gathering the moments
            if should_stop():  # a signal during the last dispatch counts too
                if ckpt is not None and latest_step() != done:
                    full = trainer.checkpoint_state(state)
                    if lead:
                        ckpt.save(done, full)
                        print(f"preemption checkpoint saved at step {done}",
                              file=sys.stderr)
                break
            full = trainer.checkpoint_state(state) if ckpt is not None else None
            if evaluates:
                eval_state = (trainer.ema_state(state) if cfg.train.eval_with_ema
                              else state)
                v_emb, t_emb = _encode_split(trainer, eval_state, eval_data,
                                             batch_size)
            if lead:
                metrics = retrieval_metrics(v_emb, t_emb)
                writer({"step": done,
                        **{f"eval/{k}": v for k, v in metrics.items()}})
                if ckpt is not None:
                    ckpt.save(done, full)
                if best_ckpt is not None:
                    if cfg.train.keep_best_metric not in metrics:
                        raise SystemExit(
                            f"train.keep_best_metric "
                            f"{cfg.train.keep_best_metric!r} is not an eval "
                            f"metric; available: {sorted(metrics)}"
                        )
                    best_ckpt.save(done, full, metrics=metrics)
            trainer.barrier()
    finally:
        if it is not None:
            it.close()  # stop and join the prefetch worker
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
        writer.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
