"""Where a train step's time goes: ``python -m crossclr_tpu_torch.profile_train``.

Builds the trainer of ``train.py`` from a config plus overrides (no eval,
no checkpoints), warms it up with ``--warmup`` steps, then measures:

* a split of single steps (median of ``--repeats``), each from a
  synchronised start, on the train CLI's data path (``data.train_stream``
  at ``train.chunk_steps``): the consumer's wait for the next batch (with
  stacked chunks, at a chunk's first step only; ``wait_mean`` is its mean
  per step), then the spans ``Trainer.train_step`` records under
  ``utils.profiling.recording``, host and device ms: the step's inputs (a
  chunk's batch indexed, an int8 batch dequantized), the towers' forward,
  the loss, the backward (under ``train.embedding_chunk``: the two-pass
  step's passes 1, 2 and 3), the optimizer (``Trainer.apply_grads``:
  AdamW, the clamp and the EMA) and the step span; ``whole``, the
  synchronised wall time from the draw to the step's end; beside it the
  prefetch worker's gather and host→device copy (its stream's events) of
  the batches drawn meanwhile;
* the same split on the serial pageable path, for comparison: the host
  gather (``data.infinite_batches``), the pageable copy in the step's
  inputs;
* one ``Trainer.fit`` of ``--steps`` steps on the train CLI's path under
  ``torch.profiler``: its wall time and pairs/s, the device's busy share
  (the union of the device events' intervals over the wall time), the
  device launches per step and the ops and kernels that took the most
  device time.

Each line carries nvidia-smi's name and power limit on a CUDA device;
``--out`` also writes the numbers as JSON.

Examples (the training slices of chip_smoke.py):
  python -m crossclr_tpu_torch.profile_train --config configs/youcook2_mlp.json \\
      data.source=synthetic data.num_pairs=16384 data.video_dim=512 \\
      data.text_dim=384
  python -m crossclr_tpu_torch.profile_train \\
      --config configs/lsmdc_transformer.json --warmup 20 --repeats 10 \\
      --steps 20 video_tower.attention=flash text_tower.attention=flash \\
      video_tower.dropout=0.1 text_tower.dropout=0.1 data.source=synthetic \\
      data.num_pairs=4096 data.video_dim=512 data.text_dim=768 \\
      data.video_seq_len=64 data.text_seq_len=96 data.variable_lengths=true \\
      data.batch_size=1024
  python -m crossclr_tpu_torch.profile_train \\
      --config configs/fullcrossclr_fused_ragged.json --warmup 20 \\
      --repeats 10 --steps 20 data.source=synthetic data.num_pairs=4096 \\
      data.video_dim=512 data.text_dim=768 data.video_seq_len=64 \\
      data.text_seq_len=96 data.variable_lengths=true data.batch_size=1024
  python -m crossclr_tpu_torch.profile_train --config configs/podslice_32k.json \\
      --warmup 2 --repeats 3 --steps 3 data.source=synthetic \\
      data.num_pairs=65536 data.video_dim=512 data.text_dim=384 \\
      data.batch_size=65536 train.warmup_steps=2
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def split_step(trainer, state, batches, repeats: int,
               stacked: bool = False) -> dict[str, float]:
    """Median ms of each part of ``repeats`` calls of ``Trainer.train_step``,
    each from a synchronised start, in order: the batch (from a
    ``DevicePrefetcher``: the consumer's ``wait``, with the worker's
    ``worker_gather`` and ``worker_h2d`` of the batches it drew meanwhile;
    else the serial ``gather``), then the step's spans (``train.inputs``,
    ``train.forward`` or ``train.encode``, ``train.loss``,
    ``train.backward``, ``train.optimizer``, then ``train.step``) by their
    host ms, the host's dispatch, and on a CUDA device by their device ms
    under ``<part> device``; last ``whole``, the wall time from the draw
    to a synchronize after the step.  ``stacked``: ``batches`` yields
    ``[n, B, ...]`` chunks, drawn every ``n`` steps."""
    from .data import DevicePrefetcher
    from .utils.profiling import clear_spans, recording, span_log

    dev = trainer.device
    times: dict[str, list[float]] = {}
    prefetched = isinstance(batches, DevicePrefetcher)
    if prefetched:
        seen = {k: len(batches.stats[k]) for k in ("gather_ms", "h2d_ms")}
    wait = "wait" if prefetched else "gather"
    chunk, i, wall = None, 0, []
    clear_spans()
    with recording():
        for _ in range(repeats):
            _sync(dev)
            t = time.perf_counter()
            if not stacked:
                batch = next(batches)
            else:
                if chunk is None or i == chunk["video"].shape[0]:
                    chunk, i = next(batches), 0
                batch = {k: v[i] for k, v in chunk.items()}
                i += 1
            _sync(dev)
            times.setdefault(wait, []).append((time.perf_counter() - t) * 1e3)
            trainer.train_step(state, batch)
            _sync(dev)
            wall.append((time.perf_counter() - t) * 1e3)
    log = span_log()
    clear_spans()
    steps = {r["index"] for r in log if r["name"] == "train.step"}
    # the steps' layers first, in their order; the step span last
    for r in sorted(log, key=lambda r: r["index"] in steps):
        if r["index"] in steps or r["parent"] in steps:
            times.setdefault(r["name"], []).append(r["host_ms"])
            if r["device_ms"] is not None:
                times.setdefault(f"{r['name']} device", []).append(r["device_ms"])
    times["whole"] = wall
    if prefetched:
        for key, part in (("gather_ms", "worker_gather"), ("h2d_ms", "worker_h2d")):
            drawn = batches.stats[key][seen[key]:]
            if drawn:
                times[part] = drawn
    parts = {k: statistics.median(v) for k, v in times.items()}
    if prefetched:
        parts["wait_mean"] = statistics.mean(times["wait"])
    return parts


TOP_ROWS = 15  # ops and kernels listed by device time
# the port's own kernels by family: substrings of the CUDA function names
KERNEL_FAMILIES = {
    "flash_fwd": ("flash_fwd_kernel", "flash_fwd_bf16_kernel"),
    "flash_dq": ("flash_dq_kernel", "flash_dq_bf16_kernel"),
    "flash_dkv": ("flash_dkv_kernel", "flash_dkv_bf16_kernel"),
    # fused_dual.cu's pair, or fused_crossclr.cu's per-direction kernels
    "loss": ("lse_fwd_kernel", "lse_bwd_kernel", "sym_fwd_bf16_kernel",
             "sym_fwd_sum_kernel", "dual_fwd_bf16_kernel", "dual_fwd_merge_kernel",
             "sym_bwd_bf16_kernel", "dual_bwd_bf16_kernel", "bwd_sum_kernel",
             "sum_partials_kernel", "direction_fwd_kernel",
             "direction_fwd_bf16_kernel", "direction_bwd_kernel",
             "direction_bwd_bf16_kernel"),
    # fused_global.cu: the rows forward, its merge, the two backwards (rows_bwd_rows,
    # rows_bwd_cols; scalar and bf16 builds) and their sums
    "rows": ("rows_lse_kernel", "rows_lse_bf16_kernel", "rows_lse_merge_kernel",
             "rows_bwd_", "rows_sum_kernel", "cols_sum_kernel"),
}


def profiled_fit(trainer, state, batches, steps: int,
                 prestacked: bool = False) -> dict:
    """One ``fit`` of ``steps`` steps under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(trainer.device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        trainer.fit(state, batches, steps=steps, log_every=steps,
                    prestacked=prestacked)
        _sync(trainer.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:  # the union of the device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    averages = sorted(prof.key_averages(), reverse=True,
                      key=lambda a: a.self_device_time_total)
    rows = [{"name": a.key, "count": a.count,
             "device_ms": a.self_device_time_total / 1e3}
            for a in averages[:TOP_ROWS] if a.self_device_time_total > 0]
    families = {
        family: sum(a.self_device_time_total for a in averages
                    if a.device_type == DeviceType.CUDA
                    and any(p in a.key for p in patterns)) / 1e3
        for family, patterns in KERNEL_FAMILIES.items()
    }
    return {
        "steps": steps,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e3 / wall_ms,
        "device_events": len(spans),
        "device_events_per_step": len(spans) / steps,
        "kernel_family_ms": families,
        "top": rows,
    }


def main(argv: list[str] | None = None) -> int:
    from .data import dataset_from_config, infinite_batches, train_stream
    from .train import chunk_steps
    from .training import Trainer, loss_route
    from .utils.config import ExperimentConfig, apply_overrides, load_config

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None, help="ExperimentConfig JSON path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--warmup", type=int, default=60, help="steps before measuring")
    ap.add_argument("--repeats", type=int, default=20, help="steps in the split")
    ap.add_argument("--steps", type=int, default=60, help="steps of the profiled fit")
    ap.add_argument("--out", default=None, help="write the numbers here as JSON")
    ap.add_argument("overrides", nargs="*", help="section.key=value overrides")
    args = ap.parse_args(argv)

    cfg = load_config(args.config) if args.config else ExperimentConfig()
    cfg = apply_overrides(cfg, args.overrides)
    dataset, _ = dataset_from_config(cfg.data)
    trainer = Trainer(cfg.video_tower, cfg.text_tower, cfg.train, args.device)
    device = trainer.device
    card = _card(device)
    state = trainer.init_state()
    b = cfg.data.batch_size
    n = chunk_steps(cfg)  # the train CLI's path
    batches = train_stream(dataset, b, n, device=device, seed=cfg.data.seed,
                           max_chunk_bytes=trainer.stacked_budget())
    try:
        state, _ = trainer.fit(state, batches, steps=args.warmup,
                               log_every=max(args.warmup, 1), prestacked=n > 1)
        route = loss_route(cfg.train, b, cfg.video_tower.embed_dim)
        tag = (f"{cfg.train.loss}, {route or 'no fused'} route, batch {b}, "
               f"{n} steps a chunk")
        if trainer.two_pass(b):
            tag += f", two-pass step (chunk {cfg.train.embedding_chunk})"

        parts = split_step(trainer, state, batches, args.repeats, stacked=n > 1)
        print(f"{tag}: median ms per part of {args.repeats} steps from a synchronised "
              "start, prefetched: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
              + f" ({card})", flush=True)
        serial = split_step(trainer, state, infinite_batches(
            dataset, b, seed=cfg.data.seed), args.repeats)
        print(f"{tag}: median ms per part of {args.repeats} steps from a synchronised "
              "start, serial pageable: " + ", ".join(f"{k} {v:.3f}" for k, v in serial.items())
              + f" ({card})", flush=True)
        fit = profiled_fit(trainer, state, batches, args.steps, prestacked=n > 1)
    finally:
        batches.close()
    rate = args.steps * cfg.data.batch_size / (fit["wall_ms"] / 1e3)
    print(f"{tag}: fit of {args.steps} steps {fit['wall_ms']:.1f} ms wall "
          f"({rate:.1f} pairs/s under the profiler); device busy "
          f"{fit['device_busy_ms']:.1f} ms = {100 * fit['device_busy_share']:.1f}% "
          f"of wall; {fit['device_events_per_step']:.1f} device events per step "
          f"({card})", flush=True)
    busy = max(fit["device_busy_ms"], 1e-9)
    print(f"{tag}: the port's kernels, ms of device time over the fit: "
          + ", ".join(f"{k} {v:.3f} ({100 * v / busy:.1f}% of busy)"
                      for k, v in fit["kernel_family_ms"].items()), flush=True)
    for row in fit["top"]:
        print(f"  {row['device_ms']:10.3f} ms {row['count']:7d}x  {row['name'][:100]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "config": args.config, "overrides": args.overrides,
            "route": route, "parts_ms": parts, "serial_parts_ms": serial,
            "pairs_per_sec_profiled": rate,
            **fit,
        }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
