"""Training traffic of a configuration whose text tower is of the
``"mla_moe"`` kind (latent attention and routed experts): ``Trainer.
train_steps`` fed by ``data.train_stream``, as ``traffic.train`` drives
it, with what that kind needs of its own.

Parameters (the cell's ``params``): those of ``traffic.train``
(``rate_metric``, ``pairs``, ``warmup_chunks``, ``trace_steps``,
``reference_block``, ``loss_block``).

What differs from ``traffic.train``:

* the weights are ``portbench.weights_moe``'s layout (the correction
  biases are buffers: given to the program, never trained);
* the store is made and searched by ``portbench.pairs`` unedited, handed
  a view of the configuration in which the text tower reads sequences as
  a transformer tower does;
* each checked step's MoE choices, as its pass 3 ran with them
  (``Trainer.routes_used``), are kept on the host, and the reference
  (``portbench.reference.mla_moe``) routes by them, with its own scores
  and weights: ``route_margin`` is the largest amount by which a chosen
  expert's reference score falls below the reference's own k-th best;
* after the traced steps it prints on stderr each MoE layer's largest and
  mean load (tokens an expert a step) and the experts that got none,
  from the tower's ``expert_load`` counter, read only after the steps."""

from __future__ import annotations

import copy
import gc
import math
import sys
import time

from .. import build, judge, pairs, weights_moe
from ..harness import Outcome
from ..reference import mla_moe as reference
from ..trace import Profiled
from .train import CHECKED_STEPS, _sync, _warm_up


def store_view(config: dict) -> dict:
    """The configuration as ``pairs`` reads it: the text tower a sequence
    tower of its input width and length."""
    view = copy.deepcopy(config)
    view["text_tower"]["kind"] = "transformer"
    return view


def _host_routes(trainer) -> list:
    """The step's choices a MoE layer, ``[B·S, k]`` uint8 on the host, the
    chunks in order."""
    import torch

    chunks = trainer.routes_used
    return [torch.cat([c[i] for c in chunks]).to(torch.uint8).cpu()
            for i in range(len(chunks[0]))]


def _loads(tower, steps: int) -> None:
    load = tower.expert_load.double() / steps
    for i, row in enumerate(load.cpu().tolist()):
        print(f"portbench: MoE layer {i + 1} tokens an expert a traced step: largest "
              f"{max(row):.1f}, mean {sum(row) / len(row):.1f}, experts with none "
              f"{sum(1 for x in row if x == 0)}", file=sys.stderr)


def run(ctx) -> Outcome:
    import torch

    from crossclr_tpu_torch.data import train_stream
    from crossclr_tpu_torch.models import mla_moe  # noqa: F401  (a port with the kind)
    from crossclr_tpu_torch.training import Trainer

    cfg, p, device = ctx.config, ctx.params, ctx.device
    batch = cfg["data"]["batch_size"]
    n = cfg["train"]["steps_per_call"]
    trainer = build.trainer(cfg, ctx.seed, device)
    ctx.lap("imports")
    store = pairs.make(store_view(cfg), p["pairs"], ctx.seed, device,
                       build.feature_dtype(cfg))
    init = weights_moe.make(cfg, ctx.seed, device)
    init_host = {k: v.cpu() for k, v in init.items()}
    ctx.lap("store and weights")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state(init)
    tower = state.model.text_tower
    del init
    stream = train_stream(store, batch, n, device=device, seed=ctx.seed,
                          max_chunk_bytes=trainer.stacked_budget())
    ctx.lap("trainer and stream")
    routes = []

    def routed(state, batch):
        out = Trainer.train_step(trainer, state, batch)
        if len(routes) < CHECKED_STEPS:
            routes.append(_host_routes(trainer))
        return out

    trainer.train_step = routed  # _warm_up's own wrapper calls it, then removes both
    try:
        prog, gathered = _warm_up(trainer, state, stream, p["warmup_chunks"],
                                  init_host, ctx)
        _sync(device)
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_start
        waits_before = len(stream.stats["wait_ms"])
        steps = 0
        while True:
            state, metrics = trainer.train_steps(state, next(stream))
            steps += n
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - t0
        wait_ms = sum(stream.stats["wait_ms"][waits_before:])
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        final_loss = float(metrics["loss"])

        summary = None
        if ctx.trace:
            chunk = next(stream)
            tower.expert_load.zero_()
            with Profiled(device) as prof:
                trainer.train_steps(state, chunk, limit=p["trace_steps"])
            summary = prof.summary
            _loads(tower, p["trace_steps"])
            del chunk
    finally:
        stream.close()
    del trainer, state, metrics, tower
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    own, pair_faults = pairs.locate(store, gathered)
    del gathered, store
    ref = reference.run(cfg, init_host, own, device=device, block=p["reference_block"],
                      loss_block=p["loss_block"], routes=routes,
                      buffers=tuple(weights_moe.buffers(cfg)))
    numbers = {**judge.training(prog, ref), "pair_faults": pair_faults,
               "route_margin": ref["route_margin"]}
    limits = ctx.cell["limits"]
    print("portbench: output check " + " ".join(f"{k}={v!r}" for k, v in numbers.items()),
          file=sys.stderr)
    return Outcome(
        end_to_end={p["rate_metric"]: steps * batch / window_s, "setup_s": setup_s},
        attempted=steps,
        failed=0 if math.isfinite(final_loss) else steps,
        memory_peak_bytes=peak,
        readings={"window_s": window_s, "steps": steps, "batch": batch,
                  "wait_ms": wait_ms, "trace": summary,
                  "trace_steps": p["trace_steps"]},
        checks={k: (numbers[k], limit) for k, limit in limits.items()},
    )
