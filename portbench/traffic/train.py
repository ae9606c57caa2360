"""Training traffic: ``Trainer.train_steps`` fed by ``data.train_stream``,
as ``Trainer.fit`` drives it on the train CLI's path.

Parameters (the cell's ``params``):
* ``rate_metric``: the name the cell reports its pairs a second under;
* ``pairs``: rows of the feature store made from the seed (``portbench.pairs``);
* ``warmup_chunks``: chunks run before the window (at least one);
* ``trace_steps``: the steps of the traced span (``--trace 1``), run
  after the window from one more chunk;
* ``reference_block``, ``loss_block``: the reference's rows a block.

Set-up makes the store and the weights, builds the trainer, opens the
stream and runs the first chunk as the window runs one, through
``train_steps`` (stopped after the checked steps), reading each step's
loss and the AdamW state after step one at the step boundary, and the
parameters after step three; then the rest of the warm-up.  The window
starts at a synchronize and ends at the synchronize after the dispatch
in which the clock passed ``--seconds``; the rate is every pair trained
in it over its whole length.  After the window the program is freed, the
checked batches are found row by row in the harness's own store
(``pairs.locate``: ``pair_faults`` counts rows gathered or paired
wrong), and the reference follows the first three steps on the store's
rows (``portbench.reference.trajectory``)."""

from __future__ import annotations

import gc
import math
import sys
import time

from .. import build, judge, pairs, weights
from ..harness import Outcome
from ..reference import trajectory
from ..trace import Profiled

CHECKED_STEPS = 3


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _norms(tensors: dict) -> dict:
    import torch

    return {k: float(torch.linalg.vector_norm(v)) for k, v in tensors.items()}


def run(ctx) -> Outcome:
    import torch

    from crossclr_tpu_torch.data import train_stream

    cfg, p, device = ctx.config, ctx.params, ctx.device
    batch = cfg["data"]["batch_size"]
    n = cfg["train"]["steps_per_call"]
    ctx.lap("imports")
    store = pairs.make(cfg, p["pairs"], ctx.seed, device, build.feature_dtype(cfg))
    init = weights.make(cfg, ctx.seed, device)
    init_host = {k: v.cpu() for k, v in init.items()}
    ctx.lap("store and weights")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer = build.trainer(cfg, ctx.seed, device)
    state = trainer.init_state(init)
    del init
    stream = train_stream(store, batch, n, device=device, seed=ctx.seed,
                          max_chunk_bytes=trainer.stacked_budget())
    ctx.lap("trainer and stream")
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
            with Profiled(device) as prof:
                trainer.train_steps(state, chunk, limit=p["trace_steps"])
            summary = prof.summary
            del chunk
    finally:
        stream.close()
    del trainer, state, metrics
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    own, pair_faults = pairs.locate(store, gathered)
    del gathered, store
    ref = trajectory.run(cfg, init_host, own, device=device,
                         block=p["reference_block"], loss_block=p["loss_block"])
    numbers = {**judge.training(prog, ref), "pair_faults": pair_faults}
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


def _warm_up(trainer, state, stream, chunks: int, init_host: dict, ctx):
    """The warm-up chunks, each one ``train_steps`` call as in the window;
    the first stops after ``CHECKED_STEPS`` steps, which are read at each
    step boundary.  Returns the program's readings of those steps and
    their batches as the stream gathered them (on the host)."""
    import torch

    chunk = next(stream)
    ctx.lap("chunk 0 drawn")
    if chunk["video"].shape[0] < CHECKED_STEPS:
        raise ValueError(f"a chunk of {chunk['video'].shape[0]} steps; the check "
                         f"needs {CHECKED_STEPS}")
    gathered = [{k: chunk[k][i].cpu() for k in ("video", "text")}
                for i in range(CHECKED_STEPS)]
    prog = {"losses": []}
    step = trainer.train_step

    def observed(state, batch):
        state, metrics = step(state, batch)
        prog["losses"].append(float(metrics["loss"]))
        if len(prog["losses"]) == 1:  # the clipped gradient AdamW's first moment was fed
            b1 = trainer.optimizer.b1
            prog["grad_norms"] = _norms({k: mu / (1.0 - b1)
                                         for k, mu in state.opt_state["mu"].items()})
        return state, metrics

    trainer.train_step = observed
    try:
        state, _ = trainer.train_steps(state, chunk, limit=CHECKED_STEPS)
    finally:
        del trainer.train_step
    with torch.no_grad():
        prog["change_norms"] = _norms({
            k: p.detach() - init_host[k].to(p.device)
            for k, p in state.model.named_parameters()})
    del chunk
    _sync(trainer.device.type)
    ctx.lap("chunk 0 trained")
    for c in range(1, chunks):
        trainer.train_steps(state, next(stream))
        _sync(trainer.device.type)
        ctx.lap(f"chunk {c} trained")
    return prog, gathered
