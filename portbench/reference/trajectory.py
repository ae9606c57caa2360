"""The first training steps of the reference, from the harness's initial
weights and the batches the program trained on: per step the towers'
embeddings (in blocks of rows, no gradient), the loss and its gradients
in the embeddings (``reference.loss``), the towers again with gradients,
block by block, back-propagated from those, then AdamW.  The gradient is
the one of the whole batch; the blocks only bound the memory.

Returns each step's loss, the per-leaf norms of the first step's clipped
gradient (what AdamW's moments were fed), and the per-leaf norms of the
parameters' change over the steps.  ``precision``, ``half_batch`` and
``qk_grad`` make the control and the planted faults (``portbench.controls``)."""

from __future__ import annotations

import torch

from . import towers
from .adamw import AdamW
from .loss import loss_and_grads
from .precision import matmul_for, strict_fp32


def _inputs(batch: dict, side: str, device: str, lo: int, hi: int):
    x = batch[side][lo:hi].to(device).float()
    mask = batch.get(f"{side}_mask")
    return x, None if mask is None else mask[lo:hi].to(device)


def _embed(params, config, batch, device, block, mm):
    n = batch["video"].shape[0]
    out = {"video": [], "text": []}
    with torch.no_grad():
        for lo in range(0, n, block):
            for side in out:
                x, m = _inputs(batch, side, device, lo, lo + block)
                out[side].append(towers.encode(params, config, side, x, m, mm))
    return torch.cat(out["video"]), torch.cat(out["text"])


def run(config: dict, init: dict, batches: list[dict], *, device: str,
        block: int, loss_block: int, precision: str = "fp32",
        half_batch: bool = False, qk_grad: bool = True) -> dict:
    strict_fp32()
    mm = matmul_for(precision)
    train = config["train"]
    params = {k: v.to(device=device, dtype=torch.float32).clone() for k, v in init.items()}
    opt = AdamW(train, params)
    losses, first = [], None
    for batch in batches:
        v_emb, t_emb = _embed(params, config, batch, device, block, mm)
        n = v_emb.shape[0]
        loss, d_v, d_t = loss_and_grads(
            v_emb, t_emb, temperature=train["temperature"],
            negative_weight=train["negative_weight"], mm=mm, block=loss_block,
            rows=n // 2 if half_batch else None)
        del v_emb, t_emb
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        for lo in range(0, n, block):
            embs = [towers.encode(leaves, config, side,
                                  *_inputs(batch, side, device, lo, lo + block), mm=mm,
                                  qk_grad=qk_grad)
                    for side in ("video", "text")]
            got = torch.autograd.grad(embs, list(leaves.values()),
                                      grad_outputs=[d_v[lo:lo + block],
                                                    d_t[lo:lo + block]],
                                      allow_unused=True)
            for k, g in zip(leaves, got):
                if g is not None:
                    grads[k] += g
        del leaves, d_v, d_t
        fed = opt.update(params, grads)
        if first is None:
            first = {k: float(torch.linalg.vector_norm(g)) for k, g in fed.items()}
        losses.append(loss)
    change = {k: float(torch.linalg.vector_norm(params[k] - init[k].to(device)))
              for k in params}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
