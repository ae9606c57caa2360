"""The ``"mla_moe"`` text tower in plain float32 and the first training
steps of a configuration that holds one, after ``models.mla_moe``'s
documented equations (DeepSeek-V3's layers at Moonlight-16B-A3B's
widths).  It imports nothing of the program.

The tower: ``input_proj`` (with a bias), per layer RMSNorm → latent
attention (q ``d → H·(n + r)``; ``[c | k_pe] = a·W_kva``; ``[k_nope |
v] = RMSNorm(c)·W_kvb``; rotate-half RoPE at θ on ``q_pe`` and the shared
``k_pe``; softmax over ``QKᵀ/√(n + r)`` under the key mask; ``o_proj``),
then RMSNorm → the dense SwiGLU MLP (the first ``first_k_dense_replace``
layers) or the routed layer (a sigmoid router on fp32 scores, the top k
of ``s + b``, weights ``s`` at the chosen experts over their sum + 1e-20
times the routed scale, SwiGLU experts and the shared expert, no
biases), a final RMSNorm, the mean over the valid positions and
``output_proj``.  Departures from the published model are the program's
(its configuration's ``changes``): features in place of token ids, no LM
head, bidirectional attention, a fixed correction bias.

Routing.  In the check the reference is handed the program's choices of
each step (what its pass 3 ran with) and routes by them, its weights from
its own scores; ``route_margin`` is the largest amount by which a chosen
expert's reference score ``s + b`` falls below the reference's own k-th
best, over every token and layer.  Put in the program's place (the
control and the planted faults of ``calibrate_moe``) it chooses itself,
and ``fault`` plants a routing fault: ``"no_bias"`` leaves the correction
bias out of the choice, ``"unnormalised"`` leaves the weights
unnormalised (the scale kept).  Every product goes through ``mm``
(``reference.precision``); the experts are a loop, each on its rows."""

from __future__ import annotations

import torch

from . import towers
from .adamw import AdamW
from .loss import loss_and_grads
from .precision import matmul_for, strict_fp32


def _silu(x):
    return x * torch.sigmoid(x)


def _rms(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def _lin(p, name, x, mm):
    shape = x.shape
    y = mm(x.reshape(-1, shape[-1]), p[f"{name}.weight"].t())
    return y.reshape(*shape[:-1], -1)


def _rope(x, theta):
    s, r = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, r, 2, dtype=torch.float32, device=x.device) / r)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)[None, :, None, :]
    half = r // 2
    return x * torch.cos(ang) + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * torch.sin(ang)


def _attention(p, name, cfg, a, mask, mm):
    b, s, _ = a.shape
    h, n, r, dv = (cfg["num_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                   cfg["v_head_dim"])
    c_rank, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    q = _lin(p, f"{name}.q_proj", a, mm).view(b, s, h, n + r)
    ckv = _lin(p, f"{name}.kv_a_proj_with_mqa", a, mm)
    c = _rms(ckv[..., :c_rank], p[f"{name}.kv_a_layernorm.weight"], eps)
    kv = _lin(p, f"{name}.kv_b_proj", c, mm).view(b, s, h, n + dv)
    q_pe = _rope(q[..., n:], cfg["rope_theta"])
    k_pe = _rope(ckv[..., c_rank:].reshape(b, s, 1, r), cfg["rope_theta"]).expand(b, s, h, r)
    big_q = torch.cat([q[..., :n], q_pe], dim=-1).transpose(1, 2)
    big_k = torch.cat([kv[..., :n], k_pe], dim=-1).transpose(1, 2)
    logits = mm(big_q, big_k.transpose(-1, -2)) / (n + r) ** 0.5
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, None, :] == 0, float("-inf"))
    out = mm(torch.softmax(logits, dim=-1), kv[..., n:].transpose(1, 2))
    return _lin(p, f"{name}.o_proj", out.transpose(1, 2).reshape(b, s, h * dv), mm)


def _swiglu(p, name, x, mm):
    return _lin(p, f"{name}.down_proj", _silu(_lin(p, f"{name}.gate_proj", x, mm))
                * _lin(p, f"{name}.up_proj", x, mm), mm)


def _moe(p, name, cfg, m, mm, given, margins, chosen, fault):
    """The routed layer on tokens ``m`` ``[T, d]``."""
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(mm(m, p[f"{name}.gate.weight"].t()))
    with torch.no_grad():
        biased = scores + p[f"{name}.gate.e_score_correction_bias"]
        own = torch.topk(biased if fault != "no_bias" else scores, k, dim=-1).indices
        idx = own if given is None else given.to(device=m.device, dtype=torch.int64)
        if margins is not None:
            kth = torch.topk(biased, k, dim=-1).values[:, -1:]
            margins.append(float((kth - biased.gather(1, idx)).clamp_min(0).max()))
    if chosen is not None:
        chosen.append(idx)
    w = scores.gather(1, idx)
    if fault != "unnormalised":
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(m)
    # one unbind a weight, so the backward stacks the experts' gradients once
    gate_ups = p[f"{name}.experts.gate_up"].unbind(0)
    downs = p[f"{name}.experts.down"].unbind(0)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        gate, up = mm(m[tok], gate_ups[e]).chunk(2, dim=-1)
        y = mm(_silu(gate) * up, downs[e])
        out = out.index_add(0, tok, y * w[tok, slot, None])
    return out + _swiglu(p, f"{name}.shared_experts", m, mm)


def encode(p: dict, cfg: dict, x, mask=None, mm=torch.matmul, prefix: str = "text_tower.",
           given: list | None = None, margins: list | None = None,
           chosen: list | None = None, fault: str | None = None):
    """The tower's fp32 embeddings ``[B, embed_dim]``.  ``given``: a
    ``[B·S, k]`` choice a MoE layer to route by; ``margins`` and
    ``chosen`` collect each layer's route margin and choices."""
    x = x.float()
    b, s, _ = x.shape
    eps = cfg["rms_norm_eps"]
    h = _lin(p, f"{prefix}input_proj", x, mm) + p[f"{prefix}input_proj.bias"]
    j = 0
    for i in range(cfg["num_layers"]):
        name = f"{prefix}layers.{i}"
        a = _rms(h, p[f"{name}.input_layernorm.weight"], eps)
        h = h + _attention(p, f"{name}.self_attn", cfg, a, mask, mm)
        m = _rms(h, p[f"{name}.post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            h = h + _swiglu(p, f"{name}.mlp", m, mm)
            continue
        out = _moe(p, f"{name}.mlp", cfg, m.reshape(b * s, -1), mm,
                   None if given is None else given[j], margins, chosen, fault)
        h = h + out.view(b, s, -1)
        j += 1
    h = _rms(h, p[f"{prefix}norm.weight"], eps)
    if mask is None:
        pooled = h.mean(dim=1)
    else:
        w = mask.float()[:, :, None]
        pooled = (h * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
    return _lin(p, f"{prefix}output_proj", pooled, mm) + p[f"{prefix}output_proj.bias"]


def _inputs(batch, side, device, lo, hi):
    x = batch[side][lo:hi].to(device).float()
    mask = batch.get(f"{side}_mask")
    return x, None if mask is None else mask[lo:hi].to(device)


def _both(p, config, batch, device, lo, hi, mm, routes, margins, chosen, fault):
    """Both towers' embeddings of rows ``[lo, hi)``; ``routes`` the step's
    ``[B·S, k]`` choices a MoE layer (None: the reference chooses)."""
    s = config["text_tower"]["max_seq_len"]
    given = None if routes is None else [r[lo * s:hi * s] for r in routes]
    v = towers.encode(p, config, "video", *_inputs(batch, "video", device, lo, hi), mm=mm)
    t = encode(p, config["text_tower"], *_inputs(batch, "text", device, lo, hi), mm=mm,
               given=given, margins=margins, chosen=chosen, fault=fault)
    return v, t


def run(config: dict, init: dict, batches: list[dict], *, device: str, block: int,
        loss_block: int, routes: list | None = None, buffers: tuple = (),
        precision: str = "fp32", fault: str | None = None) -> dict:
    """The first steps from ``init`` on ``batches``, as
    ``reference.trajectory.run`` takes them (towers in row blocks, the loss
    in anchor blocks, AdamW), the MoE layers routed by ``routes`` (a list a
    step of ``[B·S, k]`` choices a layer) or, without them, by the
    reference's own choice.  ``buffers`` are leaves of ``init`` that are
    not parameters (the correction biases): used, never updated.  Returns
    the losses, the first step's clipped gradient norms and the change
    norms by parameter, ``route_margin`` (the largest over the steps;
    nought without ``routes``) and ``routes`` (the choices routed by)."""
    strict_fp32()
    mm = matmul_for(precision)
    train = config["train"]
    values = {k: v.to(device=device, dtype=torch.float32).clone() for k, v in init.items()}
    params = {k: v for k, v in values.items() if k not in buffers}
    opt = AdamW(train, params)
    losses, first, margin, taken = [], None, 0.0, []
    for step, batch in enumerate(batches):
        n = batch["video"].shape[0]
        given = None if routes is None else routes[step]
        margins = [] if given is not None else None
        chosen_blocks = []
        embs = {"v": [], "t": []}
        with torch.no_grad():
            for lo in range(0, n, block):
                chosen = [] if given is None else None
                v, t = _both(values, config, batch, device, lo, lo + block, mm, given,
                             margins, chosen, fault)
                embs["v"].append(v)
                embs["t"].append(t)
                chosen_blocks.append(chosen)
        if given is None:
            given = [torch.cat(layer) for layer in zip(*chosen_blocks)]
        else:
            margin = max([margin, *margins])
        taken.append(given)
        loss, d_v, d_t = loss_and_grads(
            torch.cat(embs["v"]), torch.cat(embs["t"]), temperature=train["temperature"],
            negative_weight=train["negative_weight"], mm=mm, block=loss_block)
        del embs
        leaves = {k: v.detach().requires_grad_(k in params) for k, v in values.items()}
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        for lo in range(0, n, block):
            v, t = _both(leaves, config, batch, device, lo, lo + block, mm, given, None,
                         None, fault)
            got = torch.autograd.grad([v, t], [leaves[k] for k in params],
                                      grad_outputs=[d_v[lo:lo + block], d_t[lo:lo + block]],
                                      allow_unused=True)
            for key, g in zip(params, got):
                if g is not None:
                    grads[key] += g
        del leaves, d_v, d_t
        fed = opt.update(params, grads)
        if first is None:
            first = {k: float(torch.linalg.vector_norm(g)) for k, g in fed.items()}
        losses.append(loss)
    change = {k: float(torch.linalg.vector_norm(params[k] - init[k].to(device)))
              for k in params}
    return {"losses": losses, "grad_norms": first, "change_norms": change,
            "route_margin": margin, "routes": taken}
