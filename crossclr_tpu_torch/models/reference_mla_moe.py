"""The plain float32 reference of the ``"mla_moe"`` tower
(:mod:`models.mla_moe`), for the tests that hold the tower to it.  It
imports only ``torch``: no kernel of the port, no grouped product, no
permutation.  Every product is a float32 ``matmul`` with TF32 off, the
routed experts a loop over the experts, each on the tokens that chose it.

Parameters are a ``{name: tensor}`` dict under the tower's state_dict
names (``layers.1.mlp.experts.gate_up``, ``layers.0.self_attn.q_proj.
weight``; projections ``[out, in]``, grouped experts ``[E, in, out]``),
with a prefix such as ``text_tower.``; ``cfg`` is the tower's
``TowerConfig``.

The layer equations are DeepSeek-V3's (Moonlight-16B-A3B's config:
latent attention without query compression, rotate-half RoPE on the
shared rope key, the sigmoid router with its correction bias choosing
the top k, normalised and scaled weights, SwiGLU experts and shared
experts, RMSNorm), with these departures from the published model, all
the tower's:

* the input is the store's per-token features through ``input_proj``
  (with a bias), not the token-embedding table; there is no vocabulary;
* there is no LM head: the output is the masked mean of the final norm,
  then ``output_proj`` to ``embed_dim``, in float32;
* attention is bidirectional under the key-padding mask, not causal;
* the router's correction bias is a fixed buffer (DeepSeek-V3 moves it
  between steps by the experts' loads, and adds a sequence-wise balance
  loss; neither is computed here);
* with ``choices`` the routing is given, not chosen (the weights are still
  the reference's own scores at the given experts).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["encode"]


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * weight


def _lin(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p[f"{name}.weight"].t())


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of ``[B, S, heads, r]`` at positions ``0..S−1``."""
    s, r = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, r, 2, dtype=torch.float32, device=x.device) / r)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)[None, :, None, :]
    half = r // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * torch.cos(ang) + rotated * torch.sin(ang)


def _attention(p: dict, name: str, cfg, a: torch.Tensor, mask) -> torch.Tensor:
    b, s, _ = a.shape
    h, n, r, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q = _lin(p, f"{name}.q_proj", a).view(b, s, h, n + r)
    ckv = _lin(p, f"{name}.kv_a_proj_with_mqa", a)
    c, k_pe = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    c = _rms(c, p[f"{name}.kv_a_layernorm.weight"], cfg.rms_norm_eps)
    kv = _lin(p, f"{name}.kv_b_proj", c).view(b, s, h, n + dv)
    k_nope, v = kv[..., :n], kv[..., n:]
    q_pe = _rope(q[..., n:], cfg.rope_theta)
    k_pe = _rope(k_pe.reshape(b, s, 1, r), cfg.rope_theta).expand(b, s, h, r)
    big_q = torch.cat([q[..., :n], q_pe], dim=-1).transpose(1, 2)
    big_k = torch.cat([k_nope, k_pe], dim=-1).transpose(1, 2)
    logits = torch.matmul(big_q, big_k.transpose(-1, -2)) / (n + r) ** 0.5
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, None, :] == 0, float("-inf"))
    out = torch.matmul(torch.softmax(logits, dim=-1), v.transpose(1, 2))
    return _lin(p, f"{name}.o_proj", out.transpose(1, 2).reshape(b, s, h * dv))


def _swiglu(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return _lin(p, f"{name}.down_proj",
                _silu(_lin(p, f"{name}.gate_proj", x)) * _lin(p, f"{name}.up_proj", x))


def moe(p: dict, name: str, cfg, m: torch.Tensor, choices=None):
    """The routed layer on tokens ``m`` ``[T, d]``: ``(output, choices)``."""
    scores = torch.sigmoid(torch.matmul(m, p[f"{name}.gate.weight"].t()))
    if choices is None:
        biased = scores + p[f"{name}.gate.e_score_correction_bias"]
        choices = torch.topk(biased, cfg.num_experts_per_tok, dim=-1).indices
    w = scores.gather(1, choices)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    out = torch.zeros_like(m)
    gate_ups = p[f"{name}.experts.gate_up"].unbind(0)
    downs = p[f"{name}.experts.down"].unbind(0)
    for e in range(cfg.n_routed_experts):
        tok, slot = (choices == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        gate, up = torch.matmul(m[tok], gate_ups[e]).chunk(2, dim=-1)
        y = torch.matmul(_silu(gate) * up, downs[e])
        out = out.index_add(0, tok, y * w[tok, slot, None])
    return out + _swiglu(p, f"{name}.shared_experts", m), choices


@contextlib.contextmanager
def _strict_fp32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def encode(p: dict, cfg, x: torch.Tensor, mask=None, prefix: str = "",
           choices: list | None = None, chosen: list | None = None) -> torch.Tensor:
    """The tower's float32 embeddings ``[B, embed_dim]`` of ``x`` ``[B, S,
    input_dim]``.  ``choices`` (a ``[B·S, k]`` tensor a MoE layer) routes
    by given experts; the choices made are appended to ``chosen``."""
    with _strict_fp32():
        x = x.float()
        b, s, _ = x.shape
        h = _lin(p, f"{prefix}input_proj", x) + p[f"{prefix}input_proj.bias"]
        moe_index = 0
        for i in range(cfg.num_layers):
            name = f"{prefix}layers.{i}"
            a = _rms(h, p[f"{name}.input_layernorm.weight"], cfg.rms_norm_eps)
            h = h + _attention(p, f"{name}.self_attn", cfg, a, mask)
            m = _rms(h, p[f"{name}.post_attention_layernorm.weight"], cfg.rms_norm_eps)
            if i < cfg.first_k_dense_replace:
                h = h + _swiglu(p, f"{name}.mlp", m)
                continue
            given = None if choices is None else choices[moe_index]
            out, made = moe(p, f"{name}.mlp", cfg, m.reshape(b * s, -1), given)
            if chosen is not None:
                chosen.append(made)
            h = h + out.view(b, s, -1)
            moe_index += 1
        h = _rms(h, p[f"{prefix}norm.weight"], cfg.rms_norm_eps)
        if mask is None:
            pooled = h.mean(dim=1)
        else:
            w = mask.float()[:, :, None]
            pooled = (h * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
        return _lin(p, f"{prefix}output_proj", pooled) + p[f"{prefix}output_proj.bias"]
