"""A DeepSeek-V3 text tower: latent attention (MLA) and routed experts
(``TowerConfig.kind = "mla_moe"``), at the widths of a published model
such as Moonlight-16B-A3B, over the per-token features the CrossCLR towers
read.

The equations, with ``h`` the residual stream ``[B, S, d]`` in the compute
dtype (bf16) and every product in that dtype with fp32 accumulation
unless it says otherwise:

* **Input.** ``h = input_proj(x)``: ``input_dim → d`` with a bias.  No
  learned positions: RoPE places the tokens.
* **MLA, every layer.** ``a = RMSNorm(h)`` in fp32 (eps ``rms_norm_eps``).
  ``q = a·W_q`` (``d → H·(n + r)``, n = ``qk_nope_head_dim``, r =
  ``qk_rope_head_dim``), split per head into ``q_nope`` (n) and ``q_pe``
  (r).  ``[c | k_pe] = a·W_kva`` (``d → kv_lora_rank + r``).
  ``[k_nope | v] = RMSNorm_kv(c)·W_kvb`` (``kv_lora_rank → H·(n +
  v_head_dim)``).  RoPE with rotate-half, ``θ = rope_theta``, positions
  ``0..S−1``, on ``q_pe`` and on the one ``k_pe`` the heads share (a
  checkpoint's interleaved layout is a fixed permutation of those weight
  rows).  ``Q = [q_nope | q_pe]``, ``K = [k_nope | k_pe]`` (width n + r),
  ``V = v``; ``O = softmax(QKᵀ/√(n + r) under the key mask)·V``;
  ``h += O·W_o`` (``H·v_head_dim → d``).  Attention is bidirectional
  under the key-padding mask (an encoder, as LLM2Vec makes one of a
  decoder).
* **MLP, every layer**, on ``m = RMSNorm(h)``.  The first
  ``first_k_dense_replace`` layers: ``h += W_down(silu(W_gate·m) ⊙
  W_up·m)`` at width ``hidden_dim``.  The others:
  - the router, in fp32: ``s = sigmoid(m·W_r)`` (``n_routed_experts``
    outputs); the top ``num_experts_per_tok`` of ``s + b``, ``b`` the
    correction-bias buffer ``e_score_correction_bias``; the weights are
    ``s`` at the chosen experts over their sum + 1e-20, times
    ``routed_scaling_factor``;
  - ``h += Σ_k w_k·E_{i_k}(m) + S(m)``, ``E`` the routed SwiGLU experts
    at width ``moe_intermediate_size`` and ``S`` the shared one at
    ``n_shared_experts`` times that, no biases.  Dropless: no capacity
    limit, no token dropped.
* **Output.** A final RMSNorm, the mean over the valid positions (fp32),
  then ``output_proj`` (``d → embed_dim``) in fp32, as the other towers'.

How it runs.  The routed experts' products are grouped matrix products
over the experts (``torch._grouped_mm``: bf16, fp32 accumulation), one
launch for gate and up together and one for down, a layer; the tokens
are permuted into expert order on the device (a stable sort of the
choices; ``torch._grouped_mm`` takes groups of any size, so none is
padded), and each token's outputs are gathered back and summed under its
weights.  Nothing in the step waits on the host.  Expert weights are held
``[experts, in, out]``.  Attention is ``ops.flash_attention`` (the CUDA
kernels at query/key width 192 and value width 128, the values padded;
the plain version on CPU tensors): the kind takes ``attention="flash"``
only, and refuses ``"ring"`` and a model axis: sequence, tensor and
expert parallelism are not written for it.

Routing across passes.  :func:`routing` makes a forward's MoE layers
record their choices, or replay given ones: GradCache's pass 3 re-runs
each chunk with pass 1's choices, so its gradients belong to the model
whose loss pass 2 took.  Each layer adds its tokens per expert to the
tower's ``expert_load`` (``[MoE layers, experts]``, on the device) in
every forward that chooses.

Spans (``utils.profiling.span``, recorded only under a profiler or
``recording()``): ``mla.attention`` (count: tokens), ``moe.route`` (the
router, top-k and permutation; count: routed rows, tokens × top-k),
``moe.experts`` (the routed and shared products; count: routed rows) and
``moe.combine`` (the weighted gather back).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from ..utils.profiling import span

__all__ = ["MLAMoETower", "MoE", "dispatch", "routing"]


def _mm(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x·wᵀ`` in ``dtype`` (``w`` a ``[out, in]`` weight)."""
    return torch.matmul(x.to(dtype), w.to(dtype).t())


class RMSNorm(nn.Module):
    """``x / sqrt(mean(x²) + eps) · weight`` in fp32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * self.weight


def _linear(n_in: int, n_out: int) -> nn.Parameter:
    """A bias-free ``[out, in]`` weight, filled by the trainer's init or a
    state_dict."""
    return nn.Parameter(torch.empty(n_out, n_in))


class _Proj(nn.Module):
    """A bias-free projection whose state_dict key is ``<name>.weight``."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype):
        super().__init__()
        self.weight = _linear(n_in, n_out)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _mm(x, self.weight, self.dtype)


class SwiGLU(nn.Module):
    """``down(silu(gate(x)) ⊙ up(x))``, no biases."""

    def __init__(self, dim: int, width: int, dtype: torch.dtype):
        super().__init__()
        self.gate_proj = _Proj(dim, width, dtype)
        self.up_proj = _Proj(dim, width, dtype)
        self.down_proj = _Proj(width, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of ``x`` ``[B, S, heads, r]`` at positions
    ``0..S−1``, in fp32, returned in x's dtype."""
    s, r = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, r, 2, device=x.device, dtype=torch.float32) / r)
    freqs = torch.outer(torch.arange(s, device=x.device, dtype=torch.float32), inv)
    emb = torch.cat([freqs, freqs], dim=-1)[None, :, None, :]
    xf = x.float()
    half = r // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * emb.cos() + rotated * emb.sin()).to(x.dtype)


class MLA(nn.Module):
    """Multi-head latent attention without query compression
    (``q_lora_rank`` null): the module doc's MLA equations, DeepSeek's
    parameter names."""

    def __init__(self, cfg):
        super().__init__()
        d, h, dt = cfg.model_dim, cfg.num_heads, cfg.dtype
        self.cfg = cfg
        self.q_proj = _Proj(d, h * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim), dt)
        self.kv_a_proj_with_mqa = _Proj(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dt)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = _Proj(cfg.kv_lora_rank,
                               h * (cfg.qk_nope_head_dim + cfg.v_head_dim), dt)
        self.o_proj = _Proj(h * cfg.v_head_dim, d, dt)

    def forward(self, a: torch.Tensor, mask) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = a.shape
        h, n, r, dv = (cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                       cfg.v_head_dim)
        a = a.to(cfg.dtype)
        q = self.q_proj(a).view(b, s, h, n + r)
        c, k_pe = self.kv_a_proj_with_mqa(a).split([cfg.kv_lora_rank, r], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c)).view(b, s, h, n + dv)
        k_nope, v = kv.split([n, dv], dim=-1)
        q_pe = rope(q[..., n:], cfg.rope_theta)
        k_pe = rope(k_pe.reshape(b, s, 1, r), cfg.rope_theta).expand(b, s, h, r)
        big_q = torch.cat([q[..., :n], q_pe], dim=-1).transpose(1, 2)
        big_k = torch.cat([k_nope, k_pe], dim=-1).transpose(1, 2)
        out = flash_attention(big_q, big_k, v.transpose(1, 2), mask)
        return self.o_proj(out.transpose(1, 2).reshape(b, s, h * dv).to(cfg.dtype))


class Router(nn.Module):
    """The sigmoid gate: ``weight`` ``[experts, d]`` (trained) and the
    correction bias ``e_score_correction_bias`` (a buffer: it moves the
    choice, not the weights)."""

    def __init__(self, cfg):
        super().__init__()
        self.weight = _linear(cfg.model_dim, cfg.n_routed_experts)
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(cfg.n_routed_experts))


class Experts(nn.Module):
    """The routed experts' weights, grouped: ``gate_up`` ``[E, d, 2·w]``
    (gate in the first ``w`` columns, up in the rest) and ``down`` ``[E,
    w, d]``."""

    def __init__(self, cfg):
        super().__init__()
        e, d, w = cfg.n_routed_experts, cfg.model_dim, cfg.moe_intermediate_size
        self.gate_up = nn.Parameter(torch.empty(e, d, 2 * w))
        self.down = nn.Parameter(torch.empty(e, w, d))


def dispatch(idx: torch.Tensor, experts: int):
    """The grouped layout of the ``[T, k]`` choices ``idx``: ``(order,
    offs, counts)``, ``order`` ``[T·k]`` the (token, choice) slot, in
    token-major numbering, of each grouped row (expert by expert, tokens in
    order within an expert: a stable sort), ``offs`` the groups' ends
    (int32, ``[experts]``) and ``counts`` each expert's rows.  Nothing is
    read back to the host."""
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    # not bincount: on a CUDA tensor it reads the largest choice back to the host
    counts = torch.zeros(experts, dtype=torch.int64, device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    return order, torch.cumsum(counts, 0).to(torch.int32), counts


class MoE(nn.Module):
    """The routed layer: router, dispatch, grouped SwiGLU experts, shared
    expert, weighted combine (the module doc's equations).  ``load`` is
    the tower's ``expert_load`` and ``index`` this layer's row of it."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.gate = Router(cfg)
        self.experts = Experts(cfg)
        self.shared_experts = SwiGLU(cfg.model_dim,
                                     cfg.n_shared_experts * cfg.moe_intermediate_size,
                                     cfg.dtype)
        self.index = 0
        self.load: torch.Tensor | None = None
        self.route_log: list | None = None  # set by routing()
        self.replay: torch.Tensor | None = None

    def choose(self, m32: torch.Tensor):
        """``(scores, idx)``: the fp32 sigmoid scores ``[T, E]`` and the
        top-k choices of ``scores + bias`` (or the replayed ones)."""
        scores = torch.sigmoid(torch.matmul(m32, self.gate.weight.t()))
        if self.replay is not None:
            idx = self.replay
        else:
            with torch.no_grad():
                biased = scores + self.gate.e_score_correction_bias
                idx = torch.topk(biased, self.cfg.num_experts_per_tok, dim=-1).indices
        return scores, idx

    def weights(self, scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The chosen experts' scores over their sum + 1e-20, times the
        routed scale (fp32, ``[T, k]``)."""
        w = scores.gather(1, idx)
        return w / (w.sum(-1, keepdim=True) + 1e-20) * self.cfg.routed_scaling_factor

    def forward(self, m32: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        shape = m32.shape
        m32 = m32.reshape(-1, shape[-1])
        t, k, e = m32.shape[0], cfg.num_experts_per_tok, cfg.n_routed_experts
        x = m32.to(dt)
        with span("moe.route", t * k):
            scores, idx = self.choose(m32)
            w = self.weights(scores, idx)
            order, offs, counts = dispatch(idx, e)
            if self.replay is None and self.load is not None:
                with torch.no_grad():
                    self.load[self.index] += counts
            if self.route_log is not None:
                self.route_log.append(idx.detach())
            # each token's row k times, then in expert order: the backward
            # sums a token's k rows in one reduction, not by scattered adds
            slots = x[:, None, :].expand(t, k, shape[-1]).reshape(t * k, -1)
            grouped = slots.index_select(0, order)
        with span("moe.experts", t * k):
            # rows offs[g-1]:offs[g] times expert g's weight, all in one launch
            hidden = torch._grouped_mm(grouped, self.experts.gate_up.to(dt), offs=offs)
            gate, up = hidden.chunk(2, dim=-1)
            routed = torch._grouped_mm(F.silu(gate) * up, self.experts.down.to(dt),
                                       offs=offs)
            shared = self.shared_experts(x)
        with span("moe.combine", t * k):
            per_token = torch.empty_like(routed).index_copy(0, order, routed)
            out = (per_token.view(t, k, -1) * w.to(dt)[..., None]).sum(1) + shared
        return out.view(*shape[:-1], -1)


class Layer(nn.Module):
    """One decoder layer read as an encoder: MLA, then the dense MLP or
    the MoE, each pre-normed, with residual adds."""

    def __init__(self, cfg, dense: bool):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = RMSNorm(cfg.model_dim, cfg.rms_norm_eps)
        self.self_attn = MLA(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.model_dim, cfg.rms_norm_eps)
        self.mlp = (SwiGLU(cfg.model_dim, cfg.hidden_dim, cfg.dtype) if dense
                    else MoE(cfg))

    def forward(self, h: torch.Tensor, mask) -> torch.Tensor:
        b, s, _ = h.shape
        with span("mla.attention", b * s):
            h = h + self.self_attn(self.input_layernorm(h), mask)
        m = self.post_attention_layernorm(h)
        if isinstance(self.mlp, MoE):
            return h + self.mlp(m)
        return h + self.mlp(m.to(self.cfg.dtype))


class MLAMoETower(nn.Module):
    """The ``"mla_moe"`` tower over ``[B, S, input_dim]`` feature sequences
    (``mask`` ``[B, S]``, 1 = valid): ``input_proj``, ``num_layers``
    layers (the first ``first_k_dense_replace`` dense), the final norm,
    the masked mean and ``output_proj`` to ``embed_dim``."""

    def __init__(self, cfg, mesh=None, shards=None):
        super().__init__()
        if cfg.attention != "flash":
            raise ValueError(
                f"the mla_moe tower takes attention 'flash', not {cfg.attention!r}: "
                "sequence parallelism is not written for it")
        if shards is not None or (mesh is not None and mesh.n_model > 1):
            raise ValueError(
                "the mla_moe tower runs on a data axis only: tensor and expert "
                "parallelism over a model axis are not written for it")
        from .encoders import Dense

        self.cfg = cfg
        self.input_proj = Dense(cfg.input_dim, cfg.model_dim, cfg.dtype)
        self.layers = nn.ModuleList(
            Layer(cfg, i < cfg.first_k_dense_replace) for i in range(cfg.num_layers))
        self.moe_layers = [layer.mlp for layer in self.layers
                           if isinstance(layer.mlp, MoE)]
        # tokens per expert, added to by every forward that chooses
        self.register_buffer("expert_load", torch.zeros(
            len(self.moe_layers), cfg.n_routed_experts, dtype=torch.int64),
            persistent=False)
        for i, layer in enumerate(self.moe_layers):
            layer.index = i
        self.norm = RMSNorm(cfg.model_dim, cfg.rms_norm_eps)
        self.output_proj = Dense(cfg.model_dim, cfg.embed_dim, torch.float32)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        cfg = self.cfg
        for layer in self.moe_layers:  # the buffer as it lives now (after .to())
            layer.load = self.expert_load
        h = self.input_proj(x)
        for layer in self.layers:
            h = layer(h, mask)
        h = self.norm(h)
        if mask is None:
            pooled = h.mean(dim=1)
        else:
            w = mask.float()[:, :, None]
            pooled = (h * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
        return self.output_proj(pooled)


def moe_layers(model: nn.Module) -> list:
    """The MoE layers of a tower or a ``DualEncoder``, in forward order."""
    out = []
    for tower in (model, getattr(model, "video_tower", None),
                  getattr(model, "text_tower", None)):
        out += getattr(tower, "moe_layers", [])
    return out


@contextlib.contextmanager
def routing(model: nn.Module, replay: list | None = None):
    """Within the block, ``model``'s MoE layers append the choices each
    forward makes (or replays) to the yielded list, in layer order; with
    ``replay`` (such a list) layer ``i`` takes ``replay[i]`` in place of
    choosing.  A model without MoE layers yields an empty list."""
    layers = moe_layers(model)
    chosen: list = []
    if replay is not None and len(replay) != len(layers):
        raise ValueError(f"{len(replay)} routes replayed over {len(layers)} MoE layers")
    for i, layer in enumerate(layers):
        layer.route_log = chosen
        layer.replay = None if replay is None else replay[i]
    try:
        yield chosen
    finally:
        for layer in layers:
            layer.route_log = layer.replay = None

