"""Dual video/text encoder towers as ``nn.Module``s.

Counterpart of ``crossclr_tpu/models/encoders.py``.  Submodule names equal
the Flax module names, so a state_dict key is the Flax parameter path
(``block_0._MHA_0.query.weight``, ``block_0.LayerNorm_1.bias``,
``input_proj.weight``, ``pos_embed``) with Flax's ``kernel``/``scale`` leaf
read as ``weight``; ``utils.params.state_dict_from_flax`` moves weights
across.

The arithmetic follows the Flax towers step by step:

* ``Dense(dtype=bf16)`` casts input and weight to the compute dtype, runs
  the product, then adds the bias in that dtype (:class:`Dense`);
* LayerNorm runs in fp32 with eps 1e-6;
* GELU is the tanh approximation;
* ``pos_embed`` is cast to the compute dtype before the add;
* pooling is a masked mean in fp32 and ``output_proj`` runs in fp32.

``attention="ring"`` towers run sequence-parallel over the model group of
a ``parallel.Mesh`` (:func:`parallel.ring_attention`): each rank keeps its
``S / n_model`` tokens from ``input_proj`` to the pooling, adds its window
of ``pos_embed``, and sums and counts its tokens for the masked mean; the
sums and counts are added over the model group (:class:`_ModelSum`, whose
backward adds the ranks' cotangents too), so every rank of the group
pools the whole sequence.  Ring and flash towers share their parameter
names (``_MHA_0``), so a checkpoint moves between them.

Parameters stay fp32 and autograd runs through the casts, so both kinds
of tower train.  Dropout acts in train mode only: ``MLPTower`` applies
``nn.Dropout`` after the GELU, and the transformer towers with
``attention="flash"`` or ``"ring"`` apply the flash kernels'
attention-probability dropout, one seed in [0, 2^23) per attention call
drawn from the ``torch.Generator`` that :class:`DualEncoder` holds (the
trainer reseeds it every step); a ring tower places its rows at their
data coordinate's place in the global batch, so a grid drops what one
device drops on the whole batch.  ``attention="xla"`` has no dropout: its
JAX counterpart draws the mask from ``jax.random``, which the port cannot
reproduce.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention
from ..parallel.ring_attention import ring_attention

__all__ = ["DualEncoder", "MLPTower", "TowerConfig", "TransformerTower"]

_LN_EPS = 1e-6  # flax.linen.LayerNorm default
_SEED_RANGE = 1 << 23  # the flash kernels' seeds, as the JAX _MHA draws them


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    """Static architecture config for one tower; the fields and defaults
    of the JAX ``TowerConfig``, so the JSON configs load.  ``attention``
    takes ``"xla"`` (the Flax ``MultiHeadDotProductAttention`` arithmetic
    in plain PyTorch), ``"flash"`` (:func:`ops.flash_attention`: the CUDA
    kernel on a CUDA tensor) or ``"ring"`` (:func:`parallel.ring_attention`
    over a mesh's model group, its blocks by ``ring_block_impl`` and
    ``ring_interpret``).  ``remat`` is accepted by the config and waits for
    a later port."""

    kind: str = "mlp"  # "mlp" | "transformer"
    input_dim: int = 512
    embed_dim: int = 256
    hidden_dim: int = 1024
    num_layers: int = 2
    num_heads: int = 8
    max_seq_len: int = 32
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    attention: str = "xla"
    ring_block_impl: str = "auto"
    ring_interpret: bool = False


class Dense(nn.Linear):
    """``flax.linen.Dense`` with ``dtype``: the product in the compute
    dtype, then the bias added in that dtype."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return torch.matmul(x.to(dt), self.weight.to(dt).t()) + self.bias.to(dt)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=_LN_EPS)


class MLPTower(nn.Module):
    """Residual MLP blocks over pooled features, then an fp32 LayerNorm;
    block 0 reads ``input_dim``, later blocks ``embed_dim``."""

    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.cfg = cfg
        in_dim = cfg.input_dim
        self.num_blocks = max(cfg.num_layers, 1)
        for layer in range(self.num_blocks):
            suffix = "" if layer == 0 else f"_{layer}"
            self.add_module(f"skip{suffix}", Dense(in_dim, cfg.embed_dim, cfg.dtype))
            self.add_module(f"fc1{suffix}", Dense(in_dim, cfg.hidden_dim, cfg.dtype))
            self.add_module(
                f"fc2{suffix}", Dense(cfg.hidden_dim, cfg.embed_dim, cfg.dtype)
            )
            in_dim = cfg.embed_dim
        self.norm = _ln(cfg.embed_dim)
        # no parameters: the state_dict keys stay the Flax paths
        self.dropout = nn.Dropout(cfg.dropout) if cfg.dropout > 0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.cfg.dtype)
        for layer in range(self.num_blocks):
            suffix = "" if layer == 0 else f"_{layer}"
            skip = self.get_submodule(f"skip{suffix}")(h)
            y = _gelu(self.get_submodule(f"fc1{suffix}")(h))
            if self.dropout is not None:
                y = self.dropout(y)
            h = skip + self.get_submodule(f"fc2{suffix}")(y)
        return self.norm(h.float())


class _HeadProjections(nn.Module):
    """The q/k/v/out projections of Flax multi-head attention, held as
    ``[E, E]`` Linears (Flax's ``[E, H, Dh]`` / ``[H, Dh, E]`` kernels
    flattened)."""

    def __init__(self, cfg: TowerConfig):
        super().__init__()
        if cfg.embed_dim % cfg.num_heads:
            raise ValueError(
                f"embed_dim {cfg.embed_dim} not divisible by num_heads "
                f"{cfg.num_heads}"
            )
        self.cfg = cfg
        self.heads = cfg.num_heads
        self.head_dim = cfg.embed_dim // cfg.num_heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, Dense(cfg.embed_dim, cfg.embed_dim, cfg.dtype))

    def _split(self, x: torch.Tensor, name: str) -> torch.Tensor:
        b, s, _ = x.shape
        return self.get_submodule(name)(x).view(b, s, self.heads, self.head_dim)

    def _merge(self, o: torch.Tensor) -> torch.Tensor:
        b, s = o.shape[:2]
        return self.out(o.reshape(b, s, self.heads * self.head_dim))


def _ring_attend(q, k, v, mask=None, *, cfg: TowerConfig, mesh,
                 dropout_rate: float = 0.0, dropout_seed=0):
    """The ``attention="ring"`` core: this rank's sequence shard through
    :func:`parallel.ring_attention` over the mesh's model group, its rows at
    ``data_index · B · H`` in the global batch·head range."""
    return ring_attention(
        q, k, v, mask, group=mesh.model_group, block_impl=cfg.ring_block_impl,
        interpret=cfg.ring_interpret, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed,
        dropout_bh_offset=mesh.data_index * q.shape[0] * q.shape[1])


class _MHA(_HeadProjections):
    """``crossclr_tpu.models.encoders._MHA`` (attention="flash" or
    "ring"): the attention core is :func:`ops.flash_attention`, which
    launches the CUDA kernels on CUDA tensors, or the ring over ``mesh``.
    ``attend`` is the core as an attribute, so a check can swap in the
    plain version on the same weights.  In train mode with
    ``cfg.dropout > 0`` each call draws its dropout seed from
    ``dropout_gen``, as the JAX ``_MHA`` draws one per call and step."""

    def __init__(self, cfg: TowerConfig, dropout_gen: torch.Generator, mesh=None):
        super().__init__(cfg)
        self.attend = (flash_attention if cfg.attention == "flash"
                       else functools.partial(_ring_attend, cfg=cfg, mesh=mesh))
        self.dropout_gen = dropout_gen

    def forward(self, x, mask):
        # [B, S, H, Dh] -> [B, H, S, Dh]
        q, k, v = (
            self._split(x, n).transpose(1, 2) for n in ("query", "key", "value")
        )
        if self.training and self.cfg.dropout > 0:
            seed = int(torch.randint(0, _SEED_RANGE, (),
                                     generator=self.dropout_gen))
            out = self.attend(q, k, v, mask, dropout_rate=self.cfg.dropout,
                              dropout_seed=seed)
        else:
            out = self.attend(q, k, v, mask)
        return self._merge(out.transpose(1, 2).to(self.cfg.dtype))


class MultiHeadDotProductAttention(_HeadProjections):
    """``flax.linen.MultiHeadDotProductAttention`` (attention="xla") in its
    own arithmetic: the query divided by sqrt(Dh) and both products in the
    compute dtype, the mask ``query_valid ⊗ key_valid`` applied with the
    dtype's most negative finite value, and the softmax in the compute
    dtype."""

    def forward(self, x, mask):
        if self.training and self.cfg.dropout > 0:
            raise NotImplementedError(
                "attention='xla' dropout is not ported to crossclr_tpu_torch "
                "(ROADMAP queue 1 item 10): its JAX mask comes from "
                "jax.random; use attention='flash'"
            )
        dt = self.cfg.dtype
        q, k, v = (self._split(x, n) for n in ("query", "key", "value"))
        q = q / torch.tensor(self.head_dim**0.5, dtype=torch.float32).to(dt)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            m = mask.to(dt)
            pair = (m[:, :, None] * m[:, None, :])[:, None]  # [B, 1, S, S]
            logits = torch.where(
                pair != 0, logits,
                torch.tensor(torch.finfo(dt).min, dtype=dt, device=x.device),
            )
        weights = torch.softmax(logits, dim=-1).to(dt)
        return self._merge(torch.einsum("bhqk,bkhd->bqhd", weights, v))


_ATTENTION = {"flash": "_MHA_0", "ring": "_MHA_0",
              "xla": "MultiHeadDotProductAttention_0"}


class _Block(nn.Module):
    """Pre-norm transformer block (``LayerNorm_0``, attention,
    ``LayerNorm_1``, ``Dense_0``, ``Dense_1``)."""

    def __init__(self, cfg: TowerConfig, dropout_gen: torch.Generator, mesh=None):
        super().__init__()
        if cfg.attention not in _ATTENTION:
            raise ValueError(f"unknown attention impl {cfg.attention!r}")
        self.cfg = cfg
        self.LayerNorm_0 = _ln(cfg.embed_dim)
        self.attn_name = _ATTENTION[cfg.attention]
        self.add_module(self.attn_name,
                        MultiHeadDotProductAttention(cfg) if cfg.attention == "xla"
                        else _MHA(cfg, dropout_gen, mesh))
        self.LayerNorm_1 = _ln(cfg.embed_dim)
        self.Dense_0 = Dense(cfg.embed_dim, cfg.hidden_dim, cfg.dtype)
        self.Dense_1 = Dense(cfg.hidden_dim, cfg.embed_dim, cfg.dtype)

    def forward(self, x, mask):
        dt = self.cfg.dtype
        y = self.LayerNorm_0(x.float()).to(dt)
        x = x + self.get_submodule(self.attn_name)(y, mask)
        y = self.LayerNorm_1(x.float()).to(dt)
        return x + self.Dense_1(_gelu(self.Dense_0(y)))


class _ModelSum(torch.autograd.Function):
    """The sum of ``x`` over a model group, on every rank; its backward
    sums the ranks' cotangents the same way.  Each rank differentiates
    ``1/n_model`` of the loss of the pooled rows it shares with the group,
    so the sum hands each rank the whole loss's cotangent for its tokens."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class TransformerTower(nn.Module):
    """Transformer encoder over ``[B, S, input_dim]`` feature sequences:
    learned positions, pre-norm blocks, masked mean pooling, projection to
    ``embed_dim``.  ``mask``: ``[B, S]`` (1 = valid).  ``dropout_gen`` is
    the generator its attention-dropout seeds come from (the one
    :class:`DualEncoder` holds and reseeds).  ``mesh`` (a
    ``parallel.Mesh``) is needed by ``attention="ring"`` alone: every rank
    of its model group takes the same rows and runs its sequence shard."""

    def __init__(self, cfg: TowerConfig, dropout_gen: torch.Generator, mesh=None):
        super().__init__()
        if cfg.attention == "ring" and mesh is None:
            raise ValueError(
                "attention='ring' needs a mesh: construct the "
                "DualEncoder/TransformerTower with mesh=..."
            )
        self.cfg = cfg
        # the model axis this tower's sequence is sharded over (ring only)
        self.mesh = mesh if cfg.attention == "ring" else None
        self.input_proj = Dense(cfg.input_dim, cfg.embed_dim, cfg.dtype)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_seq_len, cfg.embed_dim))
        for layer in range(cfg.num_layers):
            self.add_module(f"block_{layer}", _Block(cfg, dropout_gen, mesh))
        self.final_norm = _ln(cfg.embed_dim)
        self.output_proj = Dense(cfg.embed_dim, cfg.embed_dim, torch.float32)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        cfg = self.cfg
        s = x.shape[1]
        if s > cfg.max_seq_len:
            raise ValueError(
                f"sequence length {s} exceeds TowerConfig.max_seq_len "
                f"{cfg.max_seq_len} (positional embedding table size)"
            )
        # this rank's sequence shard (all of it off a model axis), from
        # input_proj to the pooling
        n = 1 if self.mesh is None else self.mesh.n_model
        if s % n:
            raise ValueError(f"sequence length {s} not divisible by the model "
                             f"axis {n}")
        s_loc = s // n
        lo = 0 if n == 1 else self.mesh.model_index * s_loc
        if mask is not None:
            mask = mask[:, lo:lo + s_loc]
        h = (self.input_proj(x[:, lo:lo + s_loc])
             + self.pos_embed[None, lo:lo + s_loc].to(cfg.dtype))
        for layer in range(cfg.num_layers):
            h = self.get_submodule(f"block_{layer}")(h, mask)
        h = self.final_norm(h.float())
        if n == 1 and mask is None:
            pooled = h.mean(dim=1)
        elif n == 1:
            w = mask.float()[:, :, None]
            pooled = (h * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
        else:
            w = (torch.ones_like(h[:, :, :1]) if mask is None
                 else mask.float()[:, :, None])
            # the masked sums and counts of the group's shards, one all-reduce
            sums = _ModelSum.apply(torch.cat([(h * w).sum(dim=1), w.sum(dim=1)], 1),
                                   self.mesh.model_group)
            pooled = sums[:, :-1] / sums[:, -1:].clamp_min(1.0)
        return self.output_proj(pooled)


def _build_tower(cfg: TowerConfig, dropout_gen: torch.Generator,
                 mesh=None) -> nn.Module:
    if cfg.kind == "mlp":
        return MLPTower(cfg)
    if cfg.kind == "transformer":
        return TransformerTower(cfg, dropout_gen, mesh)
    raise ValueError(f"unknown tower kind: {cfg.kind!r}")


class DualEncoder(nn.Module):
    """Video tower + text tower → fp32 embeddings (not normalized), plus
    the criterion's scalar ``logit_scale`` so the module holds every leaf
    of the JAX trainer's parameter tree.

    ``dropout_gen`` is the CPU generator both transformer towers draw their
    attention-dropout seeds from, in a fixed order (video tower, then text
    tower, block by block); ``reseed_dropout`` sets it for one step.
    ``mesh`` (a ``parallel.Mesh``) reaches the ``attention="ring"`` towers;
    it is not part of the state_dict."""

    def __init__(self, video_cfg: TowerConfig, text_cfg: TowerConfig, mesh=None):
        super().__init__()
        self.video_cfg = video_cfg
        self.text_cfg = text_cfg
        self.dropout_gen = torch.Generator()
        self.video_tower = _build_tower(video_cfg, self.dropout_gen, mesh)
        self.text_tower = _build_tower(text_cfg, self.dropout_gen, mesh)
        self.logit_scale = nn.Parameter(torch.ones(()))

    def reseed_dropout(self, seed: int, step: int, chunk: int | None = None,
                       rank: int | None = None) -> None:
        """Set the dropout generator as a pure function of ``(seed, step)``,
        so a step's masks do not depend on what ran before it.  A data-
        parallel ``rank`` (None at one rank) and a ``chunk`` index (the
        two-pass step's) are folded in too, in that order, as the JAX step
        folds ``axis_index`` and ``chunk_idx`` into its key: the ranks draw
        different masks, and re-encoding a chunk draws its masks again."""
        value = ((int(seed) << 32) + int(step)) % (1 << 64)
        if rank is not None:
            value = (value * 0xBF58476D1CE4E5B9 + int(rank) + 1) % (1 << 64)
        if chunk is not None:
            # an odd multiplier mixes the chunk into every bit of the seed
            value = (value * 0x9E3779B97F4A7C15 + int(chunk) + 1) % (1 << 64)
        self.dropout_gen.manual_seed(value)

    def forward(self, video, text, video_mask=None, text_mask=None):
        return (self.encode("video", video, video_mask),
                self.encode("text", text, text_mask))

    def encode(self, side: str, x, mask=None) -> torch.Tensor:
        """One modality through its own tower only."""
        if side not in ("video", "text"):
            raise ValueError(f"side must be 'video' or 'text', got {side!r}")
        cfg = self.video_cfg if side == "video" else self.text_cfg
        tower = self.video_tower if side == "video" else self.text_tower
        if cfg.kind == "transformer":
            return tower(x, mask).float()
        if mask is not None:
            raise ValueError(
                "a sequence mask was provided but the tower kind is "
                f"{cfg.kind!r} (pooled features; masks apply to "
                "transformer towers only)"
            )
        return tower(x).float()
