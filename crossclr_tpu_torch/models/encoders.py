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

Every other tower on a mesh of ``n_model > 1`` runs tensor-parallel over
the model group (:mod:`parallel.tensor_parallel`, the JAX trainer's
``_tp_spec_for_param``): each rank holds its slice of every parameter the
rule shards (:class:`Dense` with ``split``), the transformer blocks split
their heads (``out`` and ``Dense_1`` row-parallel, ``Dense_0``
column-parallel), an MLP tower splits block 0's ``skip``/``fc1`` by
column and ``fc2`` by row, ``input_proj`` is column-parallel and
``output_proj`` row-parallel; the residual stream, the LayerNorms, the
pooling and the embeddings are whole on every rank.  A flash tower's
dropout places the rank's heads among the global ones (the kernels'
``head_count``/``head_offset``), so the grid drops what one device drops.
:meth:`DualEncoder.full_state_dict` joins the shards and
:meth:`DualEncoder.shard_state_dict` cuts them.

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
from ..parallel.tensor_parallel import (
    ModelShards,
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    shard,
    tp_dim,
)
from .mla_moe import MLAMoETower

__all__ = ["DualEncoder", "MLPTower", "TowerConfig", "TransformerTower"]

_LN_EPS = 1e-6  # flax.linen.LayerNorm default
# the tower kinds that read [B, S, input_dim] sequences under a key mask
SEQUENCE_KINDS = ("transformer", "mla_moe")
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
    a later port.

    The fields after ``ring_interpret`` are the port's own, for the
    ``"mla_moe"`` kind (:mod:`models.mla_moe`, a DeepSeek-V3 text tower):
    its residual width ``model_dim`` (``hidden_size`` in a published
    config), latent attention's widths, the routed and shared experts',
    the router's scale and the RoPE and RMSNorm constants, named as the
    published config names them.  ``num_layers``, ``num_heads`` and
    ``hidden_dim`` (the dense layers' MLP width) keep their meaning;
    ``embed_dim`` is the output width."""

    kind: str = "mlp"  # "mlp" | "transformer" | "mla_moe"
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
    model_dim: int = 2048
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5


class Dense(nn.Linear):
    """``flax.linen.Dense`` with ``dtype``: the product in the compute
    dtype, then the bias added in that dtype.

    Tensor-parallel (``shards`` set, see :func:`_dense`): ``split =
    "column"`` holds this rank's rows of the weight and adds its slice of
    the bias (the bias itself a slice where the rule shards it); ``"row"``
    holds this rank's input columns, reads this rank's slice of the input,
    and adds the whole bias after the group's partial products are summed.
    The conjugate collectives on the inputs are the caller's."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype,
                 split: str | None = None, shards: ModelShards | None = None,
                 bias_features: int | None = None):
        super().__init__(in_features, out_features)
        if bias_features is not None and bias_features != out_features:
            self.bias = nn.Parameter(torch.empty(bias_features))
        self.compute_dtype = dtype
        self.split = split
        self.shards = shards

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        bias = self.bias
        if self.split == "row":
            y = reduce_from_model(y, self.shards)
        elif self.split == "column" and bias.shape[0] != y.shape[-1]:
            bias = shard(bias, 0, self.shards.index, self.shards.n)
        return y + bias.to(dt)


def _dense(name: str, in_features: int, out_features: int, dtype: torch.dtype,
           shards: ModelShards | None, what: tuple[str, str]) -> Dense:
    """The tower layer ``name`` as this rank holds it: whole without
    ``shards`` or where the rule replicates it, else its column or row
    slice; ``what`` names the output and input widths for the refusal of a
    width the model axis does not divide."""
    dim = None if shards is None else tp_dim(f"{name}.weight",
                                             (out_features, in_features))
    if dim is None:
        return Dense(in_features, out_features, dtype)
    if dim == 0:
        local = shards.check(out_features, what[0])
        bias = local if tp_dim(f"{name}.bias", (out_features,)) == 0 else out_features
        return Dense(in_features, local, dtype, "column", shards, bias)
    return Dense(shards.check(in_features, what[1]), out_features, dtype, "row",
                 shards)


def _row_input(layer: Dense, x: torch.Tensor, shards) -> torch.Tensor:
    """A whole activation as the input of ``layer``: its slice for a
    row-parallel layer (the cotangent summed over the group), else itself."""
    if layer.split != "row":
        return x
    return shard(copy_to_model(x, shards), x.dim() - 1, shards.index, shards.n)


def _column_output(layer: Dense, y: torch.Tensor, shards) -> torch.Tensor:
    """``layer``'s output made whole: the group's column shards joined."""
    return gather_from_model(y, shards) if layer.split == "column" else y


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=_LN_EPS)


class MLPTower(nn.Module):
    """Residual MLP blocks over pooled features, then an fp32 LayerNorm;
    block 0 reads ``input_dim``, later blocks ``embed_dim``.  With
    ``shards`` the rule splits block 0 only: ``skip`` and ``fc1`` by
    column (``skip``'s shards joined before the residual add), ``fc2`` by
    row."""

    def __init__(self, cfg: TowerConfig, shards: ModelShards | None = None):
        super().__init__()
        self.cfg = cfg
        self.shards = shards
        in_dim = cfg.input_dim
        self.num_blocks = max(cfg.num_layers, 1)
        for layer in range(self.num_blocks):
            suffix = "" if layer == 0 else f"_{layer}"
            for name, (n_in, n_out) in (("skip", (in_dim, cfg.embed_dim)),
                                        ("fc1", (in_dim, cfg.hidden_dim)),
                                        ("fc2", (cfg.hidden_dim, cfg.embed_dim))):
                what = ("hidden_dim" if name == "fc1" else "embed_dim",
                        "hidden_dim" if name == "fc2" else "input width")
                self.add_module(name + suffix, _dense(name + suffix, n_in, n_out,
                                                      cfg.dtype, shards, what))
            in_dim = cfg.embed_dim
        self.norm = _ln(cfg.embed_dim)
        # no parameters: the state_dict keys stay the Flax paths
        self.dropout = nn.Dropout(cfg.dropout) if cfg.dropout > 0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.cfg.dtype)
        for layer in range(self.num_blocks):
            suffix = "" if layer == 0 else f"_{layer}"
            skip_l, fc1_l, fc2_l = (self.get_submodule(n + suffix)
                                    for n in ("skip", "fc1", "fc2"))
            h_in = h if fc1_l.split is None else copy_to_model(h, self.shards)
            skip = _column_output(skip_l, skip_l(h_in), self.shards)
            y = _gelu(fc1_l(h_in))
            if self.dropout is not None:
                y = self.dropout(y)
            h = skip + fc2_l(y)
        return self.norm(h.float())


class _HeadProjections(nn.Module):
    """The q/k/v/out projections of Flax multi-head attention, held as
    ``[E, E]`` Linears (Flax's ``[E, H, Dh]`` / ``[H, Dh, E]`` kernels
    flattened).  With ``shards`` this rank holds ``H / n`` heads: their
    q/k/v rows and ``out``'s input columns (row-parallel)."""

    def __init__(self, cfg: TowerConfig, shards: ModelShards | None = None):
        super().__init__()
        if cfg.embed_dim % cfg.num_heads:
            raise ValueError(
                f"embed_dim {cfg.embed_dim} not divisible by num_heads "
                f"{cfg.num_heads}"
            )
        self.cfg = cfg
        self.shards = shards
        self.heads = (cfg.num_heads if shards is None
                      else shards.check(cfg.num_heads, "num_heads"))
        self.head_dim = cfg.embed_dim // cfg.num_heads
        for name in ("query", "key", "value", "out"):
            self.add_module(name, _dense(name, cfg.embed_dim, cfg.embed_dim,
                                         cfg.dtype, shards,
                                         ("embed_dim", "embed_dim")))

    def _split(self, x: torch.Tensor, name: str) -> torch.Tensor:
        b, s, _ = x.shape
        return self.get_submodule(name)(x).view(b, s, self.heads, self.head_dim)

    def _input(self, x: torch.Tensor) -> torch.Tensor:
        """The block's whole activation as the local heads' input."""
        return x if self.shards is None else copy_to_model(x, self.shards)

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

    def __init__(self, cfg: TowerConfig, dropout_gen: torch.Generator, mesh=None,
                 shards: ModelShards | None = None):
        super().__init__(cfg, shards)
        self.attend = (flash_attention if cfg.attention == "flash"
                       else functools.partial(_ring_attend, cfg=cfg, mesh=mesh))
        self.dropout_gen = dropout_gen
        self.mesh = mesh

    def forward(self, x, mask):
        x = self._input(x)
        # [B, S, H, Dh] -> [B, H, S, Dh]
        q, k, v = (
            self._split(x, n).transpose(1, 2) for n in ("query", "key", "value")
        )
        if self.training and self.cfg.dropout > 0:
            seed = int(torch.randint(0, _SEED_RANGE, (),
                                     generator=self.dropout_gen))
            place = {}
            if self.shards is not None:  # this rank's heads of the global rows
                h = self.cfg.num_heads
                place = dict(head_count=h, head_offset=self.shards.index * self.heads,
                             bh_offset=self.mesh.data_index * q.shape[0] * h)
            out = self.attend(q, k, v, mask, dropout_rate=self.cfg.dropout,
                              dropout_seed=seed, **place)
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
        x = self._input(x)
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
    ``LayerNorm_1``, ``Dense_0``, ``Dense_1``).  With ``shards`` the
    attention splits its heads and the MLP pair splits by shape, as the
    rule does: the wider side's dimension (column then row where hidden >
    embed, row then column where it is narrower)."""

    def __init__(self, cfg: TowerConfig, dropout_gen: torch.Generator, mesh=None,
                 shards: ModelShards | None = None):
        super().__init__()
        if cfg.attention not in _ATTENTION:
            raise ValueError(f"unknown attention impl {cfg.attention!r}")
        self.cfg = cfg
        self.shards = shards
        self.LayerNorm_0 = _ln(cfg.embed_dim)
        self.attn_name = _ATTENTION[cfg.attention]
        self.add_module(self.attn_name,
                        MultiHeadDotProductAttention(cfg, shards)
                        if cfg.attention == "xla"
                        else _MHA(cfg, dropout_gen, mesh, shards))
        self.LayerNorm_1 = _ln(cfg.embed_dim)
        e, h = cfg.embed_dim, cfg.hidden_dim
        self.Dense_0 = _dense("Dense_0", e, h, cfg.dtype, shards,
                              ("hidden_dim", "embed_dim"))
        self.Dense_1 = _dense("Dense_1", h, e, cfg.dtype, shards,
                              ("embed_dim", "hidden_dim"))

    def forward(self, x, mask):
        dt = self.cfg.dtype
        y = self.LayerNorm_0(x.float()).to(dt)
        x = x + self.get_submodule(self.attn_name)(y, mask)
        y = self.LayerNorm_1(x.float()).to(dt)
        return x + self._mlp(y)

    def _mlp(self, y):
        d0, d1, shards = self.Dense_0, self.Dense_1, self.shards
        if d0.split == "column":  # hidden > embed: the hidden stays sharded
            return d1(_gelu(d0(copy_to_model(y, shards))))
        h = _gelu(d0(_row_input(d0, y, shards)))
        if d1.split == "column":
            h = copy_to_model(h, shards)
        return _column_output(d1, d1(h), shards)


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
    ``parallel.Mesh``) is needed by ``attention="ring"``, where every rank
    of its model group takes the same rows and runs its sequence shard,
    and by ``shards`` (tensor parallelism over its model group): its
    data coordinate places a rank's rows for dropout."""

    def __init__(self, cfg: TowerConfig, dropout_gen: torch.Generator, mesh=None,
                 shards: ModelShards | None = None):
        super().__init__()
        if cfg.attention == "ring" and mesh is None:
            raise ValueError(
                "attention='ring' needs a mesh: construct the "
                "DualEncoder/TransformerTower with mesh=..."
            )
        self.cfg = cfg
        # the model axis this tower's sequence is sharded over (ring only)
        self.mesh = mesh if cfg.attention == "ring" else None
        self.shards = shards
        self.input_proj = _dense("input_proj", cfg.input_dim, cfg.embed_dim,
                                 cfg.dtype, shards, ("embed_dim", "input_dim"))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_seq_len, cfg.embed_dim))
        for layer in range(cfg.num_layers):
            self.add_module(f"block_{layer}", _Block(cfg, dropout_gen, mesh, shards))
        self.final_norm = _ln(cfg.embed_dim)
        self.output_proj = _dense("output_proj", cfg.embed_dim, cfg.embed_dim,
                                  torch.float32, shards, ("embed_dim", "embed_dim"))

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
        x = x[:, lo:lo + s_loc]
        if self.input_proj.split:
            x = copy_to_model(x, self.shards)
        h = (_column_output(self.input_proj, self.input_proj(x), self.shards)
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
        return self.output_proj(_row_input(self.output_proj, pooled, self.shards))


def _build_tower(cfg: TowerConfig, dropout_gen: torch.Generator,
                 mesh=None, shards: ModelShards | None = None) -> nn.Module:
    if cfg.kind == "mlp":
        return MLPTower(cfg, shards)
    if cfg.kind == "transformer":
        return TransformerTower(cfg, dropout_gen, mesh, shards)
    if cfg.kind == "mla_moe":
        return MLAMoETower(cfg, mesh, shards)
    raise ValueError(f"unknown tower kind: {cfg.kind!r}")


def tensor_parallel(cfg: TowerConfig, mesh) -> bool:
    """Whether a tower of ``cfg`` on ``mesh`` splits its weights over the
    model axis: every tower but a ring tower (whose model axis carries
    the sequence) past one model rank."""
    return (mesh is not None and mesh.n_model > 1
            and not (cfg.kind == "transformer" and cfg.attention == "ring"))


class DualEncoder(nn.Module):
    """Video tower + text tower → fp32 embeddings (not normalized), plus
    the criterion's scalar ``logit_scale`` so the module holds every leaf
    of the JAX trainer's parameter tree.

    ``dropout_gen`` is the CPU generator both transformer towers draw their
    attention-dropout seeds from, in a fixed order (video tower, then text
    tower, block by block); ``reseed_dropout`` sets it for one step.
    ``mesh`` (a ``parallel.Mesh``) reaches the ``attention="ring"`` towers
    and, past one model rank, splits every other tower tensor-parallel
    (:func:`tensor_parallel`; ``split=False`` builds the whole towers, as
    a checkpoint holds them); it is not part of the state_dict.
    ``tp_dims`` maps every parameter to the dimension this rank holds a
    slice of (None: whole)."""

    def __init__(self, video_cfg: TowerConfig, text_cfg: TowerConfig, mesh=None,
                 split: bool = True):
        super().__init__()
        self.video_cfg = video_cfg
        self.text_cfg = text_cfg
        self.dropout_gen = torch.Generator()
        self.mesh = mesh
        for side, cfg in (("video", video_cfg), ("text", text_cfg)):
            shards = (ModelShards.of(mesh) if split and tensor_parallel(cfg, mesh)
                      else None)
            self.add_module(f"{side}_tower",
                            _build_tower(cfg, self.dropout_gen, mesh, shards))
        self.logit_scale = nn.Parameter(torch.ones(()))
        self.tp_dims = dict.fromkeys((k for k, _ in self.named_parameters()))
        for name, module in self.named_modules():
            if isinstance(module, Dense) and module.split is not None:
                column = module.split == "column"
                self.tp_dims[f"{name}.weight"] = 0 if column else 1
                if column and module.bias.shape[0] == module.weight.shape[0]:
                    self.tp_dims[f"{name}.bias"] = 0

    def shard_state_dict(self, full: dict) -> dict:
        """This rank's slices of a whole state_dict (a checkpoint's)."""
        return {k: v if self.tp_dims.get(k) is None
                else shard(v, self.tp_dims[k], self.mesh.model_index, self.mesh.n_model)
                for k, v in full.items()}

    def full_state_dict(self, local: dict | None = None) -> dict:
        """The whole tensors of ``local`` (this rank's state_dict, or any
        dict of tensors keyed alike): every split one joined over the
        model group in one all-gather, the others as they are.  A
        collective of the model group."""
        local = self.state_dict() if local is None else local
        names = [k for k in local if self.tp_dims.get(k) is not None]
        if not names:
            return dict(local)
        n = self.mesh.n_model
        flat = torch.cat([local[k].detach().movedim(self.tp_dims[k], 0).reshape(-1)
                          for k in names])
        gathered = flat.new_empty(n * flat.numel())
        dist.all_gather_into_tensor(gathered, flat, group=self.mesh.model_group)
        gathered = gathered.view(n, -1)
        out, offset = dict(local), 0
        for k in names:
            piece = local[k].movedim(self.tp_dims[k], 0)
            size = piece.numel()
            whole = gathered[:, offset:offset + size].reshape(n * piece.shape[0],
                                                              *piece.shape[1:])
            out[k] = whole.movedim(0, self.tp_dims[k]).contiguous()
            offset += size
        return out

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
        if cfg.kind in SEQUENCE_KINDS:
            return tower(x, mask).float()
        if mask is not None:
            raise ValueError(
                "a sequence mask was provided but the tower kind is "
                f"{cfg.kind!r} (pooled features; masks apply to "
                "transformer towers only)"
            )
        return tower(x).float()
