"""The contrastive train step and training loop on one device.

Counterpart of ``crossclr_tpu/training/trainer.py`` for ``mesh=None``.
``TrainConfig`` has every field and default of the JAX one, so the JSON
configs load.  The step:

* encodes both towers in train mode (bf16 products, fp32 parameters);
* computes the loss of :func:`make_loss_fn` on the embeddings — under
  ``learnable_temperature`` at ``τ = cfg.temperature / exp(logit_scale)``;
  the full CrossCLR losses score connectivity on the raw inputs, each
  mean-pooled over its valid steps (:meth:`Trainer.step_loss`);
* takes the gradient of every parameter, its global norm before clipping,
  and applies :class:`AdamW` or, under ``optimizer="lamb"``, :class:`LAMB`
  (optax's ``clip_by_global_norm`` + ``adamw`` / ``lamb`` with a
  warmup-cosine schedule, written out);
* clamps ``logit_scale`` to ±ln 100 after the update (learnable τ) and
  updates the EMA (``ema_decay``).

With ``embedding_chunk`` below the batch the gradient comes from the JAX
trainer's GradCache two-pass step (``value_and_grad_two_pass``): pass 1
encodes the batch chunk by chunk without autograd, pass 2 differentiates
the loss over the whole batch with respect to the embeddings and the
model's direct parameters (``logit_scale``), pass 3 re-runs each chunk's
towers with autograd and back-propagates its slice of the embeddings'
gradient into summed parameter gradients.  Each chunk's dropout
generator is reseeded from ``(train.seed, step, chunk)``, so pass 3 draws
pass 1's masks again, and an ``mla_moe`` tower's routed layers replay
pass 1's choices (``models.mla_moe.routing``), so pass 3 routes each
chunk bit for bit as pass 1 did.  The gradient is the one-pass step's;
only one chunk's activations are alive at a time.

Batches arrive as host arrays or as tensors already on the device (what
``data.prefetch_to_device`` yields), which are not copied again.  An int8
store's batch carries per-row scales; it is dequantized on the device
before the towers and before the connectivity of the full CrossCLR losses
(``data.quantize.dequantize_batch``, as the JAX step does).

``fit`` runs ``steps_per_call`` steps per dispatch as a plain loop, or,
``prestacked``, one ``[n, B, ...]`` chunk per dispatch
(:meth:`Trainer.train_steps`, each step's batch indexed on the device,
under the ``max_stacked_bytes`` budget); for the full CrossCLR losses it
first reports on stderr, once per trainer, the positive weights' effective
sample size on the first batch, and warns if the weight softmax is
near-one-hot there (:meth:`Trainer.weight_degeneracy_check`).  Refused
with a message rather than ignored: transformer-tower dropout under
``attention="xla"`` (ROADMAP queue 1 item 10: its JAX mask comes from
``jax.random``).  Under ``attention="flash"``
the towers' dropout generator is reseeded every step from
``(train.seed, step)``, so a resumed run draws the same masks.

**Data parallelism.**  Under the initialised default ``torch.distributed``
group of P ranks (``parallel.initialize_multihost``) each rank encodes its own rows of the global batch (``data.HostShard``)
and the step computes the JAX step on a ``make_mesh(n_data=P)`` mesh: the
loss and the gradients of the GLOBAL batch, summed over ranks (the JAX
step ``psum``s; not ``DistributedDataParallel``'s mean), then the same
update on every rank.
* ``global_negatives`` with ``crossclr_intra(_fused)`` or
  ``crossclr(_fused)``: the loss is ``parallel.global_cross_clr_intra`` /
  ``global_cross_clr`` (the ``_fused`` losses through the rows kernels),
  which return the global value with the rank's own gradient.
* Any other loss, or ``global_negatives=False``: the embeddings (and the
  full CrossCLR losses' pooled raw inputs) are all-gathered and every rank
  computes the plain loss L of the whole batch, as GSPMD partitions the
  JAX step's full-batch loss; each rank differentiates L / P, since the
  all-gather's backward sums the P ranks' identical cotangents.
* The gradients travel in one flat buffer: one all-reduce (SUM) a step,
  which also averages the embedding-norm metrics; the clip reads the
  summed gradient's global norm.  Under ``zero1`` each moment is sharded
  on the first dimension (of the torch layout) that P divides, as
  ``_zero1_spec`` does: the shardable gradients are reduce-scattered, the
  rest all-reduced, the optimizer runs on the rank's rows and the
  parameters are all-gathered; the numbers are the replicated update's
  (the clip's squared norm and LAMB's per-leaf norms are each one
  all-reduce of the shards' sums, :meth:`Trainer.global_leaf_sums`).  The
  EMA stays replicated.  Checkpoints hold full moments
  (:meth:`Trainer.checkpoint_state` gathers, :meth:`Trainer.restored_state`
  cuts), so they restore at any world size.
* Parameters are broadcast from rank 0 after init and after a restore;
  the rank is folded into the dropout seed (the JAX step folds
  ``axis_index``), and at one rank the seeds are the one-device ones.
At one rank the step is the one-device step, and its all-reduce a copy.

**The model axis.**  With ``mesh`` a ``parallel.make_mesh(n_data,
n_model)`` grid of ``n_model > 1``, the data group above is the mesh's
data group, and each model group's ranks take the same rows (their data
coordinate's).  Each tower uses the model axis its own way:
``attention="ring"`` towers run one sequence shard a rank with replicated
weights (sequence parallelism); every other tower is split
tensor-parallel (``models.encoders``, the JAX ``_tp_spec_for_param``), each
rank holding its slices.  The step is the JAX GSPMD step's
(``use_global`` is off past one model rank): every rank computes the
plain loss L of the whole batch, the embeddings all-gathered over the data
group, and differentiates L / n_data.  Then one all-reduce over the model
group (:meth:`Trainer.sum_model_grads`) sums what a rank holds only a part
of: a ring tower's gradients (its pooling sums over the model group in
both directions, ``models.encoders._ModelSum``, so each rank holds
n_model times its share: the sum is divided by n_model) and a
tensor-parallel tower's replicated biases that each rank consumes as a
slice (``parallel.tensor_parallel.consumed_sliced``); the sharded
gradients are their slices already and the other replicated ones whole.
The clip's norm and LAMB's counts each shard once.  ZeRO-1 cuts a rank's
tensor-parallel slice again over the data group (on another dimension, as
``_zero1_spec`` does).  Checkpoints hold whole tensors: :meth:`Trainer.
checkpoint_state` joins the slices, :meth:`Trainer.restored_state` cuts
them, so a checkpoint restores on any grid and in one process.  No rank is
folded into the dropout seed, as the JAX step folds ``axis_index`` only on
its global-negative route: each data shard's rows (and a tensor-parallel
rank's heads) take their place in the global batch·head range instead, so
the masks are one device's on the whole batch.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import itertools
import math
import sys
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from ..data.datasets import check_chunk_bytes
from ..data.quantize import dequantize_batch
from ..losses import functional as F
from ..models.encoders import DualEncoder, TowerConfig, tensor_parallel
from ..models.mla_moe import routing
from ..parallel.global_loss import (
    all_gather,
    global_cross_clr,
    global_cross_clr_intra,
)
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.tensor_parallel import consumed_sliced
from ..utils.profiling import span

__all__ = [
    "AdamW",
    "LAMB",
    "TrainConfig",
    "TrainState",
    "Trainer",
    "loss_route",
    "make_loss_fn",
    "make_optimizer",
    "to_tensor",
]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Field for field the JAX ``TrainConfig`` (see its comments)."""

    loss: str = "crossclr_intra"
    temperature: float = 0.03
    negative_weight: float = 0.8
    weight_temperature: float = 0.0035
    prune_percent: float = 0.10
    weight_norm: str = "raw"
    margin: float = 0.1
    learning_rate: float = 1e-4
    zero1: bool = False
    optimizer: str = "adamw"
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0
    global_negatives: bool = True
    global_candidate_chunk: int | None = None
    loss_precision: str | None = None
    embedding_chunk: int | None = None
    abort_on_nonfinite: bool = True
    steps_per_call: int = 1
    max_stacked_bytes: int | None = None
    learnable_temperature: bool = False
    ema_decay: float | None = None
    keep_best_metric: str | None = None
    eval_with_ema: bool = False
    seed: int = 0


@dataclasses.dataclass
class TrainState:
    """The step count, the model whose parameters it holds, the optimizer
    moments and the EMA of the parameters (None when not training /
    without ``ema_decay``).  The step updates it in place."""

    step: int
    model: DualEncoder
    opt_state: dict | None = None
    ema: dict[str, torch.Tensor] | None = None


def to_tensor(x, device, dtype=None) -> torch.Tensor:
    """A host array (numpy, or a bf16 store's raw ``uint16`` records) as a
    tensor on ``device``; a tensor already there is returned as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    x = np.asarray(x)
    if x.dtype == np.uint16:  # bf16 payload: reinterpret the bits
        t = torch.from_numpy(np.ascontiguousarray(x).view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype)


def init_params(model: torch.nn.Module, seed: int, logit_scale: float = 1.0) -> None:
    """Fill ``model`` in place from a CPU ``torch.Generator`` seeded with
    ``seed``, so the weights do not depend on the device.  The scales
    follow the Flax initializers: LeCun-normal weights (std 1/sqrt(fan_in),
    truncated at two standard deviations), zero biases, unit LayerNorm
    scales, ``pos_embed`` ~ N(0, 0.02²); ``logit_scale`` starts at
    ``logit_scale`` (the trainer passes 0 under ``learnable_temperature``,
    so ``exp(0) = 1`` reproduces ``cfg.temperature``, else 1).  A 3-D
    weight (an ``mla_moe`` tower's grouped experts, ``[E, in, out]``) takes
    the same scale by its ``in``; the routers' correction biases (buffers)
    are drawn after the parameters, normal with std 0.1."""
    gen = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pos_embed":
            value = torch.randn(p.shape, generator=gen) * 0.02
        elif leaf == "logit_scale":
            value = torch.full(p.shape, float(logit_scale))
        elif leaf == "bias":
            value = torch.zeros(p.shape)
        elif p.ndim == 1:  # LayerNorm weight
            value = torch.ones(p.shape)
        else:  # Linear weight [out, in]
            # a standard normal truncated at ±2 has std 0.87962566
            value = torch.nn.init.trunc_normal_(
                torch.empty(p.shape), generator=gen
            ) * (1.0 / math.sqrt(p.shape[1]) / 0.87962566)
        with torch.no_grad():
            p.copy_(value)
    for name, b in model.named_buffers():
        if name.endswith("e_score_correction_bias"):
            b.copy_(torch.randn(b.shape, generator=gen) * 0.1)


# ---------------------------------------------------------------------------
# loss and optimizer
# ---------------------------------------------------------------------------

# losses that take a tensor (learnable) temperature: the JAX package's list
_TRACED_TEMP_LOSSES = ("crossclr_intra", "crossclr", "crossclr_fused",
                       "info_nce", "crossclr_intra_fused")
# the full CrossCLR losses: pruning and positive weights from connectivity
_WEIGHTED_LOSSES = ("crossclr", "crossclr_fused")
# the losses that take the global-negative route over a group of ranks
_GLOBAL_LOSSES = ("crossclr_intra", "crossclr_intra_fused", "crossclr",
                  "crossclr_fused")

# CLIP clamps exp(logit_scale) at 100; the same bound, symmetric
_LOGIT_SCALE_BOUND = 4.6051702  # ln(100)


def make_loss_fn(cfg: TrainConfig) -> Callable:
    """``loss_fn(v_emb, t_emb, v_raw=None, t_raw=None, temperature=None)
    -> scalar``.  ``v_raw`` / ``t_raw`` are the raw inputs that the full
    CrossCLR losses score connectivity on (the embeddings when None; the
    other losses ignore them); a given ``temperature`` (a tensor under
    learnable τ) replaces ``cfg.temperature``."""

    def temp(override):
        return cfg.temperature if override is None else override

    if cfg.loss == "crossclr_intra":
        return lambda v, t, vr=None, tr=None, temperature=None: F.cross_clr_intra(
            v, t, temperature=temp(temperature),
            negative_weight=cfg.negative_weight,
        )
    if cfg.loss == "crossclr_intra_fused":
        from ..ops.fused_crossclr import cross_clr_intra_fused

        return lambda v, t, vr=None, tr=None, temperature=None: cross_clr_intra_fused(
            v, t, temperature=temp(temperature),
            negative_weight=cfg.negative_weight, precision=cfg.loss_precision,
        )
    if cfg.loss in _WEIGHTED_LOSSES:
        weighting = dict(negative_weight=cfg.negative_weight,
                         weight_temperature=cfg.weight_temperature,
                         prune_percent=cfg.prune_percent,
                         weight_norm=cfg.weight_norm)
        if cfg.loss == "crossclr":
            return lambda v, t, vr=None, tr=None, temperature=None: F.cross_clr(
                v, t, vr, tr, temperature=temp(temperature), **weighting)
        from ..ops.fused_global import cross_clr_fused

        return lambda v, t, vr=None, tr=None, temperature=None: cross_clr_fused(
            v, t, vr, tr, temperature=temp(temperature),
            precision=cfg.loss_precision, **weighting)
    if cfg.loss == "info_nce":
        return lambda v, t, vr=None, tr=None, temperature=None: F.info_nce(
            v, t, temperature=temp(temperature)
        )
    if cfg.loss == "max_margin":
        return lambda v, t, vr=None, tr=None, temperature=None: F.max_margin(
            v, t, margin=cfg.margin)
    raise ValueError(f"unknown loss {cfg.loss!r}")


def loss_route(cfg: TrainConfig, batch: int, embed_dim: int) -> str | None:
    """The kernel pair the loss of :func:`make_loss_fn` runs at this batch
    and embedding width: ``"per_direction"``, ``"sym"`` or ``"dual"``
    (a learnable τ reaches the loss as a tensor), or None for a loss that
    runs no fused kernel."""
    temperature = cfg.temperature
    if cfg.learnable_temperature:
        temperature = torch.tensor(temperature)
    if cfg.loss == "crossclr_intra_fused":
        from ..ops.fused_crossclr import route

        return route(batch, embed_dim, temperature, cfg.negative_weight)
    if cfg.loss == "crossclr_fused":  # always with keep masks
        from ..ops.fused_dual import route

        return route(batch, temperature, cfg.negative_weight, pruned=True)
    return None


class AdamW:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(schedule,
    weight_decay, mask))`` written out, with the JAX trainer's schedule
    ``warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1))``.

    Per update, with ``count`` the number of earlier updates:
    ``g ← g`` if ``‖g‖ < clip`` else ``g / ‖g‖ · clip`` (optax's formula,
    not ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6);
    ``μ ← (1−b1)·g + b1·μ``, ``ν ← (1−b2)·g² + b2·ν``;
    ``u = μ/(1−b1^{count+1}) / (sqrt(ν/(1−b2^{count+1})) + eps)``,
    plus ``weight_decay · p`` except for ``logit_scale``;
    ``p ← p − lr(count) · u``.  The learning rate is taken at the count
    BEFORE the increment, so the first update has lr 0.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8
    no_decay = ("logit_scale",)

    def __init__(self, cfg: TrainConfig):
        self.peak = cfg.learning_rate
        self.warmup = cfg.warmup_steps
        self.decay_steps = max(cfg.total_steps, cfg.warmup_steps + 1)
        self.weight_decay = cfg.weight_decay
        self.clip_norm = cfg.clip_norm

    def learning_rate(self, count: int) -> float:
        """optax's warmup-cosine schedule at ``count``: linear from 0 over
        the warmup, then a cosine decay to 0 at ``decay_steps``."""
        if count < self.warmup:
            return self.peak * count / self.warmup
        span = self.decay_steps - self.warmup
        step = min(count - self.warmup, span)
        return self.peak * 0.5 * (1.0 + math.cos(math.pi * step / span))

    @staticmethod
    def init(params: dict[str, torch.Tensor]) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()},
        }

    def _clipped(self, grads: dict, reduce):
        """``(gnorm, keep)``: the global norm of ``grads`` (the leaves'
        squares as the whole leaves' where ``reduce`` is given) and whether
        it is under the clip."""
        sq = [torch.sum(g * g) for g in grads.values()]
        if reduce is not None:
            sq = list(reduce(torch.stack(sq)[None])[0])
        gnorm = torch.sqrt(sum(sq))
        return gnorm, gnorm < self.clip_norm

    def _adam(self, name, p, g, opt_state, bc1, bc2) -> torch.Tensor:
        """The moments' update in place; returns the decayed Adam step."""
        mu, nu = opt_state["mu"][name], opt_state["nu"][name]
        mu.copy_((1 - self.b1) * g + self.b1 * mu)
        nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        if name not in self.no_decay:
            u = u + self.weight_decay * p
        return u

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor], opt_state: dict,
               reduce: Callable | None = None) -> torch.Tensor:
        """Clip ``grads``, update ``params`` and ``opt_state`` in place;
        returns the global gradient norm before clipping (a device
        scalar: no host sync).  ``reduce``: where ``grads`` hold shards
        (ZeRO-1, tensor parallelism), what turns a ``[k, n_leaves]``
        tensor of this rank's per-leaf sums (in ``params``' order) into
        the whole leaves' (:meth:`Trainer.global_leaf_sums`)."""
        gnorm, keep = self._clipped(grads, reduce)
        count = opt_state["count"]
        lr = self.learning_rate(count)
        bc1 = 1.0 - self.b1 ** (count + 1)
        bc2 = 1.0 - self.b2 ** (count + 1)
        for name, p in params.items():
            g = torch.where(keep, grads[name], grads[name] / gnorm * self.clip_norm)
            p.add_(-lr * self._adam(name, p, g, opt_state, bc1, bc2))
        opt_state["count"] = count + 1
        return gnorm


class LAMB(AdamW):
    """``optax.chain(clip_by_global_norm(clip_norm), lamb(schedule, b1=0.9,
    b2=0.999, eps=1e-6, eps_root=0, weight_decay, mask))`` (optax 0.2.6)
    written out: :class:`AdamW`'s clip, moments and decayed step ``u``
    (eps 1e-6), then per leaf ``u ← u · ‖p‖/‖u‖``, or ``u`` itself where
    either norm is 0 (the trust ratio applies to ``logit_scale`` too),
    then ``p ← p − lr(count) · u``.  The per-leaf squared norms of ``p``
    and ``u`` are one ``[2, n_leaves]`` tensor, reduced once where the
    leaves are shards.  Its state is AdamW's (``count``, ``mu``, ``nu``)."""

    eps = 1e-6

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor], opt_state: dict,
               reduce: Callable | None = None) -> torch.Tensor:
        gnorm, deltas = self.updates(params, grads, opt_state, reduce)
        for name, p in params.items():
            p.add_(deltas[name])
        return gnorm

    @torch.no_grad()
    def updates(self, params: dict[str, torch.Tensor],
                grads: dict[str, torch.Tensor], opt_state: dict,
                reduce: Callable | None = None) -> tuple:
        """``(gnorm, deltas)``: what :meth:`update` adds to each
        parameter, ``opt_state`` updated in place and ``params`` not."""
        gnorm, keep = self._clipped(grads, reduce)
        count = opt_state["count"]
        lr = self.learning_rate(count)
        bc1 = 1.0 - self.b1 ** (count + 1)
        bc2 = 1.0 - self.b2 ** (count + 1)
        steps = {}
        for name, p in params.items():
            g = torch.where(keep, grads[name], grads[name] / gnorm * self.clip_norm)
            steps[name] = self._adam(name, p, g, opt_state, bc1, bc2)
        sums = torch.stack([torch.stack([torch.sum(p * p) for p in params.values()]),
                            torch.stack([torch.sum(u * u) for u in steps.values()])])
        if reduce is not None:
            sums = reduce(sums)
        norms = torch.sqrt(sums)
        ratios = torch.where((norms[0] == 0) | (norms[1] == 0),
                             torch.ones_like(norms[0]), norms[0] / norms[1])
        opt_state["count"] = count + 1
        return gnorm, {name: -lr * (steps[name] * ratios[i])
                       for i, name in enumerate(params)}


def make_optimizer(cfg: TrainConfig) -> AdamW:
    """:class:`AdamW` or :class:`LAMB`, by ``cfg.optimizer``."""
    if cfg.optimizer == "adamw":
        return AdamW(cfg)
    if cfg.optimizer == "lamb":
        return LAMB(cfg)
    raise ValueError(
        f"TrainConfig.optimizer must be 'adamw' or 'lamb', got {cfg.optimizer!r}")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


class Trainer:
    """Owns the dual towers' init, the train step and the loop, and the
    eval-mode encode, on one explicit ``device``; under an initialised
    default process group it is this rank's part of the data-parallel
    step, on ``mesh`` (``parallel.make_mesh``'s grid; by default the data
    axis over every rank) its part of the data × model step (see the
    module doc).  ``rank`` and ``world`` are the data coordinate and the
    data axis's size, ``model_index`` and ``n_model`` the model
    coordinate and axis, ``global_rank`` the rank in the default group;
    ``tensor_parallel`` whether a tower is split over the model axis."""

    def __init__(self, video_cfg: TowerConfig, text_cfg: TowerConfig,
                 train_cfg: TrainConfig, device: str | torch.device = "cuda",
                 mesh: Mesh | None = None):
        for cfg in (video_cfg, text_cfg):
            if (cfg.kind == "transformer" and cfg.dropout > 0
                    and cfg.attention == "xla"):
                raise NotImplementedError(
                    f"training dropout of transformer towers with attention="
                    f"{cfg.attention!r} is not ported to crossclr_tpu_torch "
                    "(ROADMAP queue 1 item 10): the JAX 'xla' mask comes from "
                    "jax.random; use attention='flash'"
                )
        if (train_cfg.learnable_temperature
                and train_cfg.loss not in _TRACED_TEMP_LOSSES):
            raise ValueError(
                f"learnable_temperature is not meaningful for loss "
                f"{train_cfg.loss!r}; use one of {_TRACED_TEMP_LOSSES}"
            )
        if train_cfg.ema_decay is not None and not 0.0 < train_cfg.ema_decay < 1.0:
            raise ValueError(
                f"ema_decay must be in (0, 1), got {train_cfg.ema_decay}"
            )
        grouped = dist.is_available() and dist.is_initialized()
        if mesh is None and grouped:
            mesh = make_mesh()  # the data axis over every rank
        self.mesh = mesh
        self.world_group = dist.group.WORLD if grouped else None
        self.global_rank = dist.get_rank() if grouped else 0
        self.group = None if mesh is None else mesh.data_group
        self.world = 1 if mesh is None else mesh.n_data
        self.rank = 0 if mesh is None else mesh.data_index
        self.model_group = None if mesh is None else mesh.model_group
        self.n_model = 1 if mesh is None else mesh.n_model
        self.model_index = 0 if mesh is None else mesh.model_index
        self.tensor_parallel = any(tensor_parallel(c, mesh)
                                   for c in (video_cfg, text_cfg))
        # the JAX step's route (trainer.py _build_step): global negatives
        # for the CrossCLR losses past one data rank on a grid with no
        # model axis, else the gathered batch
        self.use_global = (self.world > 1 and self.n_model == 1
                           and train_cfg.global_negatives
                           and train_cfg.loss in _GLOBAL_LOSSES)
        if self.use_global and "ring" in (video_cfg.attention, text_cfg.attention):
            raise ValueError(
                "attention='ring' (sequence parallelism over the model "
                "axis) cannot run inside the data-axis global-negative "
                "step; use global_negatives=False"
            )
        self.zero1 = train_cfg.zero1 and self.world > 1
        self.video_cfg = video_cfg
        self.text_cfg = text_cfg
        self.cfg = train_cfg
        self.device = torch.device(device)
        self.optimizer = make_optimizer(train_cfg)
        self._loss_fn = make_loss_fn(train_cfg)
        # set by init_state from the model: ZeRO-1's sharded dimension of
        # each parameter (None = replicated over the data group), the
        # dimension a tensor-parallel rank holds a slice of (None: whole),
        # the gradients summed over the model group and, of them, the ring
        # towers' (divided by n_model after the sum)
        self._shard_dims: dict[str, int | None] = {}
        self._tp_dims: dict[str, int | None] = {}
        self._model_summed: list[str] = []
        self._ring_summed: list[str] = []
        # any_rank's host-side group: the default group when it is gloo,
        # else a gloo group of its ranks, made here, where every rank of
        # the default group arrives (new_group is a collective of them all)
        self._vote_group = None
        if grouped:
            self._vote_group = (self.world_group if dist.get_backend() == "gloo"
                                else dist.new_group(backend="gloo"))
        # once per trainer: the fit-startup check of the weighting channel
        self._weight_diag_done = False
        # the last step's MoE choices, a list a forward (a chunk) of lists a
        # MoE layer of [tokens, top-k] indices: what its gradients ran with
        self.routes_used: list = []

    # -- diagnostics ---------------------------------------------------------

    # rows the weighting check scores: a distributional diagnostic, cheap
    # even for the largest batches
    WEIGHT_CHECK_ROWS = 4096

    def weight_degeneracy_check(self, batch: dict) -> dict[str, float] | None:
        """Effective-sample-size fraction of the full-CrossCLR positive
        weights on a host batch, per modality, in (0, 1] (1 = flat, 1/B =
        one-hot), from the loss's own connectivity arithmetic on up to
        ``WEIGHT_CHECK_ROWS`` rows; None for losses without a weighting
        channel.  An int8 payload is cast without its scales, as the JAX
        check does: the cosine connectivity cancels per-row scales."""
        max_rows = self.WEIGHT_CHECK_ROWS
        if self.cfg.loss not in _WEIGHTED_LOSSES:
            return None
        fracs = {}
        for name in ("video", "text"):
            x = to_tensor(batch[name][:max_rows], self.device, torch.float32)
            mask = batch.get(f"{name}_mask")
            if mask is not None:
                mask = to_tensor(mask[:max_rows], self.device)
            conn = F.connectivity_scores(F.masked_mean_pool(x, mask))
            _, w = F.connectivity_keep_and_weights(
                conn, prune_percent=self.cfg.prune_percent,
                weight_temperature=self.cfg.weight_temperature,
                weight_norm=self.cfg.weight_norm,
            )
            fracs[name] = float(F.weight_effective_fraction(w))
        return fracs

    # an ESS fraction below this on the first batch: the weight softmax
    # spends most of the batch's gradient on a handful of pairs
    WEIGHT_ESS_WARN = 0.02

    def _warn_if_degenerate_weights(self, batch: dict) -> None:
        if self.global_rank != 0:  # rank 0 alone reports, on its own rows
            return
        fracs = self.weight_degeneracy_check(batch)
        if not fracs:
            return
        detail = ", ".join(f"{k} ESS={v:.4f}" for k, v in fracs.items())
        print(f"positive-weight ESS on the first batch: {detail} "
              "(1.0 = flat weights)", file=sys.stderr)
        if min(fracs.values()) >= self.WEIGHT_ESS_WARN:
            return
        print(
            "WARNING: the full-CrossCLR positive-weight softmax is "
            f"near-one-hot on the first batch ({detail}; 1.0 = flat "
            "weights): weight_temperature="
            f"{self.cfg.weight_temperature} is far below this data's "
            "connectivity spread, so most pairs contribute almost no "
            "gradient.  Raise train.weight_temperature, or set "
            'train.weight_norm="standardized" (z-scored connectivity) '
            "with weight_temperature ~ 1.0 for a scale-robust weighting "
            "channel.",
            file=sys.stderr,
        )

    # -- init ---------------------------------------------------------------

    def init_state(self, state_dict: dict | None = None) -> TrainState:
        """Step-0 state: towers seeded from ``train.seed`` (or loaded from
        ``state_dict``, e.g. ``utils.params.state_dict_from_flax`` of a JAX
        trainer's params; whole tensors either way), fresh optimizer
        moments, and the EMA at the initial parameters when ``ema_decay``
        is set.  Under a group the parameters are rank 0's (broadcast),
        under tensor parallelism this rank's slices of them and, under
        ZeRO-1, the moments this rank's shards."""
        model = DualEncoder(self.video_cfg, self.text_cfg, mesh=self.mesh,
                            split=False)
        if state_dict is None:
            init_params(model, self.cfg.seed,
                        0.0 if self.cfg.learnable_temperature else 1.0)
        else:  # it replaces every leaf and persistent buffer
            model.load_state_dict(state_dict, strict=True)
        model = model.to(self.device)
        if self.world_group is not None:
            self._broadcast(list(model.parameters()))
        model = self._split(model).eval()
        params = dict(model.named_parameters())
        self._tp_dims = dict(model.tp_dims)
        rings = [f"{side}_tower." for side, cfg in (("video", self.video_cfg),
                                                    ("text", self.text_cfg))
                 if self.n_model > 1 and cfg.attention == "ring"]
        self._ring_summed = [k for k in params if k.startswith(tuple(rings))]
        self._model_summed = self._ring_summed + [
            k for k in params if consumed_sliced(k, self._tp_dims)]
        self._shard_dims = {k: _zero1_dim(p.shape, self.world, self._tp_dims[k])
                            if self.zero1 else None for k, p in params.items()}
        ema = None
        if self.cfg.ema_decay is not None:
            ema = {k: p.detach().clone() for k, p in params.items()}
        return TrainState(step=0, model=model,
                          opt_state=self.optimizer.init(self._opt_params(params)),
                          ema=ema)

    # -- the group ------------------------------------------------------------

    @torch.no_grad()
    def _broadcast(self, tensors: list[torch.Tensor]) -> None:
        """Rank 0's values of ``tensors`` on every rank, in place."""
        flat = _flat(tensors)
        dist.broadcast(flat, 0, group=self.world_group)
        _unflat_into(flat, tensors)

    def any_rank(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (every rank calls it at the
        same point: a stop that one rank's signal asked for stops all at the
        same dispatch boundary).  The vote is a host tensor on a gloo group
        (the trainer's own when it is gloo), so it never waits for the
        device's queued work."""
        if self.world_group is None:
            return flag
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._vote_group)
        return bool(t.item())

    def broadcast_int(self, value: int) -> int:
        """Rank 0's ``value`` on every rank."""
        if self.world_group is None:
            return value
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.broadcast(t, 0, group=self.world_group)
        return int(t.item())

    def barrier(self) -> None:
        if self.world_group is not None:
            dist.barrier(group=self.world_group)

    def _split(self, model: DualEncoder) -> DualEncoder:
        """``model`` (whole towers, on the device) as this rank holds it:
        itself, or under tensor parallelism a model of this rank's slices."""
        if not self.tensor_parallel:
            return model
        local = DualEncoder(self.video_cfg, self.text_cfg, mesh=self.mesh)
        local.load_state_dict(local.shard_state_dict(model.state_dict()))
        return local.to(self.device)

    def _whole(self, state: TrainState) -> DualEncoder:
        """A model of whole towers holding ``state``'s parameters (the
        slices joined over the model group: a collective of it)."""
        model = DualEncoder(self.video_cfg, self.text_cfg, mesh=self.mesh,
                            split=False)
        model.load_state_dict(state.model.full_state_dict())
        return model.to(self.device)

    @torch.no_grad()
    def global_leaf_sums(self, names: list[str], local: torch.Tensor
                         ) -> torch.Tensor:
        """Per-leaf sums ``[k, len(names)]`` over this rank's pieces of
        the leaves ``names`` as the whole leaves' sums, in one all-reduce
        over every rank: a leaf counts on a rank where it is a ZeRO-1
        shard or the rank's data coordinate is 0, and where it is a
        tensor-parallel slice or the model coordinate is 0, so each piece
        counts once."""
        counts = torch.tensor(
            [(self._shard_dims.get(k) is not None or self.rank == 0)
             and (self._tp_dims.get(k) is not None or self.model_index == 0)
             for k in names], device=local.device)
        total = torch.where(counts, local, torch.zeros_like(local))
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.world_group)
        return total

    def _opt_params(self, params: dict) -> dict:
        """What AdamW updates: under ZeRO-1 this rank's rows (a view) of
        each sharded parameter, else the parameters."""
        return {k: p if self._shard_dims[k] is None
                else _shard(p, self._shard_dims[k], self.rank, self.world)
                for k, p in params.items()}

    @torch.no_grad()
    def _gather_shards(self, shards: dict[str, torch.Tensor],
                       out: dict[str, torch.Tensor]) -> None:
        """Every rank's ``shards`` (ZeRO-1 rows) written into the full
        tensors ``out`` in place: one all-gather."""
        names = [k for k in shards if self._shard_dims[k] is not None]
        if not names:
            return
        local = torch.cat([_rank_major(shards[k], self._shard_dims[k], 1)[0]
                           for k in names])
        gathered = local.new_empty(self.world * local.numel())
        dist.all_gather_into_tensor(gathered, local, group=self.group)
        gathered = gathered.view(self.world, -1)
        offset = 0
        for k in names:
            dim, full = self._shard_dims[k], out[k]
            moved = full.movedim(dim, 0).shape
            n = full.numel() // self.world
            piece = gathered[:, offset:offset + n].reshape(moved)
            full.copy_(piece.movedim(0, dim))
            offset += n

    def checkpoint_state(self, state: TrainState) -> TrainState:
        """``state`` as a checkpoint holds it: whole tensors.  Under ZeRO-1
        or tensor parallelism a copy whose moments are gathered from every
        rank and whose model and EMA hold whole towers (a collective: every
        rank calls it), else ``state`` itself."""
        if not (self.zero1 or self.tensor_parallel):
            return state
        params = dict(state.model.named_parameters())
        opt = {"count": state.opt_state["count"]}
        for key in ("mu", "nu"):
            full = {k: torch.empty_like(p) if self._shard_dims[k] is not None
                    else state.opt_state[key][k] for k, p in params.items()}
            self._gather_shards(state.opt_state[key], full)
            opt[key] = full
        model, ema = state.model, state.ema
        if self.tensor_parallel:
            opt["mu"], opt["nu"] = (model.full_state_dict(opt[k]) for k in ("mu", "nu"))
            ema = None if ema is None else model.full_state_dict(ema)
            model = self._whole(state)
        return TrainState(step=state.step, model=model, opt_state=opt, ema=ema)

    def restored_state(self, state: TrainState) -> TrainState:
        """``state`` after ``CheckpointManager.restore`` into whole towers
        (:meth:`checkpoint_state`'s, or :meth:`init_state`'s on one rank):
        under a group its parameters and EMA broadcast from rank 0, under
        tensor parallelism cut to this rank's slices (a new model), and
        under ZeRO-1 each moment cut to this rank's shard."""
        if self.world_group is None:
            return state
        params = dict(state.model.named_parameters())
        ema = [] if state.ema is None else list(state.ema.values())
        self._broadcast(list(params.values()) + ema)
        if self.tensor_parallel:
            model = self._split(state.model).eval()
            cut = model.shard_state_dict
            state = TrainState(
                step=state.step, model=model,
                opt_state={"count": state.opt_state["count"],
                           **{k: {n: t.clone() for n, t in cut(state.opt_state[k]).items()}
                              for k in ("mu", "nu")}},
                ema=None if state.ema is None
                else {n: t.clone() for n, t in cut(state.ema).items()})
        if self.zero1:
            for key in ("mu", "nu"):
                moments = state.opt_state[key]
                for k, dim in self._shard_dims.items():
                    if dim is not None:
                        moments[k] = _shard(moments[k], dim, self.rank,
                                            self.world).clone()
        return state

    def ema_state(self, state: TrainState) -> TrainState:
        """``state`` with the EMA parameters in a copy of the model — what
        eval encodes with under ``eval_with_ema``."""
        if state.ema is None:
            raise ValueError(
                "state carries no EMA: set train.ema_decay in the config "
                "(from step 0 of training)"
            )
        model = copy.deepcopy(state.model)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(state.ema[name])
        return TrainState(step=state.step, model=model)

    # -- the step -----------------------------------------------------------

    def step_model(self, state: TrainState, chunk: int | None = None
                   ) -> torch.nn.Module:
        """``state``'s model in train mode with this step's attention-dropout
        masks: its generator reseeded from ``(train.seed, step)`` (past one
        data rank with no model axis, the rank; and the two-pass step's
        ``chunk``), whatever ran before."""
        model = state.model.train()
        fold = self.world > 1 and self.n_model == 1
        model.reseed_dropout(self.cfg.seed, state.step, chunk,
                             rank=self.rank if fold else None)
        return model

    def step_inputs(self, batch: dict) -> tuple:
        """A host or device batch on the device (a host field copied, a
        device one kept; an int8 store's features dequantized there):
        ``(video, text, video_mask, text_mask)``, a mask None where the
        batch has none."""
        batch = dequantize_batch({k: to_tensor(v, self.device)
                                  for k, v in batch.items()})
        return (batch["video"], batch["text"], batch.get("video_mask"),
                batch.get("text_mask"))

    def step_loss(self, model: torch.nn.Module, v_emb, t_emb, video, text,
                  video_mask=None, text_mask=None) -> torch.Tensor:
        """The step's loss of the towers' embeddings on device inputs:
        under ``learnable_temperature`` at ``cfg.temperature /
        exp(logit_scale)`` (the RAW parameter: the stored value is clamped
        after the update, so the loss never differentiates through a
        clip); the full CrossCLR losses score connectivity on the raw
        inputs pooled over their valid steps only, so padding never
        counts."""
        temperature, v_raw, t_raw = self._loss_args(model, video, text,
                                                    video_mask, text_mask)
        return self._loss_fn(v_emb, t_emb, v_raw, t_raw, temperature=temperature)

    def _loss_args(self, model, video, text, video_mask, text_mask):
        """``(temperature, v_raw, t_raw)`` of :meth:`step_loss`."""
        cfg = self.cfg
        temperature = None
        if cfg.learnable_temperature:
            temperature = cfg.temperature / torch.exp(model.logit_scale)
        v_raw = t_raw = None
        if cfg.loss in _WEIGHTED_LOSSES:
            v_raw = F.masked_mean_pool(video, video_mask)
            t_raw = F.masked_mean_pool(text, text_mask)
        return temperature, v_raw, t_raw

    def step_objective(self, model: torch.nn.Module, v_emb, t_emb, video, text,
                       video_mask=None, text_mask=None):
        """``(objective, loss)``: what this rank differentiates and the
        step's loss of the GLOBAL batch.  One rank: both are
        :meth:`step_loss`.  Past one rank, on the global-negative route the
        global loss (its value global, its gradient this rank's own); else
        the plain loss L of the batch all-gathered over the data group,
        with L / P to differentiate (see the module doc)."""
        if self.world == 1 and self.n_model == 1:
            loss = self.step_loss(model, v_emb, t_emb, video, text,
                                  video_mask, text_mask)
            return loss, loss
        cfg = self.cfg
        temperature, v_raw, t_raw = self._loss_args(model, video, text,
                                                    video_mask, text_mask)
        if self.use_global:
            kw = dict(group=self.group, negative_weight=cfg.negative_weight,
                      temperature=cfg.temperature if temperature is None
                      else temperature, use_fused=cfg.loss.endswith("_fused"),
                      precision=cfg.loss_precision)
            if cfg.loss in _WEIGHTED_LOSSES:
                loss = global_cross_clr(
                    v_emb, t_emb, v_raw, t_raw,
                    weight_temperature=cfg.weight_temperature,
                    prune_percent=cfg.prune_percent, weight_norm=cfg.weight_norm,
                    candidate_chunk=cfg.global_candidate_chunk, **kw)
            else:
                loss = global_cross_clr_intra(v_emb, t_emb, **kw)
            return loss, loss
        def gather(x):
            return x if x is None or self.world == 1 else all_gather(x, self.group)

        loss = self._loss_fn(gather(v_emb), gather(t_emb),
                             gather(None if v_raw is None else v_raw.detach()),
                             gather(None if t_raw is None else t_raw.detach()),
                             temperature=temperature)
        return loss / self.world, loss

    def two_pass(self, batch_size: int) -> bool:
        """Whether a step of ``batch_size`` rows is the two-pass step:
        ``embedding_chunk`` set and below the batch."""
        chunk = self.cfg.embedding_chunk
        return bool(chunk) and chunk < batch_size

    def value_and_grad(self, state: TrainState, inputs: tuple):
        """``(loss, (v_emb, t_emb), grads)`` of one step on device
        ``inputs`` (:meth:`step_inputs`), ``grads`` by parameter name (a
        parameter the loss does not reach, ``logit_scale`` at a fixed τ,
        gets zeros, as under ``jax.grad``).  The two-pass step when
        ``embedding_chunk`` is below the batch, else one pass."""
        rows = inputs[0].shape[0]
        if self.two_pass(rows):
            chunks = rows // self.cfg.embedding_chunk
            routes = []
            with span("train.encode", chunks):
                v_emb, t_emb = self.encode_chunks(state, inputs, routes)
            with span("train.loss"):
                loss, d_v, d_t, direct = self.embedding_grads(state, v_emb, t_emb,
                                                              inputs)
            with span("train.backward", chunks):
                grads = self.tower_grads(state, inputs, d_v, d_t, direct, routes)
            return loss, (v_emb, t_emb), grads
        with span("train.forward"):
            model = self.step_model(state)
            with routing(model) as used:
                v_emb, t_emb = model(*inputs)
            self.routes_used = [used]
        with span("train.loss"):
            objective, loss = self.step_objective(model, v_emb, t_emb, *inputs)
        with span("train.backward"):
            params = dict(model.named_parameters())
            grads = torch.autograd.grad(objective, list(params.values()),
                                        allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(params.items(), grads)}
        return loss, (v_emb, t_emb), grads

    def _chunks(self, inputs: tuple) -> list[tuple]:
        """The two-pass step's row chunks of ``inputs``, in order."""
        n, c = inputs[0].shape[0], self.cfg.embedding_chunk
        if n % c:
            raise ValueError(
                f"embedding_chunk {c} does not divide the (per-device) batch {n}")
        return [tuple(None if x is None else x[i:i + c] for x in inputs)
                for i in range(0, n, c)]

    def encode_chunks(self, state: TrainState, inputs: tuple,
                      routes: list | None = None):
        """Pass 1 of the two-pass step: the train-mode embeddings of the
        whole batch, encoded chunk by chunk without autograd.  Each chunk's
        MoE choices (``models.mla_moe.routing``; none without MoE layers)
        are appended to ``routes`` where it is given."""
        embs = []
        with torch.no_grad():
            for i, rows in enumerate(self._chunks(inputs)):
                model = self.step_model(state, i)
                with routing(model) as chosen:
                    embs.append(model(*rows))
                if routes is not None:
                    routes.append(chosen)
        return (torch.cat([v for v, _ in embs]), torch.cat([t for _, t in embs]))

    def embedding_grads(self, state: TrainState, v_emb, t_emb, inputs: tuple):
        """Pass 2: ``(loss, d_v, d_t, direct)`` — the loss over the whole
        batch and its gradient with respect to the embeddings and to the
        parameters the loss reaches directly (``direct``, by name:
        ``logit_scale`` under a learnable τ).  The towers do not run."""
        v = v_emb.detach().requires_grad_()
        t = t_emb.detach().requires_grad_()
        objective, loss = self.step_objective(state.model, v, t, *inputs)
        params = dict(state.model.named_parameters())
        d_v, d_t, *grads = torch.autograd.grad(
            objective, [v, t, *params.values()], allow_unused=True)
        direct = {k: g for k, g in zip(params, grads) if g is not None}
        return loss.detach(), d_v, d_t, direct

    def tower_grads(self, state: TrainState, inputs: tuple, d_v, d_t,
                    direct: dict, routes: list | None = None) -> dict:
        """Pass 3: each chunk's towers re-run with autograd (its dropout
        masks drawn again, and with ``routes``, pass 1's MoE choices
        replayed, so the gradients are those of the model whose loss pass 2
        took) and back-propagated from its rows of ``d_v``, ``d_t``; the
        parameter gradients summed over chunks in order, then pass 2's
        ``direct`` gradients added (the JAX step's ``d_params +
        g_towers``).  ``routes_used`` keeps the choices each chunk ran with."""
        params = dict(state.model.named_parameters())
        acc = {k: torch.zeros_like(p) for k, p in params.items()}
        c = self.cfg.embedding_chunk
        self.routes_used = []
        for i, rows in enumerate(self._chunks(inputs)):
            model = self.step_model(state, i)
            with routing(model, None if routes is None else routes[i]) as used:
                embs = model(*rows)
            self.routes_used.append(used)
            grads = torch.autograd.grad(
                embs, list(params.values()),
                grad_outputs=(d_v[i * c:(i + 1) * c], d_t[i * c:(i + 1) * c]),
                allow_unused=True)
            for (name, _), g in zip(params.items(), grads):
                if g is not None:
                    acc[name].add_(g)
        for name, g in direct.items():
            acc[name] = g + acc[name]
        return acc

    @torch.no_grad()
    def sum_model_grads(self, grads: dict) -> dict:
        """The gradients a rank holds a part of, summed over the model
        group in one flat buffer, one all-reduce (SUM): the ring towers'
        (then divided by n_model) and the tensor-parallel towers' biases
        consumed as slices (see the module doc); the others as they are."""
        tensors = [grads[k] for k in self._model_summed]
        if not tensors:
            return grads
        flat = _flat(tensors)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.model_group)
        _unflat_into(flat, tensors)
        for k in self._ring_summed:
            grads[k].div_(self.n_model)
        return grads

    @torch.no_grad()
    def sum_grads(self, grads: dict, norms: torch.Tensor):
        """``(grads, norms)``: the gradients summed over the ranks and the
        embedding-norm metrics ``[video, text]`` averaged, in one flat
        buffer, one all-reduce (SUM).  Under ZeRO-1 the sharded gradients
        are reduce-scattered first, so ``grads`` holds this rank's rows of
        them."""
        names = [k for k in grads if self._shard_dims.get(k) is None]
        shards = [k for k in grads if self._shard_dims.get(k) is not None]
        if shards:
            dims = [self._shard_dims[k] for k in shards]
            send = torch.cat([_rank_major(grads[k], d, self.world)
                              for k, d in zip(shards, dims)], dim=1)
            recv = send.new_empty(send.shape[1])
            dist.reduce_scatter_tensor(recv, send.reshape(-1),
                                       op=dist.ReduceOp.SUM, group=self.group)
            grads = dict(grads)
            offset = 0
            for k, d in zip(shards, dims):
                view = _shard(grads[k], d, self.rank, self.world)
                n = view.numel()
                piece = recv[offset:offset + n].view(view.movedim(d, 0).shape)
                grads[k] = piece.movedim(0, d)
                offset += n
        out = [grads[k] for k in names] + [norms / self.world]
        flat = _flat(out)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        out[-1] = norms
        _unflat_into(flat, out)
        return grads, norms

    def apply_grads(self, state: TrainState, grads: dict) -> dict:
        """Clip and apply the optimizer to ``state``'s parameters in place
        (under ZeRO-1 to this rank's rows, from :meth:`sum_grads`' shards,
        then all-gathered; the norms of shards through
        :meth:`global_leaf_sums`), clamp ``logit_scale`` (learnable τ) and
        update the EMA; returns the device-scalar metrics of the update."""
        cfg = self.cfg
        model = state.model
        params = dict(model.named_parameters())
        opt_params = self._opt_params(params) if self.zero1 else params
        reduce = None
        if self.zero1 or self.tensor_parallel:
            reduce = functools.partial(self.global_leaf_sums, list(opt_params))
        metrics = {"grad_norm": self.optimizer.update(opt_params, grads,
                                                      state.opt_state, reduce)}
        with torch.no_grad():
            if self.zero1:
                self._gather_shards(opt_params, params)
            if cfg.learnable_temperature:
                model.logit_scale.clamp_(-_LOGIT_SCALE_BOUND, _LOGIT_SCALE_BOUND)
                metrics["logit_scale"] = model.logit_scale.detach().clone()
                metrics["effective_temperature"] = (
                    cfg.temperature / torch.exp(model.logit_scale)
                )
            if state.ema is not None:
                d = cfg.ema_decay
                # after the clamp: the EMA tracks the stored logit_scale
                for name, p in params.items():
                    state.ema[name].mul_(d).add_(p, alpha=1.0 - d)
        return metrics

    def train_step(self, state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        """One optimizer step on a host batch; updates ``state`` in place
        and returns it with device-scalar metrics.

        Its layers are spans (``utils.profiling.span``): ``train.step``
        (count: the batch's rows) holds ``train.inputs``; one pass's
        ``train.forward``, ``train.loss`` and ``train.backward``, or the
        two-pass step's ``train.encode``, ``train.loss`` and
        ``train.backward`` (counts: chunks); ``train.collectives`` where a
        group exists; ``train.optimizer`` (count: parameter leaves)."""
        with span("train.step", len(batch["video"]), step=state.step,
                  device=self.device):
            with span("train.inputs"):
                inputs = self.step_inputs(batch)
            loss, (v_emb, t_emb), grads = self.value_and_grad(state, inputs)
            with torch.no_grad():
                norms = torch.stack([torch.linalg.vector_norm(v_emb, dim=1).mean(),
                                     torch.linalg.vector_norm(t_emb, dim=1).mean()])
            if self.model_group is not None or self.group is not None:
                with span("train.collectives"):
                    if self.model_group is not None:
                        grads = self.sum_model_grads(grads)
                    if self.group is not None:
                        grads, norms = self.sum_grads(grads, norms)
            with span("train.optimizer", len(grads)):
                update = self.apply_grads(state, grads)
            metrics = {"loss": loss.detach(), **update}
            metrics["video_emb_norm"], metrics["text_emb_norm"] = norms
            state.step += 1
        return state, metrics

    # -- eval ---------------------------------------------------------------

    def encode(self, state: TrainState, batch: dict):
        """``(video_emb, text_emb)`` fp32 ``[B, E]`` for a host or device
        batch (int8 features dequantized on the device), in eval mode.  With
        ring towers every rank of the model group calls it on the same
        batch: the ring runs over them all, as the JAX encode does under its
        mesh."""
        with torch.inference_mode():
            return state.model.eval()(*self.step_inputs(batch))

    def encode_modality(self, state: TrainState, side: str, features,
                        mask=None) -> torch.Tensor:
        """Encode ONE modality through its own tower only (the serving
        hot path): fp32 ``[B, E]`` on the trainer's device; host or device
        features."""
        dev = self.device
        with torch.inference_mode():
            return state.model.eval().encode(
                side, to_tensor(features, dev), _optional(mask, dev)
            )

    # -- stacked chunks -----------------------------------------------------

    def stacked_budget(self) -> int:
        """The byte budget of ONE stacked ``[n, B, ...]`` chunk, 0 for none:
        ``train.max_stacked_bytes`` when set, else a quarter of the card's
        memory (the chunk and the prefetched next one, the two that
        ``data.train_stream`` keeps on the card, must leave room for the
        parameters and activations), 2 GiB on the CPU."""
        if self.cfg.max_stacked_bytes is not None:
            return self.cfg.max_stacked_bytes
        if self.device.type == "cuda":
            return torch.cuda.mem_get_info(self.device)[1] // 4
        return 2 << 30

    def train_steps(self, state: TrainState, stacked: dict,
                    limit: int | None = None) -> tuple[TrainState, dict]:
        """Run the chunk's ``n`` steps (its first ``limit``) in order, each
        batch ``stacked[k][i]`` indexed on the device; returns the state
        and the last step's metrics.  A chunk over :meth:`stacked_budget`
        raises before its first step."""
        n = stacked["video"].shape[0]
        if limit is not None and not 0 < limit <= n:
            raise ValueError(f"limit {limit} outside chunk length {n}")
        check_chunk_bytes(sum(_nbytes(v) for v in stacked.values()), n,
                          self.stacked_budget())
        chunk = {k: to_tensor(v, self.device) for k, v in stacked.items()}
        for i in range(n if limit is None else limit):
            state, metrics = self.train_step(state, {k: v[i] for k, v in chunk.items()})
        return state, metrics

    # -- loop ---------------------------------------------------------------

    def fit(self, state: TrainState, batches, *, steps: int,
            log_every: int = 50, writer: Any = None,
            step_offset: int | None = None,
            should_stop: Callable[[], bool] | None = None,
            prestacked: bool = False,
            ) -> tuple[TrainState, list[dict]]:
        """Run ``steps`` train steps, ``cfg.steps_per_call`` per dispatch
        (a plain loop; metrics and ``should_stop`` are read once per
        dispatch, from its last step).  ``prestacked``: ``batches`` yields
        ``[n, B, ...]`` chunks (``data.stacked_chunks``), one dispatch each
        through :meth:`train_steps`, the last one trimmed to the steps that
        remain.  At each ``log_every`` boundary and at the end the metrics
        are read to the host with ``steps_per_sec`` and ``pairs_per_sec``
        (the clock restarts after the first dispatch, so they are
        steady-state rates; pairs of the global batch, every rank's rows)
        and the global ``step``; a non-finite loss
        there raises ``FloatingPointError`` under ``abort_on_nonfinite``."""
        history = []
        it = iter(batches)
        if (self.cfg.loss in _WEIGHTED_LOSSES and steps > 0
                and not self._weight_diag_done):
            # once per trainer (train.py calls fit once per eval interval):
            # reports the positive weights' ESS, and a near-one-hot softmax
            # warns instead of silently training on one pair
            self._weight_diag_done = True
            first = next(it, None)
            if first is not None:
                self._warn_if_degenerate_weights(
                    {k: v[0] for k, v in first.items()} if prestacked else first)
                it = itertools.chain([first], it)
        if step_offset is None:
            step_offset = state.step
        spc = max(1, self.cfg.steps_per_call)
        t_start = time.perf_counter()
        t_steady = t_start
        steady_base = 0
        done = 0
        while done < steps:
            if should_stop is not None and should_stop():
                break
            if prestacked:
                chunk = next(it)
                m = chunk["video"].shape[0]
                n = min(m, steps - done)
                state, metrics = self.train_steps(
                    state, chunk, limit=n if n < m else None)
                batch_rows = chunk["video"].shape[1]
            else:
                n = min(spc, steps - done)
                for _ in range(n):
                    batch = next(it)
                    state, metrics = self.train_step(state, batch)
                batch_rows = batch["video"].shape[0]
            first_dispatch = done == 0
            prev_done, done = done, done + n
            if first_dispatch:
                _synchronize(self.device)
                t_steady = time.perf_counter()
                steady_base = done
            crossed_log = (done // log_every) > (prev_done // log_every)
            if crossed_log or done >= steps:
                metrics = {k: float(v) for k, v in metrics.items()}
                if self.cfg.abort_on_nonfinite and not np.isfinite(metrics["loss"]):
                    raise FloatingPointError(
                        f"non-finite loss {metrics['loss']} at step "
                        f"{step_offset + done}; aborting (resume from the "
                        "last checkpoint; set train.abort_on_nonfinite=false "
                        "to continue anyway, or use utils.profiling.nan_debug "
                        "to locate the source)"
                    )
                if first_dispatch:
                    rate = n / max(t_steady - t_start, 1e-9)
                else:
                    rate = (done - steady_base) / max(
                        time.perf_counter() - t_steady, 1e-9
                    )
                metrics["steps_per_sec"] = rate
                # the global batch: every rank's rows
                metrics["pairs_per_sec"] = rate * batch_rows * self.world
                metrics["step"] = step_offset + done
                history.append(metrics)
                if writer is not None:
                    writer(metrics)
        return state, history


def _flat(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_into(flat: torch.Tensor, tensors: list[torch.Tensor]) -> None:
    """The pieces of ``flat`` copied back into ``tensors``, in order: into
    their own memory, so what reads them next sees the layout it saw
    before (at one rank, the same bits as without a group)."""
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def _zero1_dim(shape, world: int, taken: int | None = None) -> int | None:
    """ZeRO-1's sharded dimension: the first that ``world`` divides, other
    than the tensor-parallel dimension ``taken`` (``_zero1_spec``), None
    for a leaf that stays replicated."""
    for i, n in enumerate(shape):
        if i != taken and n >= world and n % world == 0:
            return i
    return None


def _shard(x: torch.Tensor, dim: int, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s rows of ``x`` along ``dim`` (a view)."""
    n = x.shape[dim] // world
    return x.narrow(dim, rank * n, n)


def _rank_major(x: torch.Tensor, dim: int, world: int) -> torch.Tensor:
    """``[world, -1]``: row r is rank r's shard of ``x``, flattened with
    ``dim`` first."""
    return x.movedim(dim, 0).reshape(world, -1)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _optional(x, device):
    return None if x is None else to_tensor(x, device)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes
