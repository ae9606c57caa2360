"""Ring attention: sequence-parallel attention over the model group.

Counterpart of ``crossclr_tpu/parallel/ring_attention.py``.  The sequence
of a batch is cut into ``n`` shards over the ranks of a model group
(:mod:`.mesh`); every position-wise layer runs on its rank's shard alone,
and attention passes each rank's K/V block to its ring neighbour while the
rank folds every visiting block into its queries' result.  After ``n``
blocks every query has seen every key; a rank holds one block at a time.

Ring step ``t`` on rank ``me`` sees the block of rank ``(me − t) mod n``.
The forward makes ``n − 1`` rotations.  The backward is a second ring,
written by hand (:class:`_RingCore`): each block's dK/dV accumulators
travel with it and the last of its ``n`` rotations carries only them home.
Autograd through the forward ring would keep every step's K/V alive.

Per-block math (``block_impl``), as in the JAX package:

* ``"flash"``: the flash kernels of :mod:`..ops.flash_attention` on each
  visiting block (ring-of-flash).  The forward kernel's ``(out, lse)``
  pairs over disjoint key blocks merge exactly (:func:`_merge_partials`);
  the output and lse stay fp32 through the merge, and the merged pair
  drives the dq and dk/dv kernels with the global lse and
  ``Δ = rowsum(dO∘O)`` of the merged fp32 output, so each block's
  gradient is its exact share.  On CUDA tensors the kernels launch (one
  forward, one dq and one dk/dv per block); on CPU tensors their plain
  versions run (``mha_reference``, ``flash_dq_plain``,
  ``flash_dkv_plain``).
* ``"jnp"`` (the JAX name, kept so the configs load): the plain online
  softmax over materialized ``[s_loc, s_loc]`` score blocks.
* ``"auto"``: the kernels on a CUDA tensor (they mask the edges and take
  any ``s_local``), the plain blocks on the CPU; ``interpret`` resolves it
  to the kernels' plain versions on the CPU, as the JAX package's
  resolves it to its interpreted kernels.

Dropout is the kernels' hash mask of global ``(bh, query, key)`` indices:
each block passes its window's ``(q_offset, k_offset)``, and a batch split
over the data axis passes its rows' place in the global batch·head range
(``dropout_bh_offset``), so a sharded run drops what one device running
the whole sequence drops.

Transport: the rotation is one message a step, the step's tensors packed
into one byte buffer, sent to rank ``me + 1`` and received from ``me − 1``
with ``dist.batch_isend_irecv``.  On NCCL the buffers are the device
tensors.  Gloo cannot send a CUDA tensor point to point, so on a gloo group
with CUDA tensors the buffer is staged through page-locked host memory
(:func:`transport` names the choice); every block's math stays on the
device.  The rotation does not overlap the block's compute.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.flash_attention import (
    MAX_FLOOR,
    dropout_keep_mask,
    flash_attention_fwd,
    flash_dkv_cuda,
    flash_dkv_plain,
    flash_dq_cuda,
    flash_dq_plain,
    fold_seed,
    mha_reference,
)
from .mesh import MODEL_AXIS, Mesh

__all__ = ["BLOCK_IMPLS", "ring_attention", "sequence_parallel_attention",
           "transport"]

BLOCK_IMPLS = ("auto", "jnp", "flash")
_NEG_INF = float("-inf")
_ALIGN = 256  # bytes: where each tensor starts in a rotation's buffer


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


def transport(group, device) -> str:
    """How a ring over ``group`` moves blocks of tensors on ``device``:
    ``"none"`` (one rank), ``"nccl"``, ``"gloo"`` (CPU tensors) or
    ``"gloo, staged through page-locked host memory"`` (CUDA tensors)."""
    if group is None or dist.get_world_size(group) == 1:
        return "none"
    backend = dist.get_backend(group)
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "gloo, staged through page-locked host memory"
    return str(backend)


class _Ring:
    """A model group as a ring: ``n`` ranks, this one at ``me``, and the
    global ranks of its neighbours."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.n = 1 if group is None else dist.get_world_size(group)
        self.me = 0 if group is None else dist.get_rank(group)
        self.staged = transport(group, device).startswith("gloo, staged")
        if self.n > 1:
            self.next = dist.get_global_rank(group, (self.me + 1) % self.n)
            self.prev = dist.get_global_rank(group, (self.me - 1) % self.n)

    def rotate(self, tensors: tuple) -> tuple:
        """``jax.lax.ppermute`` with perm ``i → i + 1``: each tensor sent to
        the next rank and the previous rank's received in its place (None
        stays None)."""
        flat, layout = _pack([t for t in tensors if t is not None])
        recv = torch.empty_like(flat)
        if self.staged:
            send_h = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
            recv_h = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
            send_h.copy_(flat)
            self._exchange(send_h, recv_h)
            recv.copy_(recv_h)
        else:
            self._exchange(flat, recv)
        moved = iter(_unpack(recv, layout))
        return tuple(None if t is None else next(moved) for t in tensors)

    def _exchange(self, send: torch.Tensor, recv: torch.Tensor) -> None:
        ops = [dist.P2POp(dist.isend, send, self.next, self.group),
               dist.P2POp(dist.irecv, recv, self.prev, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _pack(tensors: list) -> tuple[torch.Tensor, list]:
    """One byte buffer holding ``tensors``, each at an offset aligned to
    ``_ALIGN`` bytes, and the layout that :func:`_unpack` reads."""
    pieces, layout, offset = [], [], 0
    for t in tensors:
        raw = t.contiguous().view(-1).view(torch.uint8)
        layout.append((offset, raw.numel(), t.dtype, t.shape))
        pieces.append(raw)
        pad = -raw.numel() % _ALIGN
        if pad:
            pieces.append(raw.new_zeros(pad))
        offset += raw.numel() + pad
    return torch.cat(pieces), layout


def _unpack(flat: torch.Tensor, layout: list) -> list:
    return [flat[o:o + n].view(dtype).view(shape) for o, n, dtype, shape in layout]


# ---------------------------------------------------------------------------
# the plain block math ("jnp")
# ---------------------------------------------------------------------------


def _block_scores(q, k, scale, mask):
    s = scale * torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if mask is not None:
        s = s.masked_fill(~mask.bool()[:, None, None, :], _NEG_INF)
    return s


def _block_keep(qf, drop: dict, q_off: int, k_off: int, sk: int):
    """``[B, H, sq, sk]`` keep mask of one ring block: the kernels' hash
    mask windowed at the block's global offsets; None without dropout."""
    if drop["dropout_rate"] <= 0.0:
        return None
    b, h, sq, _ = qf.shape
    return dropout_keep_mask(b, h, sq, drop["dropout_seed"], drop["dropout_rate"],
                                sk=sk, q_offset=q_off, k_offset=k_off,
                                bh_offset=drop["bh_offset"], device=qf.device)


def _online_block(qf, k_blk, v_blk, mask_blk, scale, m, l, acc, keep=None):
    """Fold one K/V block into the online-softmax accumulators.  ``keep``
    zeroes value-aggregation terms only: the denominator ``l`` keeps every
    term (the caller scales the survivors by 1/(1−r) once, at the end)."""
    s = _block_scores(qf, k_blk, scale, mask_blk)  # [B, H, sq, sk]
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True)).clamp_min(MAX_FLOOR)
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    p_v = p if keep is None else torch.where(keep, p, torch.zeros_like(p))
    acc_new = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p_v, v_blk.float())
    return m_new, l_new, acc_new


def _grad_block(qf, do, delta, lse, k_blk, v_blk, mask_blk, scale,
                dq_acc, dk_blk, dv_blk, keep=None, inv_keep=1.0):
    """One block's share of dq (local) and of dk/dv (the block's travelling
    accumulators), from ``p = exp(s − lse)`` with the global lse."""
    s = _block_scores(qf, k_blk, scale, mask_blk)
    p = torch.exp(s - lse)  # a masked key: exp(−inf) = 0
    pd = p if keep is None else torch.where(keep, p * inv_keep, torch.zeros_like(p))
    dv_blk = dv_blk + torch.einsum("bhqk,bhqd->bhkd", pd, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v_blk.float())
    ds = (pd * dp - p * delta) * scale
    dq_acc = dq_acc + torch.einsum("bhqk,bhkd->bhqd", ds, k_blk.float())
    dk_blk = dk_blk + torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq_acc, dk_blk, dv_blk


def _window(ring: _Ring, s_loc: int, t: int) -> tuple[int, int]:
    """Ring step ``t``'s global ``(q_offset, k_offset)``: the visiting block
    belongs to rank ``(me − t) mod n``."""
    return ring.me * s_loc, ((ring.me - t) % ring.n) * s_loc


def _inv_keep(drop: dict) -> float:
    rate = drop["dropout_rate"]
    return 1.0 / (1.0 - rate) if rate > 0.0 else 1.0


def _ring_fwd(ring, q, k, v, mask, scale, drop):
    s_loc = q.shape[2]
    qf = q.float()

    def keep(t):
        return _block_keep(qf, drop, *_window(ring, s_loc, t), s_loc)

    zeros_row = torch.zeros_like(qf[..., :1])
    m, l, acc = _online_block(qf, k, v, mask, scale, zeros_row + MAX_FLOOR,
                              zeros_row, torch.zeros_like(qf), keep(0))
    k_b, v_b, m_b = k, v, mask
    for t in range(1, ring.n):
        k_b, v_b, m_b = ring.rotate((k_b, v_b, m_b))
        m, l, acc = _online_block(qf, k_b, v_b, m_b, scale, m, l, acc, keep(t))
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    out = acc * (_inv_keep(drop) / safe_l)
    if mask is not None:
        # a row whose whole global key set is masked emits zeros: l is the
        # full sequence's softmax denominator, 0 exactly there
        out = torch.where(l > 0, out, torch.zeros_like(out))
    return out, m, l


def _ring_bwd(ring, q, k, v, mask, out, m, l, dout, scale, drop):
    s_loc = q.shape[2]
    qf, do = q.float(), dout.float()
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    lse = m + torch.log(safe_l)  # a fully masked row: m = floor, so p = 0
    delta = (do * out).sum(dim=-1, keepdim=True)

    def keep(t):  # the forward's step-t mask, drawn again
        return _block_keep(qf, drop, *_window(ring, s_loc, t), s_loc)

    dq, dk_b, dv_b = _grad_block(
        qf, do, delta, lse, k, v, mask, scale, torch.zeros_like(qf),
        torch.zeros_like(k, dtype=torch.float32),
        torch.zeros_like(v, dtype=torch.float32), keep(0), _inv_keep(drop))
    k_b, v_b, m_b = k, v, mask
    for t in range(1, ring.n):
        # dK/dV travel with their K/V block
        k_b, v_b, m_b, dk_b, dv_b = ring.rotate((k_b, v_b, m_b, dk_b, dv_b))
        dq, dk_b, dv_b = _grad_block(qf, do, delta, lse, k_b, v_b, m_b, scale,
                                     dq, dk_b, dv_b, keep(t), _inv_keep(drop))
    if ring.n > 1:  # one hop short of home: the last carries only dK/dV
        dk_b, dv_b = ring.rotate((dk_b, dv_b))
    return dq.to(q.dtype), dk_b.to(k.dtype), dv_b.to(v.dtype)


# ---------------------------------------------------------------------------
# the flash blocks (ring-of-flash)
# ---------------------------------------------------------------------------


def _block_words(ring, drop, s_loc, t) -> dict:
    q_off, k_off = _window(ring, s_loc, t)
    return dict(dropout_rate=drop["dropout_rate"], dropout_seed=drop["dropout_seed"],
                q_offset=q_off, k_offset=k_off, bh_offset=drop["bh_offset"])


def _flash_block_fwd(q, k, v, mask, scale, words):
    """``(out in q's dtype, lse fp32)`` of one block: the forward kernel on
    CUDA tensors, its plain version on CPU tensors."""
    if q.is_cuda:
        return flash_attention_fwd(q, k, v, mask, scale, **words)
    return mha_reference(q, k, v, mask, scale, True, **words)


def _flash_block_bwd(q, k, v, mask, lse, delta, do, scale, words):
    """``(dq, dk, dv)`` of one block from the global lse and Δ: the dq and
    dk/dv kernels on CUDA tensors, their plain versions on CPU tensors."""
    if q.is_cuda:
        dq = flash_dq_cuda(q, k, v, mask, lse, delta, do, scale, **words)
        return (dq, *flash_dkv_cuda(q, k, v, mask, lse, delta, do, scale, **words))
    dq = flash_dq_plain(q, k, v, mask, lse, delta, do, scale, **words)
    return (dq, *flash_dkv_plain(q, k, v, mask, lse, delta, do, scale, **words))


def _merge_partials(o, lse, o_blk, lse_blk):
    """Two partial results over DISJOINT key sets merged into the exact
    result over their union.  One of the two weights is exactly 1, so the
    denominator is ≥ 1, also on a row masked everywhere (both lse at the
    floor: both outputs 0, merged 0)."""
    m = torch.maximum(lse, lse_blk)
    a = torch.exp(lse - m)
    b = torch.exp(lse_blk - m)
    o = (a[..., None] * o + b[..., None] * o_blk.float()) / (a + b)[..., None]
    return o, m + torch.log(a + b)


def _ring_fwd_flash(ring, q, k, v, mask, scale, drop):
    s_loc = q.shape[2]
    o_blk, lse = _flash_block_fwd(q, k, v, mask, scale,
                                  _block_words(ring, drop, s_loc, 0))
    o = o_blk.float()
    k_b, v_b, m_b = k, v, mask
    for t in range(1, ring.n):
        k_b, v_b, m_b = ring.rotate((k_b, v_b, m_b))
        o_blk, lse_blk = _flash_block_fwd(q, k_b, v_b, m_b, scale,
                                          _block_words(ring, drop, s_loc, t))
        o, lse = _merge_partials(o, lse, o_blk, lse_blk)
    return o, lse  # fp32 until the caller's cast


def _ring_bwd_flash(ring, q, k, v, mask, o, lse, dout, scale, drop):
    s_loc = q.shape[2]
    do = dout.to(q.dtype).contiguous()  # the cotangent of a cast: exact
    # Δ from the merged fp32 output, as the JAX ring takes it from o_fold
    delta = (dout.float() * o).sum(dim=-1)
    dq, dk_b, dv_b = (x.float() for x in _flash_block_bwd(
        q, k, v, mask, lse, delta, do, scale, _block_words(ring, drop, s_loc, 0)))
    k_b, v_b, m_b = k, v, mask
    for t in range(1, ring.n):
        k_b, v_b, m_b, dk_b, dv_b = ring.rotate((k_b, v_b, m_b, dk_b, dv_b))
        dq_t, dk_t, dv_t = _flash_block_bwd(q, k_b, v_b, m_b, lse, delta, do, scale,
                                            _block_words(ring, drop, s_loc, t))
        dq = dq + dq_t.float()
        dk_b = dk_b + dk_t.float()
        dv_b = dv_b + dv_t.float()
    if ring.n > 1:
        dk_b, dv_b = ring.rotate((dk_b, dv_b))
    return dq.to(q.dtype), dk_b.to(k.dtype), dv_b.to(v.dtype)


# ---------------------------------------------------------------------------
# the hand-written backward over both block implementations
# ---------------------------------------------------------------------------


class _RingCore(torch.autograd.Function):
    """The forward ring, and the second ring as its backward: it keeps
    the local q, k, v and the merged result, never a visiting block."""

    @staticmethod
    def forward(ctx, q, k, v, mask, ring, scale, impl, drop):
        ctx.ring, ctx.scale, ctx.impl, ctx.drop = ring, scale, impl, drop
        if impl == "flash":
            out, lse = _ring_fwd_flash(ring, q, k, v, mask, scale, drop)
            ctx.save_for_backward(q, k, v, mask, out, lse)
        else:
            out, m, l = _ring_fwd(ring, q, k, v, mask, scale, drop)
            ctx.save_for_backward(q, k, v, mask, out, m, l)
        return out

    @staticmethod
    def backward(ctx, dout):
        if ctx.impl == "flash":
            q, k, v, mask, out, lse = ctx.saved_tensors
            grads = _ring_bwd_flash(ctx.ring, q, k, v, mask, out, lse, dout,
                                    ctx.scale, ctx.drop)
        else:
            q, k, v, mask, out, m, l = ctx.saved_tensors
            grads = _ring_bwd(ctx.ring, q, k, v, mask, out, m, l, dout,
                              ctx.scale, ctx.drop)
        return (*grads, None, None, None, None, None)


def _resolve_block_impl(block_impl: str, q: torch.Tensor, interpret: bool) -> str:
    if block_impl not in BLOCK_IMPLS:
        raise ValueError(f"block_impl must be one of {BLOCK_IMPLS}, got {block_impl!r}")
    if block_impl != "auto":
        return block_impl
    return "flash" if q.is_cuda or interpret else "jnp"


def ring_attention(q, k, v, mask=None, *, group=None, scale=None,
                   block_impl: str = "auto", interpret: bool = False,
                   dropout_rate: float = 0.0, dropout_seed=0,
                   dropout_bh_offset: int = 0) -> torch.Tensor:
    """Exact attention over a sequence sharded over ``group`` (the model
    group; None is a ring of one rank).

    ``q``, ``k``, ``v``: this rank's ``[B, H, s_local, Dh]`` shards, the
    rank's place in ``group`` its place in the sequence; ``mask``: its
    ``[B, s_local]`` key-padding shard (1 = valid).  Returns this rank's
    ``[B, H, s_local, Dh]`` slice of full-sequence attention in q's dtype,
    differentiable in q, k and v through the hand-written ring backward.
    Every rank of ``group`` calls it together.  ``block_impl`` and
    ``interpret``: see the module doc.  ``dropout_rate`` > 0 drops what
    one device over the whole sequence drops with the same
    ``dropout_seed``; with the batch also split over a data axis, pass
    ``dropout_bh_offset`` = this shard's first row in the global folded
    batch·head range (``data_index · B_local · H``)."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one shape [B, H, s_local, Dh], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    impl = _resolve_block_impl(block_impl, q, interpret)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if mask is not None:
        if tuple(mask.shape) != (q.shape[0], q.shape[2]):
            raise ValueError(f"mask must be [B, s_local] = {(q.shape[0], q.shape[2])}, "
                             f"got {tuple(mask.shape)}")
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
    drop = dict(dropout_rate=float(dropout_rate),
                dropout_seed=fold_seed(dropout_seed) if dropout_rate > 0 else 0,
                bh_offset=int(dropout_bh_offset))
    out = _RingCore.apply(q, k, v, mask, _Ring(group, q.device), scale, impl, drop)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# the standalone wrapper over global tensors
# ---------------------------------------------------------------------------


def _local(x: torch.Tensor, mesh: Mesh, split: bool, seq_dim: int = 2) -> torch.Tensor:
    """This rank's block of a global tensor: its sequence shard by model
    coordinate and, ``split``, its rows by data coordinate."""
    s_loc = x.shape[seq_dim] // mesh.n_model
    x = x.narrow(seq_dim, mesh.model_index * s_loc, s_loc)
    if split:
        b_loc = x.shape[0] // mesh.n_data
        x = x.narrow(0, mesh.data_index * b_loc, b_loc)
    return x.contiguous()


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ranks' ``x`` joined along ``dim`` in group-rank order."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    part = x.movedim(dim, 0).contiguous()
    out = part.new_empty((dist.get_world_size(group) * part.shape[0], *part.shape[1:]))
    dist.all_gather_into_tensor(out, part, group=group)
    return out.movedim(0, dim)


def _global(x: torch.Tensor, mesh: Mesh, split: bool) -> torch.Tensor:
    x = _gather(x, mesh.model_group, 2)
    return _gather(x, mesh.data_group, 0) if split else x


class _Shard(torch.autograd.Function):
    """Global → this rank's block; the backward gathers every rank's block
    gradient, so each rank holds the global gradient."""

    @staticmethod
    def forward(ctx, x, mesh, split):
        ctx.mesh, ctx.split = mesh, split
        return _local(x, mesh, split)

    @staticmethod
    def backward(ctx, g):
        return _global(g, ctx.mesh, ctx.split), None, None


class _Unshard(torch.autograd.Function):
    """This rank's block → the global tensor; every rank computes the same
    function of it, so the backward takes this rank's block of the
    cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, split):
        ctx.mesh, ctx.split = mesh, split
        return _global(x, mesh, split)

    @staticmethod
    def backward(ctx, g):
        return _local(g, ctx.mesh, ctx.split), None, None


def sequence_parallel_attention(q, k, v, mask=None, *, mesh: Mesh,
                                axis: str = MODEL_AXIS, scale=None,
                                block_impl: str = "auto", interpret: bool = False,
                                dropout_rate: float = 0.0,
                                dropout_seed=0) -> torch.Tensor:
    """Exact attention over global ``[B, H, S, Dh]`` tensors (and a global
    ``[B, S]`` mask) that every rank of ``mesh`` holds, the sequence
    sharded over the model axis: each rank runs :func:`ring_attention` on
    its shard and the result is gathered back to the global shape on every
    rank, its gradients global on every rank too.  Every rank of the mesh
    calls it together.

    The batch is split over the data axis when it divides evenly (each
    data group rings its own rows), else every data group rings the whole
    batch.  Split, each shard's rows keep their global dropout masks
    (``dropout_bh_offset = data_index · B_local · H``)."""
    if axis != MODEL_AXIS:
        raise ValueError(f"the ring runs over the {MODEL_AXIS!r} axis, got {axis!r}")
    b, h, s, _ = q.shape
    if s % mesh.n_model:
        raise ValueError(f"sequence length {s} not divisible by the model axis "
                         f"{mesh.n_model}")
    split = mesh.n_data > 1 and b % mesh.n_data == 0
    local = [_Shard.apply(x, mesh, split) for x in (q, k, v)]
    m_loc = None if mask is None else _local(mask, mesh, split, seq_dim=1)
    bh_offset = 0
    if split and dropout_rate > 0.0:
        bh_offset = mesh.data_index * local[0].shape[0] * h
    out = ring_attention(*local, m_loc, group=mesh.model_group, scale=scale,
                         block_impl=block_impl, interpret=interpret,
                         dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                         dropout_bh_offset=bh_offset)
    return _Unshard.apply(out, mesh, split)
