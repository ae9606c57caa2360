"""The port's attention dropout and flash backward against the JAX package.

On the CPU: the port's keep mask (``dropout_keep_mask``, ``fold_seed``)
must equal the JAX package's bit for bit, at several shapes, rates,
offsets and a seed past 2^24.  The port's plain attention with dropout and
its autograd gradients are held against the JAX ``mha_reference`` and
``jax.grad`` (fp32: forward atol 1e-5, gradients rtol 1e-4 / atol 1e-5:
fp32 sums in another order) and against the JAX Pallas kernels run in
interpret mode.  The backward kernels' plain versions (``flash_dq_plain``,
``flash_dkv_plain``) are held against autograd through the plain attention
at the same limits.

The ``requires_cuda`` cases hold each CUDA kernel against the plain
version on the card, with the limits ``chip_smoke.py`` enforces: the
forward as in ``tests/test_torch_flash_attention.py``; dq, dk and dv at
fp32 within 5e-5 of the largest entry (both sum in fp32, in another
order) and at bf16 at atol = rtol = 1.6e-2 (one bf16 ulp of the outputs
plus the order of the sums).
"""

import importlib

import numpy as np
import pytest
import torch

port = importlib.import_module("crossclr_tpu_torch.ops.flash_attention")

ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _jfa():
    return importlib.import_module("crossclr_tpu.ops.flash_attention")


def _inputs(b, h, s, dh, masked, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32)
               for _ in range(3))
    g = rng.standard_normal((b, h, s, dh)).astype(np.float32)  # cotangent
    mask = None
    if masked:
        lengths = rng.integers(1, s + 1, size=b)
        mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32)
        mask[-1] = 0.0  # one batch entry with no valid key at all
    return q, k, v, mask, g


MASK_CASES = [
    # b, h, s, seed, rate, q_offset, k_offset, bh_offset
    (2, 3, 17, 7, 0.3, 0, 0, 0),
    (1, 8, 64, 11, 0.1, 0, 0, 0),
    (4, 2, 37, 123456, 0.5, 0, 0, 0),
    (2, 2, 96, 8388607, 0.9, 0, 0, 0),
    (1, 2, 32, 5, 0.25, 48, 16, 0),
    (2, 3, 16, 13, 0.4, 0, 0, 6),
    (1, 2, 24, 2**25 + 3, 0.35, 8, 40, 4),  # the seed rounds in fp32
    (1, 1, 8, -5, 0.2, 0, 0, 0),
]


@pytest.mark.parametrize("b,h,s,seed,rate,qo,ko,bo", MASK_CASES)
def test_keep_mask_equals_jax_exactly(b, h, s, seed, rate, qo, ko, bo):
    want = np.asarray(_jfa().dropout_keep_mask(
        b, h, s, seed, rate, q_offset=qo, k_offset=ko, bh_offset=bo))
    got = port.dropout_keep_mask(b, h, s, seed, rate, q_offset=qo,
                                 k_offset=ko, bh_offset=bo).numpy()
    assert got.dtype == np.bool_ and got.shape == (b, h, s, s)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, 2**23 - 1, 2**23, 2**24 + 1,
                                  2**25 + 3, -5, 10**9 + 7])
def test_fold_seed_equals_jax(seed):
    want = float(_jfa().fold_seed(seed))
    assert port.fold_seed(seed) == want
    assert 0 <= port.fold_seed(seed) < 2**23


def test_keep_mask_windows_and_rows_are_slices_of_the_full_mask():
    """Offsets place a window inside the full sequence and a shard's rows
    inside the full batch·head range (the ring and dp×sp property)."""
    full = port.dropout_keep_mask(4, 3, 64, 9, 0.35)
    win = port.dropout_keep_mask(4, 3, 16, 9, 0.35, sk=24, q_offset=8,
                                 k_offset=40)
    assert torch.equal(win, full[:, :, 8:24, 40:64])
    hi = port.dropout_keep_mask(2, 3, 64, 9, 0.35, bh_offset=6)
    assert torch.equal(hi, full[2:])
    keep = port.dropout_keep_mask(2, 4, 128, 3, 0.3).float().mean().item()
    assert abs(keep - 0.7) < 0.01


def _agreement(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a == b).float().mean().item()


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_keep_mask_statistics(rate):
    """The hash behaves like independent Bernoulli(1 − rate) draws: the
    keep rate of every row, every column and every diagonal stripe of
    every (batch, head) slice within 5 sigma; two seeds, and two
    ``bh_offset`` shards, agree at the independent rate
    ``r² + (1 − r)²``.  The kernels draw the same bits (the card's exact
    mask recovery in ``chip_smoke.py``)."""
    b, h, s = 2, 4, 256
    keep = port.dropout_keep_mask(b, h, s, 12345, rate).float()
    p = 1.0 - rate

    def within(means, n):
        sigma = (p * (1 - p) / n) ** 0.5
        assert (means - p).abs().max().item() < 5 * sigma, (means.min(), means.max())

    within(keep.mean(dim=-1), s)  # rows
    within(keep.mean(dim=-2), s)  # columns
    stripes = torch.stack([keep.diagonal(off, dim1=-2, dim2=-1)[..., :s // 2].mean(-1)
                           for off in range(-s // 2, s // 2 + 1, 16)])
    within(stripes, s // 2)
    within(keep.mean(dim=(-2, -1)), s * s)  # each (batch, head)
    n = b * h * s * s
    indep = p * p + rate * rate
    sigma = (indep * (1 - indep) / n) ** 0.5
    other_seed = port.dropout_keep_mask(b, h, s, 54321, rate).float()
    assert abs(_agreement(keep, other_seed) - indep) < 5 * sigma
    shard = port.dropout_keep_mask(b, h, s, 12345, rate, bh_offset=b * h).float()
    assert abs(_agreement(keep, shard) - indep) < 5 * sigma


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rate,seed", [(0.1, 3), (0.5, 2**24 + 1)])
def test_plain_dropout_and_gradients_match_jax_reference(masked, rate, seed):
    import jax
    import jax.numpy as jnp

    jfa = _jfa()
    q, k, v, mask, g = _inputs(2, 3, 24, 8, masked, seed=int(rate * 10))
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(q_, k_, v_):
        out = jfa.mha_reference(q_, k_, v_, jmask, dropout_rate=rate,
                                dropout_seed=seed)
        return jnp.sum(out * g), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *map(jnp.asarray, (q, k, v)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    out = port.flash_attention(tq, tk, tv, tmask, dropout_rate=rate,
                               dropout_seed=seed)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    for t, jg in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if masked:
        assert torch.all(out[-1] == 0)
        assert all(torch.all(t.grad[-1] == 0) for t in (tq, tk, tv))


def test_plain_dropout_matches_interpreted_pallas_kernels():
    """Forward and gradients against the JAX Pallas kernels (``_fwd_kernel``,
    ``_dq_kernel``, ``_dkv_kernel``) run in interpret mode."""
    import jax
    import jax.numpy as jnp

    jfa = _jfa()
    q, k, v, mask, g = _inputs(2, 2, 32, 16, True, seed=5)
    mask[-1, :3] = 1.0  # keep every entry partly valid for the kernels
    jmask = jnp.asarray(mask)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, jmask, use_pallas=True,
                                  interpret=True, precision="highest",
                                  dropout_rate=0.25, dropout_seed=11)
        return jnp.sum(out * g), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = port.flash_attention(tq, tk, tv, torch.from_numpy(mask),
                               dropout_rate=0.25, dropout_seed=11)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    for t, jg in zip((tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_dropout_keeps_lse_and_rate_zero_is_identity():
    q, k, v, mask, _ = (None if x is None else torch.from_numpy(x)
                        for x in _inputs(2, 2, 12, 8, True, seed=1))
    base, lse = port.mha_reference(q, k, v, mask, return_lse=True)
    zero = port.mha_reference(q, k, v, mask, dropout_rate=0.0, dropout_seed=9)
    assert torch.equal(zero, base)
    dropped, lse_d = port.mha_reference(q, k, v, mask, return_lse=True,
                                        dropout_rate=0.3, dropout_seed=9)
    assert torch.equal(lse_d, lse) and not torch.equal(dropped, base)
    with pytest.raises(ValueError, match="dropout_rate"):
        port.flash_attention(q, k, v, mask, dropout_rate=1.0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("drop", [
    dict(dropout_rate=0.0),
    dict(dropout_rate=0.3, dropout_seed=2**24 + 1),
    dict(dropout_rate=0.2, dropout_seed=5, q_offset=8, k_offset=40, bh_offset=6),
])
def test_plain_backward_pair_equals_autograd_through_plain(masked, drop):
    """``flash_dq_plain`` and ``flash_dkv_plain`` (the backward kernels'
    plain versions, from the forward's lse and delta) give the gradients
    autograd takes through ``mha_reference``."""
    q, k, v, mask, g = (None if x is None else torch.from_numpy(x)
                        for x in _inputs(2, 3, 20, 8, masked, seed=4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = port.mha_reference(*leaves, mask, return_lse=True, **drop)
    (out * g).sum().backward()
    delta = (g * out.detach()).sum(dim=-1)
    dq = port.flash_dq_plain(q, k, v, mask, lse.detach(), delta, g, **drop)
    dk, dv = port.flash_dkv_plain(q, k, v, mask, lse.detach(), delta, g, **drop)
    for got, t in zip((dq, dk, dv), leaves):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
        if masked:
            assert torch.all(got[-1] == 0)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

GRAD_BOUND = 5e-5  # fp32: of the largest entry
BF16_TOL = 1.6e-2
FWD_LIMITS = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1.6e-2, 1.6e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cuda_inputs(cuda, dtype, b, s, dh, seed):
    q, k, v, mask, g = _inputs(b, 8, s, dh, True, seed=seed)
    q, k, v, g = (torch.from_numpy(x).to(cuda, dtype) for x in (q, k, v, g))
    return q, k, v, torch.from_numpy(mask).to(cuda), g


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [64, 96, 37])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_cuda_forward_with_dropout_matches_plain(cuda, dtype, s, rate):
    q, k, v, mask, _ = _cuda_inputs(cuda, dtype, 3, s, 48, seed=s)
    offsets = dict(q_offset=5, k_offset=70, bh_offset=16) if s == 37 else {}
    before = port.launch_counts["flash_fwd"]
    with torch.inference_mode():
        out, lse = port.flash_attention(q, k, v, mask, dropout_rate=rate,
                                        dropout_seed=1234 + s, return_lse=True,
                                        **offsets)
        ref, ref_lse = port.mha_reference(q, k, v, mask, return_lse=True,
                                          dropout_rate=rate,
                                          dropout_seed=1234 + s, **offsets)
    torch.cuda.synchronize()
    assert port.launch_counts["flash_fwd"] == before + 1
    atol, rtol = FWD_LIMITS[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5 if dtype == torch.float32
                               else 1e-3, rtol=0)
    assert torch.all(out[-1] == 0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [64, 96])
def test_cuda_forward_recovers_the_keep_mask_exactly(cuda, s, dtype):
    """q = k = 0 and v = I (Dh = S): every valid key has probability
    1/n_valid, so out · n_valid · (1 − r) is the keep mask itself (in
    bf16 P̂ = 1 rounds exactly; the output's own rounding is far below
    the 0.5 that ``round`` needs)."""
    b, h, rate = 2, 8, 0.3
    q = torch.zeros(b, h, s, s, device=cuda, dtype=dtype)
    v = torch.eye(s, device=cuda, dtype=dtype).expand(b, h, s, s).contiguous()
    mask = torch.ones(b, s, device=cuda)
    mask[1, s // 2:] = 0.0
    with torch.inference_mode():
        out = port.flash_attention(q, q, v, mask, dropout_rate=rate,
                                   dropout_seed=77)
    n_valid = mask.sum(dim=1)[:, None, None, None]
    got = torch.round(out * n_valid * (1 - rate))
    keep = port.dropout_keep_mask(b, h, s, 77, rate, device=cuda)
    want = (keep & mask.bool()[:, None, None, :]).float()
    assert torch.equal(got, want)


def _grads(fn, q, k, v, mask, g, **drop):
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v, mask, **drop)
    (out.float() * g.float()).sum().backward()
    return q.grad, k.grad, v.grad


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [64, 96, 37])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_backward_matches_autograd_through_plain(cuda, dtype, s, rate):
    q, k, v, mask, g = _cuda_inputs(cuda, dtype, 3, s, 48, seed=s + 1)
    drop = dict(dropout_rate=rate, dropout_seed=99)
    before = dict(port.launch_counts)
    got = _grads(port.flash_attention, q, k, v, mask, g, **drop)
    torch.cuda.synchronize()
    assert all(port.launch_counts[n] == before[n] + 1 for n in port.KERNELS)
    want = _grads(port.mha_reference, q, k, v, mask, g, **drop)
    for a, w in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a.float()).all()
        if dtype == torch.float32:
            err = (a - w).abs().max().item()
            assert err <= GRAD_BOUND * w.abs().max().item(), err
        else:
            torch.testing.assert_close(a.float(), w.float(), atol=BF16_TOL,
                                       rtol=BF16_TOL)
        assert torch.all(a[-1] == 0)  # the fully masked entry


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_backward_kernels_match_their_plain_versions(cuda, dtype, rate):
    """dq and dk/dv each against its plain version on the same operands
    (the forward's lse and delta), at the text tower's S=96, Dh=48."""
    q, k, v, mask, g = _cuda_inputs(cuda, dtype, 3, 96, 48, seed=21)
    drop = dict(dropout_rate=rate, dropout_seed=314)
    with torch.inference_mode():
        out, lse = port.flash_attention_fwd(q, k, v, mask, **drop)
        delta = (g.float() * out.float()).sum(dim=-1)
        got = (port.flash_dq_cuda(q, k, v, mask, lse, delta, g, **drop),
               *port.flash_dkv_cuda(q, k, v, mask, lse, delta, g, **drop))
        want = (port.flash_dq_plain(q, k, v, mask, lse, delta, g, **drop),
                *port.flash_dkv_plain(q, k, v, mask, lse, delta, g, **drop))
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert a.dtype == dtype
        if dtype == torch.float32:
            err = (a - w).abs().max().item()
            assert err <= GRAD_BOUND * w.abs().max().item(), err
        else:
            torch.testing.assert_close(a.float(), w.float(), atol=BF16_TOL,
                                       rtol=BF16_TOL)
        assert torch.all(a[-1] == 0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [64, 96])
def test_cuda_dkv_recovers_the_keep_mask_exactly_through_dv(cuda, s, dtype):
    """q = k = 0 and dO = I (Dh = S): P = 1/n_valid on every valid key, so
    dv = P̂ᵀ·I and dv · n_valid · (1 − r) is the transposed keep mask,
    with zero rows on the masked keys."""
    b, h, rate, seed = 2, 8, 0.3, 78
    zeros = torch.zeros(b, h, s, s, device=cuda, dtype=dtype)
    dout = torch.eye(s, device=cuda, dtype=dtype).expand(b, h, s, s).contiguous()
    mask = torch.ones(b, s, device=cuda)
    mask[1, s // 2:] = 0.0
    drop = dict(dropout_rate=rate, dropout_seed=seed)
    before = port.launch_counts["flash_dkv"]
    with torch.inference_mode():
        out, lse = port.flash_attention_fwd(zeros, zeros, zeros, mask, **drop)
        delta = (dout.float() * out.float()).sum(dim=-1)
        _, dv = port.flash_dkv_cuda(zeros, zeros, zeros, mask, lse, delta, dout,
                                    **drop)
    torch.cuda.synchronize()
    assert port.launch_counts["flash_dkv"] == before + 1
    n_valid = mask.sum(dim=1)[:, None, None, None]
    got = torch.round(dv.float() * n_valid * (1 - rate))
    keep = port.dropout_keep_mask(b, h, s, seed, rate, device=cuda)
    want = (keep & mask.bool()[:, None, None, :]).transpose(-1, -2).float()
    assert torch.equal(got, want)


# as tests/test_torch_flash_attention.py: Dh zero-filled to a multiple of 16
# (100 with element loads), S within one stage, past it, and streamed
BF16_SHAPES = [(dh, s) for dh in (16, 40, 64, 100, 128) for s in (17, 37, 96, 130)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dh,s", BF16_SHAPES)
def test_cuda_bf16_dkv_matches_plain_across_shapes(cuda, dh, s, rate):
    """The bf16 (tensor-core) dk/dv kernel against its plain version on the
    forward kernel's own operands, ragged masks with one fully masked entry,
    dropout 0 and 0.1."""
    q, k, v, mask, g = (torch.from_numpy(x).to(cuda)
                        for x in _inputs(3, 2, s, dh, True, seed=dh + s))
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    drop = dict(dropout_rate=rate, dropout_seed=dh + 7 * s)
    before = port.launch_counts["flash_dkv"]
    with torch.inference_mode():
        out, lse = port.flash_attention_fwd(q, k, v, mask, **drop)
        delta = (g.float() * out.float()).sum(dim=-1)
        operands = (q, k, v, mask, lse, delta, g)
        got = port.flash_dkv_cuda(*operands, **drop)
        want = port.flash_dkv_plain(*operands, **drop)
    torch.cuda.synchronize()
    assert port.launch_counts["flash_dkv"] == before + 1
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), w.float(), atol=BF16_TOL,
                                   rtol=BF16_TOL)
        assert torch.all(a[-1] == 0)


# dq: each of the 8 padded head dims, two of them ragged (40 -> 48 and
# 100 -> 112, element loads), S within one stage, at it, resident and
# streamed
DQ_BF16_SHAPES = [(dh, s) for dh in (16, 32, 40, 64, 80, 96, 100, 128)
                  for s in (37, 64, 96, 200)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dh,s", DQ_BF16_SHAPES)
def test_cuda_bf16_dq_matches_plain_across_shapes(cuda, dh, s, rate):
    """The bf16 (tensor-core) dq kernel against its plain version on the
    forward kernel's own operands, ragged masks with one fully masked entry,
    dropout 0 and 0.1."""
    q, k, v, mask, g = (torch.from_numpy(x).to(cuda)
                        for x in _inputs(3, 2, s, dh, True, seed=dh + s + 1))
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    drop = dict(dropout_rate=rate, dropout_seed=dh + 5 * s)
    before = port.launch_counts["flash_dq"]
    with torch.inference_mode():
        out, lse = port.flash_attention_fwd(q, k, v, mask, **drop)
        delta = (g.float() * out.float()).sum(dim=-1)
        operands = (q, k, v, mask, lse, delta, g)
        got = port.flash_dq_cuda(*operands, **drop)
        want = port.flash_dq_plain(*operands, **drop)
    torch.cuda.synchronize()
    assert port.launch_counts["flash_dq"] == before + 1
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL,
                               rtol=BF16_TOL)
    assert torch.all(got[-1] == 0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_repeat_launches_are_bit_identical(cuda, dtype):
    """Two launches of the forward, of dq and of dk/dv on the same inputs
    give the same bits: every output row has one writer and a fixed order
    of sums."""
    q, k, v, mask, g = _cuda_inputs(cuda, dtype, 3, 96, 48, seed=5)
    drop = dict(dropout_rate=0.1, dropout_seed=17)
    with torch.inference_mode():
        runs = []
        for _ in range(2):
            out, lse = port.flash_attention_fwd(q, k, v, mask, **drop)
            delta = (g.float() * out.float()).sum(dim=-1)
            ops = (q, k, v, mask, lse, delta, g)
            runs.append((out, lse, port.flash_dq_cuda(*ops, **drop),
                         *port.flash_dkv_cuda(*ops, **drop)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
