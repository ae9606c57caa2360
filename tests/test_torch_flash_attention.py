"""The port's flash-attention forward against the JAX package's
(dropout and the backward: ``tests/test_torch_flash_dropout.py``).

On the CPU the port's ``flash_attention`` takes its plain version,
``mha_reference``; it is held against the JAX ``mha_reference``, the JAX
Pallas kernel run in interpret mode (``flash_attention(use_pallas=True,
interpret=True, precision="highest")``) and that kernel's lse
(``_flash_fwd``).  Tolerance: fp32, atol 1e-5 (fp32 sums over at most 24
keys, in another order).

The ``requires_cuda`` cases hold the CUDA kernel against the plain
version on the card, with the limits ``chip_smoke.py`` enforces.  jax is
imported inside the tests that need it, so the CUDA cases also run where
jax is absent (``CROSSCLR_TESTS_BACKEND=cuda``).
"""

import importlib

import numpy as np
import pytest
import torch

# the module (its name is shadowed by the function in ops/__init__)
port = importlib.import_module("crossclr_tpu_torch.ops.flash_attention")

ATOL = 1e-5


def _inputs(b, h, s, dh, mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32)
               for _ in range(3))
    if mask_kind == "none":
        return q, k, v, None
    lengths = rng.integers(1, s + 1, size=b)
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.float32)
    if mask_kind == "fully_masked":
        mask[-1] = 0.0  # one batch entry with no valid key at all
    return q, k, v, mask


def _port(q, k, v, mask):
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    with torch.inference_mode():
        out = port.flash_attention(t(q), t(k), t(v), t(mask))
        _, lse = port.mha_reference(t(q), t(k), t(v), t(mask), return_lse=True)
    return out.numpy(), lse.numpy()


CASES = [
    (s, dh, mask_kind)
    for s in (8, 24)
    for dh in (8, 12)
    for mask_kind in ("none", "ragged", "fully_masked")
]


@pytest.mark.parametrize("s,dh,mask_kind", CASES)
def test_plain_matches_jax_reference_and_interpreted_kernel(s, dh, mask_kind):
    import jax.numpy as jnp

    jfa = importlib.import_module("crossclr_tpu.ops.flash_attention")

    b, h = 2, 2
    q, k, v, mask = _inputs(b, h, s, dh, mask_kind)
    out, lse = _port(q, k, v, mask)
    jmask = None if mask is None else jnp.asarray(mask)
    jq, jk, jv = map(jnp.asarray, (q, k, v))

    ref = np.asarray(jfa.mha_reference(jq, jk, jv, jmask))
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)

    kernel = np.asarray(jfa.flash_attention(
        jq, jk, jv, jmask, use_pallas=True, interpret=True,
        precision="highest",
    ))
    np.testing.assert_allclose(out, kernel, rtol=0, atol=ATOL)

    # the kernel's lse: [BH, S, 1] from the interpreted _flash_fwd
    qf, kf, vf, mask_row = jfa.fold_heads(jq, jk, jv, jmask)
    bq, bk = jfa._pick_blocks(s)
    _, jlse = jfa._flash_fwd(
        qf, kf, vf, mask_row, jfa.seed_operand(0), dh**-0.5, bq, bk, True,
        "highest", 0.0,
    )
    np.testing.assert_allclose(
        lse, np.asarray(jlse).reshape(b, h, s), rtol=0, atol=ATOL
    )
    if mask_kind == "fully_masked":
        assert np.all(out[-1] == 0.0)
        assert np.all(lse[-1] == np.float32(port.MAX_FLOOR))


def test_dispatch_follows_the_tensor_device_and_rejects_dropout():
    """CPU tensors take the plain version, with dropout and under autograd
    too; a dropout rate outside [0, 1) is rejected."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(1, 2, 5, 4, "ragged"))
    before = dict(port.launch_counts)
    out = port.flash_attention(q, k, v, mask)
    torch.testing.assert_close(out, port.mha_reference(q, k, v, mask),
                               rtol=0, atol=0)
    drop = dict(dropout_rate=0.1, dropout_seed=3)
    qg = q.clone().requires_grad_()
    dropped = port.flash_attention(qg, k, v, mask, **drop)
    torch.testing.assert_close(dropped, port.mha_reference(q, k, v, mask, **drop),
                               rtol=0, atol=0)
    dropped.sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
    assert port.launch_counts == before  # CPU tensors never launch
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="dropout_rate"):
            port.flash_attention(q, k, v, mask, dropout_rate=rate)
    with pytest.raises(ValueError, match="CUDA"):
        port.flash_attention_fwd(q, k, v, mask)
    with pytest.raises(ValueError, match="CUDA"):
        port.flash_attention_bwd(q, k, v, mask, out, None, out)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

# (dtype, out atol, out rtol, lse atol) — fp32: both sides sum in fp32 in
# another order; bf16: the outputs round to bf16 (one ulp near 1 is 7.8e-3)
LIMITS = {
    torch.float32: (2e-5, 0.0, 1e-5),
    torch.bfloat16: (1.6e-2, 1.6e-2, 1e-3),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [64, 96, 37])
def test_cuda_kernel_matches_plain(cuda, dtype, s):
    b, h, dh = 3, 8, 48
    q, k, v, mask = (
        torch.from_numpy(x).to(cuda)
        for x in _inputs(b, h, s, dh, "fully_masked", seed=s)
    )
    q, k, v = (x.to(dtype) for x in (q, k, v))
    before = port.launch_counts["flash_fwd"]
    with torch.inference_mode():
        out, lse = port.flash_attention(q, k, v, mask, return_lse=True)
        ref, ref_lse = port.mha_reference(q, k, v, mask, return_lse=True)
    torch.cuda.synchronize()
    assert port.launch_counts["flash_fwd"] == before + 1
    atol, rtol, lse_atol = LIMITS[dtype]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=lse_atol, rtol=0)
    assert torch.all(out[-1] == 0)
    assert torch.all(lse[-1] == port.MAX_FLOOR)


@pytest.mark.requires_cuda
def test_cuda_kernel_accepts_dropout_and_grad_and_rejects_wide_heads(cuda):
    q = torch.randn(1, 1, 8, 8, device=cuda, requires_grad=True)
    before = dict(port.launch_counts)
    port.flash_attention(q, q, q, dropout_rate=0.1, dropout_seed=1).sum().backward()
    torch.cuda.synchronize()
    assert all(port.launch_counts[n] == before[n] + 1 for n in port.KERNELS)
    assert q.grad is not None and torch.isfinite(q.grad).all()
    wide = torch.randn(1, 1, 8, 129, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        port.flash_attention(wide, wide, wide)


# the bf16 build's shapes: Dh zero-filled to a multiple of 16 (40 and 100
# pad; 100 also takes element loads, its rows not being 16-byte
# multiples), S below, at and past one 64-row stage, and past the 128 rows
# that stay resident (130 streams its key tiles)
BF16_SHAPES = [(dh, s) for dh in (16, 40, 64, 100, 128) for s in (17, 37, 96, 130)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dh,s", BF16_SHAPES)
def test_cuda_bf16_forward_matches_plain_across_shapes(cuda, dh, s, rate):
    """The bf16 (tensor-core) forward against the plain version, ragged
    masks with one fully masked entry, dropout 0 and 0.1."""
    q, k, v, mask = (
        torch.from_numpy(x).to(cuda)
        for x in _inputs(3, 2, s, dh, "fully_masked", seed=dh + s)
    )
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    drop = dict(dropout_rate=rate, dropout_seed=dh * s)
    before = port.launch_counts["flash_fwd"]
    with torch.inference_mode():
        out, lse = port.flash_attention(q, k, v, mask, return_lse=True, **drop)
        ref, ref_lse = port.mha_reference(q, k, v, mask, return_lse=True, **drop)
    torch.cuda.synchronize()
    assert port.launch_counts["flash_fwd"] == before + 1
    atol, rtol, lse_atol = LIMITS[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=lse_atol, rtol=0)
    assert torch.all(out[-1] == 0)
    assert torch.all(lse[-1] == port.MAX_FLOOR)
