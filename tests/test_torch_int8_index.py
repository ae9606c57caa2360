"""The port's int8 retrieval index (``evaluation.QuantizedCorpus``) against
the JAX package's, and ``serve --corpus-dtype int8``.

Mirrors ``tests/test_retrieval.py``'s int8 cases and ``tests/test_serve.py
::test_int8_corpus_index`` on one device.  Held: the host quantization
bit for bit; the int32 accumulators of int8 x int8 equal to the JAX
package's exactly (both sums are exact), including shapes that break
``torch._int_mm``'s rules and need padding (one query row, a width that
is no multiple of 8, a corpus row count that is none either); the scaled
scores within 1 ulp of JAX's on the same quantized operands (3 ulp end
to end, where each package's own normalization may move a query scale by
1 ulp); and the
JAX tests' own bounds against the fp32 index (scores within 2e-2, top-1
equal on exact-match queries).
"""

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.evaluation import (
    QuantizedCorpus,
    quantize_corpus,
    retrieve_topk,
)
from crossclr_tpu_torch.evaluation.retrieval import (
    _int8_dot,
    _quantize_queries,
    _quantized_sim,
)

# (queries, corpus rows, width): the JAX tests' shapes, one query row, and
# widths / row counts off torch._int_mm's multiples of 8
SHAPES = [(4, 200, 32), (50, 64, 8), (1, 53, 384), (17, 48, 20), (3, 9, 12)]


def _jax_quantized(qv, qs, cv, cs):
    import jax.numpy as jnp

    from crossclr_tpu.evaluation.retrieval import QuantizedCorpus as JQC
    from crossclr_tpu.evaluation.retrieval import _quantized_sim as jsim

    return np.asarray(jsim(jnp.asarray(qv), jnp.asarray(qs),
                           JQC(jnp.asarray(cv), jnp.asarray(cs))))


@pytest.mark.parametrize("nq,nc,d", SHAPES)
def test_quantization_and_int32_accumulators_match_jax(nq, nc, d):
    import jax.numpy as jnp

    from crossclr_tpu.evaluation import quantize_corpus as jquantize
    from crossclr_tpu.evaluation.retrieval import _quantize_queries as jqueries

    rng = np.random.default_rng(nq * 1000 + d)
    corpus = rng.standard_normal((nc, d)).astype(np.float32)
    queries = rng.standard_normal((nq, d)).astype(np.float32)

    qc, jqc = quantize_corpus(corpus), jquantize(corpus)
    np.testing.assert_array_equal(qc.values.numpy(), np.asarray(jqc.values))
    np.testing.assert_array_equal(qc.scales.numpy(), np.asarray(jqc.scales))
    assert qc.values.dtype == torch.int8 and qc.scales.dtype == torch.float32

    qv, qs = _quantize_queries(torch.from_numpy(queries))
    jqv, jqs = (np.asarray(x) for x in jqueries(jnp.asarray(queries)))
    np.testing.assert_array_equal(qv.numpy(), jqv)
    np.testing.assert_array_max_ulp(qs.numpy(), jqs, maxulp=1)

    # the exact int32 sums, read through JAX's own function at unit scales
    # (|acc| <= d·127² < 2^24, so fp32 holds them exactly)
    acc = _int8_dot(qv, qc.values)
    assert acc.dtype == torch.int32 and acc.shape == (nq, nc)
    ones_q, ones_c = np.ones(nq, np.float32), np.ones(nc, np.float32)
    want = _jax_quantized(jqv, ones_q, np.asarray(jqc.values), ones_c)
    np.testing.assert_array_equal(acc.numpy().astype(np.float32), want)
    np.testing.assert_array_equal(
        acc.numpy(), qv.numpy().astype(np.int32) @ qc.values.numpy().astype(np.int32).T)

    # the scaled scores on the same operands: within 1 ulp of JAX's
    host = [np.array(x) for x in (jqv, jqs, jqc.values, jqc.scales)]
    got = _quantized_sim(torch.from_numpy(host[0]), torch.from_numpy(host[1]),
                         QuantizedCorpus(torch.from_numpy(host[2]),
                                         torch.from_numpy(host[3])))
    want = _jax_quantized(jqv, jqs, np.asarray(jqc.values), np.asarray(jqc.scales))
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


@pytest.mark.parametrize("nq,nc,d", SHAPES)
def test_quantized_topk_matches_jax(nq, nc, d):
    import jax.numpy as jnp

    from crossclr_tpu.evaluation import quantize_corpus as jquantize
    from crossclr_tpu.evaluation import retrieve_topk as jtopk

    rng = np.random.default_rng(d)
    corpus = rng.standard_normal((nc, d)).astype(np.float32)
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    k = min(5, nc)
    s, i = retrieve_topk(torch.from_numpy(queries), quantize_corpus(corpus), k=k,
                         query_chunk=16)
    js, ji = jtopk(jnp.asarray(queries), jquantize(corpus), k=k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    # each package normalizes its own queries, so a query scale may differ
    # by 1 ulp (held above); through the two rounded multiplies that is
    # at most 3 ulp of a score
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=3)


def test_quantize_corpus_reconstruction_bound():
    """Dequantized rows reproduce the NORMALIZED corpus within scale/2 per
    element; every row's largest component maps to ±127."""
    rng = np.random.default_rng(0)
    c = rng.standard_normal((64, 24)).astype(np.float32)
    qc = quantize_corpus(torch.from_numpy(c))
    assert qc.values.shape == (64, 24) and qc.scales.shape == (64,)
    cn = c / np.linalg.norm(c, axis=1, keepdims=True)
    recon = qc.values.numpy().astype(np.float32) * qc.scales.numpy()[:, None]
    assert np.all(np.abs(recon - cn) <= qc.scales.numpy()[:, None] / 2 + 1e-7)
    assert np.all(np.abs(qc.values.numpy()).max(axis=1) == 127)


def test_quantized_topk_matches_fp32():
    """Exact-match queries keep their own row on top; scores within the
    quantization bound of the fp32 index; descending; chunking does not
    change a bit (integer sums)."""
    rng = np.random.default_rng(3)
    corpus = torch.from_numpy(rng.standard_normal((200, 32)).astype(np.float32))
    queries = corpus[[5, 17, 123, 77]]
    qc = quantize_corpus(corpus)
    s_f32, _ = retrieve_topk(queries, corpus, k=5)
    s_q, i_q = retrieve_topk(queries, qc, k=5)
    assert i_q[:, 0].tolist() == [5, 17, 123, 77]
    np.testing.assert_allclose(s_q[:, 0].numpy(), 1.0, atol=2e-2)
    np.testing.assert_allclose(s_q.numpy(), s_f32.numpy(), atol=2e-2)
    assert bool((s_q[:, :-1] >= s_q[:, 1:]).all())

    many = torch.from_numpy(rng.standard_normal((50, 32)).astype(np.float32))
    s1, i1 = retrieve_topk(many, qc, k=5, query_chunk=16)
    s2, i2 = retrieve_topk(many, qc, k=5, query_chunk=50)
    assert torch.equal(i1, i2) and torch.equal(s1, s2)


def test_quantized_edges():
    """A zero query row hits the scale guard and stays finite; a non-finite
    corpus is refused; ``to`` moves both tensors; k clamps to the rows."""
    rng = np.random.default_rng(9)
    qc = quantize_corpus(rng.standard_normal((16, 8)).astype(np.float32))
    queries = torch.zeros((2, 8))
    queries[1] = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    s, i = retrieve_topk(queries, qc, k=40)
    assert s.shape == i.shape == (2, 16) and bool(torch.isfinite(s).all())
    assert torch.equal(s[0], torch.zeros(16))
    moved = qc.to("cpu")
    assert moved.values.dtype == torch.int8 and moved.scales.dtype == torch.float32
    bad = np.ones((3, 8), np.float32)
    bad[1, 2] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        quantize_corpus(bad)


def test_int8_service_against_the_fp32_service():
    """``build_service(corpus_dtype="int8")``: a QuantizedCorpus on the
    device, its scores within 3e-2 of the fp32 service's (the JAX service
    test's bound) and its top-1 wherever the fp32 margin exceeds twice
    that, ``corpus_dtype`` in /healthz's terms, and the
    micro-batcher in front of it answering as the serial path does."""
    from crossclr_tpu_torch.data import SyntheticPairs
    from crossclr_tpu_torch.serve import build_service
    from crossclr_tpu_torch.utils.config import ExperimentConfig, apply_overrides

    cfg = apply_overrides(ExperimentConfig(), [
        "data.num_pairs=48", "data.batch_size=16", "data.video_dim=24",
        "data.text_dim=16", "video_tower.input_dim=24", "video_tower.embed_dim=16",
        "video_tower.hidden_dim=32", "video_tower.dtype=float32",
        "text_tower.input_dim=16", "text_tower.embed_dim=16",
        "text_tower.hidden_dim=32", "text_tower.dtype=float32",
    ])
    f32 = build_service(cfg, None, "video", random_params=True, device="cpu")
    q8 = build_service(cfg, None, "video", random_params=True, device="cpu",
                       corpus_dtype="int8", batch_window_ms=20.0)
    try:
        assert isinstance(q8.corpus_emb, QuantizedCorpus)
        assert q8.corpus_emb.values.dtype == torch.int8
        assert q8.corpus_rows == f32.corpus_rows == 48
        assert str(q8.corpus_dtype).removeprefix("torch.") == "int8"
        queries = SyntheticPairs(num_pairs=48, video_dim=24, text_dim=16).text[:5]
        a, b = f32.search(queries, k=3), q8.search(queries, k=3)
        np.testing.assert_allclose(a["scores"], b["scores"], atol=3e-2)
        # top-1 can flip only where the fp32 margin is inside twice that
        # bound; every query clear of it keeps its top-1
        clear = [r[0] - r[1] > 6e-2 for r in a["scores"]]
        assert any(clear)
        for keep, x, y in zip(clear, a["indices"], b["indices"]):
            assert not keep or x[0] == y[0]
        serial = q8._dispatch(queries, None, 3)
        assert b["indices"] == serial[1].tolist()
        assert b["scores"] == serial[0].tolist()
    finally:
        q8._batcher.close()
