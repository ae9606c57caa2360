"""The port's retrieval metrics against the JAX package's.

``retrieval_metrics`` (R@1/5/10, MdR and MnR in both directions) on the
same numpy embeddings in both packages, on the dense path and on the
query-chunked path.  Ranks are integers, so R@K and MdR must agree
exactly; MnR is a float mean of integers (rtol 1e-6).  The tie cases use
unit vectors with entries in {0, ±0.5}: every dot product is a multiple
of 0.25, exact in any summation order, so ties are exact in both
packages.  Even row counts are included: ``jnp.median`` averages the two
middle ranks there.  jax is imported inside the tests.
"""

import numpy as np
import pytest
import torch

from crossclr_tpu_torch.evaluation import retrieval as rt

EXACT = ("R@1", "R@5", "R@10", "MdR")


def _gaussian(n, d=16, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    t = (v + 1.5 * rng.standard_normal((n, d))).astype(np.float32)
    return v, t


def _tied(n, seed=0):
    """Unit rows drawn from 16 patterns of ±0.5 in 4 of 8 dims: many
    exact ties, including ties with the ground truth."""
    rng = np.random.default_rng(seed)
    signs = np.array([[(k >> b) & 1 for b in range(4)] for k in range(16)])
    patterns = np.concatenate([0.5 - signs, np.zeros((16, 4))], axis=1)
    pick = lambda: patterns[rng.integers(0, 16, n)].astype(np.float32)  # noqa: E731
    return pick(), pick()


def _jax_metrics(v, t, query_chunk=None):
    import jax.numpy as jnp

    from crossclr_tpu.evaluation import retrieval_metrics

    out = retrieval_metrics(jnp.asarray(v), jnp.asarray(t), query_chunk=query_chunk)
    return {k: float(x) for k, x in out.items()}


def _assert_metrics_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k.split("/")[1] in EXACT:
            assert got[k] == pytest.approx(want[k], rel=0, abs=1e-4), k
        else:
            assert got[k] == pytest.approx(want[k], rel=1e-6), k


@pytest.mark.parametrize("make,n", [(_gaussian, 64), (_gaussian, 37),
                                    (_tied, 50), (_tied, 33)])
@pytest.mark.parametrize("query_chunk", [None, 16])
def test_retrieval_metrics_match_jax(make, n, query_chunk):
    v, t = make(n)
    got = rt.retrieval_metrics(torch.from_numpy(v), torch.from_numpy(t),
                               query_chunk=query_chunk)
    _assert_metrics_equal(got, _jax_metrics(v, t, query_chunk))


@pytest.mark.parametrize("make,n", [(_gaussian, 50), (_tied, 64)])
def test_chunked_ranks_equal_dense_ranks(make, n):
    v, t = (torch.from_numpy(x) for x in make(n, seed=4))
    dense = rt.retrieval_metrics(v, t)
    for chunk in (1, 7, n, 4 * n):
        assert rt.retrieval_metrics(v, t, query_chunk=chunk) == dense


def test_even_count_median_averages_the_middle_ranks():
    ranks = torch.tensor([0, 3, 1, 2])
    assert float(rt._metrics_from_ranks(ranks, (1,))["MdR"]) == 2.5  # 1 + 1.5
    ranks = torch.tensor([4, 0, 2])
    assert float(rt._metrics_from_ranks(ranks, (1,))["MdR"]) == 3.0


def test_rank_of_ground_truth_favours_the_truth_on_ties():
    sim = torch.tensor([[0.5, 0.5, 0.2],
                        [0.9, 0.1, 0.1],
                        [0.3, 0.3, 0.3]])
    assert rt.rank_of_ground_truth(sim).tolist() == [0, 1, 0]


def test_past_the_dense_threshold_the_chunked_path_runs(monkeypatch):
    calls = []
    orig = rt._ranks_chunked

    def spy(q, c, chunk):
        calls.append(chunk)
        return orig(q, c, chunk)

    monkeypatch.setattr(rt, "_ranks_chunked", spy)
    monkeypatch.setattr(rt, "_DENSE_SIM_MAX_ROWS", 40)
    v, t = (torch.from_numpy(x) for x in _gaussian(41))
    got = rt.retrieval_metrics(v, t)
    assert calls == [41, 41]  # min(4096, N) rows per chunk, both directions
    monkeypatch.setattr(rt, "_DENSE_SIM_MAX_ROWS", 16384)
    assert got == rt.retrieval_metrics(v, t)
