"""The port's GMM (EM) and kNN drivers against the JAX package's, per-op
mode, on the same ``cluster_points`` inputs, for every engine.

Tolerances: GMM after 5 rounds (``tol=0``, so both run the same rounds)
within ``1e-5`` relative in the log-likelihood and ``1e-4`` absolute in α, μ
and Σ — both packages sum the same f32 terms over a few hundred points in
another order, and the M-step divides by N_k, so a few ulps of the sums
reach the parameters; the numpy float64 oracle within ``1e-3`` relative, as
the JAX package's own test.  kNN's neighbours are exact rows (the same rows
in the same order where distances are distinct), distances within ``1e-5``.
"""
import numpy as np
import pytest

from repro.core import BlazeSession as JaxSession
from repro.core.algorithms import gmm_em as jgmm_em
from repro.core.algorithms import knn as jknn
from repro.core.plan import ENGINES as JENGINES
from repro.data.synthetic import cluster_points
from repro_torch.core import BlazeSession
from repro_torch.core.algorithms import gmm_em, gmm_em_reference, knn, knn_full_sort
from repro_torch.core.plan import ENGINES


def test_engines_are_the_jax_packages():
    assert ENGINES == JENGINES


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n,seed", [(600, 1), (800, 7)])
def test_gmm_matches_jax(engine, n, seed):
    pts, _ = cluster_points(n, 2, 3, seed=seed)
    init = pts[:3].copy()
    want = jgmm_em(pts, 3, init_mu=init, tol=0.0, max_iters=5, engine=engine,
                   session=JaxSession())
    sess = BlazeSession(device="cpu")
    got = gmm_em(pts, 3, init_mu=init, tol=0.0, max_iters=5, engine=engine,
                 session=sess)
    assert got.iterations == want.iterations == 5
    assert abs(got.log_likelihood - want.log_likelihood) <= 1e-5 * abs(want.log_likelihood)
    for name in ("alpha", "mu", "sigma"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=1e-4,
                                   rtol=0, err_msg=name)
        assert getattr(got, name).dtype == np.float32
    # 4 stage configurations: log-likelihood, N_k, Σwx, Σw(x−μ)(x−μ)ᵀ
    assert got.compiles == want.compiles == 4
    assert sess.stats.calls == 20 and sess.stats.cache_hits == 16
    assert got.host_syncs == want.host_syncs == 20
    assert got.shuffle_bytes_per_iter == want.shuffle_bytes_per_iter


def test_gmm_matches_float64_reference():
    pts, _ = cluster_points(800, 2, 3, seed=7)
    init = pts[:3].copy()
    res = gmm_em(pts, 3, init_mu=init, max_iters=8, session=BlazeSession(device="cpu"))
    a, mu, sig, ll, it = gmm_em_reference(pts, 3, init, max_iters=8)
    assert res.iterations == it
    assert abs(res.log_likelihood - ll) / abs(ll) < 1e-3
    assert np.abs(np.sort(res.alpha) - np.sort(a)).max() < 1e-3


@pytest.mark.parametrize("n_shards", (1, 4))
def test_knn_matches_jax_and_full_sort(n_shards):
    pts, _ = cluster_points(4000, 4, 3, seed=9)
    q = np.zeros(4, np.float32)
    sess = BlazeSession(device="cpu", n_shards=n_shards)
    got = knn(pts, q, 64, engine="pallas", session=sess)
    want = jknn(pts, q, 64, engine="pallas", session=JaxSession())
    oracle = knn_full_sort(pts, q, 64)
    np.testing.assert_array_equal(got.neighbors, np.asarray(want.neighbors))
    np.testing.assert_array_equal(got.neighbors, oracle.neighbors)
    np.testing.assert_allclose(got.distances, oracle.distances, atol=1e-5)
    np.testing.assert_allclose(got.distances, want.distances, atol=1e-5)
    assert got.wire_candidates == 64 * n_shards
    assert (got.engine, got.engine_requested) == (want.engine, want.engine_requested)
    assert got.engine == "container:topk" and got.engine_requested == "pallas"
    assert sess.stats.host_syncs == 1 and sess.stats.calls == 0


def test_knn_validates_and_surfaces_the_engine():
    pts, _ = cluster_points(50, 2, 2, seed=1)
    sess = BlazeSession(device="cpu")
    assert knn(pts, np.zeros(2), 5, session=sess).engine_requested == "auto"
    with pytest.raises(ValueError, match="unknown engine"):
        knn(pts, np.zeros(2), 5, engine="fast", session=sess)
