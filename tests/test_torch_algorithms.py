"""The port's algorithm drivers against the JAX package's, on the same
``zipf_corpus`` / ``rmat_edges`` / ``cluster_points`` inputs, for the eager
and kernel (``pallas``) engines; plus one 4-shard run held against JAX on
four forced CPU devices.

Tolerances: π, word counts and hash-table layouts are exact; PageRank scores
after 10 iterations (``tol=0``, so both run the same steps) within ``1e-5``
max-abs; k-means centres within ``1e-4`` and inertia within ``rtol=1e-4``
after 10 iterations (``tol=0``) — float sums differ in order only.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import BlazeSession as JaxSession
from repro.core.algorithms import estimate_pi as jestimate_pi
from repro.core.algorithms import kmeans as jkmeans
from repro.core.algorithms import pagerank as jpagerank
from repro.core.algorithms import wordcount as jwordcount
from repro.data.synthetic import cluster_points, rmat_edges, zipf_corpus
from repro_torch.core import BlazeSession
from repro_torch.core.algorithms import (
    counts_dict,
    estimate_pi,
    estimate_pi_handrolled,
    gmm_em,
    kmeans,
    knn,
    pagerank,
    wordcount,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINES = ("eager", "pallas")


def _cpu(n_shards=1):
    return BlazeSession(device="cpu", n_shards=n_shards)


@pytest.mark.parametrize("engine", ENGINES)
def test_pi_matches_jax_exactly(engine):
    for n in (1000, 65_537):
        got, st = estimate_pi(n, engine=engine, session=_cpu(), return_stats=True)
        assert got == jestimate_pi(n, engine=engine, session=JaxSession())
        assert st.finalize().pairs_emitted == n
    assert estimate_pi_handrolled(65_537, device="cpu") == estimate_pi(65_537, session=_cpu())


@pytest.mark.parametrize("engine", ENGINES)
def test_wordcount_hash_matches_jax(engine):
    lines, counts = zipf_corpus(64, 16, 500, seed=0)
    jeager = jwordcount(lines, engine="eager", session=JaxSession())
    jsame = jwordcount(lines, engine=engine, session=JaxSession())
    sess = _cpu()
    hm, st = wordcount(lines, engine=engine, session=sess, return_stats=True)
    # slot for slot against JAX eager, as a dict against JAX's same engine
    np.testing.assert_array_equal(hm.table.keys.numpy(), np.asarray(jeager.table.keys))
    np.testing.assert_array_equal(hm.table.vals.numpy(), np.asarray(jeager.table.vals))
    assert counts_dict(hm) == {int(k): int(v) for k, v in jsame.to_dict().items()}
    assert counts_dict(hm) == {i: int(c) for i, c in enumerate(counts) if c}
    assert hm.total_overflow() == 0 and st.finalize().engine == engine


@pytest.mark.parametrize("engine", ENGINES)
def test_wordcount_dense_matches_jax(engine):
    lines, _ = zipf_corpus(32, 12, 300, seed=1)
    want = jwordcount(lines, engine=engine, target="dense", session=JaxSession())
    got = wordcount(lines, engine=engine, target="dense", session=_cpu())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("engine", ENGINES)
def test_pagerank_matches_jax(engine):
    edges = rmat_edges(6, 8, seed=3)
    want = jpagerank(edges, 64, tol=0.0, max_iters=10, engine=engine,
                     session=JaxSession())
    sess = _cpu()
    got = pagerank(edges, 64, tol=0.0, max_iters=10, engine=engine, session=sess)
    assert got.iterations == want.iterations == 10
    assert float(np.abs(got.scores - want.scores).max()) <= 1e-5
    # 3 stage configurations (sink sum, contribution sum, delta max)
    assert got.compiles == want.compiles == 3
    assert sess.stats.calls == 30 and sess.stats.cache_hits == 27
    assert got.host_syncs == 10 and got.dispatches == 30
    assert got.shuffle_bytes_per_iter == want.shuffle_bytes_per_iter
    assert got.pairs_shipped_per_iter == want.pairs_shipped_per_iter


@pytest.mark.parametrize("engine", ENGINES)
def test_kmeans_matches_jax(engine):
    pts, _ = cluster_points(2000, 3, 4, seed=0)
    init = pts[:4].copy()
    want = jkmeans(pts, 4, init_centers=init, tol=0.0, max_iters=10,
                   engine=engine, session=JaxSession())
    sess = _cpu()
    got = kmeans(pts, 4, init_centers=init, tol=0.0, max_iters=10,
                 engine=engine, session=sess)
    assert got.iterations == want.iterations == 10
    assert float(np.abs(got.centers - want.centers).max()) <= 1e-4
    assert abs(got.inertia - want.inertia) <= 1e-4 * abs(want.inertia)
    # 2 stage configurations: the assignment step (10x), the inertia pass
    assert got.compiles == want.compiles == 2
    assert sess.stats.calls == 11 and sess.stats.cache_hits == 9
    assert got.shuffle_bytes_per_iter == want.shuffle_bytes_per_iter


def test_drivers_refuse_modes_of_later_slices():
    # mode="stream" is ported (tests/test_torch_streaming.py); as in the
    # reference it needs chunked input, and unknown modes stay unknown.
    with pytest.raises(ValueError, match="ChunkedDistVector"):
        pagerank(rmat_edges(4, 2), 16, mode="stream", session=_cpu())
    with pytest.raises(ValueError, match="ChunkedDistVector"):
        kmeans(np.zeros((8, 2), np.float32), 2, mode="stream", session=_cpu())
    with pytest.raises(ValueError, match="unknown mode"):
        kmeans(np.zeros((8, 2), np.float32), 2, mode="spark", session=_cpu())


_JAX_4DEV = """
import json, numpy as np, jax
from repro.core import BlazeSession
from repro.core.algorithms import gmm_em, knn, pagerank, wordcount
from repro.data.synthetic import cluster_points, rmat_edges, zipf_corpus
assert len(jax.devices()) == 4
lines, _ = zipf_corpus(96, 16, 700, seed=2)
out = {}
for engine in ("eager", "pallas"):
    hm = wordcount(lines, engine=engine, session=BlazeSession())
    out[engine] = {"keys": np.asarray(hm.table.keys).tolist(),
                   "vals": np.asarray(hm.table.vals).tolist(),
                   "overflow": np.asarray(hm.table.overflow).tolist()}
pr = pagerank(rmat_edges(7, 8, seed=2), 128, tol=0.0, max_iters=10,
              session=BlazeSession())
out["scores"] = pr.scores.tolist()
pts, _ = cluster_points(803, 2, 3, seed=4)
for engine in ("eager", "pallas"):
    g = gmm_em(pts, 3, init_mu=pts[:3].copy(), tol=0.0, max_iters=5,
               engine=engine, session=BlazeSession())
    out["gmm_" + engine] = {"ll": g.log_likelihood, "alpha": g.alpha.tolist(),
                            "mu": g.mu.tolist(), "sigma": g.sigma.tolist()}
kp, _ = cluster_points(4001, 4, 3, seed=9)
nn = knn(kp, np.zeros(4, np.float32), 64, session=BlazeSession())
out["knn"] = {"neighbors": np.asarray(nn.neighbors).tolist(),
              "wire": nn.wire_candidates}
print(json.dumps(out))
"""


def test_four_shards_match_jax_on_four_devices():
    """The port's 4 stacked shards against JAX's 4-device mesh (a
    subprocess, so this process keeps its one device): wordcount tables per
    shard — eager and pallas slot for slot against JAX eager, pallas as a
    dict against JAX pallas — PageRank scores, GMM with both engines (803
    points: the last shard holds a padding row) within the GMM tolerances
    of ``tests/test_torch_gmm_knn.py``, and kNN's rows exactly."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", _JAX_4DEV], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])

    lines, _ = zipf_corpus(96, 16, 700, seed=2)
    for engine in ("eager", "pallas"):
        hm = wordcount(lines, engine=engine, session=_cpu(4))
        assert hm.n_shards == 4
        np.testing.assert_array_equal(hm.table.keys.numpy(), want["eager"]["keys"])
        np.testing.assert_array_equal(hm.table.vals.numpy(), want["eager"]["vals"])
        np.testing.assert_array_equal(hm.table.overflow.numpy(), want[engine]["overflow"])
        jdict = {}
        for ks, vs in zip(want[engine]["keys"], want[engine]["vals"]):
            jdict.update({k: v for k, v in zip(ks, vs) if k != -(2**31)})
        assert counts_dict(hm) == jdict
    pr = pagerank(rmat_edges(7, 8, seed=2), 128, tol=0.0, max_iters=10,
                  session=_cpu(4))
    assert float(np.abs(pr.scores - np.asarray(want["scores"])).max()) <= 1e-5
    pts, _ = cluster_points(803, 2, 3, seed=4)
    for engine in ("eager", "pallas"):
        g = gmm_em(pts, 3, init_mu=pts[:3].copy(), tol=0.0, max_iters=5,
                   engine=engine, session=_cpu(4))
        jg = want["gmm_" + engine]
        assert abs(g.log_likelihood - jg["ll"]) <= 1e-5 * abs(jg["ll"])
        for name in ("alpha", "mu", "sigma"):
            np.testing.assert_allclose(getattr(g, name), jg[name], atol=1e-4,
                                       rtol=0, err_msg=name)
        assert g.compiles == 4
    kp, _ = cluster_points(4001, 4, 3, seed=9)
    nn = knn(kp, np.zeros(4, np.float32), 64, session=_cpu(4))
    np.testing.assert_array_equal(nn.neighbors, np.asarray(want["knn"]["neighbors"],
                                                           np.float32))
    assert nn.wire_candidates == want["knn"]["wire"] == 256
