"""The paper's §3 applications end to end on the PyTorch port: PageRank,
k-means, GMM, 100-NN.

The port's copy of ``examples/data_mining.py``, at its sizes and seeds,
through ``repro_torch.core.algorithms`` and one ``BlazeSession`` on the
card unless ``--device cpu`` is given (without CUDA the default raises).

Run:  PYTHONPATH=src python3 examples_torch/data_mining.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import BlazeSession
from repro_torch.core.algorithms import gmm_em, kmeans, knn, pagerank
from repro_torch.data.synthetic import cluster_points, rmat_edges

#: The reference's sizes: R-MAT scale 10 (1024 pages, 16k links), k-means on
#: 50,000 points, GMM on 5,000, 100-NN among 200,000.
SIZES = {"rmat_scale": 10, "km_points": 50_000, "gmm_points": 5_000,
         "knn_points": 200_000}


def run(device=None, rmat_scale: int = SIZES["rmat_scale"],
        km_points: int = SIZES["km_points"], gmm_points: int = SIZES["gmm_points"],
        knn_points: int = SIZES["knn_points"]) -> dict:
    """The four jobs on one session on ``device`` (the card unless
    ``"cpu"``), PageRank also as a fused program held to the per-op run."""
    # One session for the whole job: it owns the mesh and the stage cache,
    # so every iterative algorithm builds each of its MapReduce
    # configurations once, however many iterations run.
    sess = BlazeSession(device=device)
    n_pages = 1 << rmat_scale

    # PageRank on an R-MAT (graph500-style) power-law graph
    edges = rmat_edges(scale=rmat_scale, edges_per_node=16, seed=0)
    pr = pagerank(edges, n_pages, tol=1e-5, session=sess)

    # k-means
    pts, _true_centers = cluster_points(km_points, 3, 5, seed=0)
    km = kmeans(pts, 5, max_iters=30, session=sess)

    # Expectation-Maximization (GMM)
    pts2, _ = cluster_points(gmm_points, 2, 3, seed=1)
    gm = gmm_em(pts2, 3, max_iters=20, session=sess)

    # Fused iteration program: the whole PageRank iteration (3 MapReduce ops
    # and the score update) as one program, 5 iterations a dispatch
    pr2 = pagerank(edges, n_pages, tol=1e-5, session=sess, mode="program", unroll=5)
    assert np.abs(pr2.scores - pr.scores).max() < 1e-5

    # 100 nearest neighbours
    pts3, _ = cluster_points(knn_points, 4, 3, seed=2)
    nn = knn(pts3, np.zeros(4, np.float32), k=100, session=sess)
    return {"pagerank": pr, "kmeans": km, "gmm": gm, "pagerank_program": pr2,
            "knn": nn, "knn_points": len(pts3), "session": sess.cache_info()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    res = run(args.device)
    pr, km, gm, pr2, nn = (res[k] for k in ("pagerank", "kmeans", "gmm",
                                            "pagerank_program", "knn"))
    top = np.argsort(-pr.scores)[:5]
    print(f"PageRank: {pr.iterations} iters, converged={pr.converged}, "
          f"compiles={pr.compiles}")
    print("  top pages:", top.tolist(), "scores:", pr.scores[top].round(5).tolist())
    print(f"  shuffle bytes/iter (eager): {pr.shuffle_bytes_per_iter}")
    print(f"k-means: {km.iterations} iters, inertia={km.inertia:.1f}, "
          f"compiles={km.compiles}")
    print("  centers:\n", km.centers.round(2))
    print(f"GMM: {gm.iterations} iters, loglik={gm.log_likelihood:.1f}, "
          f"alpha={gm.alpha.round(3).tolist()}, compiles={gm.compiles}")
    print(f"PageRank (fused program): {pr2.iterations} iters in "
          f"{pr2.dispatches} dispatches / {pr2.host_syncs} host syncs, "
          f"program_compiles={pr2.program_compiles} "
          f"(per-op loop above: {pr.dispatches} dispatches, "
          f"{pr.host_syncs} syncs)")
    print(f"100-NN: farthest of the 100 at distance {nn.distances.max():.3f}; "
          f"{nn.wire_candidates} candidate rows crossed the wire "
          f"(vs {res['knn_points']} for a full shuffle)")
    print("session totals:", res["session"])
    return res


if __name__ == "__main__":
    main()
