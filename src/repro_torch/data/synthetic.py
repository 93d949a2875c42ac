"""Synthetic datasets matching the paper's benchmark inputs.

The paper uses: the Bible + Shakespeare repeated 200× (~0.4 B words) for word
count, a graph500 (R-MAT) generator for PageRank (10 M links), random points
around 5 cluster centres for k-means (100 M) and GMM (1 M), and 200 M random
points for 100-NN.  This container has no corpus files and far less RAM, so we
generate statistically-matched stand-ins at configurable scale:

* ``zipf_corpus``  — Zipf-distributed word-id lines (word frequencies in real
                     English text are Zipfian, which is exactly what stresses
                     the eager-reduction path: few hot keys, long tail).
* ``rmat_edges``   — R-MAT/Kronecker power-law digraph (the graph500 core).
* ``cluster_points`` — Gaussian blobs around K centres.
"""
from __future__ import annotations

import numpy as np


def zipf_corpus(
    n_lines: int,
    words_per_line: int,
    vocab_size: int,
    *,
    zipf_a: float = 1.3,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (lines [n_lines, words_per_line] int32, true_counts [vocab])."""
    rng = np.random.RandomState(seed)
    ranks = rng.zipf(zipf_a, size=(n_lines, words_per_line))
    ids = np.minimum(ranks - 1, vocab_size - 1).astype(np.int32)
    # Per-line ragged lengths: pad tail with -1 (masked by the mapper).
    lens = rng.randint(max(1, words_per_line // 2), words_per_line + 1, n_lines)
    mask = np.arange(words_per_line)[None, :] < lens[:, None]
    ids = np.where(mask, ids, -1).astype(np.int32)
    counts = np.bincount(ids[ids >= 0], minlength=vocab_size)
    return ids, counts


def rmat_edges(
    scale: int,
    edges_per_node: int = 16,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> np.ndarray:
    """R-MAT digraph (graph500 defaults): returns edges [E, 2] int32, N=2**scale."""
    rng = np.random.RandomState(seed)
    n_edges = (1 << scale) * edges_per_node
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    for bit in range(scale):
        r = rng.rand(n_edges)
        # quadrant probabilities (a, b, c, d) with slight noise per level
        src_bit = r >= a + b
        dst_bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    return np.stack([src, dst], axis=1).astype(np.int32)


def cluster_points(
    n_points: int,
    dim: int,
    k: int,
    *,
    spread: float = 0.35,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian blobs around ``k`` centres → (points [n, dim], centres [k, dim])."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, dim).astype(np.float32) * 2.0
    assign = rng.randint(0, k, n_points)
    pts = centers[assign] + rng.randn(n_points, dim).astype(np.float32) * spread
    return pts.astype(np.float32), centers
