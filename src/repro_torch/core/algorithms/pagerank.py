"""PageRank (paper §3.1.2, Fig. 5) — three MapReduce ops per iteration.

The counterpart of ``repro/core/algorithms/pagerank.py``, per-op mode:

  MR1  total score of all sinks               (dense [1] target, "sum")
  MR2  new scores from Eq. 1                  (dense [N] target, "sum")
  MR3  max |Δscore| for the convergence test  (dense [1] target, "max")

Links are a DistVector of ``[E, 2]`` edges; scores ride in ``env`` so one
cached stage serves every iteration (3 compiles in all).  MR2's contribution
scatter is the dynamic-key combine the segment-reduce kernel runs under
``engine="pallas"``; MR1/MR3 emit static keys and keep the fused fast path.
Each iteration ends in one host sync for the convergence test.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import DistRange
from repro_torch.core.session import BlazeSession, resolve


def sink_mapper(p, emit, env):
    scores, deg = env
    emit(0, torch.where(deg[p] == 0, scores[p], 0.0))


def contrib_mapper(i, edge, emit, env):
    scores, deg = env
    src, dst = edge[0], edge[1]
    emit(dst, scores[src] / torch.clamp(deg[src], min=1).to(scores.dtype))


def delta_mapper(p, emit, env):
    old, new = env
    emit(0, torch.abs(new[p] - old[p]))


@dataclasses.dataclass
class PageRankResult:
    scores: np.ndarray
    iterations: int
    converged: bool
    shuffle_bytes_per_iter: int
    pairs_shipped_per_iter: int
    compiles: int = 0  # shard stages built across ALL iterations
    dispatches: int = 0  # stage runs across the loop
    host_syncs: int = 0  # blocking host materialisations across the loop


def pagerank(
    edges: np.ndarray,
    n_pages: int,
    *,
    damping: float = 0.85,
    tol: float = 1e-5,
    max_iters: int = 100,
    engine: str = "eager",
    mode: str = "per_op",
    session: BlazeSession | None = None,
) -> PageRankResult:
    if mode != "per_op":
        raise NotImplementedError(
            f"mode={mode!r} comes with the fused-program and streaming slices "
            "of the port; use mode='per_op'"
        )
    sess = resolve(session)
    dev = sess.device
    edges_v = sess.distribute(edges.astype(np.int32))
    deg = torch.from_numpy(
        np.bincount(edges[:, 0], minlength=n_pages).astype(np.int32)
    ).to(dev)
    pages = DistRange(0, n_pages, 1)
    scores = torch.full((n_pages,), 1.0 / n_pages, dtype=torch.float32, device=dev)
    d = damping
    compiles0 = sess.stats.compiles
    dispatches0 = sess.stats.dispatches
    syncs0 = sess.stats.host_syncs

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    it, converged, stats2 = 0, False, None
    for it in range(1, max_iters + 1):
        sink_total = sess.map_reduce(
            pages, sink_mapper, "sum", zeros(1), engine=engine,
            env=(scores, deg),
        )[0]
        incoming, stats2 = sess.map_reduce(
            edges_v, contrib_mapper, "sum", zeros(n_pages), engine=engine,
            env=(scores, deg), return_stats=True,
        )
        new_scores = (1.0 - d) / n_pages + d * (incoming + sink_total / n_pages)
        delta = sess.map_reduce(
            pages, delta_mapper, "max", zeros(1), engine=engine,
            env=(scores, new_scores),
        )[0]
        scores = new_scores
        if float(sess.host_value(delta)) < tol:
            converged = True
            break

    fs = stats2.finalize() if stats2 is not None else None
    return PageRankResult(
        scores=scores.cpu().numpy(),
        iterations=it,
        converged=converged,
        shuffle_bytes_per_iter=fs.shuffle_payload_bytes if fs else 0,
        pairs_shipped_per_iter=fs.pairs_shipped if fs else 0,
        compiles=sess.stats.compiles - compiles0,
        dispatches=sess.stats.dispatches - dispatches0,
        host_syncs=sess.stats.host_syncs - syncs0,
    )
