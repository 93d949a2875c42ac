"""K-Means (paper §3.1.3, Fig. 6) — one MapReduce per assignment step.

The counterpart of ``repro/core/algorithms/kmeans.py``, per-op mode.  The
mapper assigns a point to its nearest centre and emits ``(centre, [x…, 1])``;
per-centre sums and counts accumulate in one dense ``[K, dim+1]`` target (a
small fixed key range: the segment-reduce kernel's shared-memory form under
``engine="pallas"``).  The refinement step is serial, as in the paper, and
the centres ride in ``env``.  A final MapReduce computes the inertia: 2
compiles in all.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import DistVector
from repro_torch.core.session import BlazeSession, resolve


def assign_mapper(i, x, emit, centers):
    d2 = torch.sum((centers - x[None, :]) ** 2, dim=1)
    c = torch.argmin(d2)
    emit(c, torch.cat([x, torch.ones((1,), dtype=x.dtype, device=x.device)]))


def inertia_mapper(i, x, emit, centers):
    d2 = torch.sum((centers - x[None, :]) ** 2, dim=1)
    emit(0, torch.min(d2))


@dataclasses.dataclass
class KMeansResult:
    centers: np.ndarray
    iterations: int
    converged: bool
    inertia: float
    shuffle_bytes_per_iter: int
    compiles: int = 0  # shard stages built across ALL iterations
    dispatches: int = 0  # stage runs across the loop
    host_syncs: int = 0  # blocking host materialisations across the loop


def kmeans(
    points: np.ndarray | DistVector,
    k: int,
    *,
    init_centers: np.ndarray | None = None,
    tol: float = 1e-4,
    max_iters: int = 50,
    engine: str = "eager",
    mode: str = "per_op",
    seed: int = 0,
    session: BlazeSession | None = None,
) -> KMeansResult:
    if mode != "per_op":
        raise NotImplementedError(
            f"mode={mode!r} comes with the fused-program and streaming slices "
            "of the port; use mode='per_op'"
        )
    sess = resolve(session)
    if isinstance(points, DistVector):
        pts_v = points
    else:
        pts_v = sess.distribute(points.astype(np.float32))
    dim = pts_v.data.shape[1]
    if init_centers is None:
        rng = np.random.RandomState(seed)
        pool = pts_v.data[: min(len(pts_v), 4096)].cpu().numpy()
        init_centers = pool[rng.choice(len(pool), k, replace=False)]
    centers = torch.as_tensor(np.asarray(init_centers, np.float32), device=sess.device)
    compiles0 = sess.stats.compiles
    dispatches0 = sess.stats.dispatches
    syncs0 = sess.stats.host_syncs

    it, converged, stats = 0, False, None
    for it in range(1, max_iters + 1):
        sums, stats = sess.map_reduce(
            pts_v, assign_mapper, "sum",
            torch.zeros((k, dim + 1), dtype=torch.float32, device=sess.device),
            engine=engine, env=centers, return_stats=True,
        )
        counts = torch.clamp(sums[:, dim:], min=1.0)
        new_centers = sums[:, :dim] / counts  # serial refinement step
        move = float(sess.host_value(
            torch.max(torch.sum((new_centers - centers) ** 2, dim=1))
        ))
        centers = new_centers
        if move < tol * tol:
            converged = True
            break

    # Final inertia via one more MapReduce (dense [1] target), materialised
    # through the session so the sync is counted.
    inertia = sess.map_reduce(
        pts_v, inertia_mapper, "sum",
        torch.zeros((1,), dtype=torch.float32, device=sess.device),
        engine=engine, env=centers,
    )[0]
    inertia = float(sess.host_value(inertia))
    fs = stats.finalize() if stats is not None else None
    return KMeansResult(
        centers=centers.cpu().numpy(),
        iterations=it,
        converged=converged,
        inertia=inertia,
        shuffle_bytes_per_iter=fs.shuffle_payload_bytes if fs else 0,
        compiles=sess.stats.compiles - compiles0,
        dispatches=sess.stats.dispatches - dispatches0,
        host_syncs=sess.stats.host_syncs - syncs0,
    )
