"""K-Means (paper §3.1.3, Fig. 6) — one MapReduce per assignment step.

The counterpart of ``repro/core/algorithms/kmeans.py``.  The mapper assigns
a point to its nearest centre and emits ``(centre, [x…, 1])``; per-centre
sums and counts accumulate in one dense ``[K, dim+1]`` target (a small fixed
key range: the segment-reduce kernel's register form under
``engine="pallas"``).  The refinement step is serial, as in the paper, and
the centres ride in ``env``.  In ``mode="per_op"`` a final MapReduce
computes the inertia: 2 compiles in all.

``mode="program"`` plans the assignment MapReduce and the refinement glue as
one program (``session.program``) and runs ``unroll`` iterations a dispatch
(``session.run_loop``; one CUDA graph replay on the card).  The inertia
rides the assignment pass there: the mapper emits ``(centre, [x…, 1,
min_d2])`` into one ``[K, dim+2]`` target, and the inertia of the final
centres comes from one more dispatch of the same program (its centre update
discarded), so no per-op stage is ever built.  ``wire`` narrows the sums'
collective payload.  ``mode="stream"`` comes with the out-of-core slice.
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


def assign_inertia_mapper(i, x, emit, centers):
    """Program-mode mapper: one distance computation gives the centre and
    the point's inertia (``min d²``), emitted together as ``(centre, [x…,
    1, min_d2])`` into a ``[K, dim+2]`` target."""
    d2 = torch.sum((centers - x[None, :]) ** 2, dim=1)
    c = torch.argmin(d2)
    one = torch.ones((1,), dtype=x.dtype, device=x.device)
    emit(c, torch.cat([x, one, torch.min(d2)[None]]))


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
    program_compiles: int = 0  # program plans / graph captures (mode="program")
    dispatches: int = 0  # stage runs (or program blocks) across the loop
    host_syncs: int = 0  # blocking host materialisations across the loop
    collectives_per_iter: int = 0  # optimised plan's collectives (program mode)


def _program_step(pts_v: DistVector, k: int, dim: int, engine: str, wire: str):
    """(step_fn, state builder) for the planned k-means iteration: one
    ``[K, dim+2]`` MapReduce (sums | counts | inertia) and the refinement
    glue."""
    dev = pts_v.data.device

    def step(ctx, s):
        c = s["centers"]
        sums = ctx.map_reduce(
            pts_v, assign_inertia_mapper, "sum",
            torch.zeros((k, dim + 2), dtype=torch.float32, device=dev),
            engine=engine, wire=wire, env=c,
        )
        counts = torch.clamp(sums[:, dim:dim + 1], min=1.0)
        new_c = sums[:, :dim] / counts  # serial refinement step, fused
        move = torch.max(torch.sum((new_c - c) ** 2, dim=1))
        # inertia of the CURRENT centres: the distances that chose them
        inertia = torch.sum(sums[:, dim + 1])
        return {"centers": new_c, "move": move, "inertia": inertia}

    def state0(centers):
        return {"centers": centers,
                "move": torch.full((), float("inf"), device=dev),
                "inertia": torch.zeros((), device=dev)}

    return step, state0


def kmeans(
    points: np.ndarray | DistVector,
    k: int,
    *,
    init_centers: np.ndarray | None = None,
    tol: float = 1e-4,
    max_iters: int = 50,
    engine: str = "eager",
    wire: str = "none",
    mode: str = "per_op",
    unroll: int = 1,
    seed: int = 0,
    session: BlazeSession | None = None,
) -> KMeansResult:
    if mode == "stream":
        raise NotImplementedError(
            "mode='stream' comes with the out-of-core streaming slice of the "
            "port; use mode='per_op' or 'program'"
        )
    if mode not in ("per_op", "program"):
        raise ValueError(f"unknown mode {mode!r}; choose 'per_op' or 'program'")
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

    if mode == "program":
        step, state0 = _program_step(pts_v, k, dim, engine, wire)
        prog = sess.program(step)
        state, info = sess.run_loop(
            prog, state0(centers),
            cond=lambda s: float(s["move"]) < tol * tol,
            max_iters=max_iters, unroll=unroll,
        )
        # Inertia of the FINAL centres: one more dispatch of the same
        # program, whose assignment pass is the inertia pass.
        probe = prog(state, 1)
        inertia = float(sess.host_value(probe["inertia"]))
        return KMeansResult(
            centers=state["centers"].cpu().numpy(),
            iterations=info.iterations,
            converged=info.converged,
            inertia=inertia,
            shuffle_bytes_per_iter=0,
            compiles=sess.stats.compiles - compiles0,
            program_compiles=info.compiles,
            # the session's count: the inertia probe included
            dispatches=sess.stats.dispatches - dispatches0,
            host_syncs=sess.stats.host_syncs - syncs0,
            collectives_per_iter=prog.plan.collectives_per_iter,
        )

    it, converged, stats = 0, False, None
    for it in range(1, max_iters + 1):
        sums, stats = sess.map_reduce(
            pts_v, assign_mapper, "sum",
            torch.zeros((k, dim + 1), dtype=torch.float32, device=sess.device),
            engine=engine, wire=wire, env=centers, return_stats=True,
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
