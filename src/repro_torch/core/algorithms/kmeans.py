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
collective payload.

``mode="stream"`` takes a ``ChunkedDistVector`` of points (out of core): one
epoch replays the program's graph once a block (``session.run_stream``),
each block's ``[K, dim+2]`` partial accumulating in the state, the
refinement taken on the epoch's last block.  Per op, chunked points run one
stage a block.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ChunkedDistVector, DistVector
from repro_torch.core.containers import Mesh, head
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


def _stream_step(pts_c: ChunkedDistVector, k: int, dim: int, engine: str, wire: str,
                 device):
    """(step_fn, state builder) for the out-of-core k-means epoch: each
    dispatch adds its block's ``[K, dim+2]`` partial to ``acc``; the
    refinement (centres, move, inertia) is committed only on the epoch's
    last block, after which ``acc`` resets and the block counter wraps, so
    one graph serves every block of every epoch."""
    n_blocks = pts_c.n_blocks

    def step(ctx, s):
        c = s["centers"]
        part = ctx.map_reduce(
            pts_c, assign_inertia_mapper, "sum",
            torch.zeros((k, dim + 2), dtype=torch.float32, device=device),
            engine=engine, wire=wire, env=c,
        )
        acc = s["acc"] + part
        last = s["blk"] == n_blocks - 1
        counts = torch.clamp(acc[:, dim:dim + 1], min=1.0)
        new_c = acc[:, :dim] / counts  # the refinement, kept on the last block
        move = torch.max(torch.sum((new_c - c) ** 2, dim=1))
        inertia = torch.sum(acc[:, dim + 1])
        return {
            "centers": torch.where(last, new_c, c),
            "move": torch.where(last, move, s["move"]),
            "inertia": torch.where(last, inertia, s["inertia"]),
            "acc": torch.where(last, torch.zeros_like(acc), acc),
            "blk": torch.where(last, torch.zeros_like(s["blk"]), s["blk"] + 1),
        }

    def state0(centers):
        return {"centers": centers,
                "move": torch.full((), float("inf"), device=device),
                "inertia": torch.zeros((), device=device),
                "acc": torch.zeros((k, dim + 2), dtype=torch.float32, device=device),
                "blk": torch.zeros((), dtype=torch.int32, device=device)}

    return step, state0


def kmeans(
    points: np.ndarray | DistVector | ChunkedDistVector,
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
    mesh: Mesh | None = None,
    session: BlazeSession | None = None,
) -> KMeansResult:
    if mode not in ("per_op", "program", "stream"):
        raise ValueError(f"unknown mode {mode!r}; choose 'per_op', 'program' or 'stream'")
    sess, mesh = resolve(session, mesh)
    if isinstance(points, ChunkedDistVector):
        if mode == "program":
            raise ValueError("chunked points need mode='stream' (the out-of-core "
                             "program loop) or mode='per_op'")
        pts_v = points
        dim = points.shape_tail[0]
    elif isinstance(points, DistVector):
        pts_v = points
        dim = pts_v.data.shape[1]
    else:
        pts_v = sess.distribute(points.astype(np.float32), mesh=mesh)
        dim = pts_v.data.shape[1]
    if init_centers is None:
        rng = np.random.RandomState(seed)
        if isinstance(pts_v, ChunkedDistVector):
            # block 0's first rows, the same on every rank of a process mesh
            pool = pts_v.head(4096)
        else:
            # the global first rows, the same on every rank of a process mesh
            pool = head(pts_v, 4096)
        init_centers = pool[rng.choice(len(pool), k, replace=False)]
    centers = torch.as_tensor(np.asarray(init_centers, np.float32), device=mesh.device)
    compiles0 = sess.stats.compiles
    dispatches0 = sess.stats.dispatches
    syncs0 = sess.stats.host_syncs

    if mode == "stream":
        if not isinstance(pts_v, ChunkedDistVector):
            raise ValueError("mode='stream' needs ChunkedDistVector points "
                             "(see session.chunked)")
        step, state0 = _stream_step(pts_v, k, dim, engine, wire, mesh.device)
        prog = sess.program(step, mesh=mesh)
        state, info = sess.run_stream(prog, state0(centers),
                                      cond=lambda s: float(s["move"]) < tol * tol,
                                      max_epochs=max_iters)
        # Inertia of the FINAL centres: one more epoch of the same graph, its
        # refinement discarded (the in-memory program's probe dispatch).
        probe, _ = sess.run_stream(prog, state, max_epochs=1)
        inertia = float(sess.host_value(probe["inertia"]))
        return KMeansResult(
            centers=state["centers"].cpu().numpy(),
            iterations=info.epochs,
            converged=info.converged,
            inertia=inertia,
            shuffle_bytes_per_iter=0,
            compiles=sess.stats.compiles - compiles0,
            program_compiles=info.compiles,
            dispatches=sess.stats.dispatches - dispatches0,
            host_syncs=sess.stats.host_syncs - syncs0,
            collectives_per_iter=prog.plan.collectives_per_iter,
        )

    if mode == "program":
        step, state0 = _program_step(pts_v, k, dim, engine, wire)
        prog = sess.program(step, mesh=mesh)
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
            torch.zeros((k, dim + 1), dtype=torch.float32, device=mesh.device),
            engine=engine, wire=wire, env=centers, return_stats=True, mesh=mesh,
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
        torch.zeros((1,), dtype=torch.float32, device=mesh.device),
        engine=engine, env=centers, mesh=mesh,
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
