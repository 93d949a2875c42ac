"""PageRank (paper §3.1.2, Fig. 5) — three MapReduce ops per iteration.

The counterpart of ``repro/core/algorithms/pagerank.py``:

  MR1  total score of all sinks               (dense [1] target, "sum")
  MR2  new scores from Eq. 1                  (dense [N] target, "sum")
  MR3  max |Δscore| for the convergence test  (dense [1] target, "max")

Links are a DistVector of ``[E, 2]`` edges; scores ride in ``env`` so one
cached stage serves every iteration (3 compiles in all).  MR2's contribution
scatter is the dynamic-key combine the segment-reduce kernel runs under
``engine="pallas"``; MR1/MR3 emit static keys and keep the fused fast path.

* ``mode="per_op"`` (default): three dispatches and one host sync per
  iteration for the convergence test, 3 compiles in all.
* ``mode="program"``: the iteration (three ops and the score update) is one
  planned program (``session.program``) driven by ``session.run_loop``,
  ``unroll`` iterations a dispatch (one CUDA graph replay on the card): the
  sink and contribution sums share one collective, 2 an iteration.  With
  ``wire="int8"`` the program carries each shard's quantisation residual
  across iterations, keeping the power iteration unbiased.

* ``mode="stream"``: the edges are a ``ChunkedDistVector`` (out of core);
  one epoch is one iteration, replaying the program's graph once a block
  (``session.run_stream``): MR2's block partial accumulates in the state,
  and MR1, the update and MR3 are committed on the epoch's last block.  The
  out-degrees are counted from the blocks on the host, a block at a time.

``wire`` narrows MR2's collective payload (bf16, or int8 with a shared
scale).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import ChunkedDistVector, DistRange
from repro_torch.core.containers import Mesh
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
    program_compiles: int = 0  # program plans / graph captures (mode="program")
    dispatches: int = 0  # stage runs (or program blocks) across the loop
    host_syncs: int = 0  # blocking host materialisations across the loop
    collectives_per_iter: int = 0  # optimised plan's collectives (program mode)


def _program_step(edges_v, deg, n_pages: int, damping: float, engine: str,
                  wire: str):
    """(step_fn, state builder) for the planned PageRank iteration: the
    sink-sum and contribution-sum partials share one collective (both f32
    sums, same wire, with ``wire="none"``), the delta max runs alone, so the
    plan reports 2 collectives an iteration instead of 3."""
    pages = DistRange(0, n_pages, 1)
    d = damping
    dev = edges_v.data.device

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    def step(ctx, s):
        sc = s["scores"]
        sink = ctx.map_reduce(pages, sink_mapper, "sum", zeros(1), engine=engine,
                              env=(sc, deg))[0]
        incoming = ctx.map_reduce(edges_v, contrib_mapper, "sum", zeros(n_pages),
                                  engine=engine, wire=wire, env=(sc, deg))
        new = (1.0 - d) / n_pages + d * (incoming + sink / n_pages)
        delta = ctx.map_reduce(pages, delta_mapper, "max", zeros(1), engine=engine,
                               env=(sc, new))[0]
        return {"scores": new, "delta": delta}

    def state0(scores):
        return {"scores": scores,
                "delta": torch.full((), float("inf"), device=dev)}

    return step, state0


def _stream_step(edges_c: ChunkedDistVector, deg, n_pages: int, damping: float,
                 engine: str, wire: str, device):
    """(step_fn, state builder) for the out-of-core PageRank epoch: MR2 over
    the resident block accumulates into ``acc``; MR1, Eq. 1 and MR3 run
    every dispatch but are committed only on the epoch's last block, where
    ``acc`` holds the whole incoming vector, so one graph serves every block
    of every epoch."""
    pages = DistRange(0, n_pages, 1)
    d = damping
    n_blocks = edges_c.n_blocks

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    def step(ctx, s):
        sc = s["scores"]
        part = ctx.map_reduce(edges_c, contrib_mapper, "sum", zeros(n_pages),
                              engine=engine, wire=wire, env=(sc, deg))
        acc = s["acc"] + part
        last = s["blk"] == n_blocks - 1
        sink = ctx.map_reduce(pages, sink_mapper, "sum", zeros(1), engine=engine,
                              env=(sc, deg))[0]
        new = (1.0 - d) / n_pages + d * (acc + sink / n_pages)
        delta = ctx.map_reduce(pages, delta_mapper, "max", zeros(1), engine=engine,
                               env=(sc, new))[0]
        return {
            "scores": torch.where(last, new, sc),
            "delta": torch.where(last, delta, s["delta"]),
            "acc": torch.where(last, torch.zeros_like(acc), acc),
            "blk": torch.where(last, torch.zeros_like(s["blk"]), s["blk"] + 1),
        }

    def state0(scores):
        return {"scores": scores,
                "delta": torch.full((), float("inf"), device=device),
                "acc": zeros(n_pages),
                "blk": torch.zeros((), dtype=torch.int32, device=device)}

    return step, state0


def block_degrees(edges_c: ChunkedDistVector, n_pages: int) -> np.ndarray:
    """Out-degrees counted on the host a block at a time (the edge list is
    never resident); the last block's padding rows are left out.  On a
    process mesh each rank counts its rows and the ranks' counts are summed
    (a collective: every rank calls it; integers, so exact)."""
    deg = np.zeros((n_pages,), np.int64)
    for b in range(edges_c.n_blocks):
        blk = edges_c.block_host(b)[: edges_c.local_true_rows(b)]
        deg += np.bincount(blk[:, 0], minlength=n_pages)
    if edges_c.mesh is not None:
        from repro_torch.core.collectives import gather_rows

        got = gather_rows(edges_c.mesh, torch.from_numpy(deg)[None].to(edges_c.device))
        deg = got.sum(0).cpu().numpy()
    return deg.astype(np.int32)


def pagerank(
    edges: np.ndarray | ChunkedDistVector,
    n_pages: int,
    *,
    damping: float = 0.85,
    tol: float = 1e-5,
    max_iters: int = 100,
    engine: str = "eager",
    wire: str = "none",
    mode: str = "per_op",
    unroll: int = 1,
    mesh: Mesh | None = None,
    session: BlazeSession | None = None,
) -> PageRankResult:
    if mode not in ("per_op", "program", "stream"):
        raise ValueError(f"unknown mode {mode!r}; choose 'per_op', 'program' or 'stream'")
    sess, mesh = resolve(session, mesh)
    dev = mesh.device
    if isinstance(edges, ChunkedDistVector):
        if mode == "program":
            raise ValueError("chunked edges need mode='stream' (the out-of-core "
                             "program loop) or mode='per_op'")
        edges_v = edges
        deg = torch.from_numpy(block_degrees(edges, n_pages)).to(dev)
    else:
        if mode == "stream":
            raise ValueError("mode='stream' needs ChunkedDistVector edges "
                             "(see session.chunked)")
        edges_v = sess.distribute(edges.astype(np.int32), mesh=mesh)
        deg = torch.from_numpy(
            np.bincount(edges[:, 0], minlength=n_pages).astype(np.int32)
        ).to(dev)
    pages = DistRange(0, n_pages, 1)
    scores = torch.full((n_pages,), 1.0 / n_pages, dtype=torch.float32, device=dev)
    d = damping
    compiles0 = sess.stats.compiles
    dispatches0 = sess.stats.dispatches
    syncs0 = sess.stats.host_syncs

    if mode == "stream":
        step, state0 = _stream_step(edges_v, deg, n_pages, d, engine, wire, dev)
        prog = sess.program(step, mesh=mesh)
        state, info = sess.run_stream(prog, state0(scores),
                                      cond=lambda s: float(s["delta"]) < tol,
                                      max_epochs=max_iters)
        return PageRankResult(
            scores=state["scores"].cpu().numpy(),
            iterations=info.epochs,
            converged=info.converged,
            shuffle_bytes_per_iter=0,
            pairs_shipped_per_iter=0,
            compiles=sess.stats.compiles - compiles0,
            program_compiles=info.compiles,
            dispatches=sess.stats.dispatches - dispatches0,
            host_syncs=sess.stats.host_syncs - syncs0,
            collectives_per_iter=prog.plan.collectives_per_iter,
        )

    if mode == "program":
        step, state0 = _program_step(edges_v, deg, n_pages, d, engine, wire)
        prog = sess.program(step, mesh=mesh)
        state, info = sess.run_loop(
            prog, state0(scores),
            cond=lambda s: float(s["delta"]) < tol,  # counted by run_loop
            max_iters=max_iters, unroll=unroll,
        )
        return PageRankResult(
            scores=state["scores"].cpu().numpy(),
            iterations=info.iterations,
            converged=info.converged,
            shuffle_bytes_per_iter=0,  # no per-op stats inside a program
            pairs_shipped_per_iter=0,
            compiles=sess.stats.compiles - compiles0,
            program_compiles=info.compiles,
            dispatches=sess.stats.dispatches - dispatches0,
            host_syncs=sess.stats.host_syncs - syncs0,
            collectives_per_iter=prog.plan.collectives_per_iter,
        )

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    it, converged, stats2 = 0, False, None
    for it in range(1, max_iters + 1):
        sink_total = sess.map_reduce(
            pages, sink_mapper, "sum", zeros(1), engine=engine,
            env=(scores, deg), mesh=mesh,
        )[0]
        incoming, stats2 = sess.map_reduce(
            edges_v, contrib_mapper, "sum", zeros(n_pages), engine=engine,
            wire=wire, env=(scores, deg), return_stats=True, mesh=mesh,
        )
        new_scores = (1.0 - d) / n_pages + d * (incoming + sink_total / n_pages)
        delta = sess.map_reduce(
            pages, delta_mapper, "max", zeros(1), engine=engine,
            env=(scores, new_scores), mesh=mesh,
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
