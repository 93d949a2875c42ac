"""Nearest-100-neighbours (paper §3.1.5, Fig. 8).

The counterpart of ``repro/core/algorithms/knn.py``.  As in the paper, the
distributed container's ``topk`` with a custom score (negative squared
distance to the query) does the work: each shard selects its local top-k,
and only k·n_shards candidates move on — O(n + k log k) work, O(k) space.
``knn_full_sort`` is the naive baseline that sorts every distance.

kNN's plan is container-level: the ``topk`` container fixes it, so an
``engine=`` request changes nothing.  The request is validated and surfaced
(``KNNResult.engine_requested``, and on the plan's ``topk`` node in
``mode="program"``, where ``ctx.topk`` selects inside one program), never
silently dropped.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import DistVector
from repro_torch.core.containers import Mesh
from repro_torch.core.plan import ENGINES
from repro_torch.core.session import BlazeSession, resolve


def _neg_sq_dist(x, q):
    """topk score: negative squared Euclidean distance to the query ``q``."""
    return -torch.sum((x - q) ** 2)


@dataclasses.dataclass
class KNNResult:
    neighbors: np.ndarray  # [k, dim]
    distances: np.ndarray  # [k]
    wire_candidates: int  # how many rows crossed the wire
    engine: str = "container:topk"  # the plan is fixed by the container
    engine_requested: str = "auto"  # surfaced, never applied


def _program_step(pts_v: DistVector, k: int, engine: str):
    """step_fn for the planned spelling of kNN (one ``ctx.topk`` node)."""

    def step(ctx, s):
        nbrs, scores = ctx.topk(pts_v, k, score_fn=_neg_sq_dist, env=s["q"],
                                engine=engine)
        return {"q": s["q"], "neighbors": nbrs, "scores": scores}

    return step


def knn(
    points: np.ndarray | DistVector,
    query: np.ndarray,
    k: int = 100,
    *,
    engine: str = "auto",
    mode: str = "per_op",
    mesh: Mesh | None = None,
    session: BlazeSession | None = None,
) -> KNNResult:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    if mode not in ("per_op", "program"):
        raise ValueError(f"unknown mode {mode!r}; choose 'per_op' or 'program'")
    sess, mesh = resolve(session, mesh)
    if isinstance(points, DistVector):
        pts_v = points
    else:
        pts_v = sess.distribute(points.astype(np.float32), mesh=mesh)
    q = torch.as_tensor(np.asarray(query, np.float32), device=mesh.device)
    if mode == "program":
        per = pts_v.data.shape[0] // mesh.n_local  # rows a shard
        kk = min(k, per)
        m = min(k, kk * mesh.n_shards)
        dim = pts_v.data.shape[1]
        prog = sess.program(_program_step(pts_v, k, engine), mesh=mesh)
        state = {
            "q": q,
            "neighbors": torch.zeros((m, dim), dtype=pts_v.data.dtype,
                                     device=mesh.device),
            "scores": torch.full((m,), float("-inf"), device=mesh.device),
        }
        state, _info = sess.run_loop(prog, state, max_iters=1)
        nbrs, scores = sess.host_value((state["neighbors"], state["scores"]))
        return KNNResult(
            neighbors=nbrs, distances=np.sqrt(np.maximum(-scores, 0.0)),
            wire_candidates=kk * mesh.n_shards,
            engine="container:topk", engine_requested=engine,
        )
    # The query rides in env; session.topk counts the blocking candidate
    # materialisation in stats.host_syncs.
    nbrs = sess.topk(pts_v, k, score_fn=_neg_sq_dist, env=q, mesh=mesh)
    d = np.sqrt(((nbrs - np.asarray(query)[None]) ** 2).sum(1))
    return KNNResult(
        neighbors=nbrs, distances=d, wire_candidates=k * mesh.n_shards,
        engine="container:topk", engine_requested=engine,
    )


def knn_full_sort(points: np.ndarray, query: np.ndarray, k: int = 100) -> KNNResult:
    """Naive oracle: full distance sort on the host."""
    d2 = ((points - query[None]) ** 2).sum(1)
    idx = np.argsort(d2)[:k]
    return KNNResult(
        neighbors=points[idx],
        distances=np.sqrt(d2[idx]),
        wire_candidates=len(points),
    )
