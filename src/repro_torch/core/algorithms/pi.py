"""Monte-Carlo π estimation (paper §2.3.3, Table 1, Appendix A.2).

The counterpart of ``repro/core/algorithms/pi.py``: a DistRange of sample
indices, a mapper that emits ``(0, 1)`` for in-circle samples, a ``"sum"``
reducer and a 1-element dense target.  The ``emit(0, …)`` key is a Python
int, so every engine takes the static-key fast path (one fused reduction);
no kernel runs.  Randomness is counter-based (splitmix32 of the sample
index), the same bits as the JAX package.

``mode="program"`` routes the same op through the planner
(``session.program``): a one-node plan whose node hash equals the per-op
call's ``MapReduceStats.plan_hash``.  Either mode reads the count through
``session.host_value``, so ``stats.host_syncs`` counts its one sync.
"""
from __future__ import annotations

import torch

from repro_torch.core import DistRange
from repro_torch.core.containers import Mesh, hash32
from repro_torch.core.session import BlazeSession, resolve


def _uniform01(x: torch.Tensor, salt: int) -> torch.Tensor:
    h = hash32((x.to(torch.int64) & 0xFFFFFFFF) ^ salt)
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def pi_mapper(v, emit):
    x = _uniform01(v, 0x9E3779B9)
    y = _uniform01(v, 0x85EBCA6B)
    emit(0, torch.where(x * x + y * y < 1.0, 1, 0))


def _program_step(n_samples: int, engine: str, device):
    """(step_fn, initial state) for the planned spelling of π."""

    def step(ctx, s):
        counts = ctx.map_reduce(
            DistRange(0, n_samples, 1), pi_mapper, "sum",
            torch.zeros((1,), dtype=torch.int32, device=device), engine=engine,
        )
        return {"counts": counts}

    return step, {"counts": torch.zeros((1,), dtype=torch.int32, device=device)}


def estimate_pi(
    n_samples: int,
    *,
    engine: str = "eager",
    mode: str = "per_op",
    return_stats: bool = False,
    mesh: Mesh | None = None,
    session: BlazeSession | None = None,
):
    if mode not in ("per_op", "program"):
        raise ValueError(f"unknown mode {mode!r}; choose 'per_op' or 'program'")
    sess, mesh = resolve(session, mesh)
    if mode == "program":
        if return_stats:
            raise ValueError(
                "return_stats is a per-op feature; inside a program the op "
                "has no stats of its own: see session.explain instead"
            )
        step, state = _program_step(n_samples, engine, mesh.device)
        state, _info = sess.run_loop(sess.program(step, mesh=mesh), state, max_iters=1)
        return 4.0 * float(sess.host_value(state["counts"])[0]) / n_samples
    out = sess.map_reduce(
        DistRange(0, n_samples, 1),
        pi_mapper,
        "sum",
        torch.zeros((1,), dtype=torch.int32, device=mesh.device),
        engine=engine,
        return_stats=return_stats,
        mesh=mesh,
    )
    counts, stats = out if return_stats else (out, None)
    pi = 4.0 * float(sess.host_value(counts)[0]) / n_samples
    return (pi, stats) if return_stats else pi


def handrolled_count(n_samples: int, device) -> int:
    """In-circle count of the 'hand-optimised parallel for loop' baseline
    from Table 1: one reduction over all sample indices, no MapReduce."""
    idx = torch.arange(n_samples, device=device)
    x = _uniform01(idx, 0x9E3779B9)
    y = _uniform01(idx, 0x85EBCA6B)
    return int((x * x + y * y < 1.0).sum())


def estimate_pi_handrolled(n_samples: int, device=None) -> float:
    from repro_torch.core.containers import resolve_device

    return 4.0 * handrolled_count(n_samples, resolve_device(device)) / n_samples
