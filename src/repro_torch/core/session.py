"""BlazeSession — the long-lived driver context for iterative MapReduce.

The counterpart of ``repro/core/session.py``.  A session owns the device
and the shard count (the JAX session owns a mesh), caches the shard stage of
every MapReduce configuration it has run, keyed on (source spec, mapper
identity, reducer, target spec, engine, wire, env spec), and counts compiles
(stages built) and cache hits, so "10 iterations, 1 compile per
configuration" stays an assertable property.  Each op is a one-node logical
plan (``core.plan``), so its ``MapReduceStats.plan_hash`` is the hash the same
op gets inside a fused program (``session.program``, ``explain``,
``run_loop``; ``core.program``).

Its entry points run on the card unless the caller passes ``device="cpu"``;
without CUDA, ``BlazeSession()`` raises.  The free ``map_reduce`` routes
through a lazily created process-wide default session.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import containers as C
from repro_torch.core import mapreduce as _mr
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import ENGINES, resolve_engine
from repro_torch.core.cost import PALLAS_AUTO_MAX_KEYS
from repro_torch.core.reducers import Reducer, get_reducer

__all__ = [
    "BlazeSession",
    "ENGINES",
    "PALLAS_AUTO_MAX_KEYS",
    "SessionStats",
    "get_default_session",
    "reset_default_session",
    "resolve",
    "resolve_engine",
    "set_default_session",
]


@dataclasses.dataclass
class SessionStats:
    """Cumulative stage-reuse and dispatch/sync counters for one session.

    ``dispatches`` and ``host_syncs`` make the fusion contract assertable:
    N per-op iterations cost 3–4 dispatches and a host sync each, while
    ``run_loop`` over a program costs at most ceil(N / unroll) of both.
    """

    calls: int = 0  # map_reduce invocations routed through the session
    compiles: int = 0  # calls that built a new shard stage
    cache_hits: int = 0  # calls served by a cached shard stage
    dispatches: int = 0  # stage runs and program blocks
    host_syncs: int = 0  # blocking host materialisations (host_value, cond)
    program_compiles: int = 0  # program plans built (CPU) or graphs captured
    program_dispatches: int = 0  # program blocks run
    graph_captures: int = 0  # CUDA graphs captured by programs
    graph_replays: int = 0  # CUDA graph replays (one a program block on the card)
    graph_pool_peak_bytes: int = 0  # largest device memory peak over a capture
    graph_pool_reserved_bytes: int = 0  # device memory the captures reserved
    # kernel (and "kernel/form") -> launches run by graph replays
    graph_launches: dict = dataclasses.field(default_factory=dict)

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / self.calls if self.calls else 0.0


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; it comes with the {slice_name} slice "
        "of the port (ROADMAP.md, Queue 1)"
    )


class BlazeSession:
    """Owns a device, a shard count and a shard-stage cache.

    >>> sess = BlazeSession(device="cpu")
    >>> for _ in range(10):
    ...     scores = sess.map_reduce(edges, contrib_mapper, "sum",
    ...                              torch.zeros(n), env=scores)
    >>> sess.stats.compiles   # 1 — nine of the ten calls reused it
    """

    def __init__(self, device=None, n_shards: int = 1):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.device = C.resolve_device(device)
        self.n_shards = n_shards
        self._exec_cache: dict = {}
        self.stats = SessionStats()

    def map_reduce(
        self,
        source,
        mapper: Callable,
        reducer: str | Reducer,
        target,
        *,
        engine: str = "eager",
        wire: str = "none",
        env: Any = None,
        shuffle_slack: float = 2.0,
        key_range: int | None = None,
        return_stats: bool = False,
        tune: bool = False,
    ):
        """Run one MapReduce op, reusing this session's cached stages.

        ``engine`` is ``"eager" | "pallas" | "naive" | "auto"``; ``"auto"``
        and the custom-reducer fallback for ``"pallas"`` resolve (the
        resolve-engines pass on the op's one-node plan) before the cache key
        is built, so the engine in ``MapReduceStats.engine`` is the one that
        keyed and ran the stage.  ``wire`` ("none", "bf16", "int8") narrows
        a dense sum's collective payload; hash targets ship keys and values
        as they are.  ``key_range`` (hash targets) promises keys in ``[0,
        key_range)``: the shuffle ships narrowed keys and the kernel sizes
        its combine table by the distinct-key bound.
        """
        if tune:
            raise _later("tune=True", "cost-model and autotuning")
        red = get_reducer(reducer)
        kind = _mr.source_kind(source)
        hash_target = isinstance(target, C.DistHashMap)
        if not hash_target:
            target = torch.as_tensor(target, device=self.device)
        node = plan_mod.build_mapreduce_node(
            idx=0, kind=kind, src=plan_mod.source_desc(kind, source),
            source_key=None, mapper=mapper, red=red, target=target,
            engine=engine, wire=wire, key_range=key_range, env=env,
        )
        if hash_target:
            out, stats = _mr._map_reduce_hash(
                kind, source, mapper, red, target, self.n_shards, self.device,
                node.engine, shuffle_slack, env, key_range=key_range,
                cache=self._exec_cache, node=node,
            )
        else:
            out, stats = _mr._map_reduce_dense(
                kind, source, mapper, red, target, self.n_shards, self.device,
                node.engine, wire, env, return_stats, cache=self._exec_cache,
                node=node,
            )
        self.stats.calls += 1
        self.stats.compiles += stats.compiles
        self.stats.cache_hits += stats.cache_hits
        self.stats.dispatches += stats.dispatches
        return (out, stats) if return_stats else out

    def host_value(self, x) -> np.ndarray:
        """Materialise ``x`` (a tensor, or a tuple of them) on the host as
        numpy (the driver's explicit sync point), counting one sync in
        ``stats.host_syncs``."""
        self.stats.host_syncs += 1
        if isinstance(x, tuple):
            return tuple(t.detach().cpu().numpy() for t in x)
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)

    def foreach(self, v: C.DistVector, fn: Callable, env: Any = None) -> C.DistVector:
        """Session-scoped ``foreach``: an elementwise map, no stage and no
        sync (``env`` carries iteration-varying state, as for
        ``map_reduce``)."""
        return C.foreach(v, fn, env=env)

    def topk(self, v: C.DistVector, k: int, score_fn: Callable | None = None,
             env: Any = None) -> np.ndarray:
        """Session-scoped ``topk`` over this session's shards: selects on the
        device, then materialises the ``k·n_shards`` candidates on the host,
        a blocking sync counted in ``stats.host_syncs``."""
        self.stats.host_syncs += 1
        return C.topk(v, k, score_fn=score_fn, env=env, n_shards=self.n_shards)

    def distribute(self, x) -> C.DistVector:
        """``distribute`` onto this session's device and shards."""
        return C.distribute(x, self.n_shards, self.device)

    def make_dist_hashmap(self, capacity_per_shard: int, val_shape: tuple = (),
                          val_dtype: torch.dtype = torch.float32,
                          reducer: str | Reducer = "sum") -> C.DistHashMap:
        """``make_dist_hashmap`` on this session's device and shards."""
        return C.make_dist_hashmap(
            capacity_per_shard, val_shape, val_dtype, reducer,
            n_shards=self.n_shards, device=self.device,
        )

    # -- fused iteration programs (see repro_torch.core.program) -------------

    def program(self, step_fn: Callable, *, passes=None, tune: bool = False,
                hierarchical: bool = True):
        """Plan ``step_fn(ctx, state) -> state``, a whole iteration of
        MapReduce ops plus elementwise glue, as one program.

        ``ctx`` mirrors the session API (``ctx.map_reduce``, ``ctx.foreach``,
        ``ctx.topk``); iteration-varying values go through ``state``.
        Discovery builds the logical plan and runs the passes (per-node
        engines, collective batching, CSE, dead-source pruning);
        ``passes=()`` switches off the optional three.  Run it with
        ``program(state, n_iters)`` or :meth:`run_loop`; render the plan
        with :meth:`explain`.  On the card a dispatch is one CUDA graph
        replay.  ``hierarchical`` keeps the reference's signature: the
        port's one node has no hierarchy.
        """
        from repro_torch.core.program import Program

        if tune:
            raise _later("program(tune=True)", "cost-model and autotuning")
        del hierarchical
        return Program(self, step_fn, passes=passes)

    def explain(self, program, state=None) -> str:
        """Render ``program``'s optimised logical plan, Spark-EXPLAIN-style:
        nodes with resolved engines and wire dtypes, the source table,
        batched collective groups, CSE and pruning, the plan hash.  Pass
        ``state`` to build the plan without dispatching, or call after the
        program has run."""
        plan = program.build(state) if state is not None else program.plan
        if plan is None:
            raise ValueError(
                "program has no plan yet: pass state= (or dispatch it once)"
            )
        return plan.render()

    def run_loop(self, program, state, *, cond: Callable | None = None,
                 max_iters: int, unroll: int = 1, checkpoint=None,
                 checkpoint_every: int | None = None, resume: bool = False):
        """Drive a ``Program``: ``unroll`` iterations a dispatch (one graph
        replay on the card).  ``cond(state) -> bool`` (True = converged,
        stop) runs on the host between dispatches, one host sync each.
        Returns ``(state, LoopInfo)``; the state is the program's copy, never
        a buffer the next replay overwrites."""
        from repro_torch.core.program import LoopInfo

        if checkpoint is not None or checkpoint_every is not None or resume:
            raise _later("run_loop(checkpoint=, resume=)", "out-of-core streaming")
        if unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {unroll}")
        compiles0 = program.stats.compiles
        it = dispatches = host_syncs = 0
        converged = False
        while it < max_iters:
            u = min(unroll, max_iters - it)
            state = program(state, u)
            dispatches += 1
            it += u
            if cond is not None:
                self.stats.host_syncs += 1
                host_syncs += 1
                if bool(cond(state)):
                    converged = True
                    break
        return state, LoopInfo(
            iterations=it, dispatches=dispatches, host_syncs=host_syncs,
            converged=converged, compiles=program.stats.compiles - compiles0,
        )

    def run_stream(self, program, state, **kwargs):
        """Out-of-core epochs over chunked sources: a later slice."""
        raise _later("run_stream", "out-of-core streaming")

    def cache_info(self) -> dict:
        """Stage-cache snapshot: entries + cumulative counters."""
        return {
            "entries": len(self._exec_cache),
            "calls": self.stats.calls,
            "compiles": self.stats.compiles,
            "cache_hits": self.stats.cache_hits,
            "hit_rate": self.stats.hit_rate,
            "dispatches": self.stats.dispatches,
            "host_syncs": self.stats.host_syncs,
        }


# -- process-wide default session --------------------------------------------

_default_lock = threading.Lock()
_default_session: BlazeSession | None = None


def get_default_session() -> BlazeSession:
    """The lazily created session backing the free ``map_reduce`` (on the
    card: it raises without CUDA)."""
    global _default_session
    if _default_session is None:
        with _default_lock:
            if _default_session is None:
                _default_session = BlazeSession()
    return _default_session


def set_default_session(session: BlazeSession) -> BlazeSession | None:
    """Install ``session`` as the process default; returns the previous one."""
    global _default_session
    with _default_lock:
        prev, _default_session = _default_session, session
    return prev


def reset_default_session() -> None:
    """Forget the default session (a fresh one is built on next use)."""
    global _default_session
    with _default_lock:
        _default_session = None


def resolve(session: BlazeSession | None) -> BlazeSession:
    """The session, or the default one — the driver entry idiom."""
    return session if session is not None else get_default_session()
