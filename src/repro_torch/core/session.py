"""BlazeSession — the long-lived driver context for iterative MapReduce.

The counterpart of ``repro/core/session.py``, per-op part.  A session owns the
device and the shard count (the JAX session owns a mesh), caches the shard
stage of every MapReduce configuration it has run, keyed on (source spec,
mapper identity, reducer, target spec, engine, env spec), and counts compiles
(stages built) and cache hits, so "10 iterations, 1 compile per
configuration" stays an assertable property.

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
    """Cumulative stage-reuse and dispatch/sync counters for one session."""

    calls: int = 0  # map_reduce invocations routed through the session
    compiles: int = 0  # calls that built a new shard stage
    cache_hits: int = 0  # calls served by a cached shard stage
    dispatches: int = 0  # stage runs
    host_syncs: int = 0  # blocking host materialisations (host_value)

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
        and the custom-reducer fallback for ``"pallas"`` resolve before the
        cache key is built, so the engine in ``MapReduceStats.engine`` is the
        one that keyed and ran the stage.  ``key_range`` (hash targets)
        promises keys in ``[0, key_range)``: the shuffle ships narrowed keys
        and the kernel sizes its combine table by the distinct-key bound.
        """
        if wire != "none":
            raise _later(f"wire={wire!r}", "wire-format")
        if tune:
            raise _later("tune=True", "cost-model and autotuning")
        red = get_reducer(reducer)
        kind = _mr.source_kind(source)
        engine = resolve_engine(engine, target, red)
        if isinstance(target, C.DistHashMap):
            out, stats = _mr._map_reduce_hash(
                kind, source, mapper, red, target, self.n_shards, self.device,
                engine, shuffle_slack, env, key_range=key_range,
                cache=self._exec_cache,
            )
        else:
            out, stats = _mr._map_reduce_dense(
                kind, source, mapper, red,
                torch.as_tensor(target, device=self.device), self.n_shards,
                self.device, engine, env, return_stats, cache=self._exec_cache,
            )
        self.stats.calls += 1
        self.stats.compiles += stats.compiles
        self.stats.cache_hits += stats.cache_hits
        self.stats.dispatches += stats.dispatches
        return (out, stats) if return_stats else out

    def host_value(self, x) -> np.ndarray:
        """Materialise ``x`` on the host as numpy (the driver's explicit sync
        point), counting it in ``stats.host_syncs``."""
        self.stats.host_syncs += 1
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
