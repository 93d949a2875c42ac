"""BlazeSession — the long-lived driver context for iterative MapReduce.

The counterpart of ``repro/core/session.py``.  A session owns a mesh
(``containers.Mesh``: a device, and the shards stacked on it in ``n_nodes``
node rows), caches the shard stage of
every MapReduce configuration it has run, keyed on (source spec, mapper
identity, reducer, target spec, engine, wire, env spec), and counts compiles
(stages built) and cache hits, so "10 iterations, 1 compile per
configuration" stays an assertable property.  Each op is a one-node logical
plan (``core.plan``), so its ``MapReduceStats.plan_hash`` is the hash the same
op gets inside a fused program (``session.program``, ``explain``,
``run_loop``; ``core.program``).

Measured autotuning: ``map_reduce(tune=True)`` and ``program(tune=True)``
time a node's candidate launches once (``cost.dense_tuning_candidates``,
``cost.hash_tuning_candidates``) and cache the winner in ``session.tuning``
under the node's untuned plan hash, which every later build of the same op
consults; ``save_tuning`` / ``load_tuning`` persist the cache.  Out of core:
``chunked()`` keeps a dataset on the host as blocks; ``map_reduce`` over one
runs a stage per block, ``run_stream`` a program's graph per block, and
``run_loop`` / ``run_stream`` checkpoint and resume (``checkpoint=``).

Supervision (``core.faults``): every dispatch the session makes (a per-op
call, a chunked block, a program block) runs under ``retry``, a
``RetryPolicy``.  A transient fault is retried with backoff; an injected
kernel fault degrades the node (per op) or the program's kernel nodes to
eager and runs the dispatch again; a fatal fault, and any real error,
propagates.  ``escalate_overflow=True`` regrows a hash target that
overflowed along the capacity grid and runs the op again.  ``retry=None``
turns supervision off.

Topology: on a multi-node mesh (``launch.mesh.make_node_data_mesh``) the
``hierarchical-collectives`` pass makes every eligible dense reduce two
hops (each node's shards at full precision, then the node partials, the
only hop a wire narrows); ``map_reduce(..., hierarchical=False)`` and
``program(..., hierarchical=False)`` keep the flat collective, the A/B
baseline.  On a 1-node mesh the flag changes nothing.  ``mesh=`` on a call
overrides the session's mesh for that call, as in the reference.

Across processes (a mesh from ``make_node_data_mesh`` with a process group
up, one node row a process): every rank makes the same calls on the same
arguments, as every JAX process does, and ends with the same result.  Each
host decision is taken from a value every rank holds alike: the overflow
that escalation reads is the mesh's, tuning's winner is rank 0's, and a
kernel fault degrades on every rank or fails the dispatch.  A chunked
source holds each rank's rows of every block (``chunked``); a stream runs
every block on every rank, the block count agreed between the ranks, and
``cond`` reads the state, which every rank holds alike.  Checkpoints write
each rank's rows of the per-rank leaves beside rank 0's replicated ones
(``checkpoint.manager``).

Its entry points run on the card unless the caller passes ``device="cpu"``;
without CUDA, ``BlazeSession()`` raises.  The free ``map_reduce`` routes
through a lazily created process-wide default session.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import containers as C
from repro_torch.core.collectives import agree as _agree
from repro_torch.core.collectives import all_ranks_equal
from repro_torch.core import cost as cost_mod
from repro_torch.core import faults
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
    tune_measurements: int = 0  # candidate configs timed by the autotuner
    retries: int = 0  # transient-fault dispatches run again
    degraded_nodes: int = 0  # kernel faults that degraded nodes to eager
    escalations: int = 0  # hash targets regrown after overflow
    # kernel (and "kernel/form") -> launches run by graph replays
    graph_launches: dict = dataclasses.field(default_factory=dict)

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / self.calls if self.calls else 0.0


# The default supervision policy: 3 attempts, 5 ms first backoff, 30 s
# deadline (one instance, so the default is introspectable).
_DEFAULT_RETRY = faults.RetryPolicy()


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _cuda_index(device: torch.device) -> int:
    """A CUDA device's index, the current one for a bare ``"cuda"``: what a
    worker thread, which starts on device 0, sets before it touches CUDA."""
    return device.index if device.index is not None else torch.cuda.current_device()


class BlazeSession:
    """Owns a mesh (a device and its stacked shards) and a shard-stage
    cache.

    >>> sess = BlazeSession(device="cpu")
    >>> for _ in range(10):
    ...     scores = sess.map_reduce(edges, contrib_mapper, "sum",
    ...                              torch.zeros(n), env=scores)
    >>> sess.stats.compiles   # 1 — nine of the ten calls reused it
    """

    def __init__(self, device=None, n_shards: int | None = None, *,
                 mesh: C.Mesh | None = None, tuning_path: str | None = None,
                 retry: faults.RetryPolicy | None = _DEFAULT_RETRY,
                 escalate_overflow: bool = False, max_escalations: int = 3):
        if n_shards is not None and n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if mesh is None:
            mesh = C.data_mesh(n_shards, device)
        elif n_shards is not None and n_shards != mesh.n_shards:
            raise ValueError(f"n_shards={n_shards} conflicts with the mesh's "
                             f"{mesh.n_shards} shards")
        elif device is not None and C.resolve_device(device) != mesh.device:
            raise ValueError(f"device={device!r} conflicts with the mesh's {mesh.device}")
        self._mesh = mesh
        self.device = mesh.device
        self.n_shards = mesh.n_shards
        self._exec_cache: dict = {}
        self.stats = SessionStats()
        # Supervision (module docstring).  Escalation is opt-in: overflow
        # counted and dropped is itself a contract, and reading it costs a
        # host sync a hash call.
        self.retry = retry
        self.escalate_overflow = escalate_overflow
        self.max_escalations = max_escalations
        # tune_keys of nodes degraded to eager after a kernel fault; every
        # node build consults it, so a node degraded once stays degraded for
        # the session and its eager stage caches under its own signature.
        self._degraded: set = set()
        # Measured winners, keyed by node plan hash; consulted by every node
        # build (per op and in programs), so a winner measured once serves
        # every later dispatch of the same op.  ``tuning_path`` preloads a
        # cache saved by ``save_tuning``.
        self.tuning = cost_mod.TuningCache()
        self._tuning_path = tuning_path
        if tuning_path and os.path.exists(tuning_path):
            self.tuning.load(tuning_path)
        # every candidate timing: {"tune_key", "config", "wall_s"}
        self.tune_log: list[dict] = []
        # Session state (stage cache, stats, program carries and graphs) is
        # not safe to mutate from concurrent threads.  Multi-threaded front
        # ends (the serving layer's dispatcher, notably) serialize all
        # session work under this lock; single-threaded drivers never need
        # to take it.
        self.lock = threading.RLock()

    @property
    def mesh(self) -> C.Mesh:
        """The session's mesh: its device and its ``(node, data)`` shards."""
        return self._mesh

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
        mesh: C.Mesh | None = None,
        hierarchical: bool = True,
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
        its combine table by the distinct-key bound.  ``mesh`` overrides the
        session's mesh for this call.  On a multi-node mesh an eligible dense
        reduce is hierarchical (``MapReduceStats.collective`` says which ran);
        ``hierarchical=False`` keeps it flat.
        """
        red = get_reducer(reducer)
        mesh = mesh or self.mesh
        kind = _mr.source_kind(source)
        _mr._require_rank_rows(mesh, kind, source)
        hash_target = isinstance(target, C.DistHashMap)
        if not hash_target:
            target = torch.as_tensor(target, device=mesh.device)
        node = plan_mod.build_mapreduce_node(
            idx=0, kind=kind, src=plan_mod.source_desc(kind, source),
            source_key=None, mapper=mapper, red=red, target=target,
            engine=engine, wire=wire, key_range=key_range, env=env,
            tuning=self.tuning, degraded=self._degraded, n_nodes=mesh.n_nodes,
            hierarchical=hierarchical,
        )
        # Tuning skips chunked sources: their operands arrive a block at a time.
        if tune and node.tuned is None and kind != "chunked" and self._tunable(node, red, target):
            self._tune_map_reduce(kind, source, mapper, red, target, mesh, wire, env,
                                  shuffle_slack, key_range, node)
            cfg = self.tuning.peek(node.tune_key)
            if cfg is not None:
                plan_mod.apply_tuned(node, red, cfg)
        if kind == "chunked":
            out, stats = self._map_reduce_chunked(source, mapper, red, target, mesh, wire,
                                                  env, shuffle_slack, key_range, node,
                                                  return_stats)
        elif hash_target:
            def dispatch_hash(tgt):
                return _mr._map_reduce_hash(
                    kind, source, mapper, red, tgt, mesh, node.engine, shuffle_slack,
                    env, key_range=key_range, cache=self._exec_cache, node=node,
                    tuned=node.tuned,
                )

            out, stats = self._dispatch_supervised(lambda: dispatch_hash(target), node, mesh)
            out, stats = self._maybe_escalate(out, stats, target, red, node, dispatch_hash,
                                              mesh)
        else:
            out, stats = self._dispatch_supervised(
                lambda: _mr._map_reduce_dense(
                    kind, source, mapper, red, target, mesh, node.engine, wire, env,
                    return_stats, cache=self._exec_cache, node=node, tuned=node.tuned,
                    hier=node.hier,
                ),
                node, mesh,
            )
        self.stats.calls += 1
        self.stats.compiles += stats.compiles
        self.stats.cache_hits += stats.cache_hits
        self.stats.dispatches += stats.dispatches
        return (out, stats) if return_stats else out

    def _map_reduce_chunked(self, source: C.ChunkedDistVector, mapper, red, target, mesh,
                            wire, env, shuffle_slack, key_range, node, return_stats):
        """Out-of-core ``map_reduce``: one stage run a block, each block's
        result merged into the running target (merged-into-target semantics
        make the accumulation free).  A worker thread reads block k+1 and,
        on the card, copies it to the device on a copy stream while block k
        runs; the stage's stream waits on the copy's event.  The stage is
        cached once for all blocks (the block's ``base`` is a tensor).  Each
        block's dispatch is supervised; a retry runs the block view it
        holds again, and never pulls the next block."""
        from repro_torch.data.pipeline import prefetch_iter

        dev = mesh.device
        card = dev.type == "cuda"
        copy = torch.cuda.Stream(dev) if card else None
        index = _cuda_index(dev) if card else None

        def produce(b):
            if card:
                torch.cuda.set_device(index)
            return source.block_view(b, stream=copy)

        out = target
        totals = dict(pairs_emitted=0, pairs_shipped=0, shuffle_payload_bytes=0,
                      intra_bytes=0, inter_bytes=0, compiles=0, cache_hits=0, retries=0)
        last = None
        for _b, bv in prefetch_iter(produce, range(source.n_blocks)):
            if bv.ready is not None:
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(bv.ready)
                bv.data.record_stream(cur)  # made on the copy stream, read here
                bv.base.record_stream(cur)
            if isinstance(target, C.DistHashMap):
                out, st = self._dispatch_supervised(
                    lambda bv=bv, out=out: _mr._map_reduce_hash(
                        "chunked", bv, mapper, red, out, mesh, node.engine,
                        shuffle_slack, env, key_range=key_range, cache=self._exec_cache,
                        node=node, tuned=node.tuned),
                    node, mesh)
            else:
                out, st = self._dispatch_supervised(
                    lambda bv=bv, out=out: _mr._map_reduce_dense(
                        "chunked", bv, mapper, red, out, mesh, node.engine,
                        wire, env, return_stats, cache=self._exec_cache, node=node,
                        tuned=node.tuned, hier=node.hier),
                    node, mesh)
            for k in totals:
                totals[k] = totals[k] + getattr(st, k)
            last = st
        return out, dataclasses.replace(last, dispatches=source.n_blocks, **totals)

    # -- supervised dispatch (fault recovery) ---------------------------------

    def supervised(self, attempt: Callable, *, program=None, degrade=None,
                   mesh: C.Mesh | None = None):
        """Run one dispatch ``attempt()`` under the session's retry policy.

        * ``faults.FatalFault``: recorded and raised at once;
        * an injected ``kernel.*`` fault: when ``degrade()`` (``program``:
          ``program.degrade``, which drops its plans and CUDA graphs and
          keeps its carry) degrades at least one kernel node to eager, the
          dispatch runs again; every fault point fires before anything runs,
          so the retry runs the same block on the same carry;
        * any other ``faults.TransientFault``: run again up to
          ``retry.attempts`` times with exponential backoff, within
          ``retry.deadline_s``; exhaustion records the fault fatal and
          raises;
        * a real error propagates.  The reference also degrades on any real
          error while a kernel node is live; here a kernel that fails to
          build, launch or capture must fail the call, not be replaced by
          the plain engine unseen (and a sticky CUDA error poisons the
          context for any retry).

        Every injected fault is recorded under exactly one disposition, so
        ``faults.snapshot()["balanced"]`` holds across any schedule.  On a
        process mesh (``mesh``, the program's, or the session's) every rank
        arms the same schedule, so every rank takes the same fault; the
        number of nodes a degradation changed is compared across the ranks,
        and a dispatch whose ranks would degrade differently raises rather
        than run diverged programs.
        """
        policy = self.retry
        if policy is None:
            return attempt()
        if program is not None:
            degrade = program.degrade
            mesh = program._mesh
        mesh = mesh or self.mesh

        def degraded() -> bool:
            n = degrade()
            if not all_ranks_equal(mesh, n):
                raise RuntimeError(
                    f"rank {mesh.rank} degraded {n} kernel nodes after an injected "
                    "kernel fault and another rank did not: the ranks' fault "
                    "schedules differ")
            return n > 0

        t0 = time.monotonic()
        delay = policy.backoff_s
        tries = 0
        while True:
            try:
                return attempt()
            except faults.FatalFault as e:
                faults.record("fatal", e)
                raise
            except faults.TransientFault as e:
                if e.point.startswith("kernel.") and degrade is not None and degraded():
                    faults.record("degraded", e)
                    self.stats.degraded_nodes += 1
                    continue
                tries += 1
                deadline_hit = (policy.deadline_s is not None
                                and time.monotonic() - t0 + delay > policy.deadline_s)
                if tries >= policy.attempts or deadline_hit:
                    faults.record("fatal", e)
                    raise
                faults.record("retried", e)
                self.stats.retries += 1
                if delay > 0:
                    time.sleep(delay)
                delay *= policy.multiplier

    def _degrade_op_node(self, node) -> int:
        """Degrade a per-op kernel node to eager (returns 1; 0 for a node
        that runs no kernel): its tune_key joins ``_degraded`` (every later
        build of the op is born eager), the faulted stage's cache entry is
        dropped, and the eager stage caches under the node's new signature,
        so nothing else in the cache moves."""
        if node.engine != "pallas":
            return 0
        self._degraded.add(node.tune_key)
        if node.cache_sig is not None:
            self._exec_cache.pop(node.cache_sig, None)
        plan_mod.degrade_node(node)
        return 1

    def _dispatch_supervised(self, dispatch: Callable, node, mesh: C.Mesh | None = None):
        """:meth:`supervised` for one per-op node: a kernel fault degrades
        just this node, and the returned ``MapReduceStats`` carries the
        recovery (``degraded_engine``, ``retries``)."""
        retries0 = self.stats.retries
        out, stats = self.supervised(dispatch, degrade=lambda: self._degrade_op_node(node),
                                     mesh=mesh)
        retries = self.stats.retries - retries0
        if retries or node.degraded_from is not None:
            stats = dataclasses.replace(stats, retries=retries,
                                        degraded_engine=node.degraded_from)
        return out, stats

    def _maybe_escalate(self, out, stats, target, red, node, dispatch, mesh):
        """Hash-overflow recovery (``escalate_overflow=True``): when the op
        dropped pairs (the overflow grew), regrow the original target to the
        next capacity of the grid (``cost.next_capacity``) and run the same
        op against it; the overflowed output is dropped.  ``map_reduce``
        returns a new container and ``shard_of_key`` does not depend on
        capacity, so the re-run is exact.  At most ``max_escalations``
        rounds, counted in ``MapReduceStats.escalations`` and
        ``stats.escalations``.  The overflow lives on the device: each check
        is one host sync, counted in ``stats.host_syncs``; on a process
        mesh it is the mesh's overflow, gathered, so every rank regrows
        alike."""
        if self.retry is None or not self.escalate_overflow:
            return out, stats

        def grew(new, old) -> bool:
            self.stats.host_syncs += 1
            return new.total_overflow() > old.total_overflow()

        escal = 0
        cur = target
        while escal < self.max_escalations and grew(out, cur):
            cap = cost_mod.next_capacity(cur.capacity_per_shard)
            if cap is None:
                break
            cur = self._grow_hash_target(cur, cap, red, mesh)
            escal += 1
            out, st = self._dispatch_supervised(lambda tgt=cur: dispatch(tgt), node, mesh)
            stats = dataclasses.replace(
                st, escalations=escal, compiles=stats.compiles + st.compiles,
                cache_hits=stats.cache_hits + st.cache_hits,
                dispatches=stats.dispatches + st.dispatches,
                retries=stats.retries + st.retries,
            )
        self.stats.escalations += escal
        return out, stats

    def _grow_hash_target(self, target: C.DistHashMap, new_cap: int, red,
                          mesh: C.Mesh | None = None) -> C.DistHashMap:
        """``target`` rebuilt with ``new_cap`` slots a shard, every live entry
        inserted again on its own shard (``shard_of_key`` does not depend on
        capacity), each shard's overflow counter carried over so the
        caller sees only new drops (this process's shards on a process
        mesh)."""
        t = target.table
        grown = self.make_dist_hashmap(new_cap, tuple(t.vals.shape[2:]), t.vals.dtype, red,
                                       mesh=mesh)
        g = grown.table
        keys, vals, ovf = [], [], []
        for s in range(target.n_shards):
            ins = C.hashmap_insert(C.HashTable(g.keys[s], g.vals[s], g.overflow[s]),
                                   t.keys[s], t.vals[s], t.keys[s] != C.EMPTY_KEY, red,
                                   max_probes=64)
            keys.append(ins.keys)
            vals.append(ins.vals)
            ovf.append(ins.overflow + t.overflow[s])
        return C.DistHashMap(C.HashTable(torch.stack(keys), torch.stack(vals),
                                         torch.stack(ovf)), reducer_name=red.name,
                             mesh=grown.mesh)

    # -- measured autotuning (tune=True) -------------------------------------

    @staticmethod
    def _tunable(node, red: Reducer, target) -> bool:
        """Nodes the autotuner can act on: a reducer with a kernel for the
        target kind, and no ``naive`` request (a baseline, not a
        candidate)."""
        kernel = red.pallas_hash if isinstance(target, C.DistHashMap) else red.pallas_segment
        return kernel is not None and node.engine_requested != "naive"

    @staticmethod
    def _candidates_for(red: Reducer, target, key_range):
        """The measurement grid of one node (``cost``)."""
        if isinstance(target, C.DistHashMap):
            vals = target.table.vals
            v = int(np.prod(vals.shape[2:])) if vals.dim() > 2 else 1
            return cost_mod.hash_tuning_candidates(v, red.name, vals.dtype,
                                                   key_range=key_range)
        k = target.shape[0] if target.dim() else 0
        v = int(np.prod(target.shape[1:])) if target.dim() > 1 else 1
        return cost_mod.dense_tuning_candidates(k, v, red.name, target.dtype)

    def _tune_map_reduce(self, kind, source, mapper, red, target, mesh, wire, env,
                         shuffle_slack, key_range, node):
        """Time ``node``'s candidates and cache the fastest under its
        ``tune_key``.

        Each candidate runs twice through the engine's entry points: once to
        build its stage and warm up, once timed, the device synchronised
        before and after.  ``map_reduce`` merges into a new result, so the
        outputs are dropped.  Each candidate hits ``tuning.measure`` first; a
        candidate that takes an injected fault is skipped and the fault
        recorded ``absorbed`` (tuning is an optimisation, nothing retries
        it); a real error raises.  Every timing is appended to ``tune_log``.
        On a process mesh every rank takes rank 0's winner (the ranks' wall
        times differ).
        """
        hash_target = isinstance(target, C.DistHashMap)
        best_cfg, best_wall, best_j = None, float("inf"), -1
        walls = {}
        for j, cfg in enumerate(self._candidates_for(red, target, key_range)):
            tuned = cfg if cfg.engine == "pallas" else None

            def run():
                if hash_target:
                    return _mr._map_reduce_hash(
                        kind, source, mapper, red, target, mesh, cfg.engine,
                        shuffle_slack, env, key_range=key_range,
                        cache=self._exec_cache, tuned=tuned)
                return _mr._map_reduce_dense(
                    kind, source, mapper, red, target, mesh, cfg.engine, wire, env,
                    False, cache=self._exec_cache, tuned=tuned, hier=node.hier)

            try:
                faults.fault_point("tuning.measure")
                _, st = run()  # builds the stage, warms up
                _sync(mesh.device)
                t0 = time.perf_counter()
                _, st2 = run()
                _sync(mesh.device)
                wall = time.perf_counter() - t0
            except faults.InjectedFault as e:
                faults.record("absorbed", e)
                continue
            self.stats.compiles += st.compiles + st2.compiles
            self.stats.cache_hits += st.cache_hits + st2.cache_hits
            self._record_measurement(node.tune_key, cfg.describe(), wall)
            walls[j] = (cfg, wall)
            if wall < best_wall:
                best_cfg, best_wall, best_j = cfg, wall, j
        best_cfg, best_wall = walls.get(_agree(mesh, best_j), (None, None))
        if best_cfg is not None:
            self.tuning.put(node.tune_key,
                            dataclasses.replace(best_cfg, source="measured", wall_s=best_wall))

    def _record_measurement(self, key: str, config: str, wall: float) -> None:
        """Count one timing (a candidate, or a program variant pinning one
        candidate a node) and log it."""
        self.tuning.record_measurements(1)
        self.stats.tune_measurements += 1
        self.tune_log.append({"tune_key": key, "config": config, "wall_s": wall})

    def save_tuning(self, path: str | None = None) -> str:
        """Persist the tuning cache (JSON, atomic); defaults to the session's
        ``tuning_path``."""
        path = path or self._tuning_path
        if not path:
            raise ValueError("no path given and the session has no tuning_path")
        self.tuning.save(path)
        return path

    def load_tuning(self, path: str | None = None) -> int:
        """Merge a saved tuning cache into this session; returns the entries
        loaded."""
        path = path or self._tuning_path
        if not path:
            raise ValueError("no path given and the session has no tuning_path")
        return self.tuning.load(path)

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
             env: Any = None, mesh: C.Mesh | None = None) -> np.ndarray:
        """Session-scoped ``topk`` over the mesh's shards: selects on the
        device, then materialises the ``k·n_shards`` candidates on the host,
        a blocking sync counted in ``stats.host_syncs`` (gathered from every
        rank of a process mesh)."""
        self.stats.host_syncs += 1
        mesh = mesh or self.mesh
        return C.topk(v, k, score_fn=score_fn, env=env, n_shards=mesh.n_shards, mesh=mesh)

    def distribute(self, x, mesh: C.Mesh | None = None) -> C.DistVector:
        """``distribute`` onto the mesh's device and shards (the session's
        by default); on a process mesh every rank passes the whole array
        and keeps its own shards' rows."""
        return C.distribute(x, mesh=mesh or self.mesh)

    def chunked(self, x, block_rows: int, mesh: C.Mesh | None = None,
                **kwargs) -> C.ChunkedDistVector:
        """``distribute`` for datasets that do not fit on the device: a host
        array as out-of-core blocks for the mesh's device and shards
        (``compress=``, ``spill_dir=``, ``max_resident=`` shape the byte
        provider, per rank on a process mesh).  On a process mesh every
        rank passes the whole array and keeps its own shards' rows of each
        block (``containers.ChunkedDistVector``)."""
        return C.chunked(x, block_rows, mesh=mesh or self.mesh, **kwargs)

    def make_dist_hashmap(self, capacity_per_shard: int, val_shape: tuple = (),
                          val_dtype: torch.dtype = torch.float32,
                          reducer: str | Reducer = "sum",
                          mesh: C.Mesh | None = None) -> C.DistHashMap:
        """``make_dist_hashmap`` on the mesh's device and shards (this
        process's shards on a process mesh)."""
        return C.make_dist_hashmap(capacity_per_shard, val_shape, val_dtype, reducer,
                                   mesh=mesh or self.mesh)

    # -- fused iteration programs (see repro_torch.core.program) -------------

    def program(self, step_fn: Callable, *, mesh: C.Mesh | None = None, passes=None,
                tune: bool = False, hierarchical: bool = True):
        """Plan ``step_fn(ctx, state) -> state``, a whole iteration of
        MapReduce ops plus elementwise glue, as one program.

        ``ctx`` mirrors the session API (``ctx.map_reduce``, ``ctx.foreach``,
        ``ctx.topk``); iteration-varying values go through ``state``.
        Discovery builds the logical plan and runs the passes (per-node
        engines, collective batching, CSE, dead-source pruning);
        ``passes=()`` switches off the optional three.  Run it with
        ``program(state, n_iters)`` or :meth:`run_loop` (:meth:`run_stream`
        when it reads chunked sources); render the plan with
        :meth:`explain`.  On the card a dispatch is one CUDA graph replay.
        ``tune=True``: on the first build, tunable nodes without a winner
        are measured once (``Program._maybe_tune``) and the winners cached
        in ``session.tuning``.  ``mesh`` overrides the session's mesh; on a
        multi-node mesh ``hierarchical=False`` keeps the collectives flat (a
        no-op on a 1-node mesh).
        """
        from repro_torch.core.program import Program

        return Program(self, step_fn, mesh=mesh or self.mesh, passes=passes, tune=tune,
                       hierarchical=hierarchical)

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
        a buffer the next replay overwrites.

        ``checkpoint=`` (a ``CheckpointManager`` or a directory) with
        ``checkpoint_every=k`` saves the state, the program's carry and the
        iteration every ``k`` iterations at dispatch boundaries;
        ``resume=True`` restores the latest checkpoint first and goes on from
        its iteration (``LoopInfo.resumed_from``).  The carry is restored
        into the program's own buffers, which its graphs read.  Dispatches
        run supervised (:meth:`supervised`).
        """
        from repro_torch.core.program import LoopInfo, _as_checkpoint_manager

        if unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {unroll}")
        manager = _as_checkpoint_manager(checkpoint)
        if resume and manager is None:
            raise ValueError("resume=True needs checkpoint=")
        compiles0 = program.stats.compiles
        it = dispatches = host_syncs = 0
        resumed_from = None
        if resume:
            state, pos = program.restore_checkpoint(manager, state)
            if pos is not None:
                resumed_from = it = pos
        start_it = last_saved = it
        converged = False
        while it < max_iters:
            u = min(unroll, max_iters - it)
            state = self.supervised(lambda state=state, u=u: program(state, u),
                                    program=program)
            dispatches += 1
            it += u
            if manager is not None and checkpoint_every and it - last_saved >= checkpoint_every:
                program.save_checkpoint(manager, state, it)
                last_saved = it
            if cond is not None:
                self.stats.host_syncs += 1
                host_syncs += 1
                if bool(cond(state)):
                    converged = True
                    break
        return state, LoopInfo(
            iterations=it - start_it, dispatches=dispatches, host_syncs=host_syncs,
            converged=converged, compiles=program.stats.compiles - compiles0,
            resumed_from=resumed_from,
        )

    def run_stream(self, program, state, *, cond: Callable | None = None,
                   max_epochs: int = 1, prefetch: bool = True, depth: int = 2,
                   checkpoint=None, checkpoint_every: int | None = None,
                   resume: bool = False):
        """Drive a ``Program`` over its chunked (out-of-core) sources: each
        epoch replays the program's one graph once a block, block k+1's copy
        overlapping block k's replay, and ``cond(state)`` runs once an epoch.
        ``checkpoint=`` / ``checkpoint_every=`` / ``resume=`` work as in
        :meth:`run_loop`, at epoch granularity.  Returns ``(state,
        StreamInfo)``; see ``Program.run_stream``."""
        return program.run_stream(
            state, max_epochs=max_epochs, cond=cond, prefetch=prefetch, depth=depth,
            checkpoint=checkpoint, checkpoint_every=checkpoint_every, resume=resume)

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
            "program_compiles": self.stats.program_compiles,
            "program_dispatches": self.stats.program_dispatches,
            "tune_measurements": self.stats.tune_measurements,
            "retries": self.stats.retries,
            "degraded_nodes": self.stats.degraded_nodes,
            "escalations": self.stats.escalations,
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


def resolve(session: BlazeSession | None,
            mesh: C.Mesh | None = None) -> tuple[BlazeSession, C.Mesh]:
    """``(session or the default one, mesh or the session's)`` — the driver
    entry idiom."""
    sess = session if session is not None else get_default_session()
    return sess, (mesh or sess.mesh)
