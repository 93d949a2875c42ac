"""Fused iteration programs: a whole iteration planned once and replayed.

The counterpart of ``repro/core/program.py``.  A driver written as per-op
``map_reduce`` calls pays, per iteration, one dispatch per op plus a host
sync for its convergence test; BSP supersteps (Pace, arXiv:1203.2081) are
the classical fix: batch the whole superstep, synchronise once.  Here:

* **Discovery builds a ``Plan``.**  ``step_fn(ctx, state)`` runs once with a
  recording :class:`ProgramContext`, eagerly on the program's device on
  clones of the state and carry (its results are thrown away).  PyTorch's
  counterpart of ``jax.eval_shape``, the ``meta`` device, cannot run a step
  function that reads tensors it captured itself (PageRank's degrees, a
  constant matrix), so discovery runs for real.  The context records every
  ``ctx.map_reduce`` / ``ctx.foreach`` / ``ctx.topk`` as a plan node, and
  the passes run as it records:

  - *resolve-engines*: each node its own engine (``plan.resolve_engine``);
  - *batch-collectives*: dense results come back as lazy
    :class:`PlanValue`s; the collective waits until the step consumes the
    value, and everything pending then with the same (reducer, wire, dtype,
    hierarchical or not) is concatenated and reduced in one collective
    (GMM's four sums a round become two);
  - *hierarchical-collectives* (a multi-node mesh): each eligible dense
    reduce takes two hops, each node's shards first at full precision
    (``plan.apply_hierarchical``; ``hierarchical=False`` plans the program
    as on a flat mesh);
  - *cse*: a node identical to an earlier one reuses its total;
  - *prune-dead-sources*: a node whose value is never consumed is dropped,
    and a source only it read is marked pruned.

* **Execution replays the plan.**  An execute-mode context runs the same
  step function against the plan: pruned nodes are skipped, CSE'd nodes
  reuse totals, pending partials flush through the recorded groups.  One
  *dispatch* runs ``u`` iterations.  On the card it is one replay of a CUDA
  graph captured once per (state signature, ``u``) after a warm-up
  iteration on a side stream; the graph reads the state from static input
  buffers and keeps the carry (int8 error-feedback residuals ``[S, ...]``
  and hash-target tables) in buffers of its own, which it updates in place,
  so a replay hands nothing back through the host; a program's graphs all
  allocate from its first graph's memory pool.  ``ProgramStats.compiles``
  counts those captures there, and plans built on the CPU, where a dispatch
  runs the same planned step eagerly ``u`` times.  A CUDA program never runs
  without a graph, and a capture that fails raises, naming the op.

Iteration-varying values live in ``state`` (a pytree of tensors whose
structure, shapes and dtypes a step keeps).  Sources (edge lists, points)
are read through the containers the step function captured.  Per-iteration
intermediates (GMM's densities) stay ``LocalVector``s from ``ctx.foreach``.
Hash targets (``DistHashMap``) are per-shard state threaded through the
iterations and across dispatches; ``Program.hash_result(hm)`` materialises
the accumulated map.

**Tuning.**  ``session.program(step, tune=True)``: on the first build of a
state signature, ``_maybe_tune`` finds the tunable nodes without a cached
winner and times throwaway variants of the program, variant ``j`` pinning
each node to its ``min(j, len - 1)``-th candidate (``cost``); each variant
is built, dispatched once (discovery, warm-up, capture, replay), then timed
over a second dispatch, a replay, and freed with its graphs and pool before
the next is built.  The fastest variant's configs go into
``session.tuning``.

**Streams.**  A step may read a ``ChunkedDistVector`` (out of core).  The
program then holds the block in a static device buffer and the block's base
offset in a device scalar, both made at discovery; the graph reads them, and
``run_stream`` writes each block and its offset into them before the replay
(a fresh tensor per block, or a Python int, would be baked into the capture).
Block k+1 is copied from pinned host memory into a staging buffer on a copy
stream while block k replays, ordered by CUDA events, with no host sync a
block.  ``run_loop`` and ``run_stream`` checkpoint the state, the carry and
the position (``save_checkpoint``), and resume (``restore_checkpoint``),
restoring into the program's own buffers.

**Faults.**  A dispatch hits the ``dispatch`` fault point, then
``kernel.segment`` / ``kernel.hash`` for each live kernel node, before any
graph is captured or replayed, so a supervised retry
(``BlazeSession.supervised``) replays the same carry.  The ``collective``
point fires at each reduce of a plan's runs after discovery until one
succeeds (on the card, its capture), never at a replay.
:meth:`Program.degrade` puts the live kernel nodes' ``tune_key``s into the
session's degraded set and drops their plans and CUDA graphs (the
supervisor calls it after an injected kernel fault only; a real error
propagates); the next dispatch rediscovers the plan with
those nodes eager and captures again, into the carry buffers, the static
input state and the stream slots the old graphs read, which it keeps (so a
checkpoint restores into them as before).  A capture that raises leaves no
graph and no stale context behind.  Captures run in ``thread_local`` error
mode: a degrade in the middle of a stream captures again while the prefetch
worker may be allocating pinned memory on its own thread, which the
default (``global``) mode would turn into a failed capture; the program's
own thread still may not make an unsafe call, and a host sync in the step
raises (the sync-debug mode).  ``run_stream`` dispatches each block
supervised; ``save_checkpoint`` retries a transient ``checkpoint.write``
fault.

Across processes (a mesh that carries a ``torch.distributed`` group): every
rank runs the same program on its ``n_local`` shards; the carry's residuals
are this rank's rows ``[n_local, ...]``, its hash tables this rank's tables.
On the card the collectives are NCCL operations captured inside the graph: the
warm-up iteration runs them first, which brings the communicator up before
the capture, and their output buffers come from the graph's pool like any
other.  A capture NCCL refuses raises as any failed capture does, naming
the op; nothing falls back to eager.  Tuning takes rank 0's winner (the
ranks' wall times differ).  A chunked source's stream slot holds the
rank's rows of a block, its ``base`` their first global index, and every
rank replays every block; a checkpoint holds each rank's rows of the carry
beside rank 0's state (``checkpoint_ranks``).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Any, Callable

import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from repro_torch.core import containers as C
from repro_torch.core import faults
from repro_torch.core import mapreduce as _mr
from repro_torch.core import plan as plan_mod
from repro_torch.core.collectives import LocalCollectives, agree, all_ranks_equal
from repro_torch.core.plan import (
    DEFAULT_PASSES,
    ContainerOpNode,
    ForeachNode,
    GlueNode,
    MapReduceNode,
    Plan,
    SourceInfo,
)
from repro_torch.core.reducers import _BUILTIN, get_reducer
from repro_torch.core.session import _cuda_index, _sync

__all__ = [
    "LocalHashMap",
    "LocalVector",
    "LoopInfo",
    "PlanValue",
    "Program",
    "ProgramContext",
    "ProgramStats",
    "StreamInfo",
]


@dataclasses.dataclass
class LocalVector:
    """A shard-local vector inside a program (``ctx.foreach`` output):
    ``data`` holds every shard's rows, stacked as a ``DistVector``'s are;
    ``n`` is the true length.  A source for later ops of the same program;
    it never leaves the program."""

    data: torch.Tensor
    n: int


@dataclasses.dataclass
class LocalHashMap:
    """The shards' tables of a hash target inside a program, returned by
    ``ctx.map_reduce`` on a ``DistHashMap``: readable as a source by later
    ops of the same iteration."""

    table: C.HashTable
    reducer_name: str


@dataclasses.dataclass
class ProgramStats:
    """Per-program counters (mirrored cumulatively on ``SessionStats``)."""

    compiles: int = 0  # plans built (CPU) or CUDA graphs captured (card)
    dispatches: int = 0  # blocks run
    iterations: int = 0  # iterations run across all dispatches
    captures: int = 0  # CUDA graphs captured
    replays: int = 0  # CUDA graph replays (one a dispatch on the card)
    # kernel (and "kernel/form") -> launches the replays ran: each graph's
    # launches recorded at capture, counted once a replay
    replay_launches: dict = dataclasses.field(default_factory=dict)
    # iterations a replay -> that graph's launches a replay, by kernel
    captured_launches: dict = dataclasses.field(default_factory=dict)
    pool_peak_bytes: int = 0  # largest device memory peak over a capture
    pool_reserved_bytes: int = 0  # device memory the captures reserved, all graphs
    degradations: int = 0  # degrade() calls that degraded a node
    graphs_dropped: int = 0  # CUDA graphs degrade() dropped


@dataclasses.dataclass
class LoopInfo:
    """What one ``run_loop`` cost: the assertable fusion contract."""

    iterations: int  # iterations run
    dispatches: int  # blocks run (<= ceil(iterations / unroll))
    host_syncs: int  # cond evaluations
    converged: bool  # cond() went True before max_iters
    compiles: int  # compiles during this loop (see ProgramStats.compiles)
    resumed_from: int | None = None  # checkpointed iteration restored, if any


@dataclasses.dataclass
class StreamInfo:
    """What one ``run_stream`` cost: the out-of-core contract.  ``compiles``
    is at most 1 whatever the block count: every block replays one graph."""

    epochs: int  # full passes over the chunked sources (resumed ones included)
    n_blocks: int  # blocks an epoch
    dispatches: int  # block dispatches in this call
    host_syncs: int  # cond evaluations (one an epoch)
    converged: bool  # cond() went True before max_epochs
    compiles: int  # compiles during this stream (0 or 1)
    prefetch: bool  # block k+1 decoded and copied while block k ran
    bytes_streamed: int  # host-to-device block bytes moved in this call
    resumed_from: int | None = None  # checkpointed epoch restored, if any


def _source_key(kind: str, source) -> tuple:
    """Identity of a source across discovery and execution: a ``DistRange``
    by value, a container by the identity of its backing tensors, a chunked
    vector (host blocks, no device tensor of its own) by its own."""
    if kind == "range":
        return ("range", source.start, source.stop, source.step)
    if kind == "vector":
        return ("vector", id(source.data), source.n)
    if kind == "chunked":
        return ("chunked", id(source), source.n)
    return ("hashmap", id(source.table.keys), id(source.table.vals))


class _StreamSlot:
    """A chunked source's device side in one program: ``buf``, the static
    block buffer, and ``base``, the block's row offset as a device int32
    scalar.  Captured graphs bake both addresses in, so every block is
    copied into ``buf`` and its offset written into ``base`` before the
    replay.  On the card, ``staging`` (one more block) takes block k+1's
    copy from pinned host memory on ``copy`` while block k replays:
    ``landed`` marks that copy's end, ``drained`` the device-to-device copy
    out of ``staging`` into ``buf`` (after which ``staging`` may be
    refilled)."""

    def __init__(self, source, device: torch.device):
        self.source = source
        self.buf = torch.zeros((source.local_rows,) + source.shape_tail,
                               dtype=source.dtype, device=device)
        self.base = torch.zeros((), dtype=torch.int32, device=device)
        self.staging = self.copy = self.landed = self.drained = None

    def stage(self, host: torch.Tensor) -> None:
        """Start copying ``host`` (pinned) into ``staging`` on the copy
        stream, after the previous block has left it."""
        if self.staging is None:
            self.staging = torch.empty_like(self.buf)
            self.copy = torch.cuda.Stream(self.buf.device)
            self.landed, self.drained = torch.cuda.Event(), torch.cuda.Event()
            self.drained.record(torch.cuda.current_stream(self.buf.device))
        self.copy.wait_event(self.drained)
        with torch.cuda.stream(self.copy):
            self.staging.copy_(host, non_blocking=True)
        self.landed.record(self.copy)

    def install(self, b: int, host: torch.Tensor | None) -> None:
        """Make block ``b`` the resident one, on the current stream: from
        ``staging`` once its copy has landed (``host`` None), or straight
        from ``host``."""
        if host is None:
            cur = torch.cuda.current_stream(self.buf.device)
            cur.wait_event(self.landed)
            self.buf.copy_(self.staging)
            self.drained.record(cur)
        else:
            self.buf.copy_(host)
        self.base.fill_(self.source.block_base(b))


def _force_tree(tree):
    return pytree.tree_map(
        lambda x: x._force() if isinstance(x, PlanValue) else x, tree
    )


class PlanValue:
    """A lazy dense MapReduce result inside a program.

    ``ctx.map_reduce`` returns one for batchable dense ops: the shards'
    partials are computed, but the collective waits until the step function
    consumes the value, when every pending partial with the same (reducer,
    wire, dtype) ships in one concatenated collective.  Any torch function
    (``__torch_function__``), operator or attribute consumes it; ``[...]`` is
    itself lazy, so ``ctx.map_reduce(...)[0]`` does not flush early.  A value
    never consumed marks its op dead.
    """

    __slots__ = ("_ctx", "_idx", "_post")

    def __init__(self, ctx, idx: int, post: tuple = ()):
        self._ctx = ctx
        self._idx = idx
        self._post = post

    def _force(self) -> torch.Tensor:
        base = self._ctx._materialise(self._idx)
        for f in self._post:
            base = f(base)
        return base

    def __getitem__(self, item) -> "PlanValue":
        return PlanValue(self._ctx, self._idx,
                         self._post + ((lambda a, it=item: a[it]),))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_force_tree(args), **_force_tree(kwargs or {}))

    def __getattr__(self, name):
        return getattr(self._force(), name)

    def _bin(self, other, op, reverse=False):
        a = self._force()
        b = other._force() if isinstance(other, PlanValue) else other
        return op(b, a) if reverse else op(a, b)

    def __add__(self, o):
        return self._bin(o, torch.add)

    def __radd__(self, o):
        return self._bin(o, torch.add, reverse=True)

    def __sub__(self, o):
        return self._bin(o, torch.sub)

    def __rsub__(self, o):
        return self._bin(o, torch.sub, reverse=True)

    def __mul__(self, o):
        return self._bin(o, torch.mul)

    def __rmul__(self, o):
        return self._bin(o, torch.mul, reverse=True)

    def __truediv__(self, o):
        return self._bin(o, torch.true_divide)

    def __rtruediv__(self, o):
        return self._bin(o, torch.true_divide, reverse=True)

    def __pow__(self, o):
        return self._bin(o, torch.pow)

    def __neg__(self):
        return -self._force()

    def __lt__(self, o):
        return self._bin(o, torch.lt)

    def __le__(self, o):
        return self._bin(o, torch.le)

    def __gt__(self, o):
        return self._bin(o, torch.gt)

    def __ge__(self, o):
        return self._bin(o, torch.ge)

    # == / != are elementwise like every other comparison: identity
    # semantics would silently give False for `result == 0`.
    def __eq__(self, o):
        return self._bin(o, torch.eq)

    def __ne__(self, o):
        return self._bin(o, torch.ne)

    __hash__ = object.__hash__


class _CountingCollectives:
    """Counts collective launches on the discovery run — what
    ``Plan.collectives_per_iter`` reports (a batched flush counts once)."""

    def __init__(self, inner: LocalCollectives):
        self._inner = inner
        self.n_shards = inner.n_shards
        self.n_local = inner.n_local
        self.first_shard = inner.first_shard
        self.device = inner.device
        self.count = 0

    def axis_index(self):
        return self._inner.axis_index()

    def all_gather_tiled(self, x):
        self.count += 1
        return self._inner.all_gather_tiled(x)

    def all_to_all_tiled(self, x):
        self.count += 1
        return self._inner.all_to_all_tiled(x)

    def reduce(self, partial, red, wire="none", hier=False):
        self.count += 1
        return self._inner.reduce(partial, red, wire, hier=hier)

    def reduce_feedback(self, partial, red, wire, residual, hier=False):
        self.count += 1
        return self._inner.reduce_feedback(partial, red, wire, residual, hier=hier)


class ProgramContext:
    """What ``step_fn`` sees: session-API lookalikes that compose inside a
    program (``ctx.map_reduce``, ``ctx.foreach``, ``ctx.topk``), so the same
    user code reads alike in per-op and program form.

    ``"discover"`` builds the logical plan (nodes, sources, batch groups,
    CSE aliases, dead ops) while it runs; ``"execute"`` runs a finished
    plan: it skips pruned nodes, reuses CSE'd totals and flushes the same
    batched collectives.  The collectives span the whole ``mesh``; whether
    a reduce takes the two hops is the node's ``hier`` flag, which
    discovery sets when ``n_nodes > 1`` (the plan's node rows: 1 for a flat
    build on any mesh).
    """

    def __init__(self, mesh: C.Mesh, mode: str, residuals=None,
                 hash_tables=None, plan: Plan | None = None,
                 passes: tuple = DEFAULT_PASSES, tuning=None, overrides=None,
                 streams: dict | None = None, degraded: set | None = None,
                 fire: bool = False, n_nodes: int = 1, hierarchical: bool = True):
        self._n_shards = mesh.n_shards
        self._n_local = mesh.n_local  # this process's shards (all, in process)
        self._mesh = mesh
        self._device = mesh.device
        self._n_nodes = n_nodes
        self._hierarchical = hierarchical
        self._mode = mode  # "discover" | "execute"
        # Discover-mode tuning hooks: ``tuning`` is the session's cache
        # (cached winners apply to every node built), ``overrides`` maps
        # tune_key -> the candidate a measurement variant pins.
        self._tuning = tuning
        self._degraded = degraded  # the session's kernel-faulted tune_keys
        self._overrides = overrides or {}
        self._tune_info: dict[int, tuple] = {}  # idx -> candidate-grid parameters
        # chunked-source key -> _StreamSlot, the program's (shared by every
        # context of it, so the graphs read one buffer)
        self._streams = streams if streams is not None else {}
        # ``fire``: this run stands for the reference's trace, so its reduces
        # hit the ``collective`` fault point (never discovery's).
        coll = _mr.make_collectives(mesh, fire=fire and mode == "execute")
        self._coll = _CountingCollectives(coll) if mode == "discover" else coll
        self._plan = plan
        self._passes = tuple(passes)
        self._batch = "batch-collectives" in self._passes
        self._cse = "cse" in self._passes
        self._prune = "prune-dead-sources" in self._passes
        # -- discover-mode plan-building state --------------------------------
        self._nodes: list = []
        self._sources: dict[tuple, Any] = {}  # key -> source, in call order
        self._local_producers: dict[int, int] = {}  # id(tensor) -> node idx
        self._keep: list = []  # tensors whose id() keys the dicts above
        self._cse_index: dict[tuple, int] = {}
        self._groups: dict[int, list[int]] = {}
        self._group_keys: dict[int, tuple] = {}
        self._hash_targets: dict[tuple, Any] = {}
        # -- shared runtime state ---------------------------------------------
        self._call_i = 0  # ctx-op call counter (node index)
        self._pending: list[int] = []  # deferred ops awaiting their collective
        self._partials: dict[int, tuple] = {}  # idx -> (partial, red, wire, hier)
        self._totals: dict[int, torch.Tensor] = {}  # idx -> reduced total
        self._results: dict[int, torch.Tensor] = {}  # idx -> merged result
        self._meta: dict[int, tuple] = {}  # idx -> (red, target) for the merge
        self._residuals = residuals if residuals is not None else []
        self._res_i = 0
        self._hash_tables: dict[tuple, C.HashTable] = (
            hash_tables if hash_tables is not None else {}
        )
        self.last_op = "the first op"  # named when a capture fails

    # -- source resolution ----------------------------------------------------

    def _resolve_program_source(self, source):
        """(kind, source, local view, src desc, source key) for any source:
        the session containers and the program-local intermediates."""
        if isinstance(source, LocalVector):
            prod = self._local_producers.get(id(source.data), "?")
            return "vector", None, (source.data, source.n), f"local[{prod}]", None
        if isinstance(source, LocalHashMap):
            prod = self._local_producers.get(id(source.table.keys), "?")
            return ("hashmap", None, (source.table.keys, source.table.vals),
                    f"local[{prod}]", None)
        kind = _mr.source_kind(source)
        _mr._require_rank_rows(self._mesh, kind, source)
        key = _source_key(kind, source)
        if self._mode == "discover":
            self._sources.setdefault(key, source)
        if kind == "chunked":
            # The resident block, through the program's static buffer and
            # base scalar (their addresses are what a captured graph reads).
            if not isinstance(source, C.ChunkedDistVector):
                raise TypeError("a program reads a ChunkedDistVector, not a BlockView")
            slot = self._streams.get(key)
            if slot is None:
                if self._mode != "discover":
                    raise ValueError("chunked source not registered during discovery")
                slot = self._streams[key] = _StreamSlot(source, self._device)
            return (kind, source, (slot.buf, source.n, slot.base),
                    plan_mod.source_desc(kind, source), key)
        return (kind, source, _mr._local_view(kind, source),
                plan_mod.source_desc(kind, source), key)

    def _resolve_vector_source(self, v, what: str):
        """(data, n, src desc, source key) for ``foreach`` and ``topk``."""
        if isinstance(v, LocalVector):
            prod = self._local_producers.get(id(v.data), "?")
            return v.data, v.n, f"local[{prod}]", None
        if isinstance(v, C.DistVector):
            C.require_rank_rows(self._mesh, v, f"{what}'s vector")
            key = _source_key("vector", v)
            if self._mode == "discover":
                self._sources.setdefault(key, v)
            return v.data, v.n, plan_mod.source_desc("vector", v), key
        raise TypeError(f"{what} needs a DistVector or LocalVector, got {type(v)}")

    def _produced(self, t: torch.Tensor, idx: int) -> None:
        if self._mode == "discover":
            self._local_producers[id(t)] = idx
            self._keep.append(t)

    # -- plan-node bookkeeping -------------------------------------------------

    def _next_node(self, expect_type):
        """Execute mode: the plan node matching this ctx call."""
        idx = self._call_i
        self._call_i += 1
        node = self._plan.nodes[idx]
        if not isinstance(node, expect_type):
            raise RuntimeError(
                f"program run diverged from its plan at node {idx}: expected "
                f"{expect_type.__name__}, found {type(node).__name__}"
            )
        self.last_op = f"[{idx}] {node.stable_desc()}"
        return idx, node

    def _node_at(self, idx: int):
        nodes = self._plan.nodes if self._plan is not None else self._nodes
        return nodes[idx] if idx < len(nodes) else None

    def _cse_key(self, kind, source_key, local, mapper, red, target, engine,
                 wire, key_range, env):
        """Identity of a node's reduced total, the part CSE can share (the
        target merge runs per node, so two ops differing only in their
        targets still dedupe).  Tensors count by identity: the same state
        leaf or ``foreach`` output keys equal, anything recomputed does
        not."""
        if source_key is not None:
            src_ident = source_key
        else:
            src_ident = ("local",) + tuple(id(x) for x in local)
        env_ids = tuple(id(x) for x in pytree.tree_leaves(env))
        return (kind, src_ident, mapper, id(red), engine, wire, key_range,
                tuple(target.shape), str(target.dtype), env_ids)

    def _build_node(self, kind, src_desc, source_key, mapper, red, target, engine,
                    wire, key_range, env) -> MapReduceNode:
        """Discover mode: the next plan node, with the session's cached
        winner or this variant's override applied."""
        node = plan_mod.build_mapreduce_node(
            idx=self._call_i, kind=kind, src=src_desc, source_key=source_key,
            mapper=mapper, red=red, target=target, engine=engine, wire=wire,
            key_range=key_range, env=env, tuning=self._tuning, degraded=self._degraded,
            n_nodes=self._n_nodes, hierarchical=self._hierarchical,
        )
        ov = self._overrides.get(node.tune_key)
        if ov is not None and node.degraded_from is None:
            plan_mod.apply_tuned(node, red, ov)
        self._call_i += 1
        self._nodes.append(node)
        self.last_op = f"[{node.idx}] {node.stable_desc()}"
        return node

    # -- deferred collectives (the batch-collectives pass) ---------------------

    def _total_of(self, idx: int) -> torch.Tensor:
        if idx in self._totals:
            return self._totals[idx]
        node = self._node_at(idx)
        if isinstance(node, MapReduceNode) and node.cse_of is not None:
            return self._total_of(node.cse_of)
        if idx in self._pending:
            # Consumed mid-step: flush everything pending, so independent
            # reductions in flight batch into one collective per key.
            self._flush()
            return self._totals[idx]
        raise RuntimeError(f"plan node {idx} has no result to materialise")

    def _materialise(self, idx: int) -> torch.Tensor:
        if idx in self._results:
            return self._results[idx]
        node = self._node_at(idx)
        if isinstance(node, MapReduceNode) and node.dead and self._mode == "execute":
            raise RuntimeError(
                f"plan node {idx} was pruned as dead but its result was "
                "consumed: the run diverged from discovery"
            )
        red, target = self._meta[idx]
        out = red.combine(target, self._total_of(idx).to(target.dtype))
        self._results[idx] = out
        return out

    def _flush(self, needed: set | None = None):
        idxs = [i for i in self._pending if needed is None or i in needed]
        if not idxs:
            return
        self._pending = [i for i in self._pending if i not in set(idxs)]
        by_key: dict[tuple, list[int]] = {}
        for i in idxs:
            partial, red, wire, hier = self._partials[i]
            key = (red.name, wire, plan_mod.dtype_name(partial.dtype), hier)
            by_key.setdefault(key, []).append(i)
        for key, members in by_key.items():
            if len(members) == 1 or not self._batch:
                for i in members:
                    partial, red, wire, hier = self._partials[i]
                    self._totals[i] = self._coll.reduce(partial, red, wire, hier=hier)
                continue
            # One collective for the group: flatten each shard's partial,
            # concatenate, reduce once, split.  Exact for every built-in
            # reducer: the shard reduction (each hop of a hierarchical one
            # too) is elementwise.
            _, red, wire, hier = self._partials[members[0]]
            flats = [self._partials[i][0].reshape(self._n_local, -1) for i in members]
            total_cat = self._coll.reduce(torch.cat(flats, dim=1), red, wire, hier=hier)
            off = 0
            for i, f in zip(members, flats):
                shape = self._partials[i][0].shape[1:]
                self._totals[i] = total_cat[off:off + f.shape[1]].reshape(shape)
                off += f.shape[1]
            if self._mode == "discover":
                gid = len(self._groups)
                self._groups[gid] = list(members)
                self._group_keys[gid] = key
                for i in members:
                    self._nodes[i].group = gid

    def _finalize_state(self, out):
        """Materialise every plan value the step returns; what is still
        pending afterwards was never consumed: the op is dead."""
        needed: set[int] = set()
        for x in pytree.tree_leaves(out):
            if isinstance(x, PlanValue):
                node = self._node_at(x._idx)
                if isinstance(node, MapReduceNode) and node.cse_of is not None:
                    needed.add(node.cse_of)
                needed.add(x._idx)
        # With pruning on, flush only what the state needs (the rest is
        # dead); with it off, every op's collective still runs.
        self._flush(needed=needed if self._prune else None)
        out = _force_tree(out)
        if self._mode == "discover":
            for i in self._pending:
                self._nodes[i].dead = True
        self._pending = []
        return out

    # -- the in-program API ---------------------------------------------------

    @property
    def shard_index(self) -> torch.Tensor:
        """Every shard's index, ``[S]`` (this process's, ``[n_local]``, on
        a process mesh)."""
        return self._coll.axis_index()

    def map_reduce(self, source, mapper: Callable, reducer, target, *,
                   engine: str = "eager", wire: str = "none", env: Any = None,
                   shuffle_slack: float = 2.0, key_range: int | None = None):
        """One MapReduce op inside the program.

        Same contract as ``BlazeSession.map_reduce``, without per-op stats.
        A dense target returns the merged result as a lazy
        :class:`PlanValue`, its collective deferred and batched with its
        neighbours'.  A ``DistHashMap`` target returns a
        :class:`LocalHashMap`; its tables are per-shard state threaded
        through the iterations and across dispatches
        (``Program.hash_result``).  ``wire="int8"`` sums carry their error
        feedback residual through the iterations and across dispatches.
        Targets are made on the program's device.
        """
        red = get_reducer(reducer)
        env = _force_tree(env)
        if isinstance(target, C.DistHashMap):
            return self._map_reduce_hash(source, mapper, red, target, engine=engine,
                                         env=env, shuffle_slack=shuffle_slack,
                                         key_range=key_range)
        target = torch.as_tensor(target, device=self._device)
        if self._mode == "execute":
            # Pruned and CSE'd nodes are skipped before their source is read.
            peek = self._plan.nodes[self._call_i]
            if isinstance(peek, MapReduceNode) and (peek.dead or peek.cse_of is not None):
                idx, _ = self._next_node(MapReduceNode)
                self._meta[idx] = (red, target)
                return PlanValue(self, idx)
        kind, src_static, local, src_desc, source_key = (
            self._resolve_program_source(source)
        )
        if self._mode == "discover":
            node = self._build_node(kind, src_desc, source_key, mapper, red, target,
                                    engine, wire, key_range, env)
            self._meta[node.idx] = (red, target)
            v = math.prod(target.shape[1:]) if target.dim() > 1 else 1
            self._tune_info[node.idx] = ("dense", target.shape[0] if target.dim() else 0,
                                         v, red.name, target.dtype, None,
                                         red.pallas_segment is not None)
            if self._cse and not (wire == "int8" and red.name == "sum"):
                ck = self._cse_key(kind, source_key, local, mapper, red, target,
                                   node.engine, wire, key_range, env)
                hit = self._cse_index.get(ck)
                if hit is not None:
                    node.cse_of = hit
                    return PlanValue(self, node.idx)
                self._cse_index[ck] = node.idx
        else:
            idx, node = self._next_node(MapReduceNode)
            self._meta[idx] = (red, target)

        resolved = node.engine
        feedback = (wire == "int8" and red.name == "sum"
                    and resolved in ("eager", "pallas"))
        node.feedback = feedback
        # Deferrable (so batchable and prunable): a built-in reducer's eager
        # or kernel plan without error feedback, whose collective is one
        # elementwise reduce of the partials.
        deferrable = (resolved in ("eager", "pallas") and not feedback
                      and red is _BUILTIN.get(red.name)
                      and (self._batch or self._prune))
        stage, _ = _mr.dense_shard_stage(
            kind, src_static, mapper, red, target, resolved, wire,
            with_stats=False, feedback=feedback, collect=not deferrable,
            tuned=node.tuned, hier=node.hier,
        )
        residual = None
        if feedback:
            if self._mode == "discover":
                node.residual_spec = ((self._n_local,) + tuple(target.shape),
                                      torch.float32)
                residual = torch.zeros(node.residual_spec[0], device=self._device)
            else:
                residual = self._residuals[self._res_i]
        total, _live, _kp, new_residual = stage(env, local, self._coll, residual)
        if feedback:
            if self._mode == "execute":
                self._residuals[self._res_i] = new_residual
            self._res_i += 1
        if deferrable:
            self._partials[node.idx] = (total, red, wire, node.hier)
            self._pending.append(node.idx)
            return PlanValue(self, node.idx)
        self._totals[node.idx] = total
        self._results[node.idx] = red.combine(target, total.to(target.dtype))
        return self._results[node.idx]

    def _map_reduce_hash(self, source, mapper, red, target, *, engine, env,
                         shuffle_slack, key_range):
        """A hash-target op: per-shard table state, fetched from and written
        back to the threaded tables (keyed by the target's backing tensors),
        so several ops or iterations on one map compose in order.  Never
        deferred, CSE'd or pruned: the op updates threaded state."""
        kind, src_static, local, src_desc, source_key = (
            self._resolve_program_source(source)
        )
        if self._mode == "discover":
            node = self._build_node(kind, src_desc, source_key, mapper, red, target,
                                    engine, "none", key_range, env)
            vals = target.table.vals
            v = math.prod(vals.shape[2:]) if vals.dim() > 2 else 1
            self._tune_info[node.idx] = ("hash", 0, v, red.name, vals.dtype, key_range,
                                         red.pallas_hash is not None)
        else:
            _, node = self._next_node(MapReduceNode)
        C.require_rank_rows(self._mesh, target, "the hash target")
        tkey = ("hashtarget",) + _source_key("hashmap", target)[1:]
        if tkey not in self._hash_tables:
            if self._mode != "discover":
                raise ValueError(
                    "hash target not registered during discovery: targets "
                    "must be the same DistHashMap objects across iterations"
                )
            t = target.table
            self._hash_tables[tkey] = C.HashTable(t.keys.clone(), t.vals.clone(),
                                                  t.overflow.clone())
        if self._mode == "discover":
            self._hash_targets.setdefault(tkey, target)
        stage, _ = _mr.hash_shard_stage(
            kind, src_static, mapper, red, target.table.vals.dtype, node.engine,
            shuffle_slack, key_range=key_range, tuned=node.tuned,
        )
        table, _le, _ls, _kp = stage(env, self._hash_tables[tkey], local, self._coll)
        self._hash_tables[tkey] = table
        self._produced(table.keys, node.idx)
        return LocalHashMap(table, red.name)

    def foreach(self, v, fn: Callable, env: Any = None) -> LocalVector:
        """Elementwise map over a ``DistVector`` or a ``LocalVector``; the
        result stays on the shards, feeding later ops of the program."""
        env = _force_tree(env)
        data, n, src_desc, source_key = self._resolve_vector_source(v, "ctx.foreach")
        if self._mode == "discover":
            node = ForeachNode(idx=self._call_i, src=src_desc,
                               source_key=source_key, fn=fn)
            self._call_i += 1
            self._nodes.append(node)
            idx = node.idx
            self.last_op = f"[{idx}] {node.stable_desc()}"
        else:
            idx, _ = self._next_node(ForeachNode)
        out = vmap(fn)(data) if env is None else vmap(lambda x: fn(x, env))(data)
        self._produced(out, idx)
        return LocalVector(out, n)

    def topk(self, v, k: int, score_fn: Callable | None = None, env: Any = None,
             engine: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Container-level top-k inside a program: each shard's
        ``containers.topk_first`` (ties lower index first, as
        ``lax.top_k``), one all_gather of the ``k·n_shards`` candidates
        (across the ranks of a process mesh, each selecting from its
        ``n_local`` shards), a global re-select; returns ``(rows [m, ...],
        scores [m])``, ``m = min(k, kk·n_shards)``.  The plan records a
        :class:`ContainerOpNode`, an ``engine=`` request shown as ignored."""
        env = _force_tree(env)
        data, n, src_desc, source_key = self._resolve_vector_source(v, "ctx.topk")
        if self._mode == "discover":
            score_name = ("value" if score_fn is None
                          else getattr(score_fn, "__qualname__", repr(score_fn)))
            node = ContainerOpNode(idx=self._call_i, op="topk", src=src_desc,
                                   source_key=source_key,
                                   params=f"k={k} score={score_name}",
                                   engine_requested=engine)
            self._nodes.append(node)
            self._call_i += 1
            self.last_op = f"[{node.idx}] {node.stable_desc()}"
        else:
            self._next_node(ContainerOpNode)
        s_count = self._n_local
        per = data.shape[0] // s_count
        kk = min(k, per)
        if score_fn is None:
            scores = data.to(torch.float32)
        elif env is None:
            scores = vmap(score_fn)(data)
        else:
            scores = vmap(lambda x: score_fn(x, env))(data)
        first = self._coll.first_shard * per  # global row indices
        valid = torch.arange(first, first + data.shape[0], device=data.device) < n
        scores = torch.where(valid, scores, float("-inf")).view(s_count, per)
        s, i = C.topk_first(scores, kk)
        rows = data.view((s_count, per) + tuple(data.shape[1:]))
        cand = rows[torch.arange(s_count, device=data.device)[:, None], i]
        gs = self._coll.all_gather_tiled(s)
        gc = self._coll.all_gather_tiled(cand)
        m = min(k, gs.shape[0])
        s2, i2 = C.topk_first(gs, m)
        return gc[i2], s2

    # -- plan assembly (discover mode) ----------------------------------------

    def build_plan(self, state_desc: str, passes: tuple) -> Plan:
        nodes = list(self._nodes)
        nodes.append(GlueNode(idx=len(nodes), desc="state update (user glue)"))
        # prune-dead-sources: a source is live iff some live node reads it.
        live_keys: set[tuple] = set()
        for n in nodes:
            if isinstance(n, MapReduceNode) and (n.dead or n.cse_of is not None):
                continue
            sk = getattr(n, "source_key", None)
            if sk is not None:
                live_keys.add(sk)
        sources = [
            SourceInfo(key=k, desc=plan_mod.source_desc(_mr.source_kind(s), s),
                       source=s, pruned=self._prune and k not in live_keys)
            for k, s in self._sources.items()
        ]
        mr = [n for n in nodes if isinstance(n, MapReduceNode)]
        n_coll = self._coll.count
        return Plan(
            nodes=nodes,
            sources=sources,
            state_desc=state_desc,
            n_shards=self._n_shards,
            n_nodes=self._n_nodes,
            passes=passes,
            groups=dict(self._groups),
            group_keys=dict(self._group_keys),
            collectives_per_iter=n_coll,
            collectives_unbatched=n_coll + sum(len(g) - 1 for g in self._groups.values()),
            cse_hits=sum(1 for n in mr if n.cse_of is not None),
            dead_ops=sum(1 for n in mr if n.dead),
            pruned_sources=sum(1 for s in sources if s.pruned),
            residual_specs=[n.residual_spec for n in mr if n.residual_spec is not None],
            hash_targets=dict(self._hash_targets),
            tune_info=dict(self._tune_info),
        )


# ---------------------------------------------------------------------------
# State pytrees: dict keys in sorted order (as JAX flattens them), so a step
# may rebuild its state dict in any key order.
# ---------------------------------------------------------------------------


def _sorted_tree(tree):
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_sorted_tree(x) for x in tree)
    return tree


def _as_leaf(x, device) -> torch.Tensor:
    """A state leaf as a tensor on ``device``; a Python scalar becomes a
    fill (no copy from the host, so it also runs inside a capture)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (bool, int, float)):
        return torch.full((), x, device=device)
    return torch.as_tensor(x, device=device)


def _flatten(tree, device):
    leaves, spec = pytree.tree_flatten(_sorted_tree(tree))
    return [_as_leaf(x, device) for x in leaves], spec


def _state_desc(leaves) -> str:
    descs = ",".join(
        f"{plan_mod.dtype_name(x.dtype)}[{'x'.join(map(str, x.shape))}]" for x in leaves
    )
    return f"{len(leaves)} leaves: {descs}"


def add_launches(into: dict, launches: dict) -> None:
    """Add ``launches`` (by wrapper and form, as :func:`launch_counts`
    names them) into ``into``."""
    for k, n in launches.items():
        into[k] = into.get(k, 0) + n


@dataclasses.dataclass
class GraphStats:
    """What the CUDA graphs of one kind in the process have done (the LM
    decode graphs: ``launch.serve_lm.stats``; the training steps:
    ``runtime.train_loop.stats``): their captures, the kernel launches those
    captures recorded, their replays, and the launches the replays made
    (each replay its graph's recorded launches), by wrapper and by form as
    :func:`launch_counts` names them.  A replay calls no wrapper, so the
    wrappers' own counts keep only the calls that ran through them: the
    warm-up's and the capture's, as for a ``Program``; a capture's calls
    record their kernels and launch nothing, so the launches that ran are
    the wrappers' less ``capture_launches`` plus ``replay_launches``."""

    captures: int = 0
    replays: int = 0
    replay_launches: dict = dataclasses.field(default_factory=dict)
    capture_launches: dict = dataclasses.field(default_factory=dict)

    def reset(self) -> None:
        self.captures = self.replays = 0
        self.replay_launches = {}
        self.capture_launches = {}

    def captured(self, launches: dict) -> None:
        """One capture that recorded ``launches``."""
        self.captures += 1
        add_launches(self.capture_launches, launches)

    def replayed(self, launches: dict) -> None:
        """One replay of a graph that recorded ``launches``."""
        self.replays += 1
        add_launches(self.replay_launches, launches)


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, and by form where it keeps one
    (``"segment_reduce/registers"``)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.hash_combine import hash_aggregate
    from repro_torch.kernels.kmeans_assign import kmeans_assign
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    from repro_torch.kernels.segment_reduce import segment_reduce
    from repro_torch.kernels.ssd_scan import ssd_scan

    counts = {}
    for fn in (segment_reduce, hash_aggregate, kmeans_assign, flash_attention,
               ssd_scan, rwkv6_scan):
        counts[fn.__name__] = fn.launches
        for form, n in getattr(fn, "forms", {}).items():
            counts[f"{fn.__name__}/{form}"] = n
    return counts


@dataclasses.dataclass
class _Carry:
    """One state signature's cross-dispatch state: the int8 residuals, the
    hash targets' tables (updated in place, so a captured graph keeps their
    addresses), and on the card the graphs' static input buffers."""

    residuals: list
    tables: dict  # hash-target key -> HashTable
    targets: dict  # hash-target key -> the DistHashMap the step captured (initial values)
    state_in: list | None = None  # the graphs' static input state


@dataclasses.dataclass
class _Graph:
    graph: Any  # torch.cuda.CUDAGraph
    out_leaves: list
    launches: dict  # per replay, by kernel (and form)


class Program:
    """A step function planned once per state signature and run as fused
    blocks of iterations.

    Built by ``BlazeSession.program(step_fn)``; ``step_fn(ctx, state)``
    returns a state pytree with the structure, shapes and dtypes it was
    given.  ``program(state, n_iters)`` runs one dispatch of ``n_iters``
    iterations; ``session.run_loop`` drives it.  ``program.plan`` (after
    :meth:`build` or the first dispatch) is the optimised plan;
    ``session.explain(program)`` renders it; ``passes=()`` switches off CSE,
    batching and pruning.  ``mesh`` (the session's by default) is the
    topology it runs on; on a multi-node mesh ``hierarchical=False`` plans
    it as a flat one (the A/B baseline: flat collectives, the 1-D plan).

    ``keep_graph = True``, set before the first dispatch, keeps each
    captured graph's ``cudaGraph_t`` (``torch.cuda.CUDAGraph(keep_graph=
    True)``: instantiated at its first replay), so a tool can read its nodes
    through ``graph.raw_cuda_graph()``.
    """

    #: Keep the captured graphs readable (see the class docstring).
    keep_graph = False

    def __init__(self, session, step_fn: Callable, *, mesh: C.Mesh | None = None,
                 passes: tuple | None = None, tune: bool = False,
                 overrides: dict | None = None, hierarchical: bool = True):
        self._session = session
        self._step_fn = step_fn
        self._mesh = mesh if mesh is not None else session.mesh
        self._device = self._mesh.device
        self._n_shards = self._mesh.n_shards
        self._hierarchical = bool(hierarchical)
        self._n_nodes = self._mesh.n_nodes if self._hierarchical else 1
        self._passes = DEFAULT_PASSES if passes is None else tuple(passes)
        # ``tune``: measure the candidates on the first build of a signature
        # (_maybe_tune); ``overrides`` (tune_key -> config) marks a
        # measurement variant, which never tunes itself.
        self._tune = bool(tune)
        self._overrides = overrides
        self._streams: dict = {}  # chunked-source key -> _StreamSlot
        self._plans: dict = {}  # state signature -> Plan
        self._carry: dict = {}  # state signature -> _Carry
        self._graphs: dict = {}  # (state signature, u) -> _Graph
        self._pool = None  # the first graph's memory pool, which later captures share
        # Signatures whose next run (on the card, capture) hits the
        # ``collective`` point: discovered and not yet run to the end.
        self._unproven: set = set()
        self._last_sig = None
        self._active: ProgramContext | None = None  # the iteration running
        self.plan: Plan | None = None
        self.stats = ProgramStats()
        self.feedback_slots = 0  # error-feedback residual slots (int8 sums)
        self.hash_slots = 0  # hash-target table slots threaded per iteration
        # per measured variant: (overrides, its replay's wall s, the kernel
        # launches its graph recorded: none on the CPU)
        self.tune_walls: list = []

    @property
    def _on_card(self) -> bool:
        return self._device.type == "cuda"

    # -- build ---------------------------------------------------------------

    def _discover(self, leaves, spec) -> Plan:
        ctx = ProgramContext(self._mesh, "discover",
                             passes=self._passes, tuning=self._session.tuning,
                             overrides=self._overrides, streams=self._streams,
                             degraded=self._session._degraded, n_nodes=self._n_nodes,
                             hierarchical=self._hierarchical)
        probe = pytree.tree_unflatten([x.clone() for x in leaves], spec)
        out = ctx._finalize_state(self._step_fn(ctx, probe))
        out_leaves, out_spec = _flatten(out, self._device)
        if out_spec != spec:
            raise ValueError(
                "step_fn must return a state pytree with the same structure "
                f"it was given (got {out_spec}, want {spec})"
            )
        for i, (a, b) in enumerate(zip(leaves, out_leaves)):
            if (a.shape, a.dtype) != (b.shape, b.dtype):
                raise ValueError(
                    "step_fn must keep each state leaf's shape and dtype (the "
                    f"state is carried from one iteration to the next); leaf {i} "
                    f"went from {tuple(a.shape)}/{a.dtype} to "
                    f"{tuple(b.shape)}/{b.dtype}"
                )
        return ctx.build_plan(_state_desc(leaves), self._passes)

    def build(self, state) -> Plan:
        """Discover and optimise the plan for ``state``'s signature without
        dispatching (discovery runs one iteration on clones, its results
        thrown away).  Returns the :class:`Plan` ``session.explain``
        renders."""
        leaves, spec = _flatten(state, self._device)
        return self._plans[self._build(leaves, spec)]

    def _maybe_tune(self, leaves, spec) -> None:
        """First-build autotuning: time the candidates of every tunable node
        and cache the winners in the session's ``TuningCache``.

        A probe discovery finds the tunable nodes (a kernel for the target,
        no ``naive`` request, no winner yet for the ``tune_key``).  Variant
        ``j`` pins each to its ``min(j, len - 1)``-th candidate; each is a
        throwaway ``Program``, dispatched once (discovery, warm-up, capture
        and a replay on the card) and then timed over a second dispatch, a
        replay, with the device synchronised around it.  Each variant's
        graphs and pool are freed before the next is built (every k-means
        graph reserves gigabytes), whether it ran or raised.  The fastest
        variant's configs are cached under their ``tune_key``s, so the real
        build that follows, and any later program or ``map_reduce`` with the
        same op, applies them.  Programs that read chunked sources are not
        tuned: their blocks arrive a dispatch at a time.  Each variant hits
        ``tuning.measure`` first; a variant that takes an injected fault is
        skipped and the fault recorded ``absorbed``.  A real error raises:
        a variant that fails to build, launch or capture is a defect, not a
        slow candidate.
        """
        from repro_torch.core import cost

        session = self._session
        tuning = session.tuning
        probe = self._discover(leaves, spec)
        if any(_mr.source_kind(s.source) == "chunked" for s in probe.live_sources()):
            return
        cand_lists: list[tuple[str, list]] = []
        seen: set[str] = set()
        for n in probe.mapreduce_nodes():
            if (n.dead or n.cse_of is not None or n.tuned is not None
                    or n.degraded_from is not None or n.tune_key in seen
                    or tuning.peek(n.tune_key) is not None):
                continue
            tkind, k, v, red_name, dtype, key_range, has_kernel = probe.tune_info[n.idx]
            if not has_kernel or n.engine_requested == "naive":
                continue
            cands = (cost.hash_tuning_candidates(v, red_name, dtype, key_range=key_range)
                     if tkind == "hash" else
                     cost.dense_tuning_candidates(k, v, red_name, dtype))
            if len(cands) < 2:
                continue
            seen.add(n.tune_key)
            cand_lists.append((n.tune_key, cands))
        if not cand_lists:
            return
        state = pytree.tree_unflatten(leaves, spec)
        best_wall, best_set, best_j = None, None, -1
        variants = {}
        for j in range(max(len(c) for _, c in cand_lists)):
            ov = {tk: cands[min(j, len(cands) - 1)] for tk, cands in cand_lists}
            variant = Program(session, self._step_fn, mesh=self._mesh, passes=self._passes,
                              overrides=ov, hierarchical=self._hierarchical)
            try:
                faults.fault_point("tuning.measure")
                variant(state, 1)  # discovery, warm-up, capture, one replay
                _sync(self._device)
                t0 = time.perf_counter()
                variant(state, 1)  # timed: a replay
                _sync(self._device)
                wall = time.perf_counter() - t0
                launches = dict(variant.stats.captured_launches.get(1, {}))
            except faults.InjectedFault as e:
                faults.record("absorbed", e)
                continue
            finally:
                del variant
                gc.collect()
                if self._device.type == "cuda":
                    torch.cuda.empty_cache()  # the variant's graph pool goes back
            self.tune_walls.append((ov, wall, launches))
            session._record_measurement(",".join(ov), "; ".join(c.describe() for c in ov.values()),
                                        wall)
            variants[j] = (ov, wall)
            if best_wall is None or wall < best_wall:
                best_wall, best_set, best_j = wall, ov, j
        # The ranks' walls differ: every rank takes rank 0's winner.
        best_j = agree(self._mesh, best_j)
        best_set, best_wall = variants.get(best_j, (None, None))
        for tk, cfg in (best_set or {}).items():
            tuning.put(tk, dataclasses.replace(cfg, source="measured", wall_s=best_wall))

    def _build(self, leaves, spec):
        sig = plan_mod.abstract_sig(pytree.tree_unflatten(leaves, spec))
        if sig in self._plans:
            self.plan = self._plans[sig]
            return sig
        if self._tune and self._overrides is None:
            self._maybe_tune(leaves, spec)
        plan = self._discover(leaves, spec)
        self._plans[sig] = plan
        self._unproven.add(sig)
        self.plan = plan
        self.feedback_slots = len(plan.residual_specs)
        self.hash_slots = len(plan.hash_targets)
        # A signature rebuilt after degrade() keeps its carry: the graphs
        # captured next read the same buffers, and checkpoints restore into them.
        if sig not in self._carry:
            self._carry[sig] = _Carry(
                residuals=[torch.zeros(shape, dtype=dtype, device=self._device)
                           for shape, dtype in plan.residual_specs],
                tables={k: C.HashTable(hm.table.keys.clone(), hm.table.vals.clone(),
                                       hm.table.overflow.clone())
                        for k, hm in plan.hash_targets.items()},
                targets=dict(plan.hash_targets),
            )
        if not self._on_card:  # the card counts captures instead
            self.stats.compiles += 1
            self._session.stats.program_compiles += 1
        return sig

    # -- run -----------------------------------------------------------------

    def _run_iters(self, plan: Plan, state, residuals: list, tables: dict, u: int,
                   fire: bool = False):
        """``u`` iterations of the plan; with ``fire`` the first one's
        reduces hit the ``collective`` fault point."""
        for i in range(u):
            ctx = ProgramContext(self._mesh, "execute",
                                 residuals=residuals, hash_tables=tables, plan=plan,
                                 passes=self._passes, streams=self._streams,
                                 fire=fire and i == 0, n_nodes=self._n_nodes,
                                 hierarchical=self._hierarchical)
            self._active = ctx
            state = ctx._finalize_state(self._step_fn(ctx, state))
            residuals, tables = ctx._residuals, ctx._hash_tables
        return state, residuals, tables

    def _run_block(self, plan: Plan, state, carry: _Carry, u: int, fire: bool = False):
        """``u`` iterations from ``state``; the carry's new values are
        copied into its buffers in place."""
        out, residuals, tables = self._run_iters(
            plan, state, list(carry.residuals), dict(carry.tables), u, fire)
        for buf, new in zip(carry.residuals, residuals):
            buf.copy_(new)
        for key, t in carry.tables.items():
            new = tables[key]
            t.keys.copy_(new.keys)
            t.vals.copy_(new.vals)
            t.overflow.copy_(new.overflow)
        return out

    def _capture(self, sig, spec, carry: _Carry, u: int) -> _Graph:
        """Capture ``u`` iterations as one CUDA graph, after one warm-up
        iteration on a side stream on clones of the state and carry (on a
        process mesh the warm-up's collectives also bring NCCL's
        communicator up, which a capture cannot do).

        The graph shares the program's pool while any of its graphs lives;
        once ``degrade`` has dropped them all, the capture starts a new one
        (PyTorch's allocator asserts on a capture into a pool whose graphs
        are all gone while a tensor allocated in it still lives).  An injected fault
        (the ``collective`` point) passes through as it is, for the
        supervisor; any other error is raised naming the op (also as the
        error's ``plan_node``).  Either way
        nothing is left behind: no graph, no stale context, the sync-debug
        mode restored."""
        dev = self._device
        plan = self._plans[sig]
        # A block's copy may still be landing in a stream slot's staging
        # buffer (a capture in the middle of a stream): let it finish first.
        for slot in self._streams.values():
            if slot.copy is not None:
                slot.copy.synchronize()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run_iters(
                plan, pytree.tree_unflatten([x.clone() for x in carry.state_in], spec),
                [r.clone() for r in carry.residuals],
                {k: C.HashTable(t.keys.clone(), t.vals.clone(), t.overflow.clone())
                 for k, t in carry.tables.items()}, 1)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True) if self.keep_graph else torch.cuda.CUDAGraph()
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        self._active = None
        pool = self._pool if self._graphs else None
        try:
            # Every graph of the program allocates from the first one's pool:
            # they never replay at once, each reads its input from the
            # static state_in and its outputs are copied out after each
            # replay, so a later graph may reuse what an earlier one frees.
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                # Entering emptied the allocator's cache: from here on what
                # the device reserves is the graphs' pool growing.
                reserved = torch.cuda.memory_reserved(dev)
                # A host sync inside the step raises here rather than
                # breaking the capture.
                debug = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = self._fired(sig, lambda fire: self._run_block(
                        plan, pytree.tree_unflatten(carry.state_in, spec), carry, u,
                        fire=fire))
                finally:
                    torch.cuda.set_sync_debug_mode(debug)
        except faults.InjectedFault:
            self._active = None
            raise
        except Exception as e:
            where = self._active.last_op if self._active is not None else "the step"
            self._active = None
            err = RuntimeError(
                f"CUDA graph capture of the program failed at or after plan node "
                f"{where}: {e}"
            )
            err.plan_node = where
            raise err from e
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
        grown = max(0, torch.cuda.memory_reserved(dev) - reserved)
        if pool is None:
            self._pool = graph.pool()
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        out_leaves, _ = _flatten(out, dev)
        self.stats.captures += 1
        self.stats.compiles += 1
        self.stats.captured_launches[u] = launches
        self.stats.pool_peak_bytes = max(self.stats.pool_peak_bytes, peak)
        self.stats.pool_reserved_bytes += grown
        st = self._session.stats
        st.program_compiles += 1
        st.graph_captures += 1
        st.graph_pool_peak_bytes = max(st.graph_pool_peak_bytes, peak)
        st.graph_pool_reserved_bytes += grown
        return _Graph(graph, out_leaves, launches)

    def _fired(self, sig, run):
        """``run(fire)``, ``fire`` telling whether its reduces hit the
        ``collective`` point: until a run of the signature succeeds."""
        out = run(sig in self._unproven)
        self._unproven.discard(sig)
        return out

    def _stream_slots(self, sig) -> list:
        """The stream slots of the chunked sources the plan reads."""
        return [self._streams[s.key] for s in self._plans[sig].live_sources()
                if s.key in self._streams]

    def __call__(self, state, n_iters: int = 1):
        """One dispatch of ``n_iters`` iterations: a graph replay on the
        card, the planned step run eagerly on the CPU.  A program that reads
        chunked sources runs through :meth:`run_stream` instead."""
        leaves, spec = _flatten(state, self._device)
        sig = self._build(leaves, spec)
        if self._stream_slots(sig):
            raise ValueError("program reads chunked (out-of-core) sources: drive it "
                             "with program.run_stream(...) / session.run_stream(...)")
        return self._dispatch(leaves, spec, sig, n_iters)

    def _block(self, leaves, spec):
        """One dispatch of one iteration over the resident blocks, the plan
        (re)built first: a supervised retry after ``degrade`` rediscovers
        it."""
        return self._dispatch(leaves, spec, self._build(leaves, spec), 1)

    def _graph_for(self, sig, spec, leaves, n_iters: int) -> _Graph:
        """Copy ``leaves`` into the static input state and return the graph
        of ``n_iters`` iterations, capturing it the first time."""
        carry = self._carry[sig]
        if carry.state_in is None:
            carry.state_in = [torch.empty_like(x) for x in leaves]
        for dst, src in zip(carry.state_in, leaves):
            dst.copy_(src)
        g = self._graphs.get((sig, n_iters))
        if g is None:
            g = self._graphs[(sig, n_iters)] = self._capture(sig, spec, carry, n_iters)
        return g

    def _dispatch(self, leaves, spec, sig, n_iters: int):
        if n_iters < 1:
            raise ValueError(f"n_iters must be >= 1, got {n_iters}")
        plan, carry = self._plans[sig], self._carry[sig]
        # Every fault point fires before anything runs or any carry moves,
        # so a supervised retry replays exactly this dispatch.
        faults.fault_point("dispatch")
        if faults.registry.armed:
            for node in plan.mapreduce_nodes():
                if node.engine == "pallas" and not node.dead and node.cse_of is None:
                    faults.fault_point("kernel.hash" if node.target_kind == "hash"
                                       else "kernel.segment")
        if self._on_card:
            g = self._graph_for(sig, spec, leaves, n_iters)
            g.graph.replay()
            out = pytree.tree_unflatten([x.clone() for x in g.out_leaves], spec)
            self.stats.replays += 1
            self._session.stats.graph_replays += 1
            for k, n in g.launches.items():
                for launches in (self.stats.replay_launches,
                                 self._session.stats.graph_launches):
                    launches[k] = launches.get(k, 0) + n
        else:
            out = self._fired(sig, lambda fire: self._run_block(
                plan, pytree.tree_unflatten(leaves, spec), carry, n_iters, fire=fire))
            out = pytree.tree_unflatten(_flatten(out, self._device)[0], spec)
        self._last_sig = sig
        self.stats.dispatches += 1
        self.stats.iterations += int(n_iters)
        self._session.stats.dispatches += 1
        self._session.stats.program_dispatches += 1
        return out

    @property
    def plan_hash(self) -> str | None:
        """Stable digest of the most recently built plan (None before the
        first build)."""
        return None if self.plan is None else self.plan.hash

    # -- the carry -------------------------------------------------------------

    def reset_carry(self) -> None:
        """Reset the residuals and hash tables of every signature to their
        initial values, in place (the graphs keep their addresses), without
        dropping a plan or a graph.  A signature whose plan ``degrade``
        dropped keeps its carry for the rediscovery, so it is reset too."""
        for carry in self._carry.values():
            for r in carry.residuals:
                r.zero_()
            for key, hm in carry.targets.items():
                t = carry.tables[key]
                t.keys.copy_(hm.table.keys)
                t.vals.copy_(hm.table.vals)
                t.overflow.copy_(hm.table.overflow)

    def export_carry(self, state) -> dict:
        """Copies of the carry for ``state``'s signature: the residuals and
        each hash target's ``[keys, vals, overflow]``."""
        leaves, spec = _flatten(state, self._device)
        carry = self._carry[self._build(leaves, spec)]
        return {
            "residual": [r.clone() for r in carry.residuals],
            "hash": [[t.keys.clone(), t.vals.clone(), t.overflow.clone()]
                     for t in carry.tables.values()],
        }

    def import_carry(self, state, carry: dict) -> None:
        """Overwrite the carry for ``state``'s signature, in place, with an
        exported one."""
        leaves, spec = _flatten(state, self._device)
        mine = self._carry[self._build(leaves, spec)]
        for buf, new in zip(mine.residuals, carry["residual"]):
            buf.copy_(new)
        for t, (keys, vals, ovf) in zip(mine.tables.values(), carry["hash"]):
            t.keys.copy_(keys)
            t.vals.copy_(vals)
            t.overflow.copy_(ovf)

    def hash_result(self, target: C.DistHashMap) -> C.DistHashMap:
        """The accumulated state of a hash target of this program, as of the
        most recent dispatch (copies; ``target`` itself is never changed).
        ``target`` must be the ``DistHashMap`` the step function captured."""
        tkey = ("hashtarget",) + _source_key("hashmap", target)[1:]
        if self._last_sig is None:
            raise ValueError("program has not dispatched yet")
        tables = self._carry[self._last_sig].tables
        if tkey not in tables:
            raise KeyError("not a hash target of this program (targets are "
                           "keyed by the identity of their backing tensors)")
        t = tables[tkey]
        return C.DistHashMap(C.HashTable(t.keys.clone(), t.vals.clone(),
                                         t.overflow.clone()),
                             reducer_name=target.reducer_name, mesh=target.mesh)

    # -- streams (out of core) ------------------------------------------------

    def run_stream(self, state, *, max_epochs: int = 1, cond: Callable | None = None,
                   prefetch: bool = True, depth: int = 2, checkpoint=None,
                   checkpoint_every: int | None = None, resume: bool = False):
        """Out-of-core epochs: every block of the chunked sources through the
        program's one graph, in order.

        The step sees one resident block a dispatch (global indices through
        the block's ``base``) and carries its accumulation in the state or a
        hash target's table.  ``prefetch=True``: a worker thread decodes
        block k+1 into pinned memory (``data.pipeline.prefetch_iter``,
        ``depth`` blocks ahead) and, on the card, block k+1's copy to the
        device runs on a copy stream while block k replays (one static block
        buffer a source plus one staging buffer: the device holds two blocks
        whatever the dataset; the staging copy costs one device-to-device
        copy a block, against a second capture and twice the graphs for two
        static buffers).  ``prefetch=False`` is the drained baseline: each
        block is read, copied and replayed, and the device synchronised,
        before the next is read.  ``cond(state)`` runs once an epoch (one
        host sync).  ``checkpoint=`` with ``checkpoint_every=K`` saves the
        state, the carry and the epoch every ``K`` epochs; ``resume=True``
        restores the latest and goes on from its epoch (a crash mid-epoch
        replays that epoch).  On a process mesh every rank streams its rows
        of every block through its graph (the ranks' block counts must
        agree), and ``cond`` is decided by rank 0's reading, the same state
        on every rank.  Each block's dispatch runs supervised
        (``session.supervised``): a retry replays the block already resident
        in the static buffer (block k+1 waits in the staging buffer), and a
        degrade captures again after the copy stream has drained.  Returns
        ``(state, StreamInfo)``.
        """
        from repro_torch.data.pipeline import prefetch_iter

        manager = _as_checkpoint_manager(checkpoint)
        if resume and manager is None:
            raise ValueError("resume=True needs checkpoint=")
        compiles0 = self.stats.compiles
        leaves, spec = _flatten(state, self._device)
        sig = self._build(leaves, spec)
        slots = self._stream_slots(sig)
        if not slots:
            raise ValueError("program has no chunked sources: use run_loop / __call__")
        counts = {slot.source.n_blocks for slot in slots}
        if len(counts) != 1:
            raise ValueError(f"chunked sources disagree on block count: {sorted(counts)}")
        n_blocks = counts.pop()
        if not all_ranks_equal(self._mesh, n_blocks):
            raise ValueError(f"rank {self._mesh.rank}'s chunked sources have {n_blocks} "
                             "blocks and another rank's do not: every rank streams every "
                             "block (make the sources from the same array on every rank)")
        bytes_per_block = sum(slot.source.block_nbytes for slot in slots)
        dev = self._device
        card = self._on_card
        index = _cuda_index(dev) if card else None
        supervised = self._session.supervised
        if card:
            # Capture before any block moves: the copy stream must not run
            # beside the capture.
            supervised(lambda: self._graph_for(self._build(leaves, spec), spec, leaves, 1),
                       program=self)

        def produce(b):
            if card:
                torch.cuda.set_device(index)
            return [slot.source.block_tensor(b) for slot in slots]

        resumed_from = None
        if resume:
            state, pos = self.restore_checkpoint(manager, state)
            if pos is not None:
                resumed_from = pos
        epochs = resumed_from or 0
        blocks = syncs = 0
        converged = False
        while epochs < max_epochs:
            items = (prefetch_iter(produce, range(n_blocks), depth=depth) if prefetch
                     else ((b, produce(b)) for b in range(n_blocks)))
            overlap = card and prefetch
            nxt = next(items, None)
            if overlap:
                for slot, host in zip(slots, nxt[1]):
                    slot.stage(host)
            while nxt is not None:
                b, hosts = nxt
                for slot, host in zip(slots, hosts):
                    slot.install(b, None if overlap else host)
                nxt = next(items, None)
                if overlap and nxt is not None:
                    # Block b+1's copy starts now, beside block b's replay.
                    for slot, host in zip(slots, nxt[1]):
                        slot.stage(host)
                leaves, spec = _flatten(state, dev)
                state = supervised(lambda: self._block(leaves, spec), program=self)
                blocks += 1
                if not prefetch:
                    _sync(dev)
            epochs += 1
            if manager is not None and checkpoint_every and epochs % checkpoint_every == 0:
                self.save_checkpoint(manager, state, epochs)
            if cond is not None:
                self._session.stats.host_syncs += 1
                syncs += 1
                # rank 0's decision on every rank (the state is replicated,
                # so every rank's is the same)
                if agree(self._mesh, bool(cond(state))):
                    converged = True
                    break
        return state, StreamInfo(
            epochs=epochs, n_blocks=n_blocks, dispatches=blocks, host_syncs=syncs,
            converged=converged, compiles=self.stats.compiles - compiles0,
            prefetch=prefetch, bytes_streamed=blocks * bytes_per_block,
            resumed_from=resumed_from,
        )

    # -- checkpoints ----------------------------------------------------------

    def checkpoint_payload(self, state, pos: int) -> dict:
        """The resume payload: the user state (dict keys sorted, as a program
        returns it), the carry, the position."""
        return {"state": _sorted_tree(state), "carry": self.export_carry(state),
                "pos": torch.tensor(pos, dtype=torch.int64)}

    @staticmethod
    def checkpoint_ranks(payload: dict) -> dict:
        """Which leaves of ``payload`` a rank of a process mesh holds its own
        rows of: the carry's (the residuals ``[n_local, ...]``, the hash
        tables); the state and the position are replicated, every rank
        holding the same bits."""
        return {"state": pytree.tree_map(lambda _: False, payload["state"]),
                "carry": pytree.tree_map(lambda _: True, payload["carry"]),
                "pos": False}

    def save_checkpoint(self, manager, state, pos: int) -> str:
        """Save the resume payload as checkpoint ``pos`` (host copies),
        supervised: a transient ``checkpoint.write`` fault is retried, at
        most 3 tries in all; a fatal one propagates.  On a process mesh
        every rank calls it: each writes its rows of the carry, rank 0 the
        state and commits (``checkpoint.manager``)."""
        payload = self.checkpoint_payload(state, pos)
        return faults.retry_in_place(lambda: manager.save(
            pos, payload, mesh=self._mesh, per_rank=self.checkpoint_ranks(payload)))

    def restore_checkpoint(self, manager, state):
        """Restore the latest checkpoint: returns ``(state, position)``, or
        ``(state, None)`` when there is none.  The carry is copied into this
        program's own buffers (the residuals, the hash tables and, on the
        card, the graphs' static input state), never rebound: a captured
        graph keeps reading the addresses it was captured with.  On a
        process mesh every rank restores the step rank 0 picks, and keeps
        its rows of the carry, whatever process count wrote it."""
        like = self.checkpoint_payload(state, 0)
        step, restored = manager.restore_latest(like, mesh=self._mesh,
                                                per_rank=self.checkpoint_ranks(like))
        if step is None:
            return state, None
        state = restored["state"]
        self.import_carry(state, restored["carry"])
        leaves, spec = _flatten(state, self._device)
        carry = self._carry[self._build(leaves, spec)]
        if carry.state_in is not None:
            for dst, src in zip(carry.state_in, leaves):
                dst.copy_(src)
        return state, int(restored["pos"])

    # -- fault supervision ------------------------------------------------------

    def degrade(self) -> int:
        """Degrade every live kernel node of this program to eager; returns
        how many (0 once none is left, so the supervisor never loops).

        The nodes' ``tune_key``s go into the session's degraded set, so every
        later build (this program's, another's, a per-op call) is born eager;
        the plans of the signatures they belong to and those signatures'
        CUDA graphs are dropped (the graphs released before the next
        capture).  The next dispatch rediscovers the plan and captures
        again into the carry, the static input state and the stream slots,
        which stay where they are.  The tuning cache is never touched."""
        degraded = self._session._degraded
        n = 0
        for sig, plan in list(self._plans.items()):
            live = [node for node in plan.mapreduce_nodes()
                    if node.engine == "pallas" and not node.dead and node.cse_of is None]
            if not live:
                continue
            degraded.update(node.tune_key for node in live)
            n += len(live)
            del self._plans[sig]
            for key in [k for k in self._graphs if k[0] == sig]:
                del self._graphs[key]
                self.stats.graphs_dropped += 1
        if n:
            self._active = None  # its tensors live in the dropped graphs' pool
            self.stats.degradations += 1
        return n


def _as_checkpoint_manager(checkpoint):
    """A ``CheckpointManager``, a directory path, or ``None``."""
    if checkpoint is None:
        return None
    if isinstance(checkpoint, str):
        from repro_torch.checkpoint.manager import CheckpointManager

        return CheckpointManager(checkpoint)
    return checkpoint
