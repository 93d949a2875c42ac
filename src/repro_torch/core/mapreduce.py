"""Blaze MapReduce in PyTorch — eager reduction, dense fast path, hash targets.

The counterpart of ``repro/core/mapreduce.py``.  ``map_reduce(source, mapper,
reducer, target)`` keeps the paper's four-argument API:

* **source** — ``DistRange`` | ``DistVector`` | ``DistHashMap`` |
  ``ChunkedDistVector`` (out of core: the session streams it a block at a
  time, each block a ``BlockView``).
* **mapper** — paper-style emit-handler function, run under
  ``torch.func.vmap`` over every element of every shard:
    - ``DistRange``:   ``mapper(value, emit)``            (+ ``env`` if given)
    - ``DistVector``:  ``mapper(index, value, emit)``     (+ ``env`` if given)
    - chunked block:   ``mapper(index, value, emit)``, ``index`` global
    - ``DistHashMap``: ``mapper(key, value, emit)``       (+ ``env`` if given)
  ``emit(key, value, mask=True)`` may be called any static number of times;
  ``key``/``value`` may be scalars or 1-D batches, ``mask`` marks the real
  lanes.  A key passed as a Python ``int`` is static: the dense engine then
  reduces that emit with one fused whole-axis reduction.
* **reducer** — ``"sum" | "prod" | "min" | "max"`` or a custom ``Reducer``.
* **target** — a dense tensor ``[K, ...]`` (key == index) or a
  ``DistHashMap``.  The target is merged into, never cleared.
* **env** — iteration-varying state (PageRank scores, k-means centres)
  passed to the mapper; keeping the mapper fixed and the state in ``env``
  lets one shard-stage plan serve every iteration.

Engines: ``"eager"`` combines duplicate keys on the device before the
shuffle (PyTorch scatter ops); ``"pallas"`` is the eager plan with every
per-shard combine through the hand-written kernels (``Reducer.pallas_segment``
for dense targets, ``Reducer.pallas_hash`` for hash targets, before and
after the shuffle); ``"naive"`` ships every raw pair and reduces only at the
destination; ``"auto"`` is resolved by ``plan.resolve_engine``.

``wire`` ∈ {"none", "bf16", "int8"} narrows the collective payload of dense
sums (``distributed.collectives``); the stats count the narrowed widths as
JAX does.

Shards are stacked on dim 0 of one device (see ``containers``), and a shard
stage is written over all of them at once with ``LocalCollectives``.  On a
mesh whose node rows are processes a stage runs over this rank's ``n_local``
shards with ``ProcessCollectives``: shapes come from ``coll.n_local``, shard
ownership and bucket sizes from the global ``coll.n_shards``, and the
per-shard statistics are gathered, so ``MapReduceStats`` is the mesh's on
every rank.  On a
multi-node mesh a dense reduce the plan marks ``hier`` takes the two-hop
form (``core.collectives``), its stats say so (``collective``) and split
the bytes by link (``reduce_edge_bytes``); hash targets are never
hierarchical.  A
"compile" is the construction of a stage, cached by the session under the
same signature as the JAX executable cache, so compile counts carry over.
``tuned`` (a ``cost.TunedConfig``, the autotuner's winner) pins the kernel's
launch: K1's form and CTAs per SM, K2's table capacity, probe depth and
table of hot keys.

Fault points (``core.faults``): every dispatch hits ``dispatch``, and
``kernel.segment`` / ``kernel.hash`` when the engine is ``"pallas"``, before
its stage runs, so a supervised retry runs the same op again.  A cached
stage's reduces hit ``collective`` where the reference's ``jax.jit`` traces
(:class:`CachedStage`): on its runs until one succeeds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core import containers as C
from repro_torch.core import cost
from repro_torch.core import faults
from repro_torch.core.collectives import LocalCollectives, ProcessCollectives, gather_rows
from repro_torch.core.plan import abstract_sig, hier_collective_desc
from repro_torch.core.reducers import Reducer
from repro_torch.core.serialization import narrowest_int_dtype
from repro_torch.kernels.segment_reduce import THREADS


@dataclasses.dataclass
class MapReduceStats:
    """Wire accounting + runtime counters for one map_reduce call.

    Runtime fields hold device tensors until ``finalize()``, so the engine
    never waits on the device to fill in statistics.  The ``kernel_*`` fields
    describe the port's own launches: CTA size, lanes (pairs) processed, and
    for hash targets the pre-shuffle table capacity and probe depth.
    """

    engine: str
    collective: str  # which collective carried the shuffle
    pairs_emitted: Any  # live emitted pairs
    pairs_shipped: Any  # pairs that went on the wire after the local combine
    shuffle_payload_bytes: Any  # bytes the shuffle moves (all shards, one call)
    # The shuffle payload by link (combine-edge model, ``reduce_edge_bytes``;
    # a shuffle's by the share of its peer links that leave a node row).
    intra_bytes: Any = 0
    inter_bytes: Any = 0
    overflow: Any = None  # hash-table / bucket drops
    compiles: int = 0  # 1 iff this call built a new shard stage
    cache_hits: int = 0  # 1 iff this call reused a cached shard stage
    dispatches: int = 1
    kernel_block_n: int | None = None
    kernel_lanes: int | None = None
    kernel_pairs: Any = None  # live pairs entering the kernel
    kernel_occupancy: float | None = None  # kernel_pairs / kernel_lanes
    kernel_table_cap: int | None = None
    kernel_probe_depth: int | None = None
    # stable digest of this op's plan node (``core.plan``), the same for the
    # per-op and program spellings of the op
    plan_hash: str | None = None
    # supervised-dispatch provenance (``core.faults``, the session's
    # supervisor): the engine a kernel fault degraded the node from (None:
    # never degraded), retries absorbed, hash-capacity escalations taken
    degraded_engine: str | None = None
    retries: int = 0
    escalations: int = 0

    def finalize(self) -> "MapReduceStats":
        def _get(x):
            if isinstance(x, (torch.Tensor, np.ndarray)):
                return int(x.sum())
            return x

        kernel_pairs = _get(self.kernel_pairs)
        occupancy = (
            kernel_pairs / self.kernel_lanes
            if self.kernel_lanes and kernel_pairs is not None
            else None
        )
        return dataclasses.replace(
            self,
            pairs_emitted=_get(self.pairs_emitted),
            pairs_shipped=_get(self.pairs_shipped),
            shuffle_payload_bytes=_get(self.shuffle_payload_bytes),
            intra_bytes=_get(self.intra_bytes),
            inter_bytes=_get(self.inter_bytes),
            overflow=_get(self.overflow),
            kernel_pairs=kernel_pairs,
            kernel_occupancy=occupancy,
        )


@dataclasses.dataclass
class CachedStage:
    """A shard stage in the session's cache.  ``fire``: the next run's
    reduces hit the ``collective`` fault point, as the reference's ``jax.jit``
    traces on a stage's first call; true until a run succeeds."""

    stage: Callable
    kernel_meta: dict
    fire: bool = True

    def run(self, mesh: C.Mesh, *args):
        """``stage(*args, coll)`` with this run's collectives over ``mesh``."""
        out = self.stage(*args, make_collectives(mesh, fire=self.fire))
        self.fire = False
        return out


def make_collectives(mesh: C.Mesh, fire: bool = False) -> LocalCollectives:
    """The mesh's collectives (topology-aware on a multi-node mesh; across
    processes when the mesh carries a group)."""
    if mesh.process:
        return ProcessCollectives(mesh, fire=fire)
    return LocalCollectives(mesh.n_shards, mesh.device, fire=fire, n_nodes=mesh.n_nodes)


def mesh_key(mesh: C.Mesh) -> tuple:
    """A mesh's part of a stage-cache key: the shard count and device, as a
    1-D session always had, the node rows only when there are several, and
    ``rank/P`` only on a process mesh, so every in-process key is what it
    was before meshes existed."""
    return (mesh.n_shards, str(mesh.device)) + (
        (f"nodes={mesh.n_nodes}",) if mesh.n_nodes > 1 else ()) + (
        (f"rank={mesh.rank}/{mesh.n_ranks}",) if mesh.process else ())


def _gather_stats(mesh: C.Mesh, *stats: torch.Tensor) -> tuple:
    """Each integer statistic of this process's shards (``[n_local]``, or a
    scalar total) as the mesh's: ``[S]`` in shard order, or the ranks' sum.
    One all-gather for all of them on a process mesh; as they are on any
    other."""
    if not mesh.process:
        return stats
    flat = [t.reshape(-1).to(torch.int64) for t in stats]
    got = gather_rows(mesh, torch.cat(flat)[None])  # [P, sum of sizes]
    out, off = [], 0
    for t, f in zip(stats, flat):
        part = got[:, off:off + f.numel()]
        out.append((part.reshape(-1) if t.dim() else part.sum()).to(t.dtype))
        off += f.numel()
    return tuple(out)


def _scalar(x):
    """A reducer identity as a Python number (custom ones may be tensors)."""
    return x.item() if isinstance(x, torch.Tensor) else x


class _Emitter:
    """Collects emit() calls while the mapper runs under vmap.

    Keys passed as Python ints are *static*: the dense engine then skips id
    arrays and uses a fused whole-axis reduction — the paper's §2.3.3
    per-thread scalar accumulator (Monte-Carlo π's ``emit(0, …)``,
    PageRank's sink/delta sums).  Keys become int32 here, as in JAX; values
    keep their dtype until the engine casts them to the target's.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.keys: list[torch.Tensor] = []
        self.vals: list[torch.Tensor] = []
        self.masks: list[torch.Tensor] = []
        self.static_keys: list[int | None] = []

    def _tensor(self, x) -> torch.Tensor:
        # A Python scalar becomes a fill, not a copy from the host, so that a
        # mapper also runs inside a captured CUDA graph.
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, (bool, int, float)):
            return torch.full((), x, device=self.device)
        return torch.as_tensor(x, device=self.device)

    def __call__(self, key, value, mask=True):
        static = int(key) if isinstance(key, (int, np.integer)) else None
        key = self._tensor(key).to(torch.int32)
        value = self._tensor(value)
        mask = self._tensor(mask).to(torch.bool)
        if key.dim() == 0:
            key = key[None]
        width = key.shape[0]
        if value.dim() == 0 or value.shape[:1] != (width,):
            value = value.expand((width,) + tuple(value.shape))
        self.keys.append(key)
        self.vals.append(value)
        self.masks.append(mask.expand((width,)))
        self.static_keys.append(static)

    def structured(self):
        if not self.keys:
            raise ValueError("mapper emitted nothing (statically)")
        return tuple(zip(self.keys, self.vals, self.masks))


def _run_mapper_structured(kind, source, mapper, coll, local, env):
    """vmap the emit-style mapper over every shard → (entries, static keys).

    entries: per emit call, ``(keys [S, n, w], vals [S, n, w, ...],
    mask [S, n, w])``; static keys: per emit call, the Python int key or
    ``None``.
    """
    n_shards, n_local = coll.n_shards, coll.n_local
    extra = (env,) if env is not None else ()
    meta: dict = {}

    def trace(*args):
        em = _Emitter(coll.device)
        mapper(*args, em, *extra)
        meta["static"] = em.static_keys
        return em.structured()

    if kind == "range":
        values, valid = source.local_values(coll.axis_index(), n_shards)
        elem_mask = valid.reshape(-1)
        entries = vmap(trace)(values.reshape(-1))
    elif kind == "vector":
        data, n_true = local
        # global indices: this process's shards start at ``first_shard``
        start = coll.first_shard * (data.shape[0] // n_local)
        idx = torch.arange(start, start + data.shape[0], dtype=torch.int32,
                           device=data.device)
        elem_mask = idx < n_true
        entries = vmap(trace)(idx, data)
    elif kind == "chunked":
        # One block of an out-of-core dataset: ``base``, a device scalar,
        # shifts the block's rows to their global indices (read when the
        # stage runs, so one captured graph serves every block), and ``idx <
        # n`` masks the last block's padding as it masks a vector's.
        data, n_total, base = local
        idx = base + torch.arange(data.shape[0], dtype=torch.int32, device=data.device)
        elem_mask = idx < n_total
        entries = vmap(trace)(idx, data)
    elif kind == "hashmap":
        tkeys, tvals = local
        keys = tkeys.reshape(-1)
        elem_mask = keys != C.EMPTY_KEY
        entries = vmap(trace)(keys, tvals.reshape((-1,) + tuple(tvals.shape[2:])))
    else:
        raise TypeError(f"unsupported source kind {kind}")

    per = elem_mask.shape[0] // n_local
    out = []
    for k, v, m in entries:
        m = m & elem_mask[:, None]
        out.append((
            k.reshape(n_local, per, -1),
            v.reshape((n_local, per) + tuple(v.shape[1:])),
            m.reshape(n_local, per, -1),
        ))
    return out, meta["static"]


def _flatten_entries(entries, n_shards):
    """Structured emits → per-shard flat ``(keys [S, N], vals [S, N, ...],
    mask [S, N])``."""
    keys = torch.cat([k.reshape(n_shards, -1) for k, _, _ in entries], dim=1)
    vals = torch.cat(
        [v.reshape((n_shards, -1) + tuple(v.shape[3:])) for _, v, _ in entries],
        dim=1,
    )
    masks = torch.cat([m.reshape(n_shards, -1) for _, _, m in entries], dim=1)
    return keys, vals, masks


# ---------------------------------------------------------------------------
# Shuffle plumbing: bucket pairs by destination shard, fixed capacity
# ---------------------------------------------------------------------------


def bucket_by_dest(keys, vals, valid, n_dest: int, cap: int, ident):
    """Pack one shard's pairs into a ``[n_dest, cap]`` buffer keyed by hash
    ownership; returns ``(bkeys, bvals, n_dropped)``.

    A pair's position in its bucket is its rank among same-destination pairs
    in emission order (a *stable* sort + first-occurrence index), so a full
    bucket keeps the first-emitted pairs.  Vectorised, no host round-trip:
    pairs that do not fit are written to one spare slot that is cut off.
    """
    n = keys.shape[0]
    dev = keys.device
    dest = torch.where(valid, C.shard_of_key(keys, n_dest), n_dest)
    order = torch.argsort(dest, stable=True)
    sdest, skeys, svals = dest[order], keys[order], vals[order]
    first = torch.searchsorted(sdest, sdest, side="left")
    rank = torch.arange(n, device=dev) - first
    ok = (sdest < n_dest) & (rank < cap)
    flat = torch.where(ok, sdest * cap + rank, n_dest * cap)
    bkeys = torch.full((n_dest * cap + 1,), C.EMPTY_KEY, dtype=torch.int32,
                       device=dev)
    bkeys[flat] = torch.where(ok, skeys, C.EMPTY_KEY).to(torch.int32)
    bvals = torch.full((n_dest * cap + 1,) + tuple(vals.shape[1:]),
                       _scalar(ident), dtype=vals.dtype, device=dev)
    bvals[flat] = svals
    dropped = ((sdest < n_dest) & ~ok).sum().to(torch.int32)
    return (
        bkeys[:-1].reshape(n_dest, cap),
        bvals[:-1].reshape((n_dest, cap) + tuple(vals.shape[1:])),
        dropped,
    )


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def source_kind(source) -> str:
    if isinstance(source, C.DistRange):
        return "range"
    if isinstance(source, C.DistVector):
        return "vector"
    if isinstance(source, C.DistHashMap):
        return "hashmap"
    if isinstance(source, (C.ChunkedDistVector, C.BlockView)):
        return "chunked"
    raise TypeError(f"unsupported source {type(source)}")


def map_reduce(source, mapper: Callable, reducer, target, **kwargs):
    """The paper's four-arg functional API, through the process-wide default
    ``BlazeSession`` (see ``repro_torch.core.session``)."""
    from repro_torch.core.session import get_default_session

    return get_default_session().map_reduce(source, mapper, reducer, target,
                                            **kwargs)


def _require_rank_rows(mesh: C.Mesh, kind, source, target=None) -> None:
    """A vector, hash-map or chunked source, and a hash target, must hold
    this rank's rows of a process mesh (``containers.require_rank_rows``;
    a chunked source's ``BlockView`` is the block of one that was
    checked)."""
    if kind in ("vector", "hashmap") or isinstance(source, C.ChunkedDistVector):
        C.require_rank_rows(mesh, source, f"the {kind} source")
    if target is not None:
        C.require_rank_rows(mesh, target, "the hash target")


def _source_operands(kind, source) -> tuple:
    if kind == "range":
        return ()
    if kind == "vector":
        return (source.data,)
    if kind == "chunked":
        return (source.data, source.base)
    return (source.table.keys, source.table.vals)


def _source_extent(kind, source):
    if kind in ("vector", "chunked"):
        return source.n
    if kind == "range":
        return (source.start, source.stop, source.step)
    return None


def _local_view(kind, source):
    if kind == "range":
        return None
    if kind == "vector":
        return (source.data, source.n)
    if kind == "chunked":
        return (source.data, source.n, source.base)
    return (source.table.keys, source.table.vals)


def _segment_launch(tuned) -> dict:
    """K1's launch overrides of a tuned config (none for eager or untuned)."""
    if tuned is None or tuned.engine != "pallas":
        return {}
    return {k: getattr(tuned, k) for k in ("form", "ctas_per_sm")
            if getattr(tuned, k) is not None}


def dense_shard_stage(kind, source, mapper, red: Reducer, target, engine: str,
                      wire: str = "none", with_stats: bool = True,
                      feedback: bool = False, collect: bool = True, tuned=None,
                      hier: bool = False):
    """The per-shard plan for a dense ``[K, ...]`` target, as a function:

        ``stage(env, local, coll, residual=None)
            -> (total, live, kernel_pairs, residual')``

    mapper → local combine (static-key fast path, segmented reduce or the
    segment-reduce kernel) → the collective, its payload narrowed per
    ``wire``.  ``total`` is the merged result excluding the target; ``live``
    the live pairs per shard.  ``feedback=True`` (``wire="int8"`` sums in a
    program) runs the collective with error feedback on the ``[S, ...]``
    ``residual``; ``collect=False`` (eager/pallas) stops at the ``[S, K,
    ...]`` partials and leaves the collective to the caller, the seam of
    the batch-collectives pass.  ``tuned`` pins K1's launch.  Returns
    ``(stage, kernel_meta)``, ``kernel_meta`` filled when the kernel runs.
    ``hier=True`` (multi-node meshes, set by the plan layer's
    ``hierarchical-collectives`` pass) makes the collective the two-hop
    reduce of ``LocalCollectives``.
    """
    K = target.shape[0]
    launch = _segment_launch(tuned) if engine == "pallas" else {}
    target_dtype = target.dtype
    kernel_meta: dict = {}

    def stage(env, local, coll, residual=None):
        # this process's shards: the partials are [n_local, K, ...]
        n_local, dev = coll.n_local, coll.device
        entries, static_keys = _run_mapper_structured(
            kind, source, mapper, coll, local, env
        )
        live = (
            sum(m.reshape(n_local, -1).sum(1) for _, _, m in entries).to(torch.int32)
            if with_stats or engine == "naive"
            else torch.zeros(n_local, dtype=torch.int32, device=dev)
        )
        kernel_pairs = torch.zeros((), dtype=torch.int32, device=dev)

        if engine in ("eager", "pallas"):
            # §2.3.3 static-key fast path: trace-time-constant keys get a
            # fused whole-axis reduction, no id arrays (both engines: a
            # kernel cannot beat a fused scalar reduction).
            val_shape = tuple(entries[0][1].shape[3:])
            ident = red.identity(target_dtype)
            partial = torch.full((n_local, K) + val_shape, _scalar(ident),
                                 dtype=target_dtype, device=dev)
            dynamic = []
            for (keys, vals, mask), sk in zip(entries, static_keys):
                vals = vals.to(target_dtype)
                if sk is not None and 0 <= sk < K and red.axis_reduce is not None:
                    mb = mask.reshape(mask.shape + (1,) * len(val_shape))
                    contrib = red.axis_reduce(torch.where(mb, vals, ident), (1, 2))
                    partial[:, sk] = red.combine(partial[:, sk], contrib)
                else:
                    dynamic.append((keys, vals, mask))
            if dynamic:
                dkeys, dvals, dmask = _flatten_entries(dynamic, n_local)
                in_range = dmask & (dkeys >= 0) & (dkeys < K)
                if engine == "pallas" and red.pallas_segment is not None:
                    # Invalid lanes get id -1, which the kernel drops without
                    # reading their values.
                    ids = torch.where(in_range, dkeys, -1)
                    flat = dvals.reshape(n_local, dvals.shape[1], -1)
                    seg = torch.stack([
                        red.pallas_segment(ids[s], flat[s].contiguous(), K, **launch)
                        for s in range(n_local)
                    ]).reshape((n_local, K) + tuple(dvals.shape[2:]))
                    kernel_meta["block_n"] = THREADS
                    kernel_meta["lanes"] = flat.shape[1] * coll.n_shards
                    kernel_pairs = in_range.sum().to(torch.int32)
                else:
                    ids = torch.where(in_range, dkeys, K)
                    seg = torch.stack([
                        red.segment(dvals[s], ids[s], K + 1)[:K]
                        for s in range(n_local)
                    ])
                partial = red.combine(partial, seg.to(target_dtype))
            if not collect:
                total = partial  # the caller runs the (batched) collective
            elif feedback:
                total, residual = coll.reduce_feedback(partial, red, wire, residual,
                                                       hier=hier)
            else:
                total = coll.reduce(partial, red, wire, hier=hier)
        else:
            # Conventional plan: every raw pair goes to every shard, and the
            # reduction happens only there.
            keys, vals, valid = _flatten_entries(entries, n_local)
            gk = coll.all_gather_tiled(keys)
            gv = coll.all_gather_tiled(vals.to(target_dtype))
            gm = coll.all_gather_tiled(valid)
            ids_g = torch.where(gm & (gk >= 0) & (gk < K), gk, K)
            total = red.segment(gv, ids_g, K + 1)[:K]
        return total, live, kernel_pairs, residual

    return stage, kernel_meta


def reduce_edge_bytes(n_elems: int, full_bytes: int, wire_val_bytes: int,
                      n_shards: int, n_nodes: int = 1, hier: bool = False
                      ) -> tuple[int, int]:
    """``(intra_bytes, inter_bytes)`` of one dense reduction, combine-edge
    model: a reduction over ``n_shards`` participants moves ``n_shards - 1``
    combine edges of ``n_elems`` values.

    * one node: every edge intra-node at the wire's width;
    * a flat reduce on several nodes knows no topology: every edge pays the
      inter-node price at the wire's width;
    * hierarchical: ``n_shards - n_nodes`` edges inside the nodes at full
      width, ``n_nodes - 1`` across them at the wire's width.

    This is the reference's model of the combine edge, kept as it is for
    every mesh.  Across processes the port's reduce gathers, then folds
    (``core.collectives.ProcessCollectives``): each rank receives every node
    partial, ``n_nodes`` times the partial's bytes on the inter-node hop
    (flat: every shard partial, ``n_shards`` times), against the model's
    ``n_nodes - 1`` edges for the whole reduce.
    """
    if n_nodes > 1 and hier:
        return (n_elems * full_bytes * (n_shards - n_nodes),
                n_elems * wire_val_bytes * (n_nodes - 1))
    if n_nodes > 1:
        return 0, n_elems * wire_val_bytes * (n_shards - 1)
    return n_elems * wire_val_bytes * (n_shards - 1), 0


def inter_node_fraction(n_shards: int, n_nodes: int, peers: bool) -> float:
    """The share of a shuffle's payload that leaves its node row.  An
    all_gather reaches the ``n_shards - 1`` peers of a shard (``peers``),
    of which ``n_shards - n_shards / n_nodes`` are in other rows; an
    all_to_all with hash-uniform destinations sends ``(n_shards - n_shards /
    n_nodes) / n_shards`` of its pairs out of the row."""
    if n_nodes <= 1 or n_shards <= 1:
        return 0.0
    return (n_shards - n_shards // n_nodes) / (n_shards - 1 if peers else n_shards)


def split_by_link(payload: torch.Tensor, frac: float):
    """``(intra, inter)``: a payload (a device tensor, read at ``finalize``)
    split by its inter-node share, in float64 so byte counts past 2^24
    stay exact to the byte; all intra-node (and integral) on one node."""
    if not frac:
        return payload, 0
    inter = payload.double() * frac
    return payload.double() - inter, inter


def _map_reduce_dense(kind, source, mapper, red: Reducer, target, mesh: C.Mesh,
                      engine: str, wire: str, env, with_stats: bool = True,
                      cache: dict | None = None, node=None, tuned=None,
                      hier: bool = False):
    """Dense ``[K, ...]`` target — the paper's small fixed key range.
    ``hier`` (the node's ``hierarchical-collectives`` rewrite) takes hold on
    a multi-node mesh with the eager or kernel plan only."""
    K = target.shape[0]
    cache = cache if cache is not None else {}
    if engine not in ("eager", "pallas", "naive"):
        raise ValueError(f"unknown engine {engine!r}")
    _require_rank_rows(mesh, kind, source)
    n_shards, nodes = mesh.n_shards, mesh.n_nodes
    hier = bool(hier) and nodes > 1 and engine in ("eager", "pallas")
    cache_key = (
        "dense", mapper, red.name, red, engine, wire, *mesh_key(mesh),
        kind, with_stats, abstract_sig(_source_operands(kind, source)),
        _source_extent(kind, source), abstract_sig(target), abstract_sig(env), tuned,
    ) + (("hier",) if hier else ())
    if node is not None:
        node.cache_sig = cache_key
    entry = cache.get(cache_key)
    compiled_now = entry is None
    if compiled_now:
        entry = cache[cache_key] = CachedStage(*dense_shard_stage(
            kind, source, mapper, red, target, engine, wire, with_stats=with_stats,
            tuned=tuned, hier=hier,
        ))
    kernel_meta = entry.kernel_meta
    faults.fault_point("dispatch")
    if engine == "pallas":
        faults.fault_point("kernel.segment")
    total, live, kernel_pairs, _ = entry.run(mesh, env, _local_view(kind, source))
    merged = red.combine(target, total.to(target.dtype))
    if with_stats or engine == "naive":
        live, kernel_pairs = _gather_stats(mesh, live, kernel_pairs)

    full_bytes = target.element_size()
    val_bytes = {"bf16": 2, "int8": 1}.get(wire, full_bytes)
    key_bytes = narrowest_int_dtype(K).itemsize
    n_elems = target.numel()
    if engine in ("eager", "pallas"):
        payload = n_elems * val_bytes * n_shards
        collective = (hier_collective_desc(red.name, wire) if hier
                      else f"psum[{K}x{val_bytes}B]")
        shipped = n_elems * n_shards
        intra, inter = reduce_edge_bytes(n_elems, full_bytes, val_bytes, n_shards,
                                         nodes, hier)
    else:
        payload = live.sum() * (key_bytes + val_bytes) * n_shards
        collective = f"all_gather[pairs x {key_bytes + val_bytes}B]"
        shipped = live
        # every shard's pairs reach its n_shards - 1 peers, some in other rows
        intra, inter = split_by_link(payload, inter_node_fraction(n_shards, nodes,
                                                                  peers=True))
    stats = MapReduceStats(
        engine=engine,
        collective=collective,
        pairs_emitted=live,
        pairs_shipped=shipped,
        shuffle_payload_bytes=payload,
        intra_bytes=intra,
        inter_bytes=inter,
        compiles=int(compiled_now),
        cache_hits=int(not compiled_now),
        kernel_block_n=kernel_meta.get("block_n"),
        kernel_lanes=kernel_meta.get("lanes"),
        kernel_pairs=kernel_pairs if kernel_meta else None,
        plan_hash=node.hash if node is not None else None,
    )
    return merged, stats


def _wire_key_dtype(key_range: int | None) -> torch.dtype:
    """Key dtype the hash shuffle ships: narrowed when the range is known
    (the §2.3.2 fast-serialization analogue for explicit keys)."""
    if key_range is None:
        return torch.int32
    return narrowest_int_dtype(key_range)


def hash_shard_stage(kind, source, mapper, red: Reducer, val_dtype, engine: str,
                     slack: float, key_range: int | None = None, tuned=None):
    """The per-shard plan for a ``DistHashMap`` target, as a function:

        ``stage(env, table, local, coll)
            -> (table', live_emitted, live_shipped, kernel_pairs)``

    * ``eager``: sort-based ``unique_combine`` before the shuffle; a second
      ``unique_combine`` + ``hashmap_insert`` merges what arrives.
    * ``pallas``: the hash-aggregation kernel for both combines — raw pairs
      into a fresh table before the shuffle (duplicates fold in the kernel),
      received pairs straight into the target shard's table (``init=``).
    * ``naive``: every raw pair ships; the destination reduces.

    ``key_range`` (keys known to lie in ``[0, key_range)``) narrows the
    bucket keys on the wire and sizes the kernel's combine table by the
    distinct-key bound.  ``tuned`` pins K2's pre-shuffle table (capacity and
    probe depth, only offered with a ``key_range``, so the pinned capacity
    holds every distinct key) and both calls' table of hot keys.  Returns
    ``(stage, kernel_meta)``.
    """
    from repro_torch.kernels import hash_combine as HK

    use_kernel = engine == "pallas" and red.pallas_hash is not None
    pinned = tuned if use_kernel and tuned is not None and tuned.engine == "pallas" else None
    hot = {} if pinned is None or pinned.table_bits is None else {"table_bits": pinned.table_bits}
    kernel_meta: dict = {}

    def per_shard(fn, *args):
        """Run ``fn`` on each shard's slice of ``args`` and stack each output."""
        outs = [fn(*(a[s] for a in args)) for s in range(args[0].shape[0])]
        return tuple(torch.stack(col) for col in zip(*outs))

    def stage(env, table, local, coll):
        # shapes are this process's ``n_local`` shards; ownership and the
        # bucket sizes the mesh's ``n_dest`` shards
        n_local, n_dest, dev = coll.n_local, coll.n_shards, coll.device
        entries, _ = _run_mapper_structured(kind, source, mapper, coll, local, env)
        keys, vals, valid = _flatten_entries(entries, n_local)
        vals = vals.to(val_dtype)
        n_emit = keys.shape[1]
        val_shape = tuple(vals.shape[2:])
        live_emitted = valid.sum(1).to(torch.int32)
        kernel_pairs = torch.zeros(n_local, dtype=torch.int32, device=dev)
        pre_drop = torch.zeros(n_local, dtype=torch.int32, device=dev)

        if use_kernel:
            # Kernel local combine: raw pairs → a fresh table whose live rows
            # *are* the locally reduced pairs (at most one per key).
            if pinned is not None and pinned.table_cap:
                cap = pinned.table_cap
                probes = min(cap, pinned.probe_depth or cost.choose_probe_depth(n_emit, cap))
            else:
                cap = cost.table_capacity(n_emit, key_range)
                probes = cost.choose_probe_depth(n_emit, cap)
            keys, tvals, pre_drop = per_shard(
                lambda k, v: red.pallas_hash(k, v.contiguous(), cap,
                                             max_probes=probes, **hot),
                torch.where(valid, keys, HK.EMPTY_KEY),
                vals.reshape(n_local, n_emit, -1),
            )
            valid = keys != HK.EMPTY_KEY
            vals = tvals.reshape((n_local, cap) + val_shape).to(val_dtype)
            kernel_pairs = live_emitted
            kernel_meta.update(block_n=THREADS, lanes=n_emit * n_dest,
                               table_cap=cap, probe_depth=probes)
        elif engine == "eager":
            keys, vals, valid = per_shard(
                lambda k, v, m: C.unique_combine(k, v, m, red), keys, vals, valid
            )
        live_shipped = valid.sum(1).to(torch.int32)

        n_stream = keys.shape[1]
        bucket_cap = max(1, int(math.ceil(slack * n_emit / n_dest)))
        bucket_cap = min(bucket_cap, n_stream)
        ident = red.identity(vals.dtype)
        bkeys, bvals, dropped = per_shard(
            lambda k, v, m: bucket_by_dest(k, v, m, n_dest, bucket_cap, ident),
            keys, vals, valid,
        )
        # Narrowed keys on the wire: the smallest int dtype covering
        # [0, key_range); EMPTY_KEY maps to that dtype's min and back.
        wire_dtype = _wire_key_dtype(key_range)
        if wire_dtype.itemsize < 4:
            sentinel = torch.iinfo(wire_dtype).min
            nk = torch.where(bkeys == C.EMPTY_KEY, sentinel, bkeys).to(wire_dtype)
            rkeys = coll.all_to_all_tiled(nk).to(torch.int32).reshape(n_local, -1)
            rkeys = torch.where(rkeys == sentinel, C.EMPTY_KEY, rkeys)
        else:
            rkeys = coll.all_to_all_tiled(bkeys).reshape(n_local, -1)
        rvals = coll.all_to_all_tiled(bvals)
        rvals = rvals.reshape((n_local, -1) + tuple(rvals.shape[3:]))
        rvalid = rkeys != C.EMPTY_KEY
        cap_t = table.capacity
        overflow = table.overflow + dropped + pre_drop
        merge_probes = max(16, cost.choose_probe_depth(rkeys.shape[1], cap_t))
        if use_kernel:
            # Kernel merge into the target shard's table: received pairs may
            # repeat across source shards, and the kernel folds duplicates.
            tkeys, tvals, overflow = per_shard(
                lambda k, v, tk, tv, o: red.pallas_hash(
                    k, v.contiguous(), cap_t, init=(tk, tv.reshape(cap_t, -1), o),
                    max_probes=merge_probes, **hot,
                ),
                torch.where(rvalid, rkeys, HK.EMPTY_KEY),
                rvals.to(val_dtype).reshape(n_local, rkeys.shape[1], -1),
                table.keys, table.vals, overflow,
            )
            table = C.HashTable(
                tkeys, tvals.reshape(table.vals.shape).to(val_dtype), overflow
            )
        else:
            def merge(k, v, m, tk, tv, o):
                uk, uv, um = C.unique_combine(k, v, m, red)
                t = C.hashmap_insert(C.HashTable(tk, tv, o), uk, uv, um, red,
                                     max_probes=merge_probes)
                return t.keys, t.vals, t.overflow

            table = C.HashTable(*per_shard(
                merge, rkeys, rvals, rvalid, table.keys, table.vals, overflow
            ))
        return table, live_emitted, live_shipped, kernel_pairs

    return stage, kernel_meta


def _map_reduce_hash(kind, source, mapper, red: Reducer, target, mesh: C.Mesh,
                     engine: str, slack: float, env,
                     key_range: int | None = None, cache: dict | None = None,
                     node=None, tuned=None):
    """DistHashMap target: local combine → hash-partition → all_to_all →
    merge.  Never hierarchical: the all_to_all is point to point."""
    if engine not in ("eager", "pallas", "naive"):
        raise ValueError(f"unknown engine {engine!r}")
    _require_rank_rows(mesh, kind, source, target)
    cache = cache if cache is not None else {}
    cache_key = (
        "hash", mapper, red.name, red, engine, slack, *mesh_key(mesh),
        kind, key_range, abstract_sig(_source_operands(kind, source)),
        _source_extent(kind, source),
        abstract_sig((target.table.keys, target.table.vals)), abstract_sig(env), tuned,
    )
    if node is not None:
        node.cache_sig = cache_key
    entry = cache.get(cache_key)
    compiled_now = entry is None
    if compiled_now:
        entry = cache[cache_key] = CachedStage(*hash_shard_stage(
            kind, source, mapper, red, target.table.vals.dtype, engine, slack,
            key_range=key_range, tuned=tuned,
        ))
    kernel_meta = entry.kernel_meta
    faults.fault_point("dispatch")
    if engine == "pallas":
        faults.fault_point("kernel.hash")
    table, emitted, shipped, kernel_pairs = entry.run(
        mesh, env, target.table, _local_view(kind, source))
    out = C.DistHashMap(table, reducer_name=red.name, mesh=target.mesh)
    emitted, shipped, kernel_pairs, overflow = _gather_stats(
        mesh, emitted, shipped, kernel_pairs, table.overflow)
    val_bytes = target.table.vals.element_size()
    key_bytes = _wire_key_dtype(key_range).itemsize
    payload = shipped.sum() * (key_bytes + val_bytes)
    intra, inter = split_by_link(
        payload, inter_node_fraction(mesh.n_shards, mesh.n_nodes, peers=False))
    stats = MapReduceStats(
        engine=engine,
        collective=f"all_to_all[pairs x {key_bytes + val_bytes}B]",
        pairs_emitted=emitted,
        pairs_shipped=shipped,
        shuffle_payload_bytes=payload,
        intra_bytes=intra,
        inter_bytes=inter,
        overflow=overflow,
        compiles=int(compiled_now),
        cache_hits=int(not compiled_now),
        kernel_block_n=kernel_meta.get("block_n"),
        kernel_lanes=kernel_meta.get("lanes"),
        kernel_pairs=kernel_pairs if kernel_meta else None,
        kernel_table_cap=kernel_meta.get("table_cap"),
        kernel_probe_depth=kernel_meta.get("probe_depth"),
        plan_hash=node.hash if node is not None else None,
    )
    return out, stats
