"""The Blaze logical-plan IR: explicit plans, the resolve-engines pass,
EXPLAIN.

The counterpart of ``repro/core/plan.py``.  A Blaze job written as
``map_reduce`` calls is a call tree one can only run; a ``Plan`` makes it a
DAG one can optimise and render:

* ``Plan`` — :class:`MapReduceNode` / :class:`ForeachNode` /
  :class:`ContainerOpNode` / :class:`GlueNode` nodes in call order, the
  source table, batch groups and what the passes did.
  ``repro_torch.core.program`` builds one while it discovers a step
  function; standalone ``map_reduce`` builds a one-node plan through the same
  :func:`build_mapreduce_node`, so an op has one hash in both spellings.
* **Passes** — ``resolve-engines`` (:func:`resolve_engine`, per node, so one
  program can mix engines), and three that ``program.ProgramContext`` runs
  while it records: ``cse``, ``batch-collectives`` and
  ``prune-dead-sources``.
* ``Plan.render()`` — the Spark-``EXPLAIN`` analogue; the JAX package's
  golden snapshots (``tests/goldens/``) hold it line for line, apart from the
  hash and the cost figures.

Measured autotuning (``apply_tuned``: a ``TuningCache`` winner pins a node's
engine and kernel launch, keyed by ``MapReduceNode.tune_key``, the node's hash
before any override) runs in ``build_mapreduce_node``, and so does fault
degradation: a node whose ``tune_key`` the session has degraded after a
kernel fault is born eager (``degrade_node``).  So does the
``hierarchical-collectives`` pass (``apply_hierarchical``): on a multi-node
mesh an eligible dense reduce becomes the two-hop one, before ``tune_key``
is taken, so a hierarchical node never inherits a flat node's winner.  On a
1-node mesh it is a no-op, and every plan hash and EXPLAIN line is what it
was before the pass existed.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import containers as C
from repro_torch.core import cost
from repro_torch.core.cost import TunedConfig, TuningCache
from repro_torch.core.reducers import Reducer

ENGINES = ("eager", "pallas", "naive", "auto")

# The optional passes a Program runs by default, in order; resolve-engines
# always runs (a node without a resolved engine cannot run).
DEFAULT_PASSES = ("cse", "batch-collectives", "prune-dead-sources")


def node_key_count(target) -> int:
    """Accumulator rows ``k`` the engine choice is priced by: the dense key
    range, or the hash table's per-shard capacity.  0 when unknowable."""
    if isinstance(target, C.DistHashMap):
        return target.capacity_per_shard
    t = torch.as_tensor(target)
    return t.shape[0] if t.dim() else 0


def resolve_engine(engine: str, target, reducer: Reducer) -> str:
    """The resolve-engines pass for one node: ``"auto"`` asks
    ``cost.pick_engine``; a custom reducer, which has no kernel, turns
    ``"pallas"`` (and ``"auto"``) into ``"eager"``, so the engine reported in
    ``MapReduceStats`` and on the plan node is the plan that ran."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    hash_target = isinstance(target, C.DistHashMap)
    kernel = reducer.pallas_hash if hash_target else reducer.pallas_segment
    if engine == "pallas" and kernel is None:
        return "eager"
    if engine != "auto":
        return engine
    if kernel is None:
        return "eager"
    return cost.pick_engine(node_key_count(target))


def abstract_sig(tree) -> tuple:
    """Hashable (structure, shapes/dtypes/devices) signature of a pytree."""
    leaves, spec = pytree.tree_flatten(tree)
    return str(spec), tuple(
        (tuple(x.shape), dtype_name(x.dtype), str(x.device))
        if isinstance(x, torch.Tensor) else type(x).__name__
        for x in leaves
    )


def dtype_name(dt: torch.dtype) -> str:
    """numpy's name of a torch dtype (``float32``), as the JAX plans print."""
    return str(dt).removeprefix("torch.")


def _fn_name(fn: Callable) -> str:
    mod = getattr(fn, "__module__", "?")
    qual = getattr(fn, "__qualname__", getattr(fn, "__name__", repr(fn)))
    return f"{mod}.{qual}"


def _sig_desc(sig: tuple) -> str:
    """Render an ``abstract_sig`` compactly and deterministically."""
    _, leaves = sig
    if not leaves:
        return "-"
    return ",".join(
        f"{leaf[1]}[{'x'.join(map(str, leaf[0]))}]" if isinstance(leaf, tuple)
        else leaf
        for leaf in leaves
    )


def _shape(t) -> str:
    return "x".join(map(str, t.shape))


def source_desc(kind: str, source) -> str:
    """Stable human-readable description of a plan source."""
    if kind == "range":
        return f"range[{source.start}:{source.stop}:{source.step}]"
    if kind == "vector":
        d = source.data
        shape = tuple(d.shape)
        mesh = getattr(source, "mesh", None)
        if mesh is not None and mesh.process:  # the mesh's rows, not this rank's
            shape = (shape[0] * mesh.n_ranks,) + shape[1:]
        return f"vector {dtype_name(d.dtype)}[{'x'.join(map(str, shape))}] n={source.n}"
    if kind == "chunked":
        # the dataset's blocks, whichever rows of them this rank holds
        tail = "x".join(map(str, source.shape_tail))
        shape = f"{source.block_rows}{'x' + tail if tail else ''}"
        return (f"chunked {dtype_name(source.dtype)}[{shape}] n={source.n} "
                f"blocks={source.n_blocks}")
    t = source.table
    return (f"hashmap cap={t.keys.shape[-1]} "
            f"{dtype_name(t.vals.dtype)}[{'x'.join(map(str, t.vals.shape[2:]))}]")


@dataclasses.dataclass
class SourceInfo:
    """One entry of the plan's source table."""

    key: tuple  # identity key (program._source_key)
    desc: str  # stable rendering for explain/hash
    source: Any  # the container object
    pruned: bool = False  # no live node reads it


@dataclasses.dataclass
class MapReduceNode:
    """One MapReduce op: sources, reducer, target, wire, and what the passes
    decided for it (engine, batch group, CSE, deadness)."""

    idx: int  # call-order index within the plan
    kind: str  # source kind: range | vector | chunked | hashmap (incl. program-locals)
    src: str  # stable source description ("local[i]" for program locals)
    source_key: tuple | None  # source-table key (None for program locals)
    mapper: Callable
    reducer: str
    target_kind: str  # "dense" | "hash"
    target_desc: str  # e.g. "dense float32[4x3]" / "hash cap=256 int32"
    engine_requested: str
    engine: str  # after the resolve-engines pass
    wire: str
    key_range: int | None = None
    env_sig: tuple = ()
    feedback: bool = False  # int8 error-feedback sum (never batched/CSE'd)
    residual_spec: tuple | None = None  # (shape, dtype) when feedback
    # -- pass annotations ----------------------------------------------------
    group: int | None = None  # batched-collective group id (size > 1 only)
    cse_of: int | None = None  # idx of the identical earlier node it reuses
    dead: bool = False  # result provably unused -> op pruned
    collective: str = ""  # what carries this op's shuffle
    cache_sig: tuple | None = None  # the session's stage-cache key of this op
    # -- cost-model and tuning annotations, outside stable_desc: the tuning
    # cache is keyed by the hash of the untuned node, so applying a winner
    # must not move the key it was cached under -------------------------------
    cost_estimate: float | None = None  # cost.node_cost of the resolved engine
    tune_key: str = ""  # node hash at resolve time, before any tuned override
    tuned: TunedConfig | None = None  # the applied winner (measured or loaded)
    # -- fault supervision: the engine a kernel fault degraded this node from
    # (None: never degraded).  Outside stable_desc, like tuned, but the
    # degradation rewrites ``engine``, which is inside it.
    degraded_from: str | None = None
    # -- the hierarchical-collectives pass: True when the node's collective
    # was rewritten to the two-hop (intra-node full precision, inter-node
    # wire) reduce.  In stable_desc only when set, so a 1-node plan hashes
    # and renders as before the pass existed.
    hier: bool = False

    def stable_desc(self) -> str:
        desc = (
            f"map_reduce {self.reducer} fn={_fn_name(self.mapper)} "
            f"src={self.kind}:{self.src} "
            f"-> {self.target_desc} engine={self.engine} wire={self.wire} "
            f"key_range={self.key_range} env={_sig_desc(self.env_sig)}"
        )
        return desc + " hier" if self.hier else desc

    @property
    def hash(self) -> str:
        """Stable digest of everything that shapes this op's plan, equal for
        the per-op and program spellings of the same op."""
        return hashlib.sha1(self.stable_desc().encode()).hexdigest()[:12]


@dataclasses.dataclass
class ForeachNode:
    """Elementwise map over a vector source; output stays shard-local."""

    idx: int
    src: str
    source_key: tuple | None
    fn: Callable

    def stable_desc(self) -> str:
        return f"foreach src={self.src} fn={_fn_name(self.fn)}"


@dataclasses.dataclass
class ContainerOpNode:
    """A container-level plan node (``topk``): the container fixes its plan,
    so an ``engine=`` request is recorded and shown as ignored."""

    idx: int
    op: str  # "topk"
    src: str
    source_key: tuple | None
    params: str  # e.g. "k=100 score=_neg_sq_dist"
    engine_requested: str | None = None  # surfaced, never applied

    def stable_desc(self) -> str:
        return f"{self.op} src={self.src} {self.params}"


@dataclasses.dataclass
class GlueNode:
    """The user's elementwise glue between ops (opaque)."""

    idx: int
    desc: str

    def stable_desc(self) -> str:
        return f"glue {self.desc}"


@dataclasses.dataclass
class Plan:
    """An optimised logical plan: what ``session.explain`` renders and what a
    ``Program`` runs.  ``collectives_per_iter`` counts collective calls, the
    reference's model, whatever a call moves: across processes a reduce
    all-gathers its partials (``core.collectives.ProcessCollectives``), two
    gathers for the int8 wire's lattice and scales."""

    nodes: list
    sources: list[SourceInfo]
    state_desc: str
    n_shards: int
    passes: tuple[str, ...]
    n_nodes: int = 1  # node rows of the mesh (1: a 1-D mesh)
    groups: dict[int, list[int]] = dataclasses.field(default_factory=dict)
    group_keys: dict[int, tuple] = dataclasses.field(default_factory=dict)
    collectives_per_iter: int = 0  # after batching/CSE/pruning
    collectives_unbatched: int = 0  # the same plan, one collective per op
    cse_hits: int = 0
    dead_ops: int = 0
    pruned_sources: int = 0
    residual_specs: list[tuple] = dataclasses.field(default_factory=list)
    hash_targets: dict = dataclasses.field(default_factory=dict)
    # node idx -> (target_kind, k, v, reducer_name, dtype, key_range,
    # has_kernel): what the program autotuner needs to build each node's
    # candidate grid without rediscovering.  Not part of the plan hash.
    tune_info: dict = dataclasses.field(default_factory=dict)

    @property
    def hash(self) -> str:
        """Stable digest of the whole optimised plan (nodes, live sources,
        state, groups)."""
        parts = [self.state_desc, f"shards={self.n_shards}"]
        if self.n_nodes > 1:  # absent on a 1-D mesh: its hashes are unchanged
            parts.append(f"nodes={self.n_nodes}")
        parts += [n.stable_desc() for n in self.nodes]
        parts += [s.desc for s in self.sources if not s.pruned]
        parts += [f"group{g}={idxs}" for g, idxs in sorted(self.groups.items())]
        return hashlib.sha1("\n".join(parts).encode()).hexdigest()[:12]

    def live_sources(self) -> list[SourceInfo]:
        return [s for s in self.sources if not s.pruned]

    def mapreduce_nodes(self) -> list[MapReduceNode]:
        return [n for n in self.nodes if isinstance(n, MapReduceNode)]

    # -- EXPLAIN -------------------------------------------------------------

    def render(self, title: str = "Blaze logical plan") -> str:
        mesh = (f"node[{self.n_nodes}]×data[{self.n_shards // self.n_nodes}]"
                if self.n_nodes > 1 else f"data[{self.n_shards}]")
        lines = [f"== {title} (hash {self.hash}) ==",
                 f"mesh: {mesh}",
                 f"state: {self.state_desc}",
                 "passes: resolve-engines"
                 + (", hierarchical-collectives" if self.n_nodes > 1 else "")
                 + "".join(f", {p}" for p in self.passes),
                 "nodes:"]
        for n in self.nodes:
            flags = []
            if isinstance(n, MapReduceNode):
                if n.dead:
                    flags.append("DEAD (pruned)")
                if n.cse_of is not None:
                    flags.append(f"CSE -> node [{n.cse_of}]")
                if n.group is not None:
                    flags.append(f"group {chr(ord('A') + n.group)}")
                if n.feedback:
                    flags.append("int8 feedback")
                if n.degraded_from is not None:
                    flags.append(f"degraded {n.degraded_from!r} -> {n.engine!r} "
                                 "(kernel fault)")
                elif n.engine_requested != n.engine and n.tuned is None:
                    flags.append(f"requested {n.engine_requested!r}")
                if n.tuned is not None:
                    cfg = n.tuned
                    wall = f" {cfg.wall_s * 1e3:.2f}ms" if cfg.wall_s is not None else ""
                    flags.append(f"tuned {cfg.source}: {cfg.describe()}{wall}")
                mapper_name = _fn_name(n.mapper).rsplit(".", 1)[-1]
                body = (
                    f"map_reduce {n.reducer:<4} fn={mapper_name} "
                    f"src={n.kind}:{n.src} -> "
                    f"{n.target_desc}  engine={n.engine} wire={n.wire}"
                )
                if n.cost_estimate is not None:
                    body += f" cost~{int(n.cost_estimate)}"
                if n.key_range is not None:
                    body += f" key_range={n.key_range}"
                if n.collective and not n.dead and n.cse_of is None:
                    body += f"  via {n.collective}"
            elif isinstance(n, ForeachNode):
                body = f"foreach    src={n.src}  fn={_fn_name(n.fn).rsplit('.', 1)[-1]}"
            elif isinstance(n, ContainerOpNode):
                body = f"{n.op:<10} src={n.src}  {n.params}"
                if n.engine_requested and n.engine_requested != "auto":
                    flags.append(f"engine={n.engine_requested!r} ignored "
                                 "(container-level plan)")
            else:
                body = f"glue       {n.desc}"
            suffix = f"   [{'; '.join(flags)}]" if flags else ""
            lines.append(f"  [{n.idx}] {body}{suffix}")
        if self.sources:
            lines.append("sources:")
            for s in self.sources:
                mark = "  (pruned: no live consumer)" if s.pruned else ""
                lines.append(f"  - {s.desc}{mark}")
        stream = [s for s in self.sources
                  if not s.pruned and s.desc.startswith("chunked ")]
        if stream:
            lines.append("stream schedule (out-of-core, one graph):")
            for s in stream:
                mesh = getattr(s.source, "mesh", None)
                rows = (f"{s.source.block_rows} rows each" if mesh is None else
                        f"{s.source.block_rows} rows each, {s.source.local_rows} "
                        f"on each of {mesh.n_ranks} ranks")
                lines.append(
                    f"  - {s.desc}: {s.source.n_blocks} block dispatches of {rows}; "
                    "block k+1 copied host->device on a copy stream while block k "
                    "replays")
        if self.groups:
            lines.append("batched collective groups:")
            for g, idxs in sorted(self.groups.items()):
                # (reducer, wire, dtype, hier): a group never mixes
                # hierarchical and flat reduces
                red, wire, dt, hier = self.group_keys.get(g, ("?", "?", "?", False))
                lines.append(f"  {chr(ord('A') + g)}: {red}/{wire}/{dt}"
                             + ("/hier" if hier else "")
                             + f" carries nodes {idxs} ({len(idxs)} collectives -> 1)")
        lines.append(
            f"collectives/iter: {self.collectives_per_iter} "
            f"(unbatched: {self.collectives_unbatched})"
            + (f"; cse hits: {self.cse_hits}" if self.cse_hits else "")
            + (f"; dead ops pruned: {self.dead_ops}" if self.dead_ops else "")
            + (f"; sources pruned: {self.pruned_sources}" if self.pruned_sources else "")
        )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Node builders (shared by the per-op and program paths)
# ---------------------------------------------------------------------------


def target_desc_of(target) -> tuple[str, str]:
    """(target_kind, stable description) for a dense tensor or DistHashMap."""
    if isinstance(target, C.DistHashMap):
        t = target.table
        return "hash", f"hash cap={t.keys.shape[-1]} {dtype_name(t.vals.dtype)}"
    t = torch.as_tensor(target)
    return "dense", f"dense {dtype_name(t.dtype)}[{_shape(t)}]"


def hier_collective_desc(reducer_name: str, wire: str) -> str:
    """EXPLAIN's rendering of a hierarchical collective, e.g.
    ``psum[node×data, hier, wire=int8@inter]``: the intra-node hop always
    runs at full precision; ``@inter`` marks where the wire narrows."""
    op = "psum" if reducer_name == "sum" else f"{reducer_name}-reduce"
    desc = f"{op}[node×data, hier"
    if wire != "none" and reducer_name == "sum":
        desc += f", wire={wire}@inter"
    return desc + "]"


def apply_tuned(node: MapReduceNode, red: Reducer, cfg: TunedConfig) -> None:
    """Apply a tuning-cache winner to a freshly built node: its engine
    replaces the resolved one (when the reducer has the kernel the config
    asks for) and the config pins the kernel's launch in the stage builders.
    ``tune_key`` was taken before, so the node's key is unchanged."""
    kernel = red.pallas_hash if node.target_kind == "hash" else red.pallas_segment
    if cfg.engine == "pallas" and kernel is None:
        return  # a custom reducer: the config has no kernel to pin
    node.engine = cfg.engine
    node.tuned = cfg


def apply_hierarchical(node: MapReduceNode, n_nodes: int) -> bool:
    """The ``hierarchical-collectives`` pass, applied per node: an eligible
    node's collective becomes the two-hop reduce, each node's shards at full
    precision over the fast links, then the node partials over the slow
    hop, the only one a wire narrows.  Eligible: dense targets on the eager
    or kernel plan (``naive`` all-gathers raw pairs and a hash target
    shuffles point to point, neither has a reduction tree to reshape).  A
    no-op on a 1-node mesh.  Batched groups carry their members' shared
    ``hier`` flag through one concatenated two-hop reduce."""
    if n_nodes <= 1 or node.target_kind != "dense" or node.engine not in ("eager", "pallas"):
        return False
    node.hier = True
    node.collective = hier_collective_desc(node.reducer, node.wire)
    return True


def degrade_node(node: MapReduceNode) -> None:
    """Degrade a kernel-faulted node to the always-available eager engine:
    record where it came from (EXPLAIN, ``MapReduceStats.degraded_engine``)
    and drop its tuned config (a pinned kernel launch cannot run the eager
    plan).  The new ``engine`` moves the node's hash and stage-cache key, so
    the eager stage caches beside, never over, the faulted one; ``tune_key``
    was taken before and stays."""
    if node.engine == "eager":
        return
    node.degraded_from = node.engine
    node.engine = "eager"
    node.tuned = None


def build_mapreduce_node(idx: int, kind: str, src: str, source_key: tuple | None,
                         mapper: Callable, red: Reducer, target, engine: str,
                         wire: str, key_range: int | None, env: Any,
                         tuning: TuningCache | None = None,
                         degraded: set | None = None, n_nodes: int = 1,
                         hierarchical: bool = True) -> MapReduceNode:
    """Build a MapReduce node and run the resolve-engines pass on it: the one
    node constructor of ``BlazeSession.map_reduce`` and of every program
    node, which is why both give one op the same hash.  On a multi-node
    mesh (``n_nodes > 1``) the ``hierarchical-collectives`` pass runs here
    too, unless the caller keeps the flat collective (``hierarchical=False``,
    the A/B baseline), and before ``tune_key`` is taken.  With a ``tuning``
    cache, a winner cached under the node's untuned hash is applied; a node
    whose ``tune_key`` is in ``degraded`` (the session's kernel-faulted
    nodes) is born eager, so it reuses the stage its recovery built."""
    target_kind, tdesc = target_desc_of(target)
    if target_kind == "hash":
        wire = "none"  # wire narrowing is a dense-target concept
    resolved = resolve_engine(engine, target, red)
    if target_kind == "dense":
        t = torch.as_tensor(target)
        vb = {"bf16": 2, "int8": 1}.get(wire, t.element_size())
        if resolved == "naive":
            collective = "all_gather[raw pairs]"
        elif red.name == "sum":
            collective = f"psum[{t.numel()}x{vb}B]"
        else:
            collective = f"{red.name}-reduce[{t.numel()}]"
    else:
        from repro_torch.core.serialization import narrowest_int_dtype

        kb = narrowest_int_dtype(key_range).itemsize if key_range is not None else 4
        collective = f"all_to_all[pairs x {kb + target.table.vals.element_size()}B]"
    node = MapReduceNode(
        idx=idx, kind=kind, src=src, source_key=source_key, mapper=mapper,
        reducer=red.name, target_kind=target_kind, target_desc=tdesc,
        engine_requested=engine, engine=resolved, wire=wire,
        key_range=key_range, env_sig=abstract_sig(env), collective=collective,
    )
    if hierarchical:
        apply_hierarchical(node, n_nodes)
    if resolved in ("eager", "pallas"):
        node.cost_estimate = cost.node_cost(resolved, node_key_count(target))
    node.tune_key = node.hash  # identity before any tuned override
    if tuning is not None:
        cfg = tuning.get(node.tune_key)
        if cfg is not None:
            apply_tuned(node, red, cfg)
    if degraded and node.tune_key in degraded:
        degrade_node(node)
    return node


def single_op_plan(node: MapReduceNode, n_shards: int, n_nodes: int = 1) -> Plan:
    """The standalone ``map_reduce`` path: one op is a one-node plan."""
    return Plan(nodes=[node], sources=[], state_desc="-", n_shards=n_shards,
                n_nodes=n_nodes, passes=(), collectives_per_iter=1,
                collectives_unbatched=1)
