"""Prepared queries: named, parameterised Blaze programs the server serves
(the port of ``repro/serve/queries.py``).

A client cannot ship a Python mapper over the wire; what it *can* ship is a
name plus parameters — the prepared-statement model.  A :class:`QuerySpec`
is the server-side half of that contract:

* ``plan_key(params)`` — validate the parameters and return the query's
  **structural identity**: everything that shapes the compiled program
  (dataset, key counts, engine, wire format, damping baked into glue...).
  Two requests with equal plan keys share ONE resident program and can
  micro-batch into one dispatch.  Non-structural parameters (iteration
  counts, query points and seeds, which flow through ``state``) stay out
  of the key: that is what makes "same plan, different inputs" coalescible.
* ``prepare(res, params)`` — build the :class:`PreparedQuery` once per plan
  key: the ``session.program`` (plan discovered, optimizer passes run,
  ``plan_hash`` taken from the optimized plan), a ``run`` that dispatches
  one request's state through it WITHOUT any host sync, and a ``finish``
  that materialises the host payload after the batch-level sync.

Where the port differs from the reference:

* **``iters`` is not captured.**  The reference traces the trip count, so
  requests that differ only in ``iters`` share one executable.  On the card
  a program captures one CUDA graph per (state signature, iterations a
  dispatch), so ``run`` dispatches the plan's one-iteration graph ``iters``
  times, each replay's state (cloned out of the graph) feeding the next and
  the carry (hash tables, int8 residuals) threading through the replays in
  place.  A plan key costs one capture whatever ``iters`` its requests
  send; on the CPU the same loop runs the planned step eagerly.
* **Per-request state moves without a host sync.**  What a request brings
  from the host (k-means' and GMM's initial centres, kNN's query point) is
  built on the host, as the reference builds it, into pinned memory and
  copied with ``non_blocking=True`` (``_to_device``); everything else is
  made on the device (``torch.full``, ``torch.zeros``).  A pageable copy
  would wait for every replay queued before it.
* ``ServeResources`` holds the session and the mesh the server runs on
  (the session's unless the server names another), with its device and
  shard count; ``run_direct`` takes no mesh: it runs on the session's.

The six paper algorithms are provided as built-ins, reusing each driver's
``_program_step`` — the serving path and the direct ``session`` path lower
literally the same plan, which is why ``run_direct`` (the reference used by
``tests/test_torch_serve.py``) is bit-equal to served results on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable

import numpy as np
import torch

# The algorithms package __init__ rebinds submodule names to driver
# functions, so pull each planned step straight from its module.
from repro_torch.core.algorithms.gmm import _program_step as _gmm_step
from repro_torch.core.algorithms.kmeans import _program_step as _kmeans_step
from repro_torch.core.algorithms.knn import _program_step as _knn_step
from repro_torch.core.algorithms.pagerank import _program_step as _pagerank_step
from repro_torch.core.algorithms.pi import _program_step as _pi_step
from repro_torch.core.algorithms.wordcount import _program_step as _wordcount_step
from repro_torch.core.plan import ENGINES
from repro_torch.core.session import _sync
from repro_torch.serve.admission import (
    BadParamsError,
    UnknownDatasetError,
)

__all__ = [
    "BUILTIN_SPECS",
    "DatasetEntry",
    "PreparedQuery",
    "QuerySpec",
    "ServeResources",
    "builtin_specs",
    "canonical_params",
    "run_direct",
]


def canonical_params(params: dict) -> str:
    """Deterministic rendering of a params dict (the dedup half of
    ``Request.exec_key``)."""
    return json.dumps(params, sort_keys=True, separators=(",", ":"))


@dataclasses.dataclass
class DatasetEntry:
    """One resident dataset: the raw host value plus registration metadata
    (e.g. ``n_pages`` for an edge list, ``vocab_size`` for token lines)."""

    name: str
    value: np.ndarray
    meta: dict


class ServeResources:
    """What ``prepare`` sees: the resident session, the mesh the queries run
    on (its ``device`` and ``n_shards``; the session's by default), the
    dataset table, and a cache for *derived* distributed objects (the
    ``DistVector`` built from a dataset must be built once and reused —
    program source identity is keyed on the backing tensors)."""

    def __init__(self, session, datasets: dict[str, DatasetEntry],
                 tune: bool = False, mesh=None):
        self.session = session
        self.mesh = mesh if mesh is not None else session.mesh
        self.device = self.mesh.device
        self.n_shards = self.mesh.n_shards
        self.datasets = datasets
        self.tune = tune  # first-prepare autotuning for every built program
        self._derived: dict[tuple, Any] = {}

    def dataset(self, name) -> DatasetEntry:
        if not isinstance(name, str):
            raise BadParamsError(f"dataset must be a string, got {name!r}")
        entry = self.datasets.get(name)
        if entry is None:
            raise UnknownDatasetError(
                f"no dataset {name!r}; registered: {sorted(self.datasets)}"
            )
        return entry

    def derived(self, key: tuple, build: Callable[[], Any]):
        if key not in self._derived:
            self._derived[key] = build()
        return self._derived[key]


@dataclasses.dataclass
class PreparedQuery:
    """A resident query: the program plus its run/finish halves.

    ``run(params)`` dispatches one request through the program and returns a
    pytree of *device* values — it must not block on the host (the
    dispatcher syncs once per micro-batch).  ``finish(dev)`` runs after that
    sync and shapes the host payload.
    """

    plan_key: tuple
    plan_hash: str
    program: Any
    run: Callable[[dict], Any]
    finish: Callable[[Any], dict]


class QuerySpec:
    """Base query spec; subclass or instantiate the built-ins below."""

    name: str = "?"

    def plan_key(self, params: dict) -> tuple:
        raise NotImplementedError

    def prepare(self, res: ServeResources, params: dict) -> PreparedQuery:
        raise NotImplementedError


# -- parameter validation helpers ---------------------------------------------


def _int(params: dict, key: str, default: int, lo: int) -> int:
    v = params.get(key, default)
    if not isinstance(v, int) or isinstance(v, bool) or v < lo:
        raise BadParamsError(f"{key} must be an int >= {lo}, got {v!r}")
    return v


def _float(params: dict, key: str, default: float) -> float:
    v = params.get(key, default)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise BadParamsError(f"{key} must be a number, got {v!r}")
    return float(v)


def _engine(params: dict, default: str = "eager") -> str:
    v = params.get("engine", default)
    if v not in ENGINES:
        raise BadParamsError(f"unknown engine {v!r}; choose from {ENGINES}")
    return v


def _wire(params: dict) -> str:
    v = params.get("wire", "none")
    if v not in ("none", "bf16", "int8"):
        raise BadParamsError(f"unknown wire {v!r}")
    return v


# -- dispatch helpers ----------------------------------------------------------


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device`` with no host sync: on the card
    staged in pinned memory and copied with ``non_blocking=True`` (the
    caching host allocator keeps the pinned block until the copy has run)."""
    t = torch.from_numpy(np.array(a, copy=True))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _iterate(prog, state, iters: int):
    """``iters`` dispatches of one iteration each, chaining the state: one
    graph a plan on the card whatever ``iters`` is (module docstring)."""
    for _ in range(iters):
        state = prog(state, 1)
    return state


# -- built-in specs: the paper's six algorithms as prepared queries ------------


class PiQuery(QuerySpec):
    """Monte-Carlo π.  Structural: sample count + engine (the DistRange and
    plan depend on both)."""

    name = "pi"

    def plan_key(self, params):
        return ("pi", _int(params, "n_samples", 4096, 1), _engine(params))

    def prepare(self, res, params):
        n = _int(params, "n_samples", 4096, 1)
        step, state0 = _pi_step(n, _engine(params), res.device)
        prog = res.session.program(step, tune=res.tune, mesh=res.mesh)
        plan = prog.build(state0)

        def run(p):
            return _iterate(prog, state0, _int(p, "iters", 1, 1))

        def finish(dev):
            counts = dev["counts"].cpu().numpy()
            return {"pi": 4.0 * float(counts[0]) / n, "counts": counts}

        return PreparedQuery(self.plan_key(params), plan.hash, prog, run, finish)


class PageRankQuery(QuerySpec):
    """PageRank over a registered edge-list dataset.  Structural: dataset,
    damping (baked into the fused glue), engine, wire.  Requests differing
    only in ``iters`` share the plan, its one graph, and micro-batch."""

    name = "pagerank"

    def plan_key(self, params):
        return (
            "pagerank", str(params.get("dataset", "edges")),
            _float(params, "damping", 0.85), _engine(params), _wire(params),
        )

    def prepare(self, res, params):
        entry = res.dataset(params.get("dataset", "edges"))
        edges = entry.value
        n_pages = int(entry.meta.get(
            "n_pages", (edges.max() + 1) if edges.size else 1
        ))
        damping = _float(params, "damping", 0.85)

        def build():
            edges_v = res.session.distribute(edges.astype(np.int32), mesh=res.mesh)
            deg = torch.from_numpy(
                np.bincount(edges[:, 0], minlength=n_pages).astype(np.int32)
            ).to(res.device)
            return edges_v, deg

        edges_v, deg = res.derived(("pagerank", entry.name), build)
        step, state0 = _pagerank_step(
            edges_v, deg, n_pages, damping, _engine(params), _wire(params)
        )
        prog = res.session.program(step, tune=res.tune, mesh=res.mesh)
        init = state0(torch.full((n_pages,), 1.0 / n_pages, dtype=torch.float32,
                                 device=res.device))
        plan = prog.build(init)

        def run(p):
            return _iterate(prog, init, _int(p, "iters", 10, 1))

        def finish(dev):
            return {
                "scores": dev["scores"].cpu().numpy(),
                "delta": float(dev["delta"]),
            }

        return PreparedQuery(self.plan_key(params), plan.hash, prog, run, finish)


class WordCountQuery(QuerySpec):
    """Streaming word count over registered token lines (hash target).  The
    hash table is per-program carried state, so the dispatcher resets the
    program carry before every request — queries are isolated even though
    they share one resident program."""

    name = "wordcount"

    def plan_key(self, params):
        return (
            "wordcount", str(params.get("dataset", "lines")), _engine(params),
        )

    def prepare(self, res, params):
        entry = res.dataset(params.get("dataset", "lines"))
        lines = entry.value
        vocab_bound = int(entry.meta.get(
            "vocab_size", (lines.max() + 1) if lines.size else 1
        ))
        lines_v = res.derived(
            ("wordcount", entry.name),
            lambda: res.session.distribute(lines.astype(np.int32), mesh=res.mesh),
        )
        hm = res.session.make_dist_hashmap(
            max(64, 4 * vocab_bound), (), torch.int32, "sum", mesh=res.mesh
        )
        step, state0 = _wordcount_step(
            lines_v, hm, vocab_bound, _engine(params)
        )
        prog = res.session.program(step, tune=res.tune, mesh=res.mesh)
        plan = prog.build(state0)

        def run(p):
            state = _iterate(prog, state0, _int(p, "iters", 1, 1))
            return {"state": state, "hash": prog.hash_result(hm)}

        def finish(dev):
            keys, vals = dev["hash"].items()
            order = np.argsort(keys, kind="stable")
            return {"keys": keys[order], "counts": vals[order]}

        return PreparedQuery(self.plan_key(params), plan.hash, prog, run, finish)


class KMeansQuery(QuerySpec):
    """K-means over a registered point set.  Structural: dataset, k, engine,
    wire.  Seeded initial centres flow through ``state`` (non-structural),
    and so does the trip count."""

    name = "kmeans"

    def plan_key(self, params):
        return (
            "kmeans", str(params.get("dataset", "points")),
            _int(params, "k", 4, 1), _engine(params), _wire(params),
        )

    def prepare(self, res, params):
        entry = res.dataset(params.get("dataset", "points"))
        pts = entry.value
        k = _int(params, "k", 4, 1)
        dim = pts.shape[1]
        pts_v = res.derived(
            ("points", entry.name),
            lambda: res.session.distribute(pts.astype(np.float32), mesh=res.mesh),
        )
        step, state0 = _kmeans_step(
            pts_v, k, dim, _engine(params), _wire(params)
        )
        prog = res.session.program(step, tune=res.tune, mesh=res.mesh)

        def init_for(p):
            rng = np.random.RandomState(_int(p, "seed", 0, 0))
            centers = pts[rng.choice(min(len(pts), 4096), k, replace=False)]
            return state0(_to_device(centers.astype(np.float32), res.device))

        plan = prog.build(init_for(params))

        def run(p):
            return _iterate(prog, init_for(p), _int(p, "iters", 10, 1))

        def finish(dev):
            return {
                "centers": dev["centers"].cpu().numpy(),
                "inertia": float(dev["inertia"]),
            }

        return PreparedQuery(self.plan_key(params), plan.hash, prog, run, finish)


class GMMQuery(QuerySpec):
    """GMM/EM over a registered point set.  Structural: dataset, k, engine."""

    name = "gmm"

    def plan_key(self, params):
        return (
            "gmm", str(params.get("dataset", "points")),
            _int(params, "k", 2, 1), _engine(params),
        )

    def prepare(self, res, params):
        entry = res.dataset(params.get("dataset", "points"))
        pts = entry.value
        k = _int(params, "k", 2, 1)
        n, d = pts.shape

        def build():
            rows0 = np.concatenate(
                [pts, np.zeros((n, k), np.float32)], axis=1
            )
            return res.session.distribute(rows0.astype(np.float32), mesh=res.mesh)

        rows_v = res.derived(("gmm", entry.name, k), build)
        step, state0 = _gmm_step(rows_v, k, d, n, _engine(params))
        prog = res.session.program(step, tune=res.tune, mesh=res.mesh)

        def init_for(p):
            rng = np.random.RandomState(_int(p, "seed", 0, 0))
            mu = pts[rng.choice(n, k, replace=False)].astype(np.float32)
            alpha = np.full(k, 1.0 / k, np.float32)
            sigma = np.tile(np.eye(d, dtype=np.float32), (k, 1, 1))
            return state0(*(_to_device(a, res.device) for a in (alpha, mu, sigma)))

        plan = prog.build(init_for(params))

        def run(p):
            return _iterate(prog, init_for(p), _int(p, "iters", 5, 1))

        def finish(dev):
            return {
                "alpha": dev["alpha"].cpu().numpy(),
                "mu": dev["mu"].cpu().numpy(),
                "sigma": dev["sigma"].cpu().numpy(),
                "log_likelihood": float(dev["ll"]),
            }

        return PreparedQuery(self.plan_key(params), plan.hash, prog, run, finish)


class KNNQuery(QuerySpec):
    """k-nearest-neighbours via the container-level ``topk`` plan.  The
    query point flows through ``state`` — every kNN request against one
    (dataset, k) shares the plan and micro-batches."""

    name = "knn"

    def plan_key(self, params):
        return (
            "knn", str(params.get("dataset", "points")),
            _int(params, "k", 10, 1),
        )

    def prepare(self, res, params):
        entry = res.dataset(params.get("dataset", "points"))
        pts = entry.value
        k = _int(params, "k", 10, 1)
        dim = pts.shape[1]
        pts_v = res.derived(
            ("points", entry.name),
            lambda: res.session.distribute(pts.astype(np.float32), mesh=res.mesh),
        )
        per = pts_v.data.shape[0] // res.n_shards
        kk = min(k, per)
        m = min(k, kk * res.n_shards)
        step = _knn_step(pts_v, k, "auto")
        prog = res.session.program(step, tune=res.tune, mesh=res.mesh)

        def state_for(p):
            q = p.get("query")
            if (
                not isinstance(q, (list, tuple)) or len(q) != dim
                or not all(isinstance(x, (int, float)) for x in q)
            ):
                raise BadParamsError(
                    f"query must be a list of {dim} numbers, got {q!r}"
                )
            return {
                "q": _to_device(np.asarray(q, np.float32), res.device),
                "neighbors": torch.zeros((m, dim), dtype=torch.float32,
                                         device=res.device),
                "scores": torch.full((m,), float("-inf"), dtype=torch.float32,
                                     device=res.device),
            }

        plan = prog.build(state_for({"query": [0.0] * dim, **params}))

        def run(p):
            return prog(state_for(p), 1)

        def finish(dev):
            nbrs = dev["neighbors"].cpu().numpy()
            scores = dev["scores"].cpu().numpy()
            return {
                "neighbors": nbrs,
                "distances": np.sqrt(np.maximum(-scores, 0.0)),
            }

        return PreparedQuery(self.plan_key(params), plan.hash, prog, run, finish)


BUILTIN_SPECS: dict[str, QuerySpec] = {
    s.name: s
    for s in (
        PiQuery(), PageRankQuery(), WordCountQuery(), KMeansQuery(),
        GMMQuery(), KNNQuery(),
    )
}


def builtin_specs() -> dict[str, QuerySpec]:
    """A fresh copy of the built-in registry (servers may mutate theirs)."""
    return dict(BUILTIN_SPECS)


def run_direct(session, datasets: dict[str, DatasetEntry], query: str,
               params: dict, *, specs=None) -> dict:
    """Execute one query synchronously against ``session`` — the serving
    layer's reference semantics.  Tests compare served results against this
    (same spec, same program lowering, fresh session): bit for bit on the
    CPU; on the card the float sums of K1's atomic forms may land in
    another order."""
    specs = BUILTIN_SPECS if specs is None else specs
    spec = specs[query]
    res = ServeResources(session, datasets)
    prepared = spec.prepare(res, params)
    prepared.program.reset_carry()
    dev = prepared.run(params)
    _sync(session.device)
    return prepared.finish(dev)
