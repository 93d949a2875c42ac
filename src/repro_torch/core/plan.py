"""Engine resolution (the counterpart of ``repro/core/plan.py``'s
resolve-engines pass; logical plans and EXPLAIN come with the plan slice)."""
from __future__ import annotations

import torch

from repro_torch.core import containers as C
from repro_torch.core import cost
from repro_torch.core.reducers import Reducer

ENGINES = ("eager", "pallas", "naive", "auto")


def node_key_count(target) -> int:
    """Accumulator rows ``k`` the engine choice is priced by: the dense key
    range, or the hash table's per-shard capacity.  0 when unknowable."""
    if isinstance(target, C.DistHashMap):
        return target.capacity_per_shard
    t = torch.as_tensor(target)
    return t.shape[0] if t.dim() else 0


def resolve_engine(engine: str, target, reducer: Reducer) -> str:
    """The engine that runs: ``"auto"`` asks ``cost.pick_engine``; a custom
    reducer, which has no kernel, turns ``"pallas"`` (and ``"auto"``) into
    ``"eager"``, so the engine reported in ``MapReduceStats`` is the plan
    that ran."""
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
