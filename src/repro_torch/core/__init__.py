"""Blaze core: in-memory MapReduce + distributed containers in PyTorch.

Exports every name of the reference's ``repro.core`` but ``data_mesh``,
which waits for the multi-host slice (ROADMAP.md, Queue 1 item 6): the
port's session owns a device and a shard count, not a mesh.
"""
from repro_torch.core.containers import (
    EMPTY_KEY,
    BlockView,
    ChunkedDistVector,
    DistHashMap,
    DistRange,
    DistVector,
    HostBlockStore,
    chunked,
    collect,
    distribute,
    foreach,
    make_dist_hashmap,
    topk,
)
from repro_torch.core.mapreduce import MapReduceStats, map_reduce
from repro_torch.core.plan import Plan
from repro_torch.core.program import (
    LocalHashMap,
    LocalVector,
    LoopInfo,
    PlanValue,
    Program,
    ProgramStats,
    StreamInfo,
)
from repro_torch.core.reducers import Reducer, custom_reducer, get_reducer
from repro_torch.core.session import (
    PALLAS_AUTO_MAX_KEYS,
    BlazeSession,
    SessionStats,
    get_default_session,
    reset_default_session,
    resolve_engine,
    set_default_session,
)
from repro_torch.data.text import load_file

__all__ = [
    "EMPTY_KEY",
    "PALLAS_AUTO_MAX_KEYS",
    "BlazeSession",
    "BlockView",
    "ChunkedDistVector",
    "DistHashMap",
    "DistRange",
    "DistVector",
    "HostBlockStore",
    "LocalHashMap",
    "LocalVector",
    "LoopInfo",
    "MapReduceStats",
    "Plan",
    "PlanValue",
    "Program",
    "ProgramStats",
    "Reducer",
    "SessionStats",
    "StreamInfo",
    "chunked",
    "collect",
    "custom_reducer",
    "distribute",
    "foreach",
    "get_default_session",
    "get_reducer",
    "load_file",
    "make_dist_hashmap",
    "map_reduce",
    "reset_default_session",
    "resolve_engine",
    "set_default_session",
    "topk",
]
