"""Blaze core: in-memory MapReduce + distributed containers in PyTorch.

Exports every name of the reference's ``repro.core``.  ``data_mesh`` is the
port's 1-D mesh (``containers.Mesh``: shards stacked on one device); the
2-D ``("node", "data")`` one is ``repro_torch.launch.mesh.make_node_data_mesh``.
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
    data_mesh,
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
    "data_mesh",
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
