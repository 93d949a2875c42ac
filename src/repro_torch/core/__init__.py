"""Blaze core: in-memory MapReduce + distributed containers in PyTorch."""
from repro_torch.core.containers import (
    EMPTY_KEY,
    BlockView,
    ChunkedDistVector,
    DistHashMap,
    DistRange,
    DistVector,
    chunked,
    collect,
    distribute,
    foreach,
    make_dist_hashmap,
    topk,
)
from repro_torch.core.mapreduce import MapReduceStats, map_reduce
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

__all__ = [
    "EMPTY_KEY",
    "PALLAS_AUTO_MAX_KEYS",
    "BlazeSession",
    "BlockView",
    "ChunkedDistVector",
    "DistHashMap",
    "DistRange",
    "DistVector",
    "MapReduceStats",
    "Reducer",
    "SessionStats",
    "chunked",
    "collect",
    "custom_reducer",
    "distribute",
    "foreach",
    "get_default_session",
    "get_reducer",
    "make_dist_hashmap",
    "map_reduce",
    "reset_default_session",
    "resolve_engine",
    "set_default_session",
    "topk",
]
