"""Sizing rules of the port: accumulator dtypes, hash-table capacity and probe
depth, and the ``engine="auto"`` crossover.

The counterpart of ``repro/core/cost.py`` for what the per-op path needs.  The
JAX module shrinks a hash table until it fits a TPU VMEM budget; here the
table lives in device memory, so the capacity rule keeps only the load-factor
grid.  Imports only ``torch``: the kernels import it lazily.
"""
from __future__ import annotations

import torch

# engine="auto" picks the kernel for at most this many accumulator rows.
# Carried over from the TPU, where it was sized for VMEM; it awaits an H100
# measurement of the eager/kernel crossover.
PALLAS_AUTO_MAX_KEYS = 4096
# The fallback cost model's fixed eager overhead, in accumulator rows: the
# anchor that puts the modelled crossover at PALLAS_AUTO_MAX_KEYS.
EAGER_FIXED_ROWS = PALLAS_AUTO_MAX_KEYS
# Hash-table capacities are powers of two in [MIN_TABLE_CAP, MAX_TABLE_CAP].
MIN_TABLE_CAP = 128
MAX_TABLE_CAP = 1 << 20


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype of the kernels: f32 for floats (bf16 upcast), i32
    for ints."""
    return torch.float32 if dtype.is_floating_point else torch.int32


def use_matmul(reducer: str, acc: torch.dtype) -> bool:
    """True for a float sum: the reduction the TPU kernel ran as a one-hot
    matmul, and the one whose summation order the CUDA kernels leave to their
    atomics, so its results agree within a tolerance rather than exactly (and
    the plain segment reduce accumulates it in float64)."""
    return reducer == "sum" and acc == torch.float32


def choose_probe_depth(n: int, table_cap: int) -> int:
    """Probe rounds for ``n`` pairs into a ``table_cap`` table: linear-probe
    clusters lengthen with the load factor, so fuller tables get more
    rounds to find the free slots that exist."""
    alpha = min(1.0, n / max(1, table_cap))
    if alpha <= 0.5:
        depth = 16
    elif alpha <= 0.75:
        depth = 32
    else:
        depth = 64
    return min(table_cap, depth)


def table_capacity(n: int, distinct_hint: int | None = None) -> int:
    """Capacity of a fresh combine table for ``n`` pairs: the power of two
    at least twice the distinct-key bound (load factor <= 0.5), within
    ``[MIN_TABLE_CAP, MAX_TABLE_CAP]``."""
    distinct = min(n, distinct_hint) if distinct_hint else n
    cap = MIN_TABLE_CAP
    while cap < 2 * max(1, distinct) and cap < MAX_TABLE_CAP:
        cap *= 2
    return cap


def node_cost(engine: str, k: int) -> float:
    """Modelled cost of one shard-local combine over ``k`` accumulator rows,
    in accumulator-row units (EXPLAIN's ``cost~``): the kernel touches each
    row about twice (accumulate, write back), ``2k``; eager once plus a
    fixed overhead, ``k + EAGER_FIXED_ROWS``; naive ships raw pairs and
    reduces everywhere, ten times eager."""
    if engine == "pallas":
        return 2.0 * k
    if engine == "naive":
        return 10.0 * (k + EAGER_FIXED_ROWS)
    return float(k) + EAGER_FIXED_ROWS


def pick_engine(k: int) -> str:
    """``engine="auto"`` over ``k`` accumulator rows: the modelled cheaper
    engine, eager when ``k`` is unknown; the crossover is exactly
    ``k == PALLAS_AUTO_MAX_KEYS``."""
    if k <= 0:
        return "eager"
    return "pallas" if node_cost("pallas", k) <= node_cost("eager", k) else "eager"
