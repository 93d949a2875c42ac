"""Sizing rules of the port: accumulator dtypes, hash-table capacity and probe
depth, and the ``engine="auto"`` crossover.

The counterpart of ``repro/core/cost.py``.  The JAX module shrinks a hash
table until it fits a TPU VMEM budget; here the table lives in device memory,
so the capacity rule keeps only the load-factor grid.

Its tuning half (``TunedConfig``, ``TuningCache`` and the candidate grids)
keeps the reference's structure, but the grids are the port's own: the
reference's are VMEM ``block_n`` frontiers, which mean nothing on the card.
A dense node's candidates are K1's launch forms and CTAs per SM
(``kernels/segment_reduce.py``, ``launch_shape``), a hash node's K2's table
capacity, probe depth and table of hot keys (``kernels/hash_combine.py``).
Imports only ``torch`` at module level: the kernels import it lazily.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import warnings
from typing import Iterator

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


def next_capacity(cap: int, *, limit: int = MAX_TABLE_CAP) -> int | None:
    """The next rung of the hash-capacity grid above ``cap``: powers of two
    from ``MIN_TABLE_CAP`` up to ``limit``.  Overflow escalation climbs it
    one rung a re-dispatch; ``None`` means the grid is exhausted (the
    overflow stays counted)."""
    if cap >= limit:
        return None
    nxt = MIN_TABLE_CAP
    while nxt <= cap:
        nxt *= 2
    return min(nxt, limit)


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


# ---------------------------------------------------------------------------
# Measured autotuning: configs, candidate enumeration, cache
# ---------------------------------------------------------------------------

# K1's CTAs per SM each form is measured at (the defaults are
# segment_reduce.CTAS_PER_SM: 2, 2, 8).
TUNE_CTAS_PER_SM = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """One execution config for a MapReduce node: a measurement candidate,
    and (once timed) the cached winner.

    ``engine`` is ``"eager"`` or ``"pallas"`` (the hand-written kernel).
    Dense targets pin K1's ``form`` and ``ctas_per_sm``; hash targets K2's
    ``table_cap``, ``probe_depth`` and ``table_bits`` (log2 of the slots of
    its per-CTA table of hot keys, -1 for none).  ``None`` keeps the
    kernel's default.  ``wall_s`` and ``source`` are outcomes, excluded from
    equality and hash, so a config's identity depends only on what runs.
    """

    engine: str  # "eager" | "pallas"
    form: str | None = None  # K1: "registers" | "shared" | "global"
    ctas_per_sm: int | None = None  # K1: the grid's CTAs an SM
    table_cap: int | None = None  # K2: capacity of the pre-shuffle table
    probe_depth: int | None = None  # K2: probe rounds of that combine
    table_bits: int | None = None  # K2: per-CTA table of hot keys, log2 slots
    source: str = dataclasses.field(default="fallback", compare=False)
    wall_s: float | None = dataclasses.field(default=None, compare=False)

    def describe(self) -> str:
        parts = [self.engine]
        if self.form:
            parts.append(f"form={self.form}")
        if self.ctas_per_sm:
            parts.append(f"ctas/sm={self.ctas_per_sm}")
        if self.table_cap:
            parts.append(f"cap={self.table_cap}")
        if self.probe_depth:
            parts.append(f"probes={self.probe_depth}")
        if self.table_bits is not None:
            parts.append(f"bits={self.table_bits}")
        return " ".join(parts)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TunedConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def dense_tuning_candidates(k: int, v: int, reducer: str,
                            dtype: torch.dtype) -> list[TunedConfig]:
    """The measurement grid for a dense ``[k, v]`` target: eager, then K1 in
    each form valid for ``(k, v)`` (``segment_reduce.valid_forms``), each at
    :data:`TUNE_CTAS_PER_SM` CTAs an SM.  Every candidate reduces the same
    pairs with the same monoid: results are bit-identical for exact inputs
    (integer values, or floats whose sums are exact)."""
    from repro_torch.kernels.segment_reduce import valid_forms

    del reducer, dtype  # every K1 form takes every reducer and dtype
    cands = [TunedConfig(engine="eager")]
    for form in valid_forms(k, v):
        cands += [TunedConfig(engine="pallas", form=form, ctas_per_sm=c)
                  for c in TUNE_CTAS_PER_SM]
    return cands


def hash_tuning_candidates(v: int, reducer: str, dtype: torch.dtype, *,
                           key_range: int | None) -> list[TunedConfig]:
    """The measurement grid for a hash-target node with ``[v]`` values.

    With a ``key_range`` the distinct-key bound is known, so K2's pre-shuffle
    table may be pinned: capacities 2, 4 and 8 times the bound rounded up to
    a power of two (within ``[MIN_TABLE_CAP, MAX_TABLE_CAP]``, as the
    default rule's, so no candidate holds fewer slots than it), each with
    the probe depth ``choose_probe_depth`` gives a stream longer than the
    table (the default's), and each with the per-CTA table of hot keys at
    its default size, a quarter of it, and none.  Without one, capacity must
    follow the runtime stream length, so only the engine is tuned.
    """
    from repro_torch.kernels.hash_combine import table_bits

    del reducer, dtype
    cands = [TunedConfig(engine="eager")]
    if key_range is None:
        cands.append(TunedConfig(engine="pallas"))
        return cands
    bound = 1 << max(0, int(key_range) - 1).bit_length()
    caps = sorted({min(max(m * bound, MIN_TABLE_CAP), MAX_TABLE_CAP) for m in (2, 4, 8)})
    default_bits = table_bits(v)
    bits = sorted({default_bits, default_bits - 2, -1} & set(range(-1, default_bits + 1)),
                  reverse=True)
    for cap in caps:
        probes = choose_probe_depth(1 << 30, cap)
        cands += [TunedConfig(engine="pallas", table_cap=cap, probe_depth=probes,
                              table_bits=b) for b in bits]
    return cands


class TuningCache:
    """Measured winners keyed by node plan hash (``MapReduceNode.tune_key``).

    Thread-safe.  ``measurements`` counts candidate timings performed,
    ``hits`` / ``misses`` count lookups: the counters the measure-exactly-once
    tests pin.
    """

    def __init__(self) -> None:
        self._entries: dict[str, TunedConfig] = {}
        self._lock = threading.Lock()
        self.measurements = 0
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> TunedConfig | None:
        with self._lock:
            cfg = self._entries.get(key)
            if cfg is None:
                self.misses += 1
            else:
                self.hits += 1
            return cfg

    def peek(self, key: str) -> TunedConfig | None:
        with self._lock:
            return self._entries.get(key)

    def put(self, key: str, cfg: TunedConfig) -> None:
        with self._lock:
            self._entries[key] = cfg

    def record_measurements(self, n: int) -> None:
        with self._lock:
            self.measurements += n

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def items(self) -> Iterator[tuple[str, TunedConfig]]:
        with self._lock:
            return iter(sorted(self._entries.items()))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "measurements": self.measurements,
                "hits": self.hits,
                "misses": self.misses,
                "configs": {k: cfg.to_dict() for k, cfg in sorted(self._entries.items())},
            }

    def save(self, path: str) -> None:
        """Atomic JSON dump: a temporary file in the same directory, flushed
        and fsynced, then renamed over ``path`` (the checkpoints' discipline:
        the rename orders the directory entry, not the data blocks)."""
        with self._lock:
            doc = {"version": 1,
                   "entries": {k: cfg.to_dict() for k, cfg in sorted(self._entries.items())}}
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tuning-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def load(self, path: str) -> int:
        """Merge entries from ``path`` (loaded winners keep their recorded
        ``source`` and ``wall_s``); returns how many were loaded.  An
        unreadable or corrupt file is a warning, not an error: tuning is an
        optimisation, so the session re-measures on demand."""
        try:
            with open(path) as f:
                doc = json.load(f)
            items = [(k, TunedConfig.from_dict(d)) for k, d in doc.get("entries", {}).items()]
        except (OSError, ValueError, TypeError, AttributeError, UnicodeDecodeError) as e:
            warnings.warn(f"ignoring unreadable tuning cache {path!r}: {e}",
                          RuntimeWarning, stacklevel=2)
            return 0
        with self._lock:
            for k, cfg in items:
                self._entries[k] = cfg
        return len(items)
