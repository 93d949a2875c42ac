"""Blaze distributed containers on one device, shards stacked on dim 0.

The counterpart of ``repro/core/containers.py`` (in-memory part).  Where JAX
shards a container's leading dimension over a device mesh, the port keeps all
``n_shards`` shards on one device as a leading stacked dimension:

* ``DistRange``   — start/stop/step only; each shard synthesises its own
                    contiguous block of values (no storage, as in the paper);
* ``DistVector``  — ``data [n_shards * per, ...]``, shard ``s`` owning rows
                    ``[s * per, (s + 1) * per)``, plus the true length ``n``;
* ``DistHashMap`` — one fixed-capacity open-addressing table per shard,
                    ``keys [S, C]`` int32, ``vals [S, C, ...]``,
                    ``overflow [S]``; key ownership is ``shard_of_key``.

On one card ``n_shards=1`` is the real deployment; more shards exercise the
shuffle and let the port be held against the JAX package on several devices.
Containers are never mutated: every operation returns a new one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core.reducers import Reducer, get_reducer, segmented_scan
from repro_torch.kernels.hash_combine import EMPTY_KEY, hash32

__all__ = [
    "EMPTY_KEY",
    "DistHashMap",
    "DistRange",
    "DistVector",
    "HashTable",
    "collect",
    "distribute",
    "foreach",
    "hash32",
    "hashmap_insert",
    "make_dist_hashmap",
    "make_table",
    "resolve_device",
    "shard_of_key",
    "topk",
    "unique_combine",
]


def resolve_device(device=None) -> torch.device:
    """The device a container or session lives on: ``"cuda"`` unless the
    caller names another.  Raises when CUDA is asked for (or defaulted to)
    and absent; there is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch versions on the CPU"
        )
    return dev


def shard_of_key(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Ownership partition: which shard owns each key (high bits of the
    hash), int64."""
    return (hash32(keys) >> 16) % n_shards


# ---------------------------------------------------------------------------
# Eager local combine: sort + segmented scan (paper §2.3.1)
# ---------------------------------------------------------------------------


def unique_combine(keys: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor,
                   reducer: Reducer):
    """Combine duplicate keys locally; returns same-length (keys, vals, valid).

    Live entries sort first, by key; a segmented scan with the reducer's
    combine folds each run, and only the last element of a run stays.
    Masked-out or duplicate slots come back with ``key == EMPTY_KEY`` and
    ``valid == False``.  The mask is its own sort column, so no key value can
    be mistaken for a masked slot.
    """
    n = keys.shape[0]
    if n == 0:
        return keys, vals, mask
    order = torch.argsort(keys, stable=True)
    order = order[torch.argsort((~mask[order]).to(torch.uint8), stable=True)]
    skeys, svals, smask = keys[order], vals[order], mask[order]
    # Segment boundaries: key change, live/masked transition, and every
    # masked slot is its own segment.
    newseg = (skeys[1:] != skeys[:-1]) | (smask[1:] != smask[:-1]) | ~smask[1:]
    one = torch.ones(1, dtype=torch.bool, device=keys.device)
    scanned = segmented_scan(svals, torch.cat([one, newseg]), reducer.combine)
    valid = torch.cat([newseg, one]) & smask
    out_keys = torch.where(valid, skeys, EMPTY_KEY).to(keys.dtype)
    vb = valid.view((-1,) + (1,) * (svals.dim() - 1))
    out_vals = torch.where(vb, scanned, reducer.identity(vals.dtype)).to(vals.dtype)
    return out_keys, out_vals, valid


# ---------------------------------------------------------------------------
# DistHashMap: static-capacity open addressing with round-based probing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HashTable:
    """One shard's table (or all shards' tables, stacked):
    ``keys [..., C]`` int32 (EMPTY_KEY = free), ``vals [..., C, ...]``,
    ``overflow [...]`` int32 pairs dropped because probing ran out."""

    keys: torch.Tensor
    vals: torch.Tensor
    overflow: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keys.shape[-1]


def make_table(capacity: int, val_shape: tuple, val_dtype: torch.dtype,
               reducer: Reducer, device=None) -> HashTable:
    dev = resolve_device(device)
    return HashTable(
        keys=torch.full((capacity,), EMPTY_KEY, dtype=torch.int32, device=dev),
        vals=torch.full((capacity,) + tuple(val_shape),
                        reducer.identity(val_dtype), dtype=val_dtype, device=dev),
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
    )


def hashmap_insert(table: HashTable, keys: torch.Tensor, vals: torch.Tensor,
                   valid: torch.Tensor, reducer: Reducer,
                   max_probes: int = 16) -> HashTable:
    """Insert/merge a batch of pairs with *unique* keys into one shard's table.

    Linear probing, one vectorised round per probe distance ``r``:
    ``slot = (hash32(key) + r) % C`` for every unplaced pair; pairs whose
    slot is free claim it by scatter-max of the key (the largest claimant
    wins, deterministically); pairs whose key now sits at their slot fold
    their value in and stop.  Every round runs (no host sync), and pairs
    still unplaced after ``max_probes`` rounds are counted in ``overflow``.
    Callers pre-combine duplicates (``unique_combine``).
    """
    cap = table.capacity
    home = hash32(keys) % cap
    tkeys = table.keys
    # One spare row at index ``cap`` takes the writes of pairs that do not
    # deposit; it is cut off at the end.
    tvals = torch.cat([table.vals, table.vals[:1]])
    vals = vals.to(tvals.dtype)
    active = valid
    for r in range(max_probes):
        slot = (home + r) % cap
        want = active & (tkeys[slot] == EMPTY_KEY)
        claim = torch.full((cap + 1,), EMPTY_KEY, dtype=tkeys.dtype,
                           device=tkeys.device).scatter_reduce_(
            0, torch.where(want, slot, cap), torch.where(want, keys, EMPTY_KEY),
            reduce="amax", include_self=True,
        )[:cap]
        tkeys = torch.where(claim != EMPTY_KEY, claim, tkeys)
        deposit = active & (tkeys[slot] == keys)
        # Unique keys: at most one pair deposits into each slot.
        rows = torch.where(deposit, slot, cap)
        tvals[rows] = reducer.combine(tvals[rows], vals)
        active = active & ~deposit
    overflow = table.overflow + active.sum().to(torch.int32)
    return HashTable(tkeys, tvals[:cap], overflow)


@dataclasses.dataclass
class DistHashMap:
    """Distributed hash map: ``table`` holds one ``HashTable`` per shard,
    stacked on dim 0 (``keys [S, C]``, ``vals [S, C, ...]``,
    ``overflow [S]``)."""

    table: HashTable
    reducer_name: str

    @property
    def capacity_per_shard(self) -> int:
        return self.table.keys.shape[-1]

    @property
    def n_shards(self) -> int:
        return self.table.keys.shape[0]

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        """Live entries as host arrays ``(keys [n], vals [n, ...])``, in
        table order."""
        keys = self.table.keys.reshape(-1).cpu().numpy()
        vals = self.table.vals.reshape((-1,) + tuple(self.table.vals.shape[2:]))
        live = np.flatnonzero(keys != EMPTY_KEY)
        return keys[live], vals.cpu().numpy()[live]

    def to_dict(self) -> dict[int, np.ndarray]:
        """Host-side materialisation (the paper's ``collect``)."""
        keys, vals = self.items()
        return dict(zip(keys.tolist(), vals))

    def size(self) -> int:
        return int((self.table.keys != EMPTY_KEY).sum())

    def total_overflow(self) -> int:
        return int(self.table.overflow.sum())


def make_dist_hashmap(capacity_per_shard: int, val_shape: tuple = (),
                      val_dtype: torch.dtype = torch.float32,
                      reducer: str | Reducer = "sum", *, n_shards: int = 1,
                      device=None) -> DistHashMap:
    red = get_reducer(reducer)
    dev = resolve_device(device)
    shape = (n_shards, capacity_per_shard)
    table = HashTable(
        keys=torch.full(shape, EMPTY_KEY, dtype=torch.int32, device=dev),
        vals=torch.full(shape + tuple(val_shape), red.identity(val_dtype),
                        dtype=val_dtype, device=dev),
        overflow=torch.zeros((n_shards,), dtype=torch.int32, device=dev),
    )
    return DistHashMap(table, reducer_name=red.name)


# ---------------------------------------------------------------------------
# DistRange / DistVector
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DistRange:
    """start/stop/step — no storage; shards synthesise their local subrange."""

    start: int
    stop: int
    step: int

    def __len__(self) -> int:
        return max(0, -(-(self.stop - self.start) // self.step))

    def local_values(self, shard_idx: torch.Tensor, n_shards: int):
        """(values, valid) ``[S, per]`` for the shards in ``shard_idx``:
        contiguous block partitioning, values int32."""
        n = len(self)
        per = -(-n // n_shards)
        local_i = (torch.arange(per, device=shard_idx.device)[None, :]
                   + shard_idx[:, None].to(torch.int64) * per)
        vals = self.start + local_i * self.step
        return vals.to(torch.int32), local_i < n


@dataclasses.dataclass
class DistVector:
    """``data [n_shards * per, ...]``, shard ``s`` owning rows
    ``[s * per, (s + 1) * per)``; ``n`` is the true (pre-pad) length."""

    data: torch.Tensor
    n: int

    def __len__(self) -> int:
        return self.n


def distribute(x, n_shards: int = 1, device=None) -> DistVector:
    """Paper's ``distribute``: host array → DistVector (pads to a multiple
    of ``n_shards`` with zeros)."""
    x = np.asarray(x)
    n = x.shape[0]
    pad = (-n) % n_shards
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
    data = torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))
    return DistVector(data, n)


def collect(v: DistVector) -> np.ndarray:
    """Paper's ``collect``: DistVector → host array (drops padding)."""
    return v.data[: v.n].cpu().numpy()


def foreach(v: DistVector, fn: Callable, env=None) -> DistVector:
    """Apply ``fn`` to each element (``fn(x)``, or ``fn(x, env)`` when ``env``
    is given) with ``torch.func.vmap``; returns a new ``DistVector`` with the
    same ``n``.  Padding rows are mapped too, as in the JAX package."""
    if env is None:
        out = vmap(fn)(v.data)
    else:
        out = vmap(lambda x: fn(x, env))(v.data)
    return DistVector(out, v.n)


def topk(v: DistVector, k: int, score_fn: Callable | None = None, env=None, *,
         n_shards: int = 1) -> np.ndarray:
    """Paper's ``DistVector.topk``: the ``k`` rows of highest score, best
    first, as a host array.

    Each of the ``n_shards`` shards scores its rows (``score_fn(x)`` or
    ``score_fn(x, env)`` under ``vmap``; the raw values without a
    ``score_fn``), gives padding rows ``-inf`` and keeps its top
    ``min(k, per)`` with ``torch.topk``; only those ``k·n_shards``
    candidates move to the host, where a stable sort of ``-score`` picks the
    final ``k``.
    """
    data = v.data
    per = data.shape[0] // n_shards
    kk = min(k, per)
    if score_fn is None:
        scores = data.float()
    elif env is None:
        scores = vmap(score_fn)(data)
    else:
        scores = vmap(lambda x: score_fn(x, env))(data)
    valid = torch.arange(data.shape[0], device=data.device) < v.n
    scores = torch.where(valid, scores, float("-inf")).view(n_shards, per)
    s, idx = torch.topk(scores, kk, dim=1)
    rows = data.view((n_shards, per) + tuple(data.shape[1:]))
    cand = rows[torch.arange(n_shards, device=data.device)[:, None], idx]
    s = s.cpu().numpy().reshape(-1)
    cand = cand.cpu().numpy().reshape((-1,) + tuple(data.shape[1:]))
    return cand[np.argsort(-s, kind="stable")[:k]]
