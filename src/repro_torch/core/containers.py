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
The shards group node-major into the rows of a ``("node", "data")`` mesh
(``Mesh``; ``data_mesh`` is the 1-D one), which the collectives read; a
container's layout depends on the shard count only.
Containers are never mutated: every operation returns a new one.

Out of core (the counterpart of the reference's ``ChunkedDistVector``): a
dataset that stays on the host as blocks (``HostBlockStore``: raw, zlib
compressed, or spilled to disk past an LRU bound), streamed to the device one
block at a time, each block seen as a ``BlockView``.  On a CUDA machine the
raw blocks live in pinned (page-locked) memory, and compressed or spilled
ones decode into pinned buffers: a copy from pageable memory blocks the host
and cannot overlap the device's work.  On a mesh of several processes each
rank holds its own shards' rows of every block.
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Any, Callable

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core.reducers import Reducer, get_reducer, segmented_scan
from repro_torch.kernels.hash_combine import EMPTY_KEY, hash32

__all__ = [
    "DATA_AXIS",
    "EMPTY_KEY",
    "NODE_AXIS",
    "BlockView",
    "ChunkedDistVector",
    "DistHashMap",
    "DistRange",
    "DistVector",
    "HashTable",
    "HostBlockStore",
    "Mesh",
    "chunked",
    "collect",
    "data_axes",
    "data_mesh",
    "distribute",
    "foreach",
    "hash32",
    "head",
    "hashmap_insert",
    "make_dist_hashmap",
    "make_table",
    "n_nodes",
    "resolve_device",
    "shard_count",
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


# ---------------------------------------------------------------------------
# The topology: a (node, data) mesh of stacked shards
#
# The reference shards its containers over the data-parallel axes of a JAX
# mesh: the 1-D ``("data",)`` mesh of one host, or the 2-D ``("node",
# "data")`` mesh of a multi-host launch, ``node`` the slow inter-host axis
# and ``data`` the fast intra-host one.  The port's shards are stacked on
# dim 0 of one device, so its mesh is just that grouping: ``n_nodes`` rows
# of ``n_data`` shards, shard ``s = node * n_data + d`` (the reference's
# node-major flattening).  A container's layout depends only on the shard
# count, so one built on a (1x8) mesh runs unchanged on a (2x4) one.
#
# Across processes the mesh carries a ``torch.distributed`` group: each
# process is one node row and holds its ``n_local`` shards (rows ``rank *
# n_local ...``) of every container; ``n_shards`` stays the global count.
# Containers made on such a mesh keep it (``DistVector.mesh``,
# ``DistHashMap.mesh``, ``ChunkedDistVector.mesh``), so ``collect``, ``topk``
# and a hash map's materialisation gather the ranks' rows; a chunked vector
# keeps each rank's rows of every block.
# ---------------------------------------------------------------------------

DATA_AXIS = "data"
NODE_AXIS = "node"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_nodes`` node rows of ``n_data`` shards each, stacked on one
    device.  Hashable, so it keys caches; a 1-node mesh is the 1-D
    ``("data",)`` mesh.

    ``group`` (a ``torch.distributed`` process group; None: the whole mesh
    lives in this process) makes each of its ``n_ranks`` processes one node
    row: this one, ``rank``, holds ``n_local`` of the ``n_shards`` shards.
    A group's backend must reach the device: ``gloo`` has no CUDA
    all-gather or all-to-all, and NCCL no CPU one."""

    n_nodes: int
    n_data: int
    device: torch.device
    group: Any = None
    rank: int = 0
    n_ranks: int = 1

    def __post_init__(self):
        if self.n_nodes < 1 or self.n_data < 1:
            raise ValueError(f"a mesh needs >= 1 node and >= 1 shard a node, got "
                             f"({self.n_nodes}, {self.n_data})")
        if self.group is None:
            if (self.rank, self.n_ranks) != (0, 1):
                raise ValueError("a mesh without a process group has one rank")
            return
        if self.n_nodes != self.n_ranks or not 0 <= self.rank < self.n_ranks:
            raise ValueError(f"a process mesh is one node row a process: {self.n_nodes} "
                             f"node rows, rank {self.rank} of {self.n_ranks}")
        if isinstance(self.group, torch.distributed.ProcessGroup):
            backend = torch.distributed.get_backend(self.group)
            if self.device.type == "cpu" and backend == "nccl":
                raise ValueError("an 'nccl' process group carries CUDA tensors only: "
                                 "bring the group up with backend='gloo' for the CPU")
            if self.device.type == "cuda" and backend != "nccl":
                raise ValueError(
                    f"a {backend!r} process group cannot carry the collectives of "
                    "CUDA tensors (gloo has no CUDA all-gather or all-to-all, and "
                    "staging through the host would hide the device): bring the "
                    "group up with backend='nccl'")

    @property
    def n_shards(self) -> int:
        return self.n_nodes * self.n_data

    @property
    def n_local(self) -> int:
        """The shards this process holds (all of them without a group)."""
        return self.n_shards // self.n_ranks

    @property
    def process(self) -> bool:
        """Whether the mesh spans processes (carries a group)."""
        return self.group is not None


def data_mesh(n_shards: int | None = None, device=None) -> Mesh:
    """The 1-D mesh: ``n_shards`` (default 1) shards on ``device``."""
    return Mesh(1, 1 if n_shards is None else int(n_shards), resolve_device(device))


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The axes a container's leading dim shards over, slowest (node) first."""
    return (NODE_AXIS, DATA_AXIS) if mesh.n_nodes > 1 else (DATA_AXIS,)


def n_nodes(mesh: Mesh) -> int:
    """The node rows of the mesh (1 on a 1-D mesh)."""
    return mesh.n_nodes


def shard_count(mesh: Mesh) -> int:
    """Total data-parallel shards, the product over ``data_axes(mesh)``."""
    return mesh.n_shards


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


def _gathered(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x``'s rows of every rank of a process mesh, in shard order (``x``
    itself on any other mesh)."""
    if mesh is None or not mesh.process:
        return x
    from repro_torch.core.collectives import gather_rows

    return gather_rows(mesh, x)


@dataclasses.dataclass
class DistHashMap:
    """Distributed hash map: ``table`` holds one ``HashTable`` per shard,
    stacked on dim 0 (``keys [S, C]``, ``vals [S, C, ...]``,
    ``overflow [S]``).  On a process mesh (``mesh``) the table is this
    rank's ``n_local`` rows, and the host-side views below gather every
    rank's (a collective: every rank calls them together)."""

    table: HashTable
    reducer_name: str
    mesh: Any = None

    @property
    def capacity_per_shard(self) -> int:
        return self.table.keys.shape[-1]

    @property
    def n_shards(self) -> int:
        """The shards of the table this process holds."""
        return self.table.keys.shape[0]

    def items(self) -> tuple[np.ndarray, np.ndarray]:
        """Live entries as host arrays ``(keys [n], vals [n, ...])``, in
        table order."""
        keys = _gathered(self.mesh, self.table.keys).reshape(-1).cpu().numpy()
        vals = _gathered(self.mesh, self.table.vals)
        vals = vals.reshape((-1,) + tuple(self.table.vals.shape[2:]))
        live = np.flatnonzero(keys != EMPTY_KEY)
        return keys[live], vals.cpu().numpy()[live]

    def to_dict(self) -> dict[int, np.ndarray]:
        """Host-side materialisation (the paper's ``collect``)."""
        keys, vals = self.items()
        return dict(zip(keys.tolist(), vals))

    def size(self) -> int:
        return int((_gathered(self.mesh, self.table.keys) != EMPTY_KEY).sum())

    def total_overflow(self) -> int:
        return int(_gathered(self.mesh, self.table.overflow).sum())


def make_dist_hashmap(capacity_per_shard: int, val_shape: tuple = (),
                      val_dtype: torch.dtype = torch.float32,
                      reducer: str | Reducer = "sum", *, n_shards: int = 1,
                      device=None, mesh: Mesh | None = None) -> DistHashMap:
    """An empty map of ``n_shards`` tables on ``device``; with ``mesh`` its
    shards and device, and on a process mesh this rank's ``n_local``
    tables."""
    red = get_reducer(reducer)
    if mesh is not None:
        n_shards, device = mesh.n_local, mesh.device
    dev = resolve_device(device)
    shape = (n_shards, capacity_per_shard)
    table = HashTable(
        keys=torch.full(shape, EMPTY_KEY, dtype=torch.int32, device=dev),
        vals=torch.full(shape + tuple(val_shape), red.identity(val_dtype),
                        dtype=val_dtype, device=dev),
        overflow=torch.zeros((n_shards,), dtype=torch.int32, device=dev),
    )
    return DistHashMap(table, reducer_name=red.name,
                       mesh=mesh if mesh is not None and mesh.process else None)


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
    ``[s * per, (s + 1) * per)``; ``n`` is the true (pre-pad) length.  On a
    process mesh (``mesh``) ``data`` is this rank's ``n_local * per`` rows,
    global rows ``rank * n_local * per ...``."""

    data: torch.Tensor
    n: int
    mesh: Any = None

    def __len__(self) -> int:
        return self.n


def distribute(x, n_shards: int = 1, device=None, *, mesh: Mesh | None = None) -> DistVector:
    """Paper's ``distribute``: host array → DistVector (pads to a multiple
    of ``n_shards`` with zeros).  With ``mesh`` its shards and device; on a
    process mesh every rank passes the whole host array, as every JAX
    process does, and keeps its own shards' rows."""
    if mesh is not None:
        n_shards, device = mesh.n_shards, mesh.device
    x = np.asarray(x)
    n = x.shape[0]
    pad = (-n) % n_shards
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
    if mesh is not None and mesh.process:
        rows = x.shape[0] // mesh.n_ranks
        x = x[mesh.rank * rows:(mesh.rank + 1) * rows]
        data = torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))
        return DistVector(data, n, mesh)
    data = torch.from_numpy(np.ascontiguousarray(x)).to(resolve_device(device))
    return DistVector(data, n)


def collect(v: DistVector) -> np.ndarray:
    """Paper's ``collect``: DistVector → host array (drops padding); on a
    process mesh every rank's rows, gathered."""
    return _gathered(v.mesh, v.data)[: v.n].cpu().numpy()


def head(v: DistVector, m: int) -> np.ndarray:
    """The first ``min(m, len(v))`` rows of ``v`` as a host array, the same
    on every rank (a process mesh gathers each rank's first rows, so the
    whole vector never moves)."""
    m = min(m, v.n)
    if v.mesh is None or not v.mesh.process:
        return v.data[:m].cpu().numpy()
    return _gathered(v.mesh, v.data[:min(m, v.data.shape[0])])[:m].cpu().numpy()


def foreach(v: DistVector, fn: Callable, env=None) -> DistVector:
    """Apply ``fn`` to each element (``fn(x)``, or ``fn(x, env)`` when ``env``
    is given) with ``torch.func.vmap``; returns a new ``DistVector`` with the
    same ``n``.  Padding rows are mapped too, as in the JAX package."""
    if env is None:
        out = vmap(fn)(v.data)
    else:
        out = vmap(lambda x: fn(x, env))(v.data)
    return DistVector(out, v.n, v.mesh)


def topk_first(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.topk(x, k)`` along the last dim with ties broken as
    ``jax.lax.top_k`` breaks them: of equal values the lower index first,
    both in which are kept and in their order (``torch.topk`` leaves both
    unspecified).  The ``k``-th value's ties are taken lowest index first
    (one more ``topk``, over their indices), then the ``k`` kept are sorted
    by (value descending, index ascending).  No host sync."""
    s, idx = torch.topk(x, k, dim=-1)
    if k == 0:
        return s, idx
    n = x.shape[-1]
    thr = s[..., -1:]
    ar = torch.arange(n, device=x.device)
    low = -torch.topk(torch.where(x == thr, -ar, -n), k, dim=-1).values  # ascending
    m = (s == thr).sum(-1, keepdim=True)  # the k-th value's slots, the last m
    t = torch.arange(k, device=x.device) - (k - m)
    idx = torch.where(t >= 0, low.gather(-1, t.clamp(min=0)), idx)
    by_index = idx.argsort(-1)
    s, idx = s.gather(-1, by_index), idx.gather(-1, by_index)
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    return s.gather(-1, order), idx.gather(-1, order)


def topk(v: DistVector, k: int, score_fn: Callable | None = None, env=None, *,
         n_shards: int = 1, mesh: Mesh | None = None) -> np.ndarray:
    """Paper's ``DistVector.topk``: the ``k`` rows of highest score, best
    first, as a host array.

    Each of the ``n_shards`` shards scores its rows (``score_fn(x)`` or
    ``score_fn(x, env)`` under ``vmap``; the raw values without a
    ``score_fn``), gives padding rows ``-inf`` and keeps its top
    ``min(k, per)`` (:func:`topk_first`: ties lower index first, as
    ``lax.top_k``); only those ``k·n_shards``
    candidates move to the host, where a stable sort of ``-score`` picks the
    final ``k``.  On a process mesh (``mesh``, or the vector's) each rank
    selects from its ``n_local`` shards, and the candidates and their scores
    are all-gathered, so the same host sort runs on every rank.
    """
    data = v.data
    mesh = mesh if mesh is not None else v.mesh
    mesh = mesh if mesh is not None and mesh.process else None
    require_rank_rows(mesh, v, "topk's vector")
    n_rows = n_shards if mesh is None else mesh.n_local
    per = data.shape[0] // n_rows
    kk = min(k, per)
    if score_fn is None:
        scores = data.float()
    elif env is None:
        scores = vmap(score_fn)(data)
    else:
        scores = vmap(lambda x: score_fn(x, env))(data)
    first = 0 if mesh is None else mesh.rank * data.shape[0]  # global row indices
    valid = torch.arange(first, first + data.shape[0], device=data.device) < v.n
    scores = torch.where(valid, scores, float("-inf")).view(n_rows, per)
    s, idx = topk_first(scores, kk)
    rows = data.view((n_rows, per) + tuple(data.shape[1:]))
    cand = rows[torch.arange(n_rows, device=data.device)[:, None], idx]
    s = _gathered(mesh, s).cpu().numpy().reshape(-1)
    cand = _gathered(mesh, cand).cpu().numpy().reshape((-1,) + tuple(data.shape[1:]))
    return cand[np.argsort(-s, kind="stable")[:k]]


# ---------------------------------------------------------------------------
# Out of core: chunked vectors as host-resident blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockView:
    """One device-resident block of a :class:`ChunkedDistVector`.

    ``data`` is the block's rows, padded to ``block_rows`` (shards stacked as
    a ``DistVector``'s); ``base`` is a device int32 scalar holding the
    block's global row offset (a tensor, not a Python int, so that one stage
    or one captured graph serves every block); ``n`` is the whole dataset's
    true row count, so mappers see global indices and ``idx < n`` masks the
    padding.  ``ready``, when set, is the CUDA event the block's copy
    recorded on the stream that made it: consumers wait on it first.
    """

    data: torch.Tensor
    base: torch.Tensor
    n: int
    ready: Any = None

    def __len__(self) -> int:
        return self.n


def _torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class HostBlockStore:
    """Byte provider of a chunked vector: host blocks, optional zlib
    compression, and LRU spill of cold blocks to a ``BlockStore`` on disk.

    All blocks share one shape and dtype, so bytes decode without per-block
    metadata.  With ``pin`` (a CUDA machine) raw blocks are kept in pinned
    memory and :meth:`get_tensor` decodes compressed or spilled blocks into
    a fresh pinned buffer, taken from PyTorch's caching host allocator,
    which reuses it only after the copies that read it have finished.
    """

    def __init__(self, blocks: list[np.ndarray], *, compress: bool = False,
                 spill=None, max_resident: int | None = None, pin: bool = False):
        if not blocks:
            raise ValueError("HostBlockStore needs at least one block")
        self.block_shape = blocks[0].shape
        self.dtype = blocks[0].dtype
        for b in blocks:
            if b.shape != self.block_shape or b.dtype != self.dtype:
                raise ValueError("all blocks must share one shape and dtype")
        self.compress = compress
        self.spill = spill
        self.max_resident = max_resident
        self.pin = pin
        self.n_blocks = len(blocks)
        # counters (read through ChunkedDistVector.stats())
        self.loads_from_disk = 0
        self.decompressions = 0
        self.spill_bytes = 0
        self.compressed_bytes = 0
        self.raw_bytes = sum(int(b.nbytes) for b in blocks)
        self._resident: dict[int, Any] = {}  # insertion order is LRU order
        for i, b in enumerate(blocks):
            self._admit(i, self._encode(b))

    def _encode(self, arr: np.ndarray):
        if self.compress:
            payload = zlib.compress(np.ascontiguousarray(arr).tobytes(), 1)
            self.compressed_bytes += len(payload)
            return payload
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.pin_memory() if self.pin else t

    @staticmethod
    def _payload_bytes(payload) -> bytes:
        if isinstance(payload, bytes):
            return payload
        return payload.numpy().tobytes()

    def _admit(self, i: int, payload):
        self._resident[i] = payload
        if self.max_resident is None or self.spill is None:
            return
        while len(self._resident) > max(1, self.max_resident):
            victim, vpayload = next(iter(self._resident.items()))
            del self._resident[victim]
            if not self.spill.has(f"block_{victim:06d}"):
                self.spill_bytes += self.spill.put(f"block_{victim:06d}",
                                                   self._payload_bytes(vpayload))

    def _payload(self, i: int):
        """Block ``i``'s stored payload, loaded from disk (and re-admitted)
        when it was spilled."""
        if i in self._resident:
            payload = self._resident.pop(i)
            self._resident[i] = payload  # refresh its LRU position
            return payload
        self.loads_from_disk += 1
        raw = self.spill.get(f"block_{i:06d}")
        payload = raw if self.compress else self._encode(
            np.frombuffer(bytearray(raw), dtype=self.dtype).reshape(self.block_shape))
        self._admit(i, payload)
        return payload

    def get(self, i: int) -> np.ndarray:
        """Block ``i`` as a host array."""
        payload = self._payload(i)
        if self.compress:
            self.decompressions += 1
            raw = zlib.decompress(payload)
            return np.frombuffer(raw, dtype=self.dtype).reshape(self.block_shape)
        return payload.numpy()

    def get_tensor(self, i: int) -> torch.Tensor:
        """Block ``i`` as a CPU tensor, pinned when the store pins: a raw
        block is the stored tensor itself, a compressed one is decoded
        straight into a fresh (pinned) buffer."""
        payload = self._payload(i)
        if not self.compress:
            return payload
        self.decompressions += 1
        out = torch.empty(self.block_shape, dtype=_torch_dtype(self.dtype),
                          pin_memory=self.pin)
        np.copyto(out.numpy().reshape(-1).view(np.uint8),
                  np.frombuffer(zlib.decompress(payload), np.uint8))
        return out

    def stats(self) -> dict:
        return {
            "n_blocks": self.n_blocks,
            "raw_bytes": self.raw_bytes,
            "compressed_bytes": self.compressed_bytes if self.compress else 0,
            "spill_bytes": self.spill_bytes,
            "loads_from_disk": self.loads_from_disk,
            "decompressions": self.decompressions,
            "resident_blocks": len(self._resident),
            "pinned": self.pin,
        }


class ChunkedDistVector:
    """An out-of-core ``DistVector``: host blocks streamed to the device.

    The device holds one block at a time (two while the next one's copy
    overlaps this one's work).  ``session.map_reduce`` with a chunked source
    runs one stage per block, and ``program.run_stream`` one graph replay
    per block.  A host-side container: :meth:`block_view` makes the
    :class:`BlockView` that enters a stage.

    Block ``b`` is rows ``[b * block_rows, (b + 1) * block_rows)`` of the
    dataset, split into ``n_shards`` shards of ``block_rows / n_shards``
    rows as a ``DistVector``'s rows are.  On a mesh of several processes
    (``mesh``) each rank keeps, of every block, its own shards' rows: rank
    ``r`` holds shards ``r * n_local ... (r + 1) * n_local - 1``, the
    ``local_rows = block_rows / P`` rows that start at global row
    :meth:`block_base` of the block.  So a rank holds ``1/P`` of the dataset
    on its host, its device holds its rows of the resident blocks, and its
    mapper sees the global indices the in-process mesh gives the same rows.
    ``block_rows``, ``n_blocks`` and ``n`` stay the dataset's; the byte
    provider (and its spill directory, one a rank) holds this rank's rows.
    """

    def __init__(self, provider: HostBlockStore, n: int, block_rows: int,
                 n_shards: int = 1, device=None, *, mesh: Mesh | None = None):
        self.provider = provider
        self.n = n
        self.block_rows = block_rows
        self.n_shards = n_shards
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.process else None
        if block_rows % n_shards:
            raise ValueError(f"block_rows={block_rows} must be a multiple of "
                             f"{n_shards} shards")
        if self.mesh is not None and (self.mesh.n_shards != n_shards
                                      or provider.block_shape[0] != self.local_rows):
            raise ValueError(f"a rank of the {self.mesh.n_ranks}-process mesh holds "
                             f"{self.local_rows} rows a block of {n_shards} shards, "
                             f"not {provider.block_shape[0]}")

    @classmethod
    def from_array(cls, x: np.ndarray, block_rows: int, n_shards: int = 1,
                   device=None, *, compress: bool = False,
                   spill_dir: str | None = None,
                   max_resident: int | None = None,
                   mesh: Mesh | None = None) -> "ChunkedDistVector":
        """Split a host array into blocks of ``block_rows`` (rounded up to a
        multiple of the shards), the last one padded with zeros; pinned on a
        CUDA device.  On a mesh of several processes (``mesh``; its shards
        and device) every rank passes the whole array and keeps its own
        rows of each block, spilling under ``spill_dir/rank_<r>``."""
        if block_rows <= 0:
            raise ValueError(f"block_rows must be positive, got {block_rows}")
        if mesh is not None:
            n_shards, device = mesh.n_shards, mesh.device
            mesh = mesh if mesh.process else None
        dev = resolve_device(device)
        x = np.asarray(x)
        n = x.shape[0]
        block_rows = max(n_shards, -(-block_rows // n_shards) * n_shards)
        n_blocks = max(1, -(-n // block_rows))
        lo, hi = 0, block_rows
        if mesh is not None:
            local = block_rows // mesh.n_ranks
            lo, hi = mesh.rank * local, (mesh.rank + 1) * local
            if spill_dir is not None:
                spill_dir = os.path.join(spill_dir, f"rank_{mesh.rank:05d}")
        blocks = []
        for b in range(n_blocks):
            blk = x[b * block_rows + lo:b * block_rows + hi]
            if blk.shape[0] < hi - lo:
                pad = np.zeros((hi - lo - blk.shape[0],) + x.shape[1:], x.dtype)
                blk = np.concatenate([blk, pad], axis=0)
            blocks.append(np.ascontiguousarray(blk))
        spill = None
        if spill_dir is not None:
            from repro_torch.checkpoint.manager import BlockStore

            spill = BlockStore(spill_dir)
        provider = HostBlockStore(blocks, compress=compress, spill=spill,
                                  max_resident=max_resident, pin=dev.type == "cuda")
        return cls(provider, n, block_rows, n_shards, dev, mesh=mesh)

    # -- geometry ------------------------------------------------------------

    @property
    def n_blocks(self) -> int:
        return self.provider.n_blocks

    @property
    def shape_tail(self) -> tuple:
        return tuple(self.provider.block_shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return _torch_dtype(self.provider.dtype)

    @property
    def local_rows(self) -> int:
        """The rows of a block this process holds (``block_rows`` without a
        process mesh)."""
        return self.block_rows // (self.mesh.n_ranks if self.mesh is not None else 1)

    @property
    def block_nbytes(self) -> int:
        """The bytes of a block this process moves to its device."""
        return int(self.local_rows * int(np.prod(self.shape_tail, dtype=np.int64))
                   * np.dtype(self.provider.dtype).itemsize)

    def __len__(self) -> int:
        return self.n

    def block_base(self, b: int) -> int:
        """The global index of the first row of block ``b`` this process
        holds."""
        rank = self.mesh.rank if self.mesh is not None else 0
        return b * self.block_rows + rank * self.local_rows

    def block_true_rows(self, b: int) -> int:
        """The dataset's rows in block ``b`` (its padding left out)."""
        return max(0, min(self.block_rows, self.n - b * self.block_rows))

    def local_true_rows(self, b: int) -> int:
        """This process's rows of block ``b`` that are the dataset's."""
        return max(0, min(self.local_rows, self.n - self.block_base(b)))

    # -- access --------------------------------------------------------------

    def block_host(self, b: int) -> np.ndarray:
        return self.provider.get(b)

    def block_tensor(self, b: int) -> torch.Tensor:
        """Block ``b`` as a CPU tensor (pinned on a CUDA machine)."""
        return self.provider.get_tensor(b)

    def block_view(self, b: int, stream=None) -> BlockView:
        """Copy block ``b`` to the device.  With a CUDA ``stream`` the copy
        runs there and the view's ``ready`` event marks its end; without
        one it runs on the current stream."""
        host = self.block_tensor(b)
        if stream is None or self.device.type != "cuda":
            return BlockView(host.to(self.device),
                             torch.full((), self.block_base(b), dtype=torch.int32,
                                        device=self.device), self.n)
        with torch.cuda.stream(stream):
            data = host.to(self.device, non_blocking=True)
            base = torch.full((), self.block_base(b), dtype=torch.int32,
                              device=self.device)
            ready = torch.cuda.Event()
            ready.record(stream)
        return BlockView(data, base, self.n, ready)

    def _rows_of_ranks(self, rows: np.ndarray) -> np.ndarray:
        """``rows [m, ...]`` of every rank, in rank order (a collective on a
        process mesh; ``rows`` itself without one)."""
        if self.mesh is None:
            return rows
        from repro_torch.core.collectives import gather_rows

        got = gather_rows(self.mesh, torch.from_numpy(np.ascontiguousarray(rows))
                          .to(self.device))
        return got.cpu().numpy()

    def collect(self) -> np.ndarray:
        """Host materialisation without the padding (small datasets, tests);
        on a process mesh every rank's rows, gathered (a collective)."""
        local = np.stack([self.block_host(b) for b in range(self.n_blocks)])
        out = self._rows_of_ranks(local)  # [P * n_blocks, local_rows, ...]
        n_ranks = self.mesh.n_ranks if self.mesh is not None else 1
        out = out.reshape((n_ranks, self.n_blocks) + local.shape[1:]).swapaxes(0, 1)
        return out.reshape((-1,) + self.shape_tail)[: self.n]

    def head(self, m: int) -> np.ndarray:
        """The first ``min(m, block_true_rows(0))`` rows of the dataset
        (rows of block 0), the same on every rank: a process mesh gathers
        each rank's first rows of block 0 (a collective)."""
        m = min(m, self.block_true_rows(0))
        first = self.block_host(0)[: min(m, self.local_rows)]
        return self._rows_of_ranks(first)[:m]

    def stats(self) -> dict:
        return self.provider.stats()


def require_rank_rows(mesh: Mesh | None, container, what: str) -> None:
    """Raise unless ``container`` (a ``DistVector``, ``DistHashMap`` or
    ``ChunkedDistVector``) holds this rank's rows of ``mesh``.  On a mesh
    of several processes a container made without it (``DistVector(x, n)``,
    ``distribute(x, 8)``, ``chunked(x, rows, 8)``) holds the global rows,
    and every rank would take them for its own shards: the result would
    count the data ``P`` times, silently."""
    if mesh is None or mesh.n_ranks == 1:
        return
    own = getattr(container, "mesh", None)
    if isinstance(container, DistHashMap):
        rows, want = container.table.keys.shape[0], mesh.n_local
    elif isinstance(container, ChunkedDistVector):
        rows = container.provider.block_shape[0]
        want = container.block_rows // mesh.n_ranks
    else:
        rows = container.data.shape[0]
        want = mesh.n_local * -(-container.n // mesh.n_shards)
    if (own is None or own.group is not mesh.group or own.n_shards != mesh.n_shards
            or own.rank != mesh.rank or rows != want):
        raise ValueError(
            f"{what} holds {rows} rows, not this rank's {want} of the {mesh.n_ranks}-process "
            "mesh: make it on the mesh (distribute(mesh=), make_dist_hashmap(mesh=), "
            "chunked(mesh=), or the session's) so that each rank keeps its own shards")


def chunked(x: np.ndarray, block_rows: int, n_shards: int = 1, device=None, *,
            compress: bool = False, spill_dir: str | None = None,
            max_resident: int | None = None, mesh: Mesh | None = None) -> ChunkedDistVector:
    """The paper's ``distribute`` for datasets that do not fit on the device:
    a host array as blocks streamed one at a time (:class:`ChunkedDistVector`).
    With ``mesh`` its shards and device; on a mesh of several processes
    every rank passes the whole array and keeps its own rows of each block."""
    return ChunkedDistVector.from_array(x, block_rows, n_shards, device,
                                        compress=compress, spill_dir=spill_dir,
                                        max_resident=max_resident, mesh=mesh)
