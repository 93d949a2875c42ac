"""Hash aggregation: reduce-by-key into an open-addressing (linear-probing)
table, duplicates welcome.

The combiner of ``engine="pallas"`` for ``DistHashMap`` targets, both before
the shuffle (raw pairs into a fresh table) and after it (received pairs
merged into the target shard's table through ``init=``); the counterpart of
the TPU kernel ``repro/kernels/hash_combine.py::hash_aggregate``.  On a CUDA
tensor :func:`hash_aggregate` launches ``csrc/hash_combine.cu`` once: each
CTA folds the duplicates of its lanes into a table of hot keys in shared
memory, then the probe rounds (claim, commit, deposit) run over the
compacted partials with no host sync (the source says why); on a CPU tensor
it runs :func:`hash_aggregate_plain`, the rounds over every lane in plain
PyTorch.

Both process every lane in one round-synchronous batch, so the table equals
``containers.hashmap_insert`` of the unique keys slot for slot.  (The TPU
kernel walks pair blocks in order, so its layout depends on its block size;
it agrees with this one as a dict.)
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_reduce import (
    _DTYPE_CODE,
    _OP_CODE,
    REDUCERS,
    fold_rows,
    identity,
)

EMPTY_KEY = -(2**31)  # "slot free" sentinel, int32 min
TABLE_BYTES = 48 * 1024  # the kernel's per-CTA table of hot keys (csrc kMaxTableBytes)
MAX_TABLE_BITS = 12  # at most 4,096 slots
CTA_PROBES = 4  # linear probes a warp group tries in that table (csrc kCtaProbes)
SOLO_LANES = 256  # lanes left at which one CTA runs the last rounds (csrc kSoloLanes)
_U32 = 0xFFFFFFFF


def hash32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finaliser of int32 keys, as int64 holding the uint32 value.

    PyTorch has no right shift on uint32 tensors, so the arithmetic runs in
    int64 and is masked to 32 bits after every multiply.  The second
    constant is taken as ``0x846CA68B - 2**32`` (same value modulo 2^32) so
    no product leaves the int64 range.
    """
    x = x.to(torch.int64) & _U32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _U32
    x = ((x ^ (x >> 15)) * (0x846CA68B - 2**32)) & _U32
    return x ^ (x >> 16)


def hash_aggregate_plain(keys, vals, table_cap, *, reducer="sum", init=None,
                         max_probes=None):
    """The plain PyTorch version: the same probe rounds over the lanes still
    active, ``scatter_reduce(amax)`` for the claim, a reducer fold for the
    deposit, and an early exit when no lane is left."""
    tkeys, tvals, ovf = _initial_table(keys, vals, table_cap, reducer, init)
    acc = tvals.dtype
    vals = vals.to(acc)
    home = hash32(keys) % table_cap
    lanes = torch.nonzero(keys != EMPTY_KEY).squeeze(1)
    for r in range(_probes(max_probes, keys.shape[0], table_cap)):
        if lanes.numel() == 0:
            break
        lkeys = keys[lanes]
        slot = (home[lanes] + r) % table_cap
        want = tkeys[slot] == EMPTY_KEY
        claim = torch.full_like(tkeys, EMPTY_KEY).scatter_reduce_(
            0, slot[want], lkeys[want], reduce="amax", include_self=True
        )
        tkeys = torch.where(claim != EMPTY_KEY, claim, tkeys)
        dep = tkeys[slot] == lkeys
        fold_rows(tvals, slot[dep], vals[lanes[dep]], reducer)
        lanes = lanes[~dep]
    return tkeys, tvals, ovf + lanes.numel()


def table_bits(v: int) -> int:
    """log2 of the slots of the kernel's per-CTA table of hot keys for rows
    of ``v`` values: the most slots (at most ``2^MAX_TABLE_BITS``) whose tag,
    multiplicity and ``[v]`` 4-byte partials fit :data:`TABLE_BYTES`; -1
    when one slot does not (no table: every warp group passes through)."""
    slot_bytes = 8 + 4 * v
    bits = MAX_TABLE_BITS
    while bits >= 0 and slot_bytes << bits > TABLE_BYTES:
        bits -= 1
    return bits


_default_bits = table_bits  # hash_aggregate's keyword of that name shadows it


class DeviceCount:
    """A count that kernels add to in device memory, so that no launch waits
    on the host: ``int()`` reads it (a sync), ``reset()`` sets it to 0."""

    def __init__(self):
        self._bufs: dict[int, torch.Tensor] = {}

    def buffer(self, device: torch.device) -> torch.Tensor:
        """The count's word on ``device`` (a CUDA device with its index)."""
        if device.index not in self._bufs:
            self._bufs[device.index] = torch.zeros((), dtype=torch.int64, device=device)
        return self._bufs[device.index]

    def reset(self) -> None:
        for buf in self._bufs.values():
            buf.zero_()

    def __int__(self) -> int:
        return sum(int(buf) for buf in self._bufs.values())


@functools.cache
def _kernel() -> ctypes._CFuncPtr:
    """The C entry point, built, loaded and typed once per process."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.entry("hash_combine", "blaze_hash_aggregate",
                        [*[vp] * 16, ctypes.c_longlong, *[i32] * 6, vp])


def hash_aggregate(keys: torch.Tensor, vals: torch.Tensor, table_cap: int, *,
                   reducer: str = "sum", init=None, max_probes: int | None = None,
                   table_bits: int | None = None):
    """Reduce ``keys [N]`` int32 (``EMPTY_KEY`` = dead lane) and ``vals
    [N, V]`` into a ``table_cap``-slot table.

    Returns ``(tkeys [C] int32, tvals [C, V] acc-dtype, overflow [] int32)``;
    ``overflow`` counts lanes still unplaced after ``max_probes`` rounds,
    plus whatever ``init=(keys, vals, overflow)`` carried.  The kernel on
    CUDA tensors (one launch, no host sync), the plain version on CPU
    tensors.  ``table_bits`` pins the log2 slots of the kernel's per-CTA
    table of hot keys (-1: none; default the module's ``table_bits(V)``, the
    most that fit); one that does not fit raises, on either device.  The
    result does not depend on it.
    """
    if reducer not in REDUCERS:
        raise ValueError(f"unknown reducer {reducer!r}; supported: {REDUCERS}")
    if vals.dim() != 2 or keys.shape != vals.shape[:1]:
        raise ValueError(f"need keys [N] and vals [N, V], got "
                         f"{tuple(keys.shape)} and {tuple(vals.shape)}")
    if table_cap < 1 or (max_probes is not None and max_probes < 1):
        raise ValueError(f"need table_cap >= 1 and max_probes >= 1, got "
                         f"{table_cap} and {max_probes}")
    bits = _default_bits(vals.shape[1])
    if table_bits is not None:
        if not isinstance(table_bits, int) or not -1 <= table_bits <= bits:
            raise ValueError(f"hash_aggregate: table_bits {table_bits!r} does not fit "
                             f"rows of {vals.shape[1]} values (-1 to {bits})")
        bits = table_bits
    if keys.device.type == "cpu" and vals.device.type == "cpu":
        return hash_aggregate_plain(keys, vals, table_cap, reducer=reducer,
                                    init=init, max_probes=max_probes)
    if keys.device != vals.device or vals.device.type != "cuda":
        raise ValueError(f"keys on {keys.device}, vals on {vals.device}: need "
                         "both on one CUDA device (or both on the CPU)")
    if keys.dtype != torch.int32 or vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"need int32 keys and f32/bf16/i32 vals, got "
                        f"{keys.dtype} and {vals.dtype}")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("keys and vals must be contiguous")
    n, v = vals.shape
    if n >= 2**31 or table_cap >= 2**31:
        raise ValueError(f"N = {n}, C = {table_cap}: the kernel takes fewer than 2^31")
    if n == 0:
        return _initial_table(keys, vals, table_cap, reducer, init)
    from repro_torch.core.cost import acc_dtype  # core imports this module

    dev = vals.device
    acc = acc_dtype(vals.dtype)
    # The kernel writes the table: a copy of init's, or a fresh one.
    tkeys = torch.empty((table_cap,), dtype=torch.int32, device=dev)
    tvals = torch.empty((table_cap, v), dtype=acc, device=dev)
    ovf = torch.empty((), dtype=torch.int32, device=dev)
    ikeys = ivals = iovf = None
    if init is not None:
        ikeys = init[0].to(dev, torch.int32).contiguous()
        ivals = init[1].to(dev, acc).contiguous()
        iovf = torch.as_tensor(init[2], dtype=torch.int32, device=dev)
        if ikeys.shape != (table_cap,) or ivals.shape != (table_cap, v) or iovf.dim():
            raise ValueError(f"init: need keys [{table_cap}], vals [{table_cap}, {v}] and "
                             f"a scalar overflow, got {tuple(ikeys.shape)}, "
                             f"{tuple(ivals.shape)} and {tuple(iovf.shape)}")
    probes = _probes(max_probes, n, table_cap)
    # Scratch, every word written by the kernel before it is read: the
    # compacted lanes' keys, multiplicities and partial rows (with room for
    # the lanes gathered for the last rounds), the claims of even and odd
    # rounds [2, C], and apart, so that hash_aggregate.lanes holds no more
    # than itself, live[probes + 1] and the gathered count.
    m = n + SOLO_LANES
    ints = torch.empty(3 * m + 2 * table_cap, dtype=torch.int32, device=dev)
    svals = torch.empty((n, v), dtype=tvals.dtype, device=dev)
    counts = torch.empty(probes + 2, dtype=torch.int32, device=dev)
    base, word = ints.data_ptr(), ints.element_size()
    skey, smult, sidx, claim = (base + i * m * word for i in range(4))
    live, gathered = counts.data_ptr(), counts[probes + 1:].data_ptr()
    args = (keys.data_ptr(), vals.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in (ikeys, ivals, iovf)),
            tkeys.data_ptr(), tvals.data_ptr(),
            ovf.data_ptr(), hash_aggregate.rounds.buffer(dev).data_ptr(), skey, smult,
            sidx, svals.data_ptr(), claim, live, gathered, n, v, table_cap, probes,
            bits, _DTYPE_CODE[vals.dtype], _OP_CODE[reducer])
    index = dev.index
    if index == torch.cuda.current_device():  # the launch goes to the current device
        err = _kernel()(*args, _build.raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = _kernel()(*args, _build.raw_stream(index))
    _build.check(err, "hash_aggregate")
    hash_aggregate.launches += 1
    hash_aggregate.lanes = counts[: probes + 1]
    return tkeys, tvals, ovf


# Kernel launches since the caller last reset it: one a call.
hash_aggregate.launches = 0
# Probe rounds the kernel ran, counted on the card (int() reads them).
hash_aggregate.rounds = DeviceCount()
# The last call's live[]: [0] the lanes left after the pre-combine, [r + 1]
# those left after round r (0 once every lane is placed).
hash_aggregate.lanes = None


def _probes(max_probes: int | None, n: int, table_cap: int) -> int:
    if max_probes is not None:
        return max_probes
    from repro_torch.core.cost import choose_probe_depth

    return choose_probe_depth(n, table_cap)


def _initial_table(keys, vals, table_cap, reducer, init):
    """(keys, vals, overflow) to merge into: copies of ``init`` in the
    accumulator dtype, or a fresh table."""
    from repro_torch.core.cost import acc_dtype  # core imports this module

    acc = acc_dtype(vals.dtype)
    dev = vals.device
    if init is None:
        return (
            torch.full((table_cap,), EMPTY_KEY, dtype=torch.int32, device=dev),
            torch.full((table_cap, vals.shape[1]), identity(reducer, acc),
                       dtype=acc, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
        )
    ikeys, ivals, iovf = init
    return (
        ikeys.to(torch.int32).clone(),
        ivals.to(acc).clone(),
        torch.as_tensor(iovf, dtype=torch.int32, device=dev).clone(),
    )
