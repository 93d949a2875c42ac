"""Hash aggregation: reduce-by-key into an open-addressing (linear-probing)
table, duplicates welcome.

The combiner of ``engine="pallas"`` for ``DistHashMap`` targets, both before
the shuffle (raw pairs into a fresh table) and after it (received pairs
merged into the target shard's table through ``init=``); the counterpart of
the TPU kernel ``repro/kernels/hash_combine.py::hash_aggregate``.  On a CUDA
tensor :func:`hash_aggregate` runs the rounds of ``csrc/hash_combine.cu``
(claim, commit, deposit; the source says why); on a CPU tensor it runs
:func:`hash_aggregate_plain`, the same rounds in plain PyTorch.

Both process every lane in one round-synchronous batch, so the table equals
``containers.hashmap_insert`` of the unique keys slot for slot.  (The TPU
kernel walks pair blocks in order, so its layout depends on its block size;
it agrees with this one as a dict.)
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_reduce import (
    _DTYPE_CODE,
    _OP_CODE,
    REDUCERS,
    THREADS,
    fold_rows,
    identity,
)

EMPTY_KEY = -(2**31)  # "slot free" sentinel, int32 min
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


def hash_aggregate(keys: torch.Tensor, vals: torch.Tensor, table_cap: int, *,
                   reducer: str = "sum", init=None, max_probes: int | None = None):
    """Reduce ``keys [N]`` int32 (``EMPTY_KEY`` = dead lane) and ``vals
    [N, V]`` into a ``table_cap``-slot table.

    Returns ``(tkeys [C] int32, tvals [C, V] acc-dtype, overflow [] int32)``;
    ``overflow`` counts lanes still unplaced after ``max_probes`` rounds,
    plus whatever ``init=(keys, vals, overflow)`` carried.  The kernel on
    CUDA tensors, the plain version on CPU tensors.
    """
    if reducer not in REDUCERS:
        raise ValueError(f"unknown reducer {reducer!r}; supported: {REDUCERS}")
    if vals.dim() != 2 or keys.shape != vals.shape[:1]:
        raise ValueError(f"need keys [N] and vals [N, V], got "
                         f"{tuple(keys.shape)} and {tuple(vals.shape)}")
    if table_cap < 1 or (max_probes is not None and max_probes < 1):
        raise ValueError(f"need table_cap >= 1 and max_probes >= 1, got "
                         f"{table_cap} and {max_probes}")
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
    tkeys, tvals, ovf = _initial_table(keys, vals, table_cap, reducer, init)
    n, v = vals.shape
    if n == 0:
        return tkeys, tvals, ovf
    tkeys, tvals = tkeys.contiguous(), tvals.contiguous()
    dev = vals.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lane_blocks = min(-(-n // THREADS), sms * 8)
    slot_blocks = min(-(-table_cap // THREADS), sms * 8)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    claim_fn = _build.entry("hash_combine", "blaze_hash_claim",
                            [vp, vp, vp, vp, i64, i32, i32, i32, i32, vp])
    commit_fn = _build.entry("hash_combine", "blaze_hash_commit",
                             [vp, vp, i32, i32, i32, vp])
    deposit_fn = _build.entry("hash_combine", "blaze_hash_deposit",
                              [vp, vp, vp, vp, vp, vp, i64, i32, i32, i32,
                               i32, i32, i32, i32, vp])
    active = (keys != EMPTY_KEY).to(torch.uint8)
    claim = torch.full_like(tkeys, EMPTY_KEY)
    remaining = torch.zeros(1, dtype=torch.int32, device=dev)
    left = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for r in range(_probes(max_probes, n, table_cap)):
            remaining.zero_()
            _build.check(claim_fn(
                keys.data_ptr(), active.data_ptr(), tkeys.data_ptr(),
                claim.data_ptr(), n, table_cap, r, lane_blocks, THREADS,
                stream), "hash_aggregate claim")
            hash_aggregate.launches += 1
            _build.check(commit_fn(
                tkeys.data_ptr(), claim.data_ptr(), table_cap, slot_blocks,
                THREADS, stream), "hash_aggregate commit")
            hash_aggregate.launches += 1
            _build.check(deposit_fn(
                keys.data_ptr(), vals.data_ptr(), active.data_ptr(),
                tkeys.data_ptr(), tvals.data_ptr(), remaining.data_ptr(), n, v,
                table_cap, r, _DTYPE_CODE[vals.dtype], _OP_CODE[reducer],
                lane_blocks, THREADS, stream), "hash_aggregate deposit")
            hash_aggregate.launches += 1
            left = int(remaining.item())  # host sync: the early-exit test
            if left == 0:
                break
    return tkeys, tvals, ovf + left


# Kernel launches since the caller last reset it: three per probe round
# (claim, commit, deposit).
hash_aggregate.launches = 0


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
