"""Compressed collectives: the fast-serialization analogue on the wire.

The counterpart of ``repro/distributed/collectives.py`` over the port's
shard model: every function takes the shards' values stacked on dim 0 of
one tensor ``[S, ...]`` (``core.collectives.LocalCollectives``) and returns
the reduced ``[...]``, which JAX replicates on every shard.
``compressed_psum`` narrows the payload (bf16, or int8 with one scale
shared by all shards) before the sum; ``psum_with_feedback`` returns what
the narrowing dropped as the next round's residual, so iterative jobs stay
unbiased.

As in the reference, the int8 sum runs in int32 over the int8 lattice
(numerically an int8 wire), and a bf16 sum folds the shards in order,
rounding to bf16 at every addition, as a bf16 ring would.

**Hierarchical form.**  On a ``("node", "data")`` mesh the intra-node links
are the fast ones.  ``n_nodes > 1`` is the reference's ``intra_axis=``: the
shards, grouped node-major ``[n_nodes, n_data, ...]``, are first summed
over each node's ``n_data`` shards at full precision (the reference's
``psum`` over ``intra_axis``), and only the ``n_nodes`` node partials cross
the narrowed wire (its ``axis``, the node axis): the int8 scale is the
largest magnitude over the node partials, the reference's ``pmax`` over
the node axis.  One quantisation addend a node instead of one a shard.

**Across processes.**  ``gather=`` (``core.collectives.ProcessCollectives``)
means ``x`` holds this rank's rows only: the narrowed payload of those rows
is gathered (bf16 values; the int8 lattice, after one gather of the ranks'
largest magnitudes for the shared scale) and every rank folds all of them in
shard order, the bits of the in-process sum over the gathered rows.
"""
from __future__ import annotations

import numpy as np
import torch


def intra_node_sum(x: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """``[S, ...]`` → ``[n_nodes, ...]``: each node's ``S / n_nodes``
    shards summed at full precision (the hierarchical reduce's first hop)."""
    return x.reshape((n_nodes, x.shape[0] // n_nodes) + tuple(x.shape[1:])).sum(
        1, dtype=x.dtype)


def _int8_scale(x: torch.Tensor, gather=None) -> torch.Tensor:
    """The scale every shard shares: the largest magnitude over all shards
    (``pmax``; with ``gather``, the largest of the ranks' largest) over
    127, at least 1e-30."""
    amax = x.abs().amax()
    if gather is not None:
        amax = gather(amax.reshape(1)).amax()
    return torch.clamp(amax / 127.0, min=1e-30)


def _int8_lattice(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127)


def compressed_psum(x: torch.Tensor, *, wire: str = "none",
                    n_nodes: int = 1, gather=None) -> torch.Tensor:
    """Sum ``x [S, ...]`` over its shard dimension with the payload narrowed
    per ``wire``; with ``n_nodes > 1``, hierarchically: each node's shards
    at full precision first, then the narrowed sum of the node partials.
    ``gather`` (across processes): ``x`` is this rank's rows, and the sum
    runs over every rank's."""
    if n_nodes > 1:
        x = intra_node_sum(x, n_nodes)
    g = gather if gather is not None else (lambda t: t)
    if wire == "none":
        return g(x).sum(0, dtype=x.dtype)
    if wire == "bf16":
        xb = g(x.to(torch.bfloat16))
        out = xb[0]
        for s in range(1, xb.shape[0]):
            out = out + xb[s]
        return out.to(x.dtype)
    if wire == "int8":
        x32 = x.to(torch.float32)
        scale = _int8_scale(x32, gather)
        return _int8_sum(_int8_lattice(x32, scale), scale, gather).to(x.dtype)
    raise ValueError(f"unknown wire {wire!r}")


def _int8_sum(lattice: torch.Tensor, scale: torch.Tensor, gather=None) -> torch.Tensor:
    """The f32 sum of every shard's lattice row (gathered from every rank
    with ``gather``: the int8 lattice is what crosses) in int32, times the
    shared scale."""
    if gather is not None:
        lattice = gather(lattice.to(torch.int8))
    s = lattice.to(torch.int32).sum(0, dtype=torch.int32)
    return s.to(torch.float32) * scale


def psum_with_feedback(x: torch.Tensor, residual: torch.Tensor, *, wire: str,
                       n_nodes: int = 1, gather=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(reduced, new_residual)``: error feedback around the lossy sum.

    ``residual`` is ``[S, ...]`` f32, one per shard.  With a shared scale
    the quantisation is deterministic, so each shard's loss is recomputed
    rather than echoed back, as in the reference.  With ``n_nodes > 1`` the
    intra-node hop is folded at full precision before the quantisation, so
    the residual tracks the one lossy hop: one per node, added to the node
    partial, and every shard of a node carries the same rows (the
    reference's residual is replicated within a node).  ``gather`` (across
    processes, as in :func:`compressed_psum`): ``x`` and ``residual`` are
    this rank's rows (``n_nodes`` its node rows), the sum runs over every
    rank's in shard order, the int8 scale is the largest of the ranks'
    maxima, and the new residual is this rank's rows.
    """
    if n_nodes > 1:
        per = x.shape[0] // n_nodes
        target = intra_node_sum(x, n_nodes).to(torch.float32) + residual[::per]
    else:
        target = x.to(torch.float32) + residual
    if wire == "int8":
        scale = _int8_scale(target, gather)
        lattice = _int8_lattice(target, scale)
        reduced = _int8_sum(lattice, scale, gather)
        new_residual = target - lattice * scale
    elif wire == "bf16":
        reduced = compressed_psum(target, wire=wire, gather=gather)
        new_residual = target - target.to(torch.bfloat16).to(torch.float32)
    else:
        reduced = compressed_psum(target, wire=wire, gather=gather)
        new_residual = torch.zeros_like(target)
    if n_nodes > 1:
        new_residual = new_residual.repeat_interleave(per, dim=0)
    return reduced, new_residual


#: Narrowed wire widths; every other mode derives from the tensor dtype.
_WIRE_ITEMSIZE = {"bf16": 2, "int8": 1}

#: One f32 scale accompanies each int8 frame.
_INT8_SCALE_BYTES = 4


def wire_bytes(x, wire: str, *, n_scales: int = 1) -> int:
    """Payload bytes one ring pass moves for this tensor (or shape-bearing
    array): ``wire="none"`` takes the element width from the dtype;
    ``"int8"`` counts the lattice plus ``n_scales`` f32 scales (1 for the
    shared-scale collective; ``ceil(n / block)`` for the per-block
    serialization format)."""
    if wire != "none" and wire not in _WIRE_ITEMSIZE:
        raise ValueError(f"unknown wire {wire!r}")
    shape = tuple(getattr(x, "shape", np.shape(x)))
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if wire == "none":
        if isinstance(x, torch.Tensor):
            return n * x.element_size()
        return n * np.dtype(getattr(x, "dtype", np.asarray(x).dtype)).itemsize
    payload = n * _WIRE_ITEMSIZE[wire]
    if wire == "int8":
        if n_scales < 1:
            raise ValueError(f"n_scales must be >= 1, got {n_scales}")
        payload += n_scales * _INT8_SCALE_BYTES
    return payload
