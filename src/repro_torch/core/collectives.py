"""Collectives over shards stacked on dim 0 of one device.

The counterpart of ``RealCollectives`` in ``repro/core/mapreduce.py``: a
shard stage names no collective directly but goes through this object.  Here
every per-shard value is a tensor whose leading dimension is the shard, and
each collective is plain tensor arithmetic over that dimension.  The result
of a reducing or gathering collective is replicated on every shard in JAX;
the port keeps its one copy.  A dense sum may narrow its payload on the
wire (``wire="bf16" | "int8"``, through ``distributed.collectives``), the
counterpart of ``RealCollectives.reduce``/``reduce_feedback``.

The topology: on a ``("node", "data")`` mesh the shards group node-major
into ``n_nodes`` rows (``containers.Mesh``).  A flat collective reduces all
``S`` shards at once, whatever the rows.  ``reduce(..., hier=True)`` and
``reduce_feedback(..., hier=True)`` on more than one node take two hops,
as the reference's do: each node's shards at full precision, then the node
partials across the slow hop, the only one the wire narrows.

Across processes (``ProcessCollectives``): a mesh that carries a
``torch.distributed`` group (``launch.mesh.make_node_data_mesh`` with a
group up) gives each process one node row, its ``n_local`` shards stacked
on its device as above.  The intra-node hop stays the in-process arithmetic;
the inter-node hop crosses processes.  A reduce gathers, then folds: it
all-gathers exactly the partials the in-process code would fold (every
shard's for a flat reduce, each node's full-precision partial for a
hierarchical one; the wire's narrowed payload where a wire narrows) and
every rank runs the fold ``LocalCollectives`` runs.  So ``P`` processes give
the bits of the in-process ``(P x S/P)`` mesh for every dtype, reducer and
wire, and every rank holds the same replicated result.  A ring
``all_reduce`` would add in another order and lose both.

``fire=True`` makes every :meth:`reduce` hit the ``collective`` fault point
(``core.faults``), and a hierarchical one also ``collective.inter`` right
before its inter-node hop.  The reference hits them while ``jax.jit``
traces a stage; here a stage runs eagerly on every call, so its owner sets
``fire`` only on the runs that stand for a trace (``mapreduce.CachedStage``,
``Program``).
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from repro_torch.core import faults
from repro_torch.core.reducers import Reducer


class LocalCollectives:
    """The collectives of a mesh whose shards all live in this process
    (``n_local == n_shards``), and the one implementation of every reduce:
    :class:`ProcessCollectives` only sets ``gather``, so ``P`` processes
    fold the same partials in the same order as one."""

    #: Gathers every rank's rows of a tensor in rank order (a process mesh);
    #: None in one process, where every row is already here.
    gather = None

    def __init__(self, n_shards: int, device: torch.device, fire: bool = False,
                 n_nodes: int = 1):
        if n_shards % n_nodes:
            raise ValueError(f"cannot split {n_shards} shards into {n_nodes} node rows")
        self.n_shards = n_shards
        self.n_local = n_shards  # every shard lives in this process
        self.first_shard = 0
        self.device = device
        self.fire = fire
        self.n_nodes = n_nodes
        self.local_nodes = n_nodes  # the node rows this process holds

    def _is_hier(self, hier: bool) -> bool:
        return bool(hier) and self.n_nodes > 1

    def _fire(self, point: str) -> None:
        if self.fire:
            faults.fault_point(point)

    def _all(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` (``x`` itself in one process)."""
        return x if self.gather is None else self.gather(x)

    def axis_index(self) -> torch.Tensor:
        """This process's global shard indices, ``[n_local]`` (every
        shard's, ``[S]``, in one process)."""
        return torch.arange(self.first_shard, self.first_shard + self.n_local,
                            device=self.device)

    def _hop(self, partial: torch.Tensor, red: Reducer, wire: str) -> torch.Tensor:
        """One reduction hop over the leading (shard or node) dimension of
        every rank's rows: a narrowed sum through ``compressed_psum`` (its
        payload is what crosses), else the reducer's own collective over the
        gathered rows (sum/min/max over the dimension, gather-then-fold for
        prod and custom reducers)."""
        if wire == "none" or red.name != "sum":
            return red.collective(self._all(partial))
        if wire not in ("bf16", "int8"):
            raise ValueError(f"unknown wire mode {wire!r}")
        from repro_torch.distributed.collectives import compressed_psum

        return compressed_psum(partial, wire=wire, gather=self.gather)

    def reduce(self, partial: torch.Tensor, red: Reducer,
               wire: str = "none", hier: bool = False) -> torch.Tensor:
        """``[n_local, ...]`` shard partials → the replicated ``[...]`` with
        the reducer's collective (sum/min/max over the shard dimension;
        gather-then-fold for prod and custom reducers); a sum with
        ``wire="bf16" | "int8"`` goes through ``compressed_psum``
        (shared-scale int8 over the int8 lattice, or bf16).  ``hier=True``
        on more than one node: each node's shards first at full precision
        (the intra hop, always in this process), then the node partials, the
        wire narrowing only that second hop."""
        self._fire("collective")
        if not self._is_hier(hier):
            return self._hop(partial, red, wire)
        if wire != "none" and red.name == "sum":
            from repro_torch.distributed.collectives import intra_node_sum

            nodes = intra_node_sum(partial, self.local_nodes)
        else:
            by_node = partial.reshape((self.local_nodes, -1) + tuple(partial.shape[1:]))
            nodes = torch.stack([red.collective(by_node[n])
                                 for n in range(self.local_nodes)])
        self._fire("collective.inter")
        return self._hop(nodes, red, wire)

    def reduce_feedback(self, partial: torch.Tensor, red: Reducer, wire: str,
                        residual: torch.Tensor, hier: bool = False):
        """``wire="int8"`` sums with error feedback: each shard quantizes
        ``partial + residual`` per 256-element block
        (``quantize_with_feedback``), the lattices and their scales cross,
        every rank dequantizes them and sums in f32 in shard order, and what
        each shard's narrowing dropped comes back as its next residual
        ``[n_local, ...]``, which stays where it was made.  ``hier=True`` on
        more than one node folds each node's shards at full precision before
        the quantisation: each node quantizes its partial plus its residual,
        so ``n_nodes`` addends pass the lattice, and every shard of a node
        carries the node's residual.  Any other (reducer, wire) is
        :meth:`reduce` with the residual passed through."""
        if wire != "int8" or red.name != "sum":
            return self.reduce(partial, red, wire, hier=hier), residual
        from repro_torch.core.serialization import Quantized, dequantize, quantize_with_feedback

        p32 = partial.to(torch.float32)
        per = 1
        if self._is_hier(hier):
            from repro_torch.distributed.collectives import intra_node_sum

            per = self.n_local // self.local_nodes
            p32 = intra_node_sum(p32, self.local_nodes)  # the full-precision intra hop
            residual = residual[::per]
            self._fire("collective.inter")
        qs, new_residual = [], []
        for s in range(p32.shape[0]):
            q, r = quantize_with_feedback(p32[s], residual[s], "int8")
            qs.append(q)
            new_residual.append(r)
        if self.gather is not None:  # the lattices and their scales cross
            lattice = self.gather(torch.stack([q.payload for q in qs]))
            scales = self.gather(torch.stack([q.scale for q in qs]))
            qs = [Quantized(lattice[s], scales[s], "int8") for s in range(lattice.shape[0])]
        total = torch.stack([dequantize(q, p32[0]) for q in qs]).sum(0).to(partial.dtype)
        new_residual = torch.stack(new_residual)
        if per > 1:
            new_residual = new_residual.repeat_interleave(per, dim=0)
        return total, new_residual

    def all_gather_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """``[n_local, n, ...]`` → ``[S * n, ...]``: every shard's rows, in
        shard order."""
        return self._all(x).reshape((-1,) + tuple(x.shape[2:]))

    def all_to_all_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """``[S_src, S_dst, cap, ...]`` → ``[S_dst, S_src, cap, ...]``: each
        destination receives its bucket from every source."""
        return x.transpose(0, 1).contiguous()


# ---------------------------------------------------------------------------
# Across processes: one node row a process over torch.distributed
# ---------------------------------------------------------------------------


def _all_gather_single():
    """``all_gather_single``, named ``all_gather_into_tensor`` before
    PyTorch 2.13."""
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


#: Dtypes NCCL has no type for; they cross as their bytes (the collectives
#: here only move data).
_AS_BYTES = (torch.int16, torch.uint16)


def _bytes_of(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous, its last dimension as bytes where NCCL lacks its
    dtype (a 0-d tensor as one row)."""
    x = x.contiguous()
    if x.dtype not in _AS_BYTES:
        return x
    return (x.reshape(1) if x.dim() == 0 else x).view(torch.uint8)


def _from_bytes(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.view(like.dtype) if like.dtype in _AS_BYTES else y


def gather_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x [m, ...]`` on every rank of ``mesh``'s group → ``[P * m, ...]``,
    rank 0's rows first (one ``all_gather``).  Every rank passes the same
    shape and dtype."""
    b = _bytes_of(x)
    out = torch.empty((mesh.n_ranks * b.shape[0],) + tuple(b.shape[1:]),
                      dtype=b.dtype, device=b.device)
    _all_gather_single()(out, b, group=mesh.group)
    return _from_bytes(out, x)


def agree(mesh, value: int) -> int:
    """Rank 0's ``value``, on every rank (a host decision that must not
    differ between ranks, such as tuning's winner); ``value`` itself on a
    mesh without a group."""
    if getattr(mesh, "group", None) is None:
        return value
    t = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    dist.broadcast(t, src=dist.get_global_rank(mesh.group, 0), group=mesh.group)
    return int(t.item())


def all_ranks_equal(mesh, value: int) -> bool:
    """Whether every rank of ``mesh``'s group holds the same ``value``
    (True without a group)."""
    if getattr(mesh, "group", None) is None:
        return True
    got = gather_rows(mesh, torch.tensor([int(value)], dtype=torch.int64,
                                         device=mesh.device))
    return bool((got == got[0]).all().item())


class ProcessCollectives(LocalCollectives):
    """The collectives of a mesh whose node rows are processes.

    Each rank holds ``n_local = S / P`` shards, its node row, stacked on dim
    0 of its device; ``n_shards`` is the global count ``S``.  Every reduce
    is :class:`LocalCollectives`' own with ``gather`` set: it gathers the
    partials the in-process fold folds, then every rank folds them alike
    (module docstring) — flat, every shard's partial ``[S, ...]``;
    ``hier``, this row's full-precision partial, one a node ``[P, ...]``; a
    narrowed wire its payload: bf16 values, or the int8 lattice and its
    scales (the shared scale is the max of the ranks' maxima, so exact).
    The fault points fire where they fire in process, before anything
    crosses.  Only the shuffle is its own: :meth:`all_to_all_tiled` moves
    ``[n_local, S, cap, ...]`` to ``[n_local, S, cap, ...]`` through
    ``all_to_all_single``, data movement only.

    In a captured CUDA graph each collective is one NCCL operation (two for
    the int8 wire's scale and lattice).
    """

    def __init__(self, mesh, fire: bool = False):
        super().__init__(mesh.n_shards, mesh.device, fire=fire, n_nodes=mesh.n_nodes)
        self.mesh = mesh
        self.group = mesh.group
        self.n_ranks = mesh.n_ranks
        self.n_local = mesh.n_local
        self.local_nodes = mesh.n_nodes // mesh.n_ranks
        self.first_shard = mesh.rank * mesh.n_local
        self.gather = functools.partial(gather_rows, mesh)

    def all_to_all_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """``[n_local src, S dst, cap, ...]`` → ``[n_local dst, S src, cap,
        ...]``: each destination shard receives its bucket from every
        source shard, sources in shard order."""
        nl, P = self.n_local, self.n_ranks
        tail = tuple(x.shape[2:])
        # [src, (rank, dst), ...] -> [rank, dst, src, ...]: rank p's chunk first
        send = _bytes_of(x.reshape((nl, P, nl) + tail).permute(
            (1, 2, 0) + tuple(range(3, 3 + len(tail)))))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        recv = _from_bytes(recv, x)
        # [src rank, dst, src, ...] -> [dst, (src rank, src), ...]
        return recv.permute((1, 0, 2) + tuple(range(3, 3 + len(tail)))).reshape(
            (nl, P * nl) + tail)
