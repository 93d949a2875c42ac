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
partials across the slow hop, the only one the wire narrows.  Collectives
across processes are not built (ROADMAP.md, Queue 1 item 6b).

``fire=True`` makes every :meth:`reduce` hit the ``collective`` fault point
(``core.faults``), and a hierarchical one also ``collective.inter`` right
before its inter-node hop.  The reference hits them while ``jax.jit``
traces a stage; here a stage runs eagerly on every call, so its owner sets
``fire`` only on the runs that stand for a trace (``mapreduce.CachedStage``,
``Program``).
"""
from __future__ import annotations

import torch

from repro_torch.core import faults
from repro_torch.core.reducers import Reducer


def _collective_reduce(partial: torch.Tensor, red: Reducer, wire: str) -> torch.Tensor:
    """One reduction hop over the leading (shard or node) dimension: a
    narrowed sum through ``compressed_psum``, else the reducer's own
    collective (sum/min/max over the dimension, gather-then-fold for prod
    and custom reducers)."""
    if wire == "none" or red.name != "sum":
        return red.collective(partial)
    if wire not in ("bf16", "int8"):
        raise ValueError(f"unknown wire mode {wire!r}")
    from repro_torch.distributed.collectives import compressed_psum

    return compressed_psum(partial, wire=wire)


class LocalCollectives:
    def __init__(self, n_shards: int, device: torch.device, fire: bool = False,
                 n_nodes: int = 1):
        if n_shards % n_nodes:
            raise ValueError(f"cannot split {n_shards} shards into {n_nodes} node rows")
        self.n_shards = n_shards
        self.device = device
        self.fire = fire
        self.n_nodes = n_nodes

    def _is_hier(self, hier: bool) -> bool:
        return bool(hier) and self.n_nodes > 1

    def _fire(self, point: str) -> None:
        if self.fire:
            faults.fault_point(point)


    def axis_index(self) -> torch.Tensor:
        """Every shard's index, ``[S]``."""
        return torch.arange(self.n_shards, device=self.device)

    def reduce(self, partial: torch.Tensor, red: Reducer,
               wire: str = "none", hier: bool = False) -> torch.Tensor:
        """``[S, ...]`` shard partials → ``[...]`` with the reducer's
        collective (sum/min/max over the shard dimension; gather-then-fold
        for prod and custom reducers); a sum with ``wire="bf16" | "int8"``
        goes through ``compressed_psum`` (shared-scale int8 over the int8
        lattice, or bf16).  ``hier=True`` on more than one node: each
        node's shards first at full precision, then the node partials, the
        wire narrowing only that second hop."""
        self._fire("collective")
        if not self._is_hier(hier):
            return _collective_reduce(partial, red, wire)
        if wire != "none" and red.name == "sum":
            self._fire("collective.inter")
            from repro_torch.distributed.collectives import compressed_psum

            return compressed_psum(partial, wire=wire, n_nodes=self.n_nodes)
        by_node = partial.reshape((self.n_nodes, -1) + tuple(partial.shape[1:]))
        intra = torch.stack([_collective_reduce(by_node[n], red, "none")
                             for n in range(self.n_nodes)])
        self._fire("collective.inter")
        return _collective_reduce(intra, red, wire)

    def reduce_feedback(self, partial: torch.Tensor, red: Reducer, wire: str,
                        residual: torch.Tensor, hier: bool = False):
        """``wire="int8"`` sums with error feedback: each shard quantizes
        ``partial + residual`` per 256-element block
        (``quantize_with_feedback``), the dequantized lattices are summed in
        f32, and what each shard's narrowing dropped comes back as its next
        residual ``[S, ...]``.  ``hier=True`` on more than one node folds
        each node's shards at full precision before the quantisation: each
        node quantizes its partial plus its residual, so ``n_nodes`` addends
        pass the lattice, and every shard of a node carries the node's
        residual.  Any other (reducer, wire) is :meth:`reduce` with the
        residual passed through."""
        if wire != "int8" or red.name != "sum":
            return self.reduce(partial, red, wire, hier=hier), residual
        from repro_torch.core.serialization import dequantize, quantize_with_feedback

        p32 = partial.to(torch.float32)
        per = 1
        if self._is_hier(hier):
            from repro_torch.distributed.collectives import intra_node_sum

            per = self.n_shards // self.n_nodes
            p32 = intra_node_sum(p32, self.n_nodes)  # the full-precision intra hop
            residual = residual[::per]
            self._fire("collective.inter")
        deq, new_residual = [], []
        for s in range(p32.shape[0]):
            q, r = quantize_with_feedback(p32[s], residual[s], "int8")
            deq.append(dequantize(q, p32[s]))
            new_residual.append(r)
        total = torch.stack(deq).sum(0).to(partial.dtype)
        new_residual = torch.stack(new_residual)
        if per > 1:
            new_residual = new_residual.repeat_interleave(per, dim=0)
        return total, new_residual

    def all_gather_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """``[S, n, ...]`` → ``[S * n, ...]``: every shard's rows, in shard
        order."""
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def all_to_all_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """``[S_src, S_dst, cap, ...]`` → ``[S_dst, S_src, cap, ...]``: each
        destination receives its bucket from every source."""
        return x.transpose(0, 1).contiguous()

