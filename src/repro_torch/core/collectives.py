"""Collectives over shards stacked on dim 0 of one device.

The counterpart of ``RealCollectives`` in ``repro/core/mapreduce.py``: a
shard stage names no collective directly but goes through this object.  Here
every per-shard value is a tensor whose leading dimension is the shard, and
each collective is plain tensor arithmetic over that dimension.  The result
of a reducing or gathering collective is replicated on every shard in JAX;
the port keeps its one copy.  A dense sum may narrow its payload on the
wire (``wire="bf16" | "int8"``, through ``distributed.collectives``), the
counterpart of ``RealCollectives.reduce``/``reduce_feedback``'s flat form.
Collectives across cards, and the hierarchical form, come with the
multi-host slice.

``fire=True`` makes every :meth:`reduce` hit the ``collective`` fault point
(``core.faults``).  The reference hits it while ``jax.jit`` traces a stage;
here a stage runs eagerly on every call, so its owner sets ``fire`` only on
the runs that stand for a trace (``mapreduce.CachedStage``, ``Program``).
"""
from __future__ import annotations

import torch

from repro_torch.core import faults
from repro_torch.core.reducers import Reducer


class LocalCollectives:
    def __init__(self, n_shards: int, device: torch.device, fire: bool = False):
        self.n_shards = n_shards
        self.device = device
        self.fire = fire

    def axis_index(self) -> torch.Tensor:
        """Every shard's index, ``[S]``."""
        return torch.arange(self.n_shards, device=self.device)

    def reduce(self, partial: torch.Tensor, red: Reducer,
               wire: str = "none") -> torch.Tensor:
        """``[S, ...]`` shard partials → ``[...]`` with the reducer's
        collective (sum/min/max over the shard dimension; gather-then-fold
        for prod and custom reducers); a sum with ``wire="bf16" | "int8"``
        goes through ``compressed_psum`` (shared-scale int8 over the int8
        lattice, or bf16)."""
        if self.fire:
            faults.fault_point("collective")
        if wire == "none" or red.name != "sum":
            return red.collective(partial)
        if wire not in ("bf16", "int8"):
            raise ValueError(f"unknown wire mode {wire!r}")
        from repro_torch.distributed.collectives import compressed_psum

        return compressed_psum(partial, wire=wire)

    def reduce_feedback(self, partial: torch.Tensor, red: Reducer, wire: str,
                        residual: torch.Tensor):
        """``wire="int8"`` sums with error feedback: each shard quantizes
        ``partial + residual`` per 256-element block
        (``quantize_with_feedback``), the dequantized lattices are summed in
        f32, and what each shard's narrowing dropped comes back as its next
        residual ``[S, ...]``.  Any other (reducer, wire) is :meth:`reduce`
        with the residual passed through."""
        if wire != "int8" or red.name != "sum":
            return self.reduce(partial, red, wire), residual
        from repro_torch.core.serialization import dequantize, quantize_with_feedback

        p32 = partial.to(torch.float32)
        deq, new_residual = [], []
        for s in range(p32.shape[0]):
            q, r = quantize_with_feedback(p32[s], residual[s], "int8")
            deq.append(dequantize(q, p32[s]))
            new_residual.append(r)
        total = torch.stack(deq).sum(0).to(partial.dtype)
        return total, torch.stack(new_residual)

    def all_gather_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """``[S, n, ...]`` → ``[S * n, ...]``: every shard's rows, in shard
        order."""
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def all_to_all_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """``[S_src, S_dst, cap, ...]`` → ``[S_dst, S_src, cap, ...]``: each
        destination receives its bucket from every source."""
        return x.transpose(0, 1).contiguous()

