"""Collectives over shards stacked on dim 0 of one device.

The counterpart of ``RealCollectives`` in ``repro/core/mapreduce.py``: a
shard stage names no collective directly but goes through this object.  Here
every per-shard value is a tensor whose leading dimension is the shard, and
each collective is plain tensor arithmetic over that dimension.  The result
of a reducing or gathering collective is replicated on every shard in JAX;
the port keeps its one copy.  Collectives across cards come with the
multi-host slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.reducers import Reducer


class LocalCollectives:
    def __init__(self, n_shards: int, device: torch.device):
        self.n_shards = n_shards
        self.device = device

    def axis_index(self) -> torch.Tensor:
        """Every shard's index, ``[S]``."""
        return torch.arange(self.n_shards, device=self.device)

    def reduce(self, partial: torch.Tensor, red: Reducer) -> torch.Tensor:
        """``[S, ...]`` shard partials → ``[...]`` with the reducer's
        collective (sum/min/max over the shard dimension; gather-then-fold
        for prod and custom reducers)."""
        return red.collective(partial)

    def all_gather_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """``[S, n, ...]`` → ``[S * n, ...]``: every shard's rows, in shard
        order."""
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def all_to_all_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """``[S_src, S_dst, cap, ...]`` → ``[S_dst, S_src, cap, ...]``: each
        destination receives its bucket from every source."""
        return x.transpose(0, 1).contiguous()
