"""Plain PyTorch oracles for the data-mining kernels.

The counterpart of the data-mining half of ``repro/kernels/ref.py``: each
function is the semantic ground truth, small and obviously right, written
without regard to speed.  Tests hold the kernels' wrappers against these;
``kernels.ops`` reaches them with ``impl="ref"``.
"""
from __future__ import annotations

import torch


def segment_reduce_ref(ids: torch.Tensor, vals: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Sum ``vals`` rows into ``num_segments`` dense buckets, in ``vals``'
    dtype; ids outside ``[0, num_segments)`` are dropped."""
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, ids[keep].long(), vals[keep])


def kmeans_assign_ref(points: torch.Tensor, centers: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(assign [N] int32, stats [K, D+1])``: the nearest centre by the full
    ``‖x‖² − 2x·cᵀ + ‖c‖²`` (first index on ties), and per centre ``Σx`` and
    the count, from a one-hot product."""
    d2 = ((points ** 2).sum(1, keepdim=True) - 2.0 * points @ centers.T
          + (centers ** 2).sum(1)[None, :])
    assign = torch.argmin(d2, dim=1)
    onehot = torch.nn.functional.one_hot(assign, centers.shape[0]).to(points.dtype)
    sums = onehot.T @ points
    counts = onehot.sum(0)[:, None]
    return assign.to(torch.int32), torch.cat([sums, counts], dim=1)
