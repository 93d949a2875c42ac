"""Public kernel entry points with backend dispatch (data-mining half of
``repro/kernels/ops.py``).

* ``impl="pallas"`` — the hand-written CUDA kernel (the JAX package's name
  for its kernel tier, kept so callers port one-to-one); on a CPU tensor the
  kernel's wrapper runs its plain PyTorch version;
* ``impl="ref"``    — the oracles in ``kernels/ref.py``;
* ``impl="auto"``   — the kernel on a CUDA tensor, ``ref`` on a CPU tensor.

There is no fallback: if the kernel fails, the call fails.  ``block_n``
keeps the JAX signature; the CUDA kernels pick their own tiles.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels.kmeans_assign import kmeans_assign as _kmeans_kernel
from repro_torch.kernels.segment_reduce import segment_reduce as _segment_kernel

IMPLS = ("auto", "pallas", "ref")


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    if impl == "auto":
        return "pallas" if x.device.type == "cuda" else "ref"
    return impl


def segment_reduce(ids: torch.Tensor, vals: torch.Tensor, num_segments: int, *,
                   impl: str = "auto", block_n: int = 1024) -> torch.Tensor:
    """Sum ``vals [N, V]`` rows into ``num_segments`` dense buckets by
    ``ids [N]``; ids outside ``[0, num_segments)`` are dropped."""
    del block_n
    if _resolve(impl, vals) == "pallas":
        return _segment_kernel(ids, vals, num_segments, reducer="sum")
    return R.segment_reduce_ref(ids, vals, num_segments)


def kmeans_assign(points: torch.Tensor, centers: torch.Tensor, *,
                  impl: str = "auto", block_n: int = 1024
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(assign [N] int32, stats [K, D+1] = [Σx | count])`` of ``points``
    against ``centers``."""
    if _resolve(impl, points) == "pallas":
        return _kmeans_kernel(points, centers, block_n=block_n)
    return R.kmeans_assign_ref(points, centers)
