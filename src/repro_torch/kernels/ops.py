"""Public kernel entry points with backend dispatch (the port of
``repro/kernels/ops.py`` for the kernels ported so far).

* ``impl="pallas"`` — the hand-written CUDA kernel (the JAX package's name
  for its kernel tier, kept so callers port one-to-one); on a CPU tensor the
  kernel's wrapper runs its plain PyTorch version;
* ``impl="ref"``    — the oracles in ``kernels/ref.py``;
* ``impl="auto"``   — the kernel on a CUDA tensor, ``ref`` on a CPU tensor.

There is no fallback: if the kernel fails, the call fails.  ``block_n``,
``block_q``, ``block_k`` and ``shard_hint`` keep the JAX signature and are
dropped: the CUDA kernels pick their own tiles, and the port runs on one
card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel
from repro_torch.kernels.kmeans_assign import kmeans_assign as _kmeans_kernel
from repro_torch.kernels.segment_reduce import segment_reduce as _segment_kernel

IMPLS = ("auto", "pallas", "ref")


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    if impl == "auto":
        return "pallas" if x.device.type == "cuda" else "ref"
    return impl


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None, softcap: float = 0.0,
              scale: float | None = None, q_offset: int | None = None,
              impl: str = "auto", block_q: int = 256, block_k: int = 512,
              shard_hint: str | None = None) -> torch.Tensor:
    """Attention of ``q [B, Hq, Sq, D]`` over ``k, v [B, Hkv, Skv, D]``
    (see ``kernels.ref.attention_ref`` for the masking rules)."""
    del block_q, block_k, shard_hint
    if _resolve(impl, q) == "pallas":
        return _flash_kernel(q, k, v, causal=causal, window=window, softcap=softcap,
                             scale=scale, q_offset=q_offset)
    return R.attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                           q_offset=q_offset, scale=scale)


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
