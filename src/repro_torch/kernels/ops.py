"""Public kernel entry points with backend dispatch (the port of
``repro/kernels/ops.py``).

* ``impl="pallas"``  — the hand-written CUDA kernel (the JAX package's name
  for its kernel tier, kept so callers port one-to-one); on a CPU tensor the
  kernel's wrapper runs its plain PyTorch version;
* ``impl="chunked"`` — ``ssd`` and ``rwkv6`` only: the plain chunked version
  beside the kernel (the reference's ``ops.ssd_chunked`` and
  ``ops.rwkv6_chunked``), on any device;
* ``impl="ref"``     — the oracles in ``kernels/ref.py``;
* ``impl="auto"``    — the kernel on a CUDA tensor; on a CPU tensor ``ref``,
  or for ``ssd`` and ``rwkv6`` ``chunked``, as the reference resolves it.

Where a call is to be differentiated (grad mode on and an input that
requires grad), ``attention``, ``ssd`` and ``rwkv6`` run the kernel through
``kernels.autograd.kernel_with_grad``: the forward is the kernel, the
backward recomputes the plain version (``attention_ref``,
``ssd_scan_plain``, ``rwkv6_scan_plain``) under autograd.  Such a call may
not write a cache in place (``out_state``).  Otherwise the kernel runs
alone, as on the serving path.

There is no fallback: if the kernel fails, the call fails.  ``block_n``,
``block_q``, ``block_k`` and ``shard_hint`` keep the JAX signature and are
dropped: the CUDA kernels pick their own tiles, and the port runs on one
card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels.autograd import kernel_with_grad, needs_grad
from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel
from repro_torch.kernels.kmeans_assign import kmeans_assign as _kmeans_kernel
from repro_torch.kernels.rwkv6_scan import rwkv6_scan as _rwkv6_kernel
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
from repro_torch.kernels.segment_reduce import segment_reduce as _segment_kernel
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_kernel
from repro_torch.kernels.ssd_scan import ssd_scan_plain

IMPLS = ("auto", "pallas", "chunked", "ref")


def _resolve(impl: str, x: torch.Tensor, *, cpu: str = "ref",
             impls: tuple[str, ...] = ("auto", "pallas", "ref")) -> str:
    """The impl to run on ``x``'s device: ``auto`` is the kernel on a CUDA
    tensor and ``cpu`` on a CPU tensor; ``impls`` are those the op has."""
    if impl not in impls:
        raise ValueError(f"unknown impl {impl!r}; choose from {impls}")
    if impl == "auto":
        return "pallas" if x.device.type == "cuda" else cpu
    return impl


def _no_cache_write(out_state: torch.Tensor | None, op: str) -> None:
    if out_state is not None:
        raise ValueError(f"ops.{op}: a differentiated call cannot write its state into "
                         "out_state in place; pass no cache when training")


def _into(out_state: torch.Tensor | None, y: torch.Tensor, state: torch.Tensor):
    if out_state is not None:
        state = out_state.copy_(state)
    return y, state


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None, softcap: float = 0.0,
              scale: float | None = None, q_offset: int | None = None,
              impl: str = "auto", block_q: int = 256, block_k: int = 512,
              shard_hint: str | None = None) -> torch.Tensor:
    """Attention of ``q [B, Hq, Sq, D]`` over ``k, v [B, Hkv, Skv, D]``
    (see ``kernels.ref.attention_ref`` for the masking rules)."""
    del block_q, block_k, shard_hint
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset)
    if _resolve(impl, q) != "pallas":
        return R.attention_ref(q, k, v, **kw)
    if needs_grad(q, k, v):
        return kernel_with_grad(lambda *t: _flash_kernel(*t, **kw),
                                lambda *t: R.attention_ref(*t, **kw), q, k, v)
    return _flash_kernel(q, k, v, **kw)


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


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, init_state: torch.Tensor | None = None,
        out_state: torch.Tensor | None = None, chunk: int = 128,
        impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD: ``(y [B, S, H, P], h_T [B, H, P, N] f32)`` of ``x [B, S,
    H, P]``, ``dt [B, S, H]``, ``a [H]``, ``b, c [B, S, G, N]`` from
    ``init_state`` (see ``kernels.ssd_scan.ssd_scan``).  With ``out_state``
    the final state is written there (it may be ``init_state``: a cache
    updated in place)."""
    impl = _resolve(impl, x, cpu="chunked", impls=IMPLS)
    if impl == "pallas":
        if needs_grad(x, dt, a, b, c, init_state):
            _no_cache_write(out_state, "ssd")
            return kernel_with_grad(
                lambda *t: _ssd_kernel(*t[:5], init_state=t[5], chunk=chunk),
                lambda *t: ssd_scan_plain(*t[:5], init_state=t[5], chunk=chunk),
                x, dt, a, b, c, init_state)
        return _ssd_kernel(x, dt, a, b, c, init_state=init_state, out_state=out_state,
                           chunk=chunk)
    if impl == "ref":
        return _into(out_state, *R.ssd_ref(x, dt, a, b, c, init_state=init_state))
    return ssd_scan_plain(x, dt, a, b, c, init_state=init_state, out_state=out_state,
                          chunk=chunk)


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor, *, init_state: torch.Tensor | None = None,
          out_state: torch.Tensor | None = None, chunk: int = 64,
          impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 wkv: ``(out [B, S, H, V], S_T [B, H, K, V] f32)`` of ``r, k, w
    [B, S, H, K]``, ``v [B, S, H, V]``, ``u [H, K]`` from ``init_state``
    (see ``kernels.rwkv6_scan.rwkv6_scan``; ``ref`` has no decay floor).
    With ``out_state`` the final state is written there (it may be
    ``init_state``: a cache updated in place)."""
    impl = _resolve(impl, r, cpu="chunked", impls=IMPLS)
    if impl == "pallas":
        if needs_grad(r, k, v, w, u, init_state):
            _no_cache_write(out_state, "rwkv6")
            return kernel_with_grad(
                lambda *t: _rwkv6_kernel(*t[:5], init_state=t[5], chunk=chunk),
                lambda *t: rwkv6_scan_plain(*t[:5], init_state=t[5], chunk=chunk),
                r, k, v, w, u, init_state)
        return _rwkv6_kernel(r, k, v, w, u, init_state=init_state, out_state=out_state,
                             chunk=chunk)
    if impl == "ref":
        return _into(out_state, *R.rwkv6_ref(r, k, v, w, u, init_state=init_state))
    return rwkv6_scan_plain(r, k, v, w, u, init_state=init_state, out_state=out_state,
                            chunk=chunk)
