"""Built-in and custom reducers (commutative monoids) for Blaze MapReduce.

The counterpart of ``repro/core/reducers.py``.  A reducer carries every level
of the reduction tree:

* ``identity(dtype)``        — the monoid identity (a Python number for the
                               built-ins), used to fill accumulators and pad
                               masked-out emits;
* ``combine(a, b)``          — elementwise merge of two partials;
* ``segment(vals, ids, n)``  — reduce-by-key into a dense ``[n, ...]``
                               accumulator (the eager engine's combine);
* ``collective(x)``          — the cross-shard reduction of stacked partials
                               ``[S, ...]`` over the shard dimension;
* ``axis_reduce(x, dims)``   — a fused reduction over ``dims`` for the
                               static-key fast path;
* ``pallas_segment`` / ``pallas_hash`` — the kernel slots ``engine="pallas"``
  runs (``repro_torch.kernels``): hand-written CUDA on the card, their plain
  versions on the CPU.  Custom reducers leave them ``None``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.kernels.hash_combine import hash_aggregate
from repro_torch.kernels.segment_reduce import fold_rows, identity, segment_reduce


@dataclasses.dataclass(frozen=True)
class Reducer:
    """A commutative monoid usable at every level of the reduction tree."""

    name: str
    identity_fn: Callable[[torch.dtype], Any]
    combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    segment: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]
    collective: Callable[[torch.Tensor], torch.Tensor]
    axis_reduce: Callable[..., torch.Tensor] | None = None
    pallas_segment: Callable[..., torch.Tensor] | None = None
    pallas_hash: Callable[..., Any] | None = None

    def identity(self, dtype: torch.dtype):
        return self.identity_fn(dtype)


def _builtin_segment(name: str):
    def segment(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
        out = torch.full((n,) + tuple(vals.shape[1:]), identity(name, vals.dtype),
                         dtype=vals.dtype, device=vals.device)
        return fold_rows(out, ids.long(), vals, name)

    return segment


def _fold_collective(combine):
    """Gather-then-fold over the shard dimension: exact for any sign and
    dtype (never ``exp(sum(log x))``, which breaks on negatives, zeros and
    ints)."""

    def collective(x: torch.Tensor) -> torch.Tensor:
        out = x[0]
        for s in range(1, x.shape[0]):
            out = combine(out, x[s])
        return out

    return collective


def _prod_axes(x: torch.Tensor, dim) -> torch.Tensor:
    dims = sorted(d % x.dim() for d in dim)
    moved = torch.movedim(x, dims, list(range(len(dims))))
    return moved.reshape((-1,) + tuple(moved.shape[len(dims):])).prod(0)


def _builtin(name, combine, collective, axis_reduce) -> Reducer:
    return Reducer(
        name=name,
        identity_fn=functools.partial(identity, name),
        combine=combine,
        segment=_builtin_segment(name),
        collective=collective,
        axis_reduce=axis_reduce,
        pallas_segment=functools.partial(segment_reduce, reducer=name),
        pallas_hash=functools.partial(hash_aggregate, reducer=name),
    )


SUM = _builtin(
    "sum", torch.add, lambda x: x.sum(0, dtype=x.dtype),
    lambda x, dim: x.sum(dim, dtype=x.dtype),
)
PROD = _builtin("prod", torch.mul, _fold_collective(torch.mul), _prod_axes)
MIN = _builtin(
    "min", torch.minimum, lambda x: x.amin(0), lambda x, dim: x.amin(dim)
)
MAX = _builtin(
    "max", torch.maximum, lambda x: x.amax(0), lambda x, dim: x.amax(dim)
)

_BUILTIN: dict[str, Reducer] = {r.name: r for r in (SUM, PROD, MIN, MAX)}


def segmented_scan(vals: torch.Tensor, starts: torch.Tensor, combine):
    """Inclusive scan of ``vals`` along dim 0 with ``combine``, restarting
    wherever ``starts`` is True: ``jax.lax.associative_scan``'s recursion
    (combine the even/odd pairs, scan the pair results, fold each even
    element onto the scan before it, interleave) over the segmented
    operator ``where(b_start, b, combine(a, b))``, flags OR-ed.  So
    ``combine`` applies in the reference's order and a float sum rounds as
    the reference's does (a run of three is ``(a + b) + c``).  Shapes are
    static and nothing syncs with the host, so a captured graph can hold
    it; about ``2 n`` applications of ``combine`` in ``2 log2 n`` steps."""

    def op(av, af, bv, bf):
        fb = bf.view((-1,) + (1,) * (bv.dim() - 1))
        return torch.where(fb, bv, combine(av, bv)), af | bf

    def scan(v, f):
        n = v.shape[0]
        if n < 2:
            return v, f
        odd_v, odd_f = scan(*op(v[0:-1:2], f[0:-1:2], v[1::2], f[1::2]))
        if n % 2 == 0:
            ev, ef = op(odd_v[:-1], odd_f[:-1], v[2::2], f[2::2])
        else:
            ev, ef = op(odd_v, odd_f, v[2::2], f[2::2])
        out_v, out_f = torch.empty_like(v), torch.empty_like(f)
        out_v[:1], out_f[:1] = v[:1], f[:1]
        out_v[2::2], out_f[2::2] = ev, ef
        out_v[1::2], out_f[1::2] = odd_v, odd_f
        return out_v, out_f

    return scan(vals, starts)[0]


def custom_reducer(
    name: str,
    combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    identity_fn: Callable[[torch.dtype], Any],
) -> Reducer:
    """A reducer from a user ``combine`` (the paper's custom-reducer API).

    Its segmented reduce sorts by key and runs :func:`segmented_scan`; its
    collective gathers the shard partials and folds them.  It has no kernel.
    """

    def segment(vals: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
        out = torch.full((n,) + tuple(vals.shape[1:]), 0, dtype=vals.dtype,
                         device=vals.device)
        out[:] = identity_fn(vals.dtype)
        if ids.numel() == 0:
            return out
        order = torch.argsort(ids, stable=True)
        svals, sids = vals[order], ids[order]
        change = sids[1:] != sids[:-1]
        first = torch.ones(1, dtype=torch.bool, device=ids.device)
        scanned = segmented_scan(svals, torch.cat([first, change]), combine)
        last = torch.cat([change, first]) & (sids < n)
        out[sids[last].long()] = scanned[last]
        return out

    return Reducer(name, identity_fn, combine, segment, _fold_collective(combine))


def get_reducer(reducer: str | Reducer) -> Reducer:
    """Resolve a reducer by name (paper API: pass ``"sum"`` etc.) or instance."""
    if isinstance(reducer, Reducer):
        return reducer
    try:
        return _BUILTIN[reducer]
    except KeyError:
        raise ValueError(
            f"unknown reducer {reducer!r}; built-ins: {sorted(_BUILTIN)}"
        ) from None
