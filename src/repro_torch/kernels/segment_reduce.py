"""Dense reduce-by-key: (id, value-row) pairs into a ``[K, V]`` accumulator.

The combiner of ``engine="pallas"`` for dense targets, the counterpart of the
TPU kernel ``repro/kernels/segment_reduce.py::segment_reduce``.  On a CUDA
tensor :func:`segment_reduce` launches the hand-written kernel in
``csrc/segment_reduce.cu`` in the form :func:`launch_shape` picks (per-thread
partials in registers for few keys, a shared-memory accumulator per CTA for
``K*V`` that fits it, global atomics otherwise; the source says why); on a
CPU tensor it runs :func:`segment_reduce_plain`, the same function in plain
PyTorch.

Contract (as on the TPU): ids outside ``[0, K)`` are dropped and their values
never read; sum/prod/min/max; the result is f32 for float inputs (bf16 is
upcast) and i32 for int inputs; an empty stream gives the identity.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

REDUCERS = ("sum", "prod", "min", "max")
THREADS = 256
# Largest [K, V] accumulator a CTA keeps in shared memory: 48 KiB is what a
# launch may take without opting in to more.
SHARED_BYTES = 48 * 1024
REG_K = 8  # most keys the register form keeps per slot (csrc kRegK)
SLOTS = 4  # consecutive elements a register-form thread takes a step (csrc kSlots)
FORMS = ("registers", "shared", "global")  # the C entry's numbering
CTAS_PER_SM = {"registers": 2, "shared": 2, "global": 8}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_OP_CODE = {"sum": 0, "prod": 1, "min": 2, "max": 3}


def identity(reducer: str, dtype: torch.dtype):
    """The reducer's identity as a Python number of ``dtype``'s kind."""
    if reducer == "sum":
        return 0
    if reducer == "prod":
        return 1
    if dtype.is_floating_point:
        return float("inf") if reducer == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if reducer == "min" else info.min


def fold_rows(acc: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor,
              reducer: str) -> torch.Tensor:
    """Fold ``vals[i]`` into ``acc[rows[i]]`` in place with the reducer;
    ``rows`` are int64 and in range, ``vals`` in ``acc``'s dtype."""
    if reducer == "sum":
        return acc.index_add_(0, rows, vals)
    reduce = {"prod": "prod", "min": "amin", "max": "amax"}[reducer]
    index = rows.view((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)
    return acc.scatter_reduce_(0, index, vals, reduce=reduce, include_self=True)


def segment_reduce_plain(ids: torch.Tensor, vals: torch.Tensor,
                         num_segments: int, *, reducer: str = "sum"
                         ) -> torch.Tensor:
    """The plain PyTorch version: mask the dropped lanes, then one
    ``index_add_``/``scatter_reduce`` into an identity-filled ``[K, V]``.

    A float sum accumulates in float64 and rounds to f32 once: a running f32
    sum stops growing once a cell passes 2^24 times its addends' size (adding
    1.0 to 2^24 rounds back to 2^24), so at k-means' 10^8 pairs on 5 keys an
    f32 scatter-add is no yardstick for the kernel.
    """
    from repro_torch.core.cost import acc_dtype, use_matmul  # core imports this module

    acc = acc_dtype(vals.dtype)
    work = torch.float64 if use_matmul(reducer, acc) else acc
    out = torch.full((num_segments, vals.shape[1]), identity(reducer, acc),
                     dtype=work, device=vals.device)
    keep = (ids >= 0) & (ids < num_segments)
    return fold_rows(out, ids[keep].long(), vals[keep].to(work), reducer).to(acc)


def valid_forms(num_segments: int, v: int) -> tuple[str, ...]:
    """The forms the kernel can take for ``num_segments`` keys of ``[v]``
    rows: ``"registers"`` for at most :data:`REG_K` keys while the f32 ``[K,
    V]`` copy it merges through fits :data:`SHARED_BYTES`, ``"shared"`` while
    that copy fits, ``"global"`` always."""
    fits = num_segments * v * 4 <= SHARED_BYTES
    return (("registers",) if fits and num_segments <= REG_K else ()) + (
        ("shared",) if fits else ()) + ("global",)


def check_override(num_segments: int, v: int, form: str | None,
                   ctas_per_sm: int | None) -> None:
    """Raise ``ValueError`` for a launch override the kernel cannot take at
    this shape (a tuned config never falls back to another launch)."""
    if form is not None and form not in valid_forms(num_segments, v):
        raise ValueError(f"segment_reduce: form {form!r} is not valid for "
                         f"{num_segments} keys of width {v} (valid: "
                         f"{valid_forms(num_segments, v)})")
    if ctas_per_sm is not None and (not isinstance(ctas_per_sm, int) or ctas_per_sm < 1):
        raise ValueError(f"segment_reduce: ctas_per_sm must be a positive int, "
                         f"got {ctas_per_sm!r}")


def launch_shape(n: int, v: int, num_segments: int, sms: int, *,
                 form: str | None = None, ctas_per_sm: int | None = None
                 ) -> tuple[str, int]:
    """``(form, blocks)`` of the kernel's launch for ``n`` pairs of width
    ``v`` into ``num_segments`` keys on a card of ``sms`` SMs: by default the
    first of :func:`valid_forms` (``"registers"`` for at most :data:`REG_K`
    keys, else ``"shared"`` while the f32 ``[K, V]`` copy fits
    :data:`SHARED_BYTES`, else ``"global"``); a grid of ``blocks`` CTAs of
    :data:`THREADS`, at most ``sms`` times :data:`CTAS_PER_SM` of the form.
    ``form`` and ``ctas_per_sm`` override both (a tuned launch); an override
    the shape cannot take raises.  The shared and global forms stride over
    the pairs (pair ``i`` goes to CTA ``(i % (blocks * THREADS)) //
    THREADS``); the register form over the flat values, :data:`SLOTS` a
    thread a step (element ``e`` goes to thread ``(e // SLOTS) % (blocks *
    THREADS)``), with ``SLOTS * THREADS * blocks`` a multiple of ``v`` so
    that a thread's slots keep their columns."""
    check_override(num_segments, v, form, ctas_per_sm)
    form = form or valid_forms(num_segments, v)[0]
    per_sm = ctas_per_sm or CTAS_PER_SM[form]
    if form != "registers":
        return form, max(1, min(-(-n // THREADS), sms * per_sm))
    step = v // math.gcd(v, SLOTS * THREADS)  # blocks must be a multiple of this
    blocks = min(-(-n * v // (SLOTS * THREADS)), sms * per_sm)
    return form, max(step, -(-blocks // step) * step)


@functools.cache
def _kernel() -> ctypes._CFuncPtr:
    """The C entry point, built, loaded and typed once per process."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return _build.entry("segment_reduce", "blaze_segment_reduce", [
        vp, vp, vp, ctypes.c_longlong, *[i32] * 8, vp,
    ])


def segment_reduce(ids: torch.Tensor, vals: torch.Tensor, num_segments: int,
                   *, reducer: str = "sum", form: str | None = None,
                   ctas_per_sm: int | None = None) -> torch.Tensor:
    """Dense ``[K, V]`` reduce-by-key of ``ids [N]`` int32 and ``vals
    [N, V]`` (f32, bf16 or i32, contiguous); the kernel on a CUDA tensor,
    the plain version on a CPU tensor.  ``form`` and ``ctas_per_sm`` pin the
    kernel's launch (:func:`launch_shape`); an override the shape cannot
    take raises, on either device."""
    if reducer not in REDUCERS:
        raise ValueError(f"unknown reducer {reducer!r}; supported: {REDUCERS}")
    if vals.dim() != 2 or ids.shape != vals.shape[:1]:
        raise ValueError(f"need ids [N] and vals [N, V], got {tuple(ids.shape)} "
                         f"and {tuple(vals.shape)}")
    check_override(num_segments, vals.shape[1], form, ctas_per_sm)
    if ids.device.type == "cpu" and vals.device.type == "cpu":
        return segment_reduce_plain(ids, vals, num_segments, reducer=reducer)
    if ids.device != vals.device or vals.device.type != "cuda":
        raise ValueError(f"ids on {ids.device}, vals on {vals.device}: need "
                         "both on one CUDA device (or both on the CPU)")
    if ids.dtype != torch.int32 or vals.dtype not in _DTYPE_CODE:
        raise TypeError(f"need int32 ids and f32/bf16/i32 vals, got "
                        f"{ids.dtype} and {vals.dtype}")
    if not (ids.is_contiguous() and vals.is_contiguous()):
        raise ValueError("ids and vals must be contiguous")
    from repro_torch.core.cost import acc_dtype

    n, v = vals.shape
    acc = acc_dtype(vals.dtype)
    out = torch.full((num_segments, v), identity(reducer, acc), dtype=acc,
                     device=vals.device)
    if n == 0 or v == 0 or num_segments == 0:
        return out  # a 0-block grid is a launch error
    dev = vals.device.index
    form, blocks = launch_shape(n, v, num_segments, _build.sm_count(dev), form=form,
                                ctas_per_sm=ctas_per_sm)
    args = (ids.data_ptr(), vals.data_ptr(), out.data_ptr(), n, v, num_segments,
            _DTYPE_CODE[vals.dtype], _OP_CODE[reducer], FORMS.index(form),
            int(vals.data_ptr() % 16 == 0), blocks, THREADS)
    if dev == torch.cuda.current_device():  # the launch goes to the current device
        err = _kernel()(*args, _build.raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            err = _kernel()(*args, _build.raw_stream(dev))
    _build.check(err, "segment_reduce")
    segment_reduce.launches += 1
    segment_reduce.forms[form] += 1
    return out


segment_reduce.launches = 0  # kernel launches since the caller last reset it
segment_reduce.forms = dict.fromkeys(FORMS, 0)  # the same, by form
