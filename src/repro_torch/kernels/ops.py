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

K4, K5 and K6 are custom ops (``torch.ops.blaze.flash_attention``,
``flash_attention_at`` (the query offset a 0-d tensor on the device, as a
captured decode step passes it), ``dh_logits``, ``dh_softmax_pv``,
``ssd_scan``, ``ssd_scan_into``, ``rwkv6_scan``, ``rwkv6_scan_into``): the
real implementation is the kernel's wrapper, a fake one gives the output
shapes (a fake or meta tensor has no ``data_ptr()``), a flop formula gives
``torch.utils.flop_counter`` each call's operations, and each differentiates
with the plain version's gradients (``autograd.register_plain_backward``).
The ``_into`` forms write the final state into ``out_state`` in place.

On ``DTensor`` inputs (a model sharded over a ``DeviceMesh``,
``distributed/sharding.py``) each kernel runs under ``local_map`` on every
rank's shards: batch over the dp axes where it divides, heads over model
(the reference's ``shard_hint="heads"``; K5 and K6 always), the sequence
whole; K4 with heads that do not divide the model axis splits its query
rows over it instead (each rank's rows at their offset, the keys whole).
Where the kv heads (K4) or the B/C groups (K5) do not split with the query
heads, each rank takes the ones its own heads read.  ``shard_hint="dh"``
(decode with ``d_head`` sharded over model, kv heads that do not divide
it) runs K4's ``"dh"`` form: on each rank's slice of ``d_head``,
``dh_logits`` gives the partial logits, the model axis all-reduces them as
the reference's are (a ``DTensor`` redistribute, outside the kernels), and
``dh_softmax_pv`` takes the softmax and the rank's slice of the output.
With ``impl="ref"`` or on CPU tensors the plain pair
(``ref.attention_logits``, ``ref.attention_from_logits``) runs instead, and
``attention.dh_plain_calls`` counts those calls.

There is no fallback: if the kernel fails, the call fails.  ``block_n``,
``block_q`` and ``block_k`` keep the JAX signature and are dropped: the CUDA
kernels pick their own tiles.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.utils.flop_counter import register_flop_formula

from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ref as R
from repro_torch.kernels.autograd import kernel_with_grad, needs_grad, register_plain_backward
from repro_torch.kernels.flash_attention import dh_logits as _dh_logits_kernel
from repro_torch.kernels.flash_attention import dh_softmax_pv as _dh_pv_kernel
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


# ---------------------------------------------------------------------------
# K4-K6 as custom ops
# ---------------------------------------------------------------------------


def _flash_impl(q, k, v, causal, window, softcap, scale, q_offset):
    return _flash_kernel(q, k, v, causal=causal, window=window, softcap=softcap,
                         scale=scale, q_offset=q_offset)


_flash_op = torch.library.custom_op(
    "blaze::flash_attention", _flash_impl, mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int? window, float softcap, "
           "float? scale, int? q_offset) -> Tensor")


@_flash_op.register_fake
def _(q, k, v, causal, window, softcap, scale, q_offset):
    return torch.empty_like(q)


def _flash_at_impl(q, k, v, q_offset, causal, window, softcap, scale):
    return _flash_kernel(q, k, v, causal=causal, window=window, softcap=softcap,
                         scale=scale, q_offset=q_offset)


_flash_at_op = torch.library.custom_op(
    "blaze::flash_attention_at", _flash_at_impl, mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, Tensor q_offset, bool causal, int? window, "
           "float softcap, float? scale) -> Tensor")


@_flash_at_op.register_fake
def _(q, k, v, q_offset, causal, window, softcap, scale):
    return torch.empty_like(q)


def _live_pairs(sq: int, skv: int, off: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the masks keep, query ``i`` at ``off + i``."""
    pos = torch.arange(sq, dtype=torch.int64) + off
    hi = torch.clamp(pos + 1, max=skv) if causal else torch.full_like(pos, skv)
    lo = torch.clamp(pos - window + 1, min=0) if window is not None else torch.zeros_like(pos)
    return int(torch.clamp(hi - lo, min=0).sum())


@register_flop_formula(torch.ops.blaze.flash_attention)
def _flash_flops(q, k, v, causal, window, softcap, scale, q_offset, *args, **kwargs):
    """Two products (``q·kᵀ`` and ``p·v``) over the live pairs."""
    b, hq, sq, d = q
    skv = k[2]
    off = skv - sq if q_offset is None else q_offset
    return 4 * b * hq * d * _live_pairs(sq, skv, off, causal, window)


@register_flop_formula(torch.ops.blaze.flash_attention_at)
def _flash_at_flops(q, k, v, q_offset, causal, window, softcap, scale, *args, **kwargs):
    """As ``blaze::flash_attention``'s at the largest offset the keys allow
    (``Skv - Sq``): a formula sees shapes, not the offset on the device."""
    b, hq, sq, d = q
    return 4 * b * hq * d * _live_pairs(sq, k[2], k[2] - sq, causal, window)


_dh_logits_op = torch.library.custom_op(
    "blaze::dh_logits", _dh_logits_kernel, mutates_args=(),
    schema="(Tensor q, Tensor k, float scale) -> Tensor")


def _dh_pv_impl(logits, v, causal, window, softcap, q_offset):
    return _dh_pv_kernel(logits, v, causal=causal, window=window, softcap=softcap,
                         q_offset=q_offset)


_dh_pv_op = torch.library.custom_op(
    "blaze::dh_softmax_pv", _dh_pv_impl, mutates_args=(),
    schema="(Tensor logits, Tensor v, bool causal, int? window, float softcap, "
           "int? q_offset) -> Tensor")


@_dh_logits_op.register_fake
def _(q, k, scale):
    return q.new_empty((*q.shape[:3], k.shape[2]), dtype=torch.float32)


@_dh_pv_op.register_fake
def _(logits, v, causal, window, softcap, q_offset):
    return logits.new_empty((*logits.shape[:3], v.shape[3]), dtype=v.dtype)


@register_flop_formula([torch.ops.blaze.dh_logits, torch.ops.blaze.dh_softmax_pv])
def _dh_flops(x, y, *args, **kwargs):
    """What ``flop_counter`` counts for the plain pair's einsums: ``2·B·Hq·
    Sq·Skv·Dl`` each (``x``: q or the logits; ``y``: k or v)."""
    b, hq, sq = x[:3]
    return 2 * b * hq * sq * y[2] * y[3]


_SCAN = "(Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c, Tensor? init_state"


def _ssd_impl(x, dt, a, b, c, init_state, chunk):
    return _ssd_kernel(x, dt, a, b, c, init_state=init_state, chunk=chunk)


def _ssd_into_impl(x, dt, a, b, c, init_state, out_state, chunk):
    return _ssd_kernel(x, dt, a, b, c, init_state=init_state, out_state=out_state,
                       chunk=chunk)[0]


_ssd_op = torch.library.custom_op(
    "blaze::ssd_scan", _ssd_impl, mutates_args=(),
    schema=_SCAN + ", int chunk) -> (Tensor, Tensor)")
_ssd_into_op = torch.library.custom_op(
    "blaze::ssd_scan_into", _ssd_into_impl, mutates_args=("out_state",),
    schema=_SCAN + ", Tensor(a!) out_state, int chunk) -> Tensor")


@_ssd_op.register_fake
def _(x, dt, a, b, c, init_state, chunk):
    bsz, _, h, p = x.shape
    return torch.empty_like(x, memory_format=torch.contiguous_format), x.new_empty(
        (bsz, h, p, b.shape[-1]), dtype=torch.float32)


@_ssd_into_op.register_fake
def _(x, dt, a, b, c, init_state, out_state, chunk):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@register_flop_formula([torch.ops.blaze.ssd_scan, torch.ops.blaze.ssd_scan_into])
def _ssd_flops(x, dt, a, b, c, *args, **kwargs):
    """The recurrence's state update and read-out: ``4·P·N`` a step and head."""
    bsz, s, h, p = x
    return 4 * bsz * s * h * p * b[-1]


def _rwkv6_impl(r, k, v, w, u, init_state, chunk):
    return _rwkv6_kernel(r, k, v, w, u, init_state=init_state, chunk=chunk)


def _rwkv6_into_impl(r, k, v, w, u, init_state, out_state, chunk):
    return _rwkv6_kernel(r, k, v, w, u, init_state=init_state, out_state=out_state,
                         chunk=chunk)[0]


_WKV = "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor? init_state"
_rwkv6_op = torch.library.custom_op(
    "blaze::rwkv6_scan", _rwkv6_impl, mutates_args=(),
    schema=_WKV + ", int chunk) -> (Tensor, Tensor)")
_rwkv6_into_op = torch.library.custom_op(
    "blaze::rwkv6_scan_into", _rwkv6_into_impl, mutates_args=("out_state",),
    schema=_WKV + ", Tensor(a!) out_state, int chunk) -> Tensor")


@_rwkv6_op.register_fake
def _(r, k, v, w, u, init_state, chunk):
    bsz, _, h, kd = r.shape
    return torch.empty_like(v, memory_format=torch.contiguous_format), r.new_empty(
        (bsz, h, kd, v.shape[-1]), dtype=torch.float32)


@_rwkv6_into_op.register_fake
def _(r, k, v, w, u, init_state, out_state, chunk):
    return torch.empty_like(v, memory_format=torch.contiguous_format)


@register_flop_formula([torch.ops.blaze.rwkv6_scan, torch.ops.blaze.rwkv6_scan_into])
def _rwkv6_flops(r, k, v, *args, **kwargs):
    """The state update and read-out: ``4·K·V`` a step and head."""
    bsz, s, h, kd = r
    return 4 * bsz * s * h * kd * v[-1]


register_plain_backward(
    _flash_op, lambda causal, window, softcap, scale, q_offset: (
        lambda q, k, v: R.attention_ref(q, k, v, causal=causal, window=window,
                                        softcap=softcap, scale=scale, q_offset=q_offset)),
    3)
register_plain_backward(
    _dh_logits_op, lambda scale: (lambda q, k: R.attention_logits(q, k, scale)), 2)
register_plain_backward(
    _dh_pv_op, lambda causal, window, softcap, q_offset: (
        lambda lg, v: R.attention_from_logits(lg, v, v.dtype, causal=causal, window=window,
                                              softcap=softcap, q_offset=q_offset)),
    2)
register_plain_backward(
    _ssd_op, lambda chunk: (lambda *t: ssd_scan_plain(*t[:5], init_state=t[5],
                                                      chunk=chunk)), 6)
register_plain_backward(
    _rwkv6_op, lambda chunk: (lambda *t: rwkv6_scan_plain(*t[:5], init_state=t[5],
                                                          chunk=chunk)), 6)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None, softcap: float = 0.0,
              scale: float | None = None, q_offset: int | None = None,
              impl: str = "auto", block_q: int = 256, block_k: int = 512,
              shard_hint: str | None = None) -> torch.Tensor:
    """Attention of ``q [B, Hq, Sq, D]`` over ``k, v [B, Hkv, Skv, D]``
    (see ``kernels.ref.attention_ref`` for the masking rules).  On
    ``DTensor``s, ``shard_hint="dh"`` runs K4's "dh" form on each rank's
    slice of ``d_head``; otherwise the kernel runs on each rank's heads
    (module doc).  ``q_offset`` may be a 0-d integer tensor on ``q``'s
    device (``blaze::flash_attention_at``: the kernel reads it there), but
    not on ``DTensor``s."""
    del block_q, block_k
    kw = dict(causal=causal, window=window, softcap=float(softcap), scale=scale,
              q_offset=q_offset)
    at = isinstance(q_offset, torch.Tensor)
    if isinstance(q, DTensor):
        if at:
            raise ValueError("ops.attention: the sharded route takes an int q_offset, "
                             "not a tensor")
        if shard_hint == "dh":
            return _dh_attention(q, k, v, kw, impl)
        return _sharded_attention(q, k, v, kw, impl)
    if _resolve(impl, q) != "pallas":
        return R.attention_ref(q, k, v, **kw)
    if at:
        opts = (q_offset, causal, window, float(softcap), scale)
        op = lambda *t: _flash_at_op(*t, *opts)  # noqa: E731
    else:
        opts = tuple(kw.values())
        op = lambda *t: _flash_op(*t, *opts)  # noqa: E731
    if needs_grad(q, k, v):
        return kernel_with_grad(op, lambda *t: R.attention_ref(*t, **kw), q, k, v)
    return op(q, k, v)


attention.dh_plain_calls = 0  # sharded "dh" calls that ran the plain pair


def _dh_attention(q: DTensor, k: DTensor, v: DTensor, kw: dict, impl: str) -> DTensor:
    """``attention_ref`` with ``d_head`` sharded over model (batch over dp
    where it divides): each rank's logits are a partial sum over its slice
    of ``d_head``, all-reduced over model (the reference's "dh" layout:
    ``[B, Hq, Sq, Skv]`` logits cross the wire, not the cache), then each
    rank takes the softmax and its slice of the output.  On a CUDA device
    with ``impl`` "auto" or "pallas" the two sides are K4's "dh" kernels
    (``blaze::dh_logits``, ``blaze::dh_softmax_pv``); with "ref" or on the
    CPU the plain pair, counted in ``attention.dh_plain_calls``."""
    mesh = q.device_mesh
    model = SH.axis_index(mesh, SH.MODEL)
    q_pl = SH.fitted_placements(mesh, q.shape, (SH.DP, None, None, SH.MODEL))
    kv_pl = SH.fitted_placements(mesh, k.shape, (SH.DP, None, None, SH.MODEL))
    whole = tuple(Replicate() if i == model else p for i, p in enumerate(q_pl))
    partial = tuple(Partial() if i == model else p for i, p in enumerate(q_pl))
    scale = kw["scale"] if kw["scale"] is not None else 1.0 / math.sqrt(q.shape[-1])
    rest = {n: kw[n] for n in ("causal", "window", "softcap", "q_offset")}
    if _resolve(impl, q) == "pallas" and q.device.type == "cuda":
        def logits_fn(ql, kl):
            return _dh_logits_op(ql, kl, scale)

        def pv_fn(lg, vl):
            return _dh_pv_op(lg, vl, **rest)
    else:
        attention.dh_plain_calls += 1

        def logits_fn(ql, kl):
            return R.attention_logits(ql, kl, scale)

        def pv_fn(lg, vl):
            return R.attention_from_logits(lg, vl, q.dtype, **rest)
    logits = SH.run_local(logits_fn, partial, (q, k), (q_pl, kv_pl))
    logits = logits.redistribute(mesh, whole)  # the partial sums, all-reduced
    return SH.run_local(pv_fn, q_pl, (logits, v), (whole, kv_pl))


def _model_rank(x: DTensor) -> int:
    i = SH.axis_index(x.device_mesh, SH.MODEL)
    return 0 if i is None else x.device_mesh.get_coordinate()[i]


def _heads_for(x: torch.Tensor, n_local: int, first: int, n_total: int,
               n_groups: int, dim: int) -> torch.Tensor:
    """The groups (kv heads, B/C groups) that query heads ``first ..
    first + n_local`` of ``n_total`` read, from all ``n_groups`` of them
    along ``dim``: a slice where the local heads split evenly over whole
    groups, else one group a head."""
    rep = n_total // n_groups
    lo, hi = first // rep, (first + n_local - 1) // rep + 1
    if (n_local % rep == 0 and first % rep == 0) or (rep % n_local == 0 and hi - lo == 1):
        return x.narrow(dim, lo, hi - lo)
    idx = torch.arange(first, first + n_local, device=x.device) // rep
    return x.index_select(dim, idx)


def _sharded_attention(q: DTensor, k: DTensor, v: DTensor, kw: dict, impl: str):
    """The attention on each rank's shards: batch over dp where it divides,
    query heads over model where they divide (kv heads too where both do),
    else the query rows over model where they divide (each rank's rows at
    their own offset), the keys whole."""
    mesh = q.device_mesh
    hq, hkv, sq = q.shape[1], k.shape[1], q.shape[2]
    q_pl = SH.fitted_placements(mesh, q.shape, (SH.DP, SH.MODEL, None, None))
    q_split = SH.is_sharded_placements(q_pl, 1)
    rows_split = False
    if not q_split:  # heads that do not divide: split the query rows instead
        q_pl = SH.fitted_placements(mesh, q.shape, (SH.DP, None, SH.MODEL, None))
        rows_split = SH.is_sharded_placements(q_pl, 2)
    kv_axes = (SH.DP, SH.MODEL if q_split else None, None, None)
    kv_pl = SH.fitted_placements(mesh, k.shape, kv_axes)
    kv_split = SH.is_sharded_placements(kv_pl, 1)
    n_model = mesh.shape[SH.axis_index(mesh, SH.MODEL)] if q_split or rows_split else 1
    first = _model_rank(q) * (hq // n_model) if q_split else 0
    if rows_split:
        off = k.shape[2] - sq if kw["q_offset"] is None else kw["q_offset"]
        kw = dict(kw, q_offset=off + _model_rank(q) * (sq // n_model))

    def local(ql, kl, vl):
        if q_split and not kv_split:
            kl = _heads_for(kl, ql.shape[1], first, hq, hkv, 1)
            vl = _heads_for(vl, ql.shape[1], first, hq, hkv, 1)
        return attention(ql, kl, vl, impl=impl, **kw)

    return SH.run_local(local, q_pl, (q, k, v), (q_pl, kv_pl, kv_pl))


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
    if isinstance(x, DTensor):
        return _sharded_scan(ssd, (x, dt, a), (b, c), init_state, out_state,
                             dict(chunk=chunk, impl=impl))
    impl = _resolve(impl, x, cpu="chunked", impls=IMPLS)
    if impl == "pallas":
        if needs_grad(x, dt, a, b, c, init_state):
            _no_cache_write(out_state, "ssd")
            return kernel_with_grad(
                lambda *t: _ssd_op(*t, chunk),
                lambda *t: ssd_scan_plain(*t[:5], init_state=t[5], chunk=chunk),
                x, dt, a, b, c, init_state)
        if out_state is not None:
            return _ssd_into_op(x, dt, a, b, c, init_state, out_state, chunk), out_state
        return _ssd_op(x, dt, a, b, c, init_state, chunk)
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
    if isinstance(r, DTensor):
        return _sharded_scan(rwkv6, (r, k, v, w, u), (), init_state, out_state,
                             dict(chunk=chunk, impl=impl))
    impl = _resolve(impl, r, cpu="chunked", impls=IMPLS)
    if impl == "pallas":
        if needs_grad(r, k, v, w, u, init_state):
            _no_cache_write(out_state, "rwkv6")
            return kernel_with_grad(
                lambda *t: _rwkv6_op(*t, chunk),
                lambda *t: rwkv6_scan_plain(*t[:5], init_state=t[5], chunk=chunk),
                r, k, v, w, u, init_state)
        if out_state is not None:
            return _rwkv6_into_op(r, k, v, w, u, init_state, out_state, chunk), out_state
        return _rwkv6_op(r, k, v, w, u, init_state, chunk)
    if impl == "ref":
        return _into(out_state, *R.rwkv6_ref(r, k, v, w, u, init_state=init_state))
    return rwkv6_scan_plain(r, k, v, w, u, init_state=init_state, out_state=out_state,
                            chunk=chunk)


def _sharded_scan(op, heads, groups, init_state, out_state, kw):
    """K5 (``op=ssd``: ``heads = (x, dt, a)``, ``groups = (b, c)``) or K6
    (``op=rwkv6``: ``heads = (r, k, v, w, u)``) on each rank's shards: batch
    over dp where it divides, heads over model where they divide (the
    reference's note: the scans are parallel over heads), the sequence
    whole.  The states take the same placements; ``out_state`` must already
    have them, so the kernel writes the cache's own shards."""
    x = heads[0]
    mesh = x.device_mesh
    h = x.shape[2]

    def pl(t, head_dim):
        axes = [None] * t.ndim
        if head_dim != 0:
            axes[0] = SH.DP
        axes[head_dim] = SH.MODEL
        return SH.fitted_placements(mesh, t.shape, axes)

    head_pls = [pl(t, 0 if t.ndim == 1 or (op is rwkv6 and t.ndim == 2) else 2)
                for t in heads]
    split = SH.is_sharded_placements(head_pls[0], 2)
    state_pl = SH.fitted_placements(
        mesh, (x.shape[0], h, 1, 1), (SH.DP, SH.MODEL if split else None, None, None))
    group_pls = [SH.fitted_placements(mesh, t.shape, (SH.DP, None, None, None))
                 for t in groups]
    if out_state is not None and tuple(out_state.placements) != state_pl:
        raise ValueError(f"out_state is placed {out_state.placements}, the scan's "
                         f"state {state_pl}: the kernel would write a copy")
    n_model = mesh.shape[SH.axis_index(mesh, SH.MODEL)] if split else 1
    first = _model_rank(x) * (h // n_model) if split else 0
    n_heads, n_groups = len(heads), len(groups)

    def local(*t):
        hs = list(t[:n_heads])
        gs = [_heads_for(g, hs[0].shape[2], first, h, g.shape[2], 2) if split else g
              for g in t[n_heads:n_heads + n_groups]]
        st_in, st_out = t[n_heads + n_groups:]
        return op(*hs, *gs, init_state=st_in, out_state=st_out, **kw)

    args = (*heads, *groups, init_state, out_state)
    pls = (*head_pls, *group_pls, state_pl, state_pl)
    y_pl = head_pls[2] if op is rwkv6 else head_pls[0]
    return SH.run_local(local, (y_pl, state_pl), args, pls)
