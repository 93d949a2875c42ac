"""Flash attention: online-softmax attention with causal, GQA, sliding-window,
softcap and offset masking (the LM stack's attention kernel).

The counterpart of the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``.  On a CUDA tensor :func:`flash_attention` launches the
hand-written kernel in ``csrc/flash_attention.cu`` (the source says how it
is built and why); on a CPU tensor it runs ``kernels.ref.attention_ref``,
the same function in plain PyTorch.

Unlike the TPU kernel, which takes ``q_offset`` as a compile-time constant
and so cannot serve from a KV cache whose length is a traced value, this
one takes it as a run-time argument of the launch, or as a 0-d integer
tensor on the card that the kernel reads from device memory: a decode step
captured in a CUDA graph keeps its position there, and each replay moves
it on (``launch.serve_lm.DecodeGraph``).  The decode form then sizes its
split over the keys from the cache and the window (:func:`static_tiles`),
not from the offset, and each split finds its tiles from the offset it
reads: the live tiles spread over the splits.  Inputs are read through
their strides: ``k`` and ``v`` may be ``[B, S, H, D]`` cache buffers seen as
``[B, H, S, D]`` through ``.transpose(1, 2)``, with no copy.

The kernel has three forms, chosen by :func:`form` from the dtype and the
packed query rows ``R = (Hq / Hkv)·Sq`` (the query heads that share a kv
head, times the positions):

* ``"f32"``: f32 inputs, on the CUDA cores in exact f32;
* ``"bf16-prefill"``: bf16 with ``R > 16``, on the tensor cores (bf16
  products, f32 sums; the probabilities are rounded to bf16 for ``p·v``);
* ``"bf16-decode"``: bf16 with ``R <= 16``, split over the keys
  (:func:`decode_splits`): each split writes unnormalised partials and a
  second kernel merges them.  :func:`flash_decode_plain` is the same
  arithmetic in plain PyTorch.

Each call counts one launch in ``flash_attention.launches`` and one in
``flash_attention.forms[form]``, whatever the form launches.

The ``"dh"`` form (``csrc/flash_attention_dh.cu``) serves decode with
``d_head`` sharded over the model axis (kv heads that do not divide it):
:func:`dh_logits` gives a rank's f32 partial logits over its slice of
``d_head``, and after their all-reduce (outside the kernels, in
``kernels.ops``) :func:`dh_softmax_pv` the softmax and the product with its
slice of ``v``; the plain versions are ``kernels.ref.attention_logits`` and
``attention_from_logits``.  Each call is one launch, counted in
``dh_logits.launches`` or ``dh_softmax_pv.launches`` and by form (``"ring"``:
bulk copies of the cache's layout; ``"element"``: other layouts) in their
``forms``, never in ``FORMS``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_from_logits, attention_logits, attention_ref

MAX_D = 256
DTYPES = (torch.float32, torch.bfloat16)
FORMS = ("f32", "bf16-prefill", "bf16-decode")
DECODE_ROWS = 16  # the decode form's query tile: (Hq / Hkv)·Sq rows at most
KEY_TILE = 64  # keys per tile in every form
SPLIT_PARTS = 4  # partials a decode split writes: one per warp
NEG_INF = -1e30  # the masked logit of the TPU kernel


def form(q: torch.Tensor, k: torch.Tensor) -> str:
    """The kernel form a call with these ``q [B, Hq, Sq, D]`` and ``k [B,
    Hkv, Skv, D]`` takes: ``"f32"`` for f32; for bf16, ``"bf16-decode"`` when
    ``(Hq / Hkv)·Sq <= 16``, else ``"bf16-prefill"``."""
    if q.dtype == torch.float32:
        return "f32"
    rows = q.shape[1] // k.shape[1] * q.shape[2]
    return "bf16-decode" if rows <= DECODE_ROWS else "bf16-prefill"


def key_tiles(sq: int, skv: int, q_offset: int, causal: bool,
              window: int | None) -> tuple[int, int]:
    """The 64-key tiles ``[t_lo, t_hi)`` that hold every key some query row
    sees (the kernels' own rule; ``t_hi <= t_lo`` when no row sees a key)."""
    k_hi = min(skv, q_offset + sq) if causal else skv
    k_lo = max(0, q_offset - window + 1) if window is not None else 0
    return k_lo // KEY_TILE, -(-k_hi // KEY_TILE) if k_hi > 0 else 0


def static_tiles(sq: int, skv: int, window: int | None) -> int:
    """The most 64-key tiles :func:`key_tiles` can give ``sq`` query rows
    over ``skv`` keys at any offset: every tile of the keys, or for a window
    the most that ``L = window + sq - 1`` consecutive keys can touch,
    ``ceil((L - 1) / 64) + 1`` (the decode form's grid where the offset is
    read on the device)."""
    full = -(-skv // KEY_TILE)
    if window is None:
        return full
    return min(full, max(1, -(-(window + sq - 2) // KEY_TILE) + 1))


def decode_splits(batch: int, hkv: int, n_tiles: int, sm_count: int) -> tuple[int, int]:
    """``(splits, tiles per split)`` for the decode form: enough splits that
    the ``batch·hkv·splits`` CTAs give each of the card's ``sm_count`` SMs
    two, each split at least one tile, and no split empty."""
    if n_tiles <= 0:
        return 1, 1
    splits = max(1, min(n_tiles, -(-2 * sm_count // (batch * hkv))))
    per = -(-n_tiles // splits)
    return -(-n_tiles // per), per


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       splits: int, causal: bool = True, window: int | None = None,
                       softcap: float = 0.0, scale: float | None = None,
                       q_offset: int | torch.Tensor | None = None) -> torch.Tensor:
    """The decode form's arithmetic in plain PyTorch (f32): the key tiles of
    :func:`key_tiles` cut into ``splits`` runs of whole tiles (with a 0-d
    tensor ``q_offset`` the kernel reads on the device, ``splits`` comes from
    :func:`static_tiles` and the runs' length from the live tiles, worked
    out on the device as the kernel does: no host read), each run into
    4 partials (keys ``16w..16w+15`` of every 64-key tile, the kernel's
    warps), each partial's ``(m, l, acc)`` of every row with masked logits at
    -1e30, ``p`` rounded to ``q``'s dtype for ``acc``; then the combine: ``M
    = max m``, ``out = Σ e^{m−M} acc / max(Σ e^{m−M} l, 1e-30)``.  A
    partial with no live key (``m = -1e30, l = 0``) weighs 0; a row with no
    live key gives zeros.  ``splits`` may exceed the tiles (empty splits)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if isinstance(q_offset, torch.Tensor):
        off = q_offset.to(q.device)
        t_lo = (off - window + 1).clamp_min(0) // KEY_TILE if window is not None else 0
        k_hi = (off + sq).clamp_max(skv) if causal else torch.tensor(skv, device=q.device)
        t_hi = (-(-k_hi // KEY_TILE)).clamp_min(0)
        per = (-(-(t_hi - t_lo) // splits)).clamp_min(1)
    else:
        off = skv - sq if q_offset is None else int(q_offset)
        t_lo, t_hi = key_tiles(sq, skv, off, causal, window)
        per = max(1, -(-(t_hi - t_lo) // splits))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.repeat_interleave(rep, 1).float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + off
    key = torch.arange(skv, device=q.device)
    live = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        live &= key[None, :] <= qpos
    if window is not None:
        live &= key[None, :] > qpos - window
    s = s.masked_fill(~live, NEG_INF)
    split = torch.div(key // KEY_TILE - t_lo, per, rounding_mode="floor").clamp(0, splits - 1)
    part = split * SPLIT_PARTS + key % KEY_TILE // 16                   # [Skv]
    nparts = splits * SPLIT_PARTS
    idx = part.expand_as(s)
    m = s.new_full(s.shape[:-1] + (nparts,), NEG_INF).scatter_reduce(-1, idx, s, "amax")
    p = torch.where(live, torch.exp(s - m.gather(-1, idx)), 0.0)
    l = torch.zeros_like(m).scatter_add(-1, idx, p)
    onehot = torch.nn.functional.one_hot(part, nparts).float()          # [Skv, P]
    acc = torch.einsum("bhqk,kp,bhkd->bhqpd", p.to(q.dtype).float(), onehot,
                       v.repeat_interleave(rep, 1).float())
    w = torch.exp(m - m.amax(-1, keepdim=True))
    out = (w[..., None] * acc).sum(-2) / (w * l).sum(-1, keepdim=True).clamp_min(1e-30)
    return out.to(q.dtype)


def _strides(name: str, x: torch.Tensor) -> tuple[int, int, int]:
    """``x``'s ``[batch, head, seq]`` strides in elements (0 for a dimension
    of size 1, which the kernel never steps along), after checking that the
    kernel can read it: the last dimension contiguous, the strides multiples
    of 8 elements and the data 16-byte aligned (16-byte vector loads)."""
    (nb, nh, ns, _), (sb, sh, ss, sd) = x.shape, x.stride()
    strides = (sb if nb > 1 else 0, sh if nh > 1 else 0, ss if ns > 1 else 0)
    if sd != 1:
        raise ValueError(f"{name}: the last dimension must be contiguous")
    if (strides[0] | strides[1] | strides[2]) % 8 or x.data_ptr() % 16:
        raise ValueError(f"{name}: strides must be multiples of 8 elements and "
                         "the data 16-byte aligned (16-byte vector loads)")
    return strides


def _launch(fn: ctypes._CFuncPtr, args: tuple, dev: int, what: str) -> None:
    """``fn(*args, stream)`` on CUDA device ``dev``'s current stream (the
    launch goes to the current device), raising if it was refused."""
    if dev == torch.cuda.current_device():
        err = fn(*args, _build.raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, _build.raw_stream(dev))
    _build.check(err, what)


@functools.cache
def _kernel() -> ctypes._CFuncPtr:
    """The C entry point, built, loaded and typed once per process."""
    ll, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    return _build.entry("flash_attention", "blaze_flash_attention", [
        ptr, ptr, ptr, ptr, *[ll] * 12, *[i32] * 10, ptr, ctypes.c_float, ctypes.c_float,
        i32, i32, i32, ptr, ptr,
    ])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float = 0.0, scale: float | None = None,
                    q_offset: int | torch.Tensor | None = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Attention of ``q [B, Hq, Sq, D]`` over ``k, v [B, Hkv, Skv, D]``, f32
    or bf16 (all three alike), output in ``q``'s dtype.

    Query row ``i`` sits at absolute position ``q_offset + i`` (default
    ``Skv - Sq``): an ``int`` read at run time, or a 0-d integer tensor on
    ``q``'s device that the kernel reads from device memory (the host never
    reads it; the decode form's split is then sized by
    :func:`static_tiles`).  ``block_q``/``block_k``
    keep the TPU kernel's signature; the CUDA kernel picks its own tiles.
    On the card the form follows :func:`form`: f32 on the CUDA cores, bf16
    on the tensor cores, split over the keys when ``(Hq / Hkv)·Sq <= 16``.
    """
    del block_q, block_k
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: need the same "
                         "B and D, and Hq a multiple of Hkv")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")
    off_dev = None
    if isinstance(q_offset, torch.Tensor):
        if q_offset.numel() != 1 or q_offset.dtype.is_floating_point:
            raise ValueError(f"a tensor q_offset must hold one integer, got "
                             f"{tuple(q_offset.shape)} {q_offset.dtype}")
        off_dev, off = q_offset.reshape(()), 0
    else:
        off = skv - sq if q_offset is None else int(q_offset)
    if q.device.type == k.device.type == v.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                             q_offset=off if off_dev is None else off_dev, scale=scale)
    if not (q.device == k.device == v.device and q.device.type == "cuda"):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}: need "
                         "all on one CUDA device (or all on the CPU)")
    if off_dev is not None:
        if off_dev.device != q.device:
            raise ValueError(f"q_offset on {off_dev.device}, q on {q.device}: the kernel "
                             "reads the offset on q's device")
        off_dev = off_dev.to(torch.int32)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"need q, k, v all f32 or all bf16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if d % 8 or not 0 < d <= MAX_D:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 up to {MAX_D}")
    strides = (*_strides("q", q), *_strides("k", k), *_strides("v", v))
    out = torch.empty_like(q)  # keeps q's strides when q is dense
    strides += _strides("out", out)
    if out.numel() == 0:
        return out  # a 0-block grid is a launch error
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kind = form(q, k)
    splits = per = 1
    ws = None
    if kind == "bf16-decode":
        if off_dev is None:
            t_lo, t_hi = key_tiles(sq, skv, off, causal, window)
            n_tiles = t_hi - t_lo
        else:
            n_tiles = static_tiles(sq, skv, window)
        splits, per = decode_splits(b, hkv, n_tiles, _build.sm_count(q.device.index))
        ws = torch.empty(b * hkv * SPLIT_PARTS * splits * (hq // hkv) * sq * (d + 2),
                         dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
            b, hq, hkv, sq, skv, d, int(causal), int(window is not None), window or 0, off,
            off_dev.data_ptr() if off_dev is not None else None,
            float(scale), float(softcap), FORMS.index(kind), splits, per,
            ws.data_ptr() if ws is not None else None)
    _launch(_kernel(), args, q.device.index, "flash_attention")
    flash_attention.launches += 1
    flash_attention.forms[kind] += 1
    return out


flash_attention.launches = 0  # kernel launches since the caller last reset it
flash_attention.forms = dict.fromkeys(FORMS, 0)  # the same, by form


# ---------------------------------------------------------------------------
# The "dh" form: d_head sharded over the model axis (csrc/flash_attention_dh.cu)
# ---------------------------------------------------------------------------

DH_MAX_D = 128  # the widest slice of d_head a rank may hold
DH_FORMS = ("ring", "element")  # the "dh" kernels' forms (csrc/flash_attention_dh.cu)
DH_STAGES = 4  # the ring's stages, at most
DH_SMEM_MAX = 232448 - 1024  # dynamic shared memory a CTA may take (227 KB a block)
DH_SM_SMEM = 233472  # shared memory an SM (228 KB)
DH_CTA_RESERVE = 1024 + 256  # the runtime's 1 KB a CTA and the kernels' static barriers
# the resident CTAs an SM each kernel is built for (its __launch_bounds__
# minimum): dh_logits' columns form at 8 or 4 elements a thread ("logits"),
# its forms at 16 and the heads form ("logits_wide"), dh_softmax_pv
DH_CTAS_PER_SM = {"logits": 3, "logits_wide": 2, "softmax_pv": 2}
_DH_LDP = KEY_TILE + 4  # floats a row of the kernels' logits and output tiles
_DH_LDR = 2 * KEY_TILE + 4  # floats a row of dh_softmax_pv's weights (a round of two tiles)


class DhPlan(NamedTuple):
    """How a "dh" kernel is launched at one shape (:func:`dh_plan`)."""

    form: str  # "ring" (bulk copies) or "element" (a load an element)
    hg: int  # kv heads a CTA stages together
    groups: int  # head groups: ceil(Hkv / hg)
    stages: int  # the ring's stages (1 in the element form)
    smem: int  # dynamic shared memory a CTA, bytes
    ctas_per_sm: int  # the CTAs an SM at that memory, up to DH_CTAS_PER_SM
    ctas: int  # the grid's CTAs
    splits: int  # dh_softmax_pv: CTAs a (batch row, head group); dh_logits: 1
    per: int  # items (dh_logits) or live key tiles (dh_softmax_pv) a CTA
    t_lo: int  # the key tiles the CTAs walk: [t_lo, t_hi)
    t_hi: int


def _a4(n: int) -> int:
    return (n + 3) & ~3


def dh_smem_bytes(kernel: str, hg: int, rpk: int, dl: int, es: int, stages: int) -> int:
    """The dynamic shared memory of a CTA of ``dh_logits`` (``kernel`` =
    ``"logits"``) or ``dh_softmax_pv`` (``"softmax_pv"``) staging ``hg`` kv
    heads of ``rpk`` query rows each at slice width ``dl``, elements of
    ``es`` bytes, in ``stages`` stages: the formula of the kernels' source
    (``blaze_dh_smem_bytes``, held equal on the card)."""
    rows, w = hg * rpk, hg * dl
    if kernel == "logits":  # the ring, the staged queries, two output tiles
        words = stages * 16 * w * es + _a4(hg * ((dl * rpk) | 1)) + 2 * rows * _DH_LDP
    else:  # the ring (v and logits rows), two weight tiles, acc and the rows' state
        words = (stages * (16 * w * es + _DH_LDP * rows) + 2 * rows * _DH_LDR
                 + _a4(rows * dl) + _a4(2 * rows) + 8 * _a4(rows))
    return 4 * words


def dh_merge_splits(hg: int, rpk: int, dl: int, es: int, stages: int) -> int:
    """The most splits whose partials (``m, l, acc[dl]`` a row, counted
    as ``dl + 3`` words) ``dh_softmax_pv``'s last CTA stages in its ring
    (the kernels' ``merge_splits``)."""
    rows = hg * rpk
    ring = stages * (16 * hg * dl * es + _DH_LDP * rows)
    return max(1, (ring - 4) // (rows * (dl + 3)))


def dh_ctas_target(kernel: str, dl: int, rpk: int) -> int:
    """The resident CTAs an SM the kernel's form at slice width ``dl`` and
    ``rpk`` query rows a kv head is built for (the columns form takes at
    most 2 rows a head)."""
    if kernel == "logits" and (_dh_elems(dl) in (16, 0) or rpk > 2):
        return DH_CTAS_PER_SM["logits_wide"]
    return DH_CTAS_PER_SM[kernel]


def dh_ctas_fit(nbytes: int) -> int:
    """The CTAs of ``nbytes`` of dynamic shared memory that fit an SM."""
    return DH_SM_SMEM // (nbytes + DH_CTA_RESERVE) if nbytes <= DH_SMEM_MAX else 0


def _dh_fit(kernel: str, hkv: int, rpk: int, dl: int, es: int,
            ring: bool) -> tuple[int, int, int, int] | None:
    """``(hg, stages, bytes, CTAs an SM)``: the most kv heads, up to
    ``hkv`` and ``DH_MAX_D`` elements wide (in the ring form, 16-byte runs),
    whose CTA fits; for them the most stages (2 to ``DH_STAGES`` in the ring
    form) that keep ``DH_CTAS_PER_SM`` CTAs an SM, else the most that fit
    one."""
    depths = range(DH_STAGES, 1, -1) if ring else (1,)
    want = dh_ctas_target(kernel, dl, rpk)
    for hg in range(min(hkv, DH_MAX_D // dl), 0, -1):
        if ring and hg * dl * es % 16:
            continue
        sizes = [(st, dh_smem_bytes(kernel, hg, rpk, dl, es, st)) for st in depths]
        for need in (want, 1):
            fits = [(st, nb) for st, nb in sizes if dh_ctas_fit(nb) >= need]
            if fits:
                st, nb = fits[0]
                return hg, st, nb, min(want, dh_ctas_fit(nb))
    return None


@functools.lru_cache(maxsize=1024)
def dh_plan(kernel: str, batch: int, hq: int, hkv: int, sq: int, dl: int, es: int,
            ring: bool, sm_count: int, t_lo: int, t_hi: int) -> DhPlan:
    """The launch of ``dh_logits`` (``kernel`` = ``"logits"``, key tiles
    ``[0, t_hi)``, every one) or ``dh_softmax_pv`` (``"softmax_pv"``, the
    live tiles ``[t_lo, t_hi)`` of :func:`key_tiles`) at this shape, ``es``
    bytes an element, on a card of ``sm_count`` SMs; computed once a shape.

    The head group and the ring's depth from :func:`_dh_fit` (the element
    form where ``ring`` is False or no group fits as a ring); then a grid
    that fills the SMs once at that many CTAs an SM: ``dh_logits``' CTAs
    each walk ``per`` consecutive (batch row, head group, key tile) items,
    ``dh_softmax_pv``'s ``splits`` CTAs a (batch row, head group) each
    ``per`` consecutive live tiles, none empty, and no more splits than the
    merge stages in the ring (:func:`dh_merge_splits`).  Raises where a
    single kv head does not fit."""
    rpk = hq // hkv * sq
    fit = _dh_fit(kernel, hkv, rpk, dl, es, True) if ring else None
    form = "ring" if fit else "element"
    fit = fit or _dh_fit(kernel, hkv, rpk, dl, es, False)
    if fit is None:
        raise ValueError(f"dh_{kernel}: {rpk} query rows a kv head at d_head slice {dl} "
                         "exceed the kernel's shared memory")
    hg, stages, smem, per_sm = fit
    groups = -(-hkv // hg)
    target = per_sm * sm_count
    if kernel == "logits":
        items = batch * groups * t_hi
        ctas = min(items, target)
        per = -(-items // ctas)
        return DhPlan(form, hg, groups, stages, smem, per_sm, -(-items // per), 1, per, 0, t_hi)
    n = t_hi - t_lo
    cap = dh_merge_splits(hg, rpk, dl, es, stages)
    splits = max(1, min(n, cap, -(-target // (batch * groups)))) if n > 0 else 1
    per = -(-n // splits) if n > 0 else 1
    splits = -(-n // per) if n > 0 else 1
    return DhPlan(form, hg, groups, stages, smem, per_sm, splits * batch * groups, splits, per,
                  t_lo, t_hi)


def _dh_ring(x: torch.Tensor) -> bool:
    """Whether bulk copies can take ``x [B, H, S, Dl]``'s key rows: a key's
    ``Dl`` elements of consecutive heads contiguous (the cache's own layout)
    and every run 16-byte aligned (a head group's run is checked by
    :func:`dh_plan`)."""
    (nb, nh, ns, dl), (sb, sh, ss, sd), es = x.shape, x.stride(), x.element_size()
    if (dl > 1 and sd != 1) or (nh > 1 and sh != dl):
        return False
    if (nh * dl * es) % 16 or x.data_ptr() % 16:
        return False
    return all(st * es % 16 == 0 for st, n in ((sb, nb), (ss, ns)) if n > 1)


def _dh_elems(dl: int) -> int:
    """The elements of a head's ``dl`` a thread of ``dh_logits``' columns
    form takes a key: the most of 16, 8 and 4 that divide ``dl`` into a
    power of two of columns; 0 (the heads form) where none does."""
    return next((e for e in (16, 8, 4) if dl % e == 0 and (dl // e) & (dl // e - 1) == 0), 0)


def _dh_strides(x: torch.Tensor) -> tuple[int, ...]:
    """``x``'s strides in elements, 0 along a dimension of size 1 (the
    kernels never step along one)."""
    return tuple(st if n > 1 else 0 for n, st in zip(x.shape, x.stride()))


_DH_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _dh_tickets(dev: int, n: int) -> torch.Tensor:
    """``dh_softmax_pv``'s ``n`` split counters on CUDA device ``dev``: a
    buffer per (device, stream), zeroed once when first asked for (each call
    leaves its counters 0 again), so that two calls in flight at once on two
    streams never share one."""
    key = (dev, _build.raw_stream(dev))
    buf = _DH_TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = _DH_TICKETS[key] = torch.zeros(max(n, 256), dtype=torch.int32,
                                             device=torch.device("cuda", dev))
    return buf


def _dh_check(name: str, x: torch.Tensor, y: torch.Tensor, xname: str, yname: str) -> None:
    """``x [B, Hq, Sq, *]`` against ``y [B, Hkv, S, Dl]``: 4-D, the same B,
    Hq a multiple of Hkv, ``1 <= Dl <= DH_MAX_D``; ``y`` f32 or bf16."""
    if x.dim() != 4 or y.dim() != 4 or x.shape[0] != y.shape[0] or y.shape[1] == 0 \
            or x.shape[1] % y.shape[1]:
        raise ValueError(f"{name}: need {xname} [B, Hq, Sq, ...] and {yname} [B, Hkv, S, "
                         f"Dl] with Hq a multiple of Hkv, got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    if not 1 <= y.shape[3] <= DH_MAX_D:
        raise ValueError(f"{name}: a d_head slice of {y.shape[3]}; the kernels take 1 to "
                         f"{DH_MAX_D}")
    if y.dtype not in DTYPES:
        raise TypeError(f"{name}: need {yname} f32 or bf16, got {y.dtype}")


def _dh_device(name: str, *xs: torch.Tensor) -> bool:
    """True where every tensor lies on the CPU (the plain version runs);
    False where all lie on one CUDA device; raises otherwise."""
    if all(x.device.type == "cpu" for x in xs):
        return True
    if not (all(x.device == xs[0].device for x in xs) and xs[0].device.type == "cuda"):
        raise ValueError(f"{name}: tensors on {[str(x.device) for x in xs]}: need all on "
                         "one CUDA device (or all on the CPU)")
    return False


@functools.cache
def _dh_kernel(symbol: str) -> ctypes._CFuncPtr:
    """A C entry point of ``csrc/flash_attention_dh.cu``, built, loaded and
    typed once per process."""
    ll, i32, ptr, f32 = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    fn = _build.entry("flash_attention_dh", symbol, {
        "blaze_dh_logits": [ptr] * 3 + [ll] * 8 + [i32] * 11 + [ll, i32, f32, ptr],
        "blaze_dh_softmax_pv": [ptr] * 5 + [ll] * 9 + [i32] * 14 + [f32] + [i32] * 4 + [ptr],
        "blaze_dh_smem_bytes": [i32] * 6,
    }[symbol])
    if symbol == "blaze_dh_smem_bytes":
        fn.restype = ll
    return fn


def dh_logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """The f32 partial logits ``[B, Hq, Sq, Skv]`` of ``q [B, Hq, Sq, Dl]``
    against ``k [B, Hkv, Skv, Dl]`` over this slice of ``d_head``: ``scale ·
    Σ_d q·k`` (query head ``h`` reads kv head ``h // (Hq / Hkv)``), before the
    all-reduce over the model axis (``kernels.ref.attention_logits``).

    ``q`` and ``k`` are f32 or bf16 alike, read through their strides (a
    cache's ``[B, S, Hkv, Dl]`` buffer seen as ``[B, Hkv, S, Dl]``, or a
    window's view of it, with no copy).  On CPU tensors the plain version
    runs; on a CUDA device the kernel ``dh_logits_kernel``, one launch, in
    the ring form where bulk copies can take ``k`` (:func:`_dh_ring`), else
    the element form; counted in ``dh_logits.launches`` and
    ``dh_logits.forms``."""
    _dh_check("dh_logits", q, k, "q", "k")
    if q.shape[3] != k.shape[3]:
        raise ValueError(f"dh_logits: q {tuple(q.shape)} and k {tuple(k.shape)} hold "
                         "different slices of d_head")
    if k.dtype != q.dtype:
        raise TypeError(f"dh_logits: need q and k both f32 or both bf16, got {q.dtype}, "
                        f"{k.dtype}")
    if _dh_device("dh_logits", q, k):
        return attention_logits(q, k, scale)
    b, hq, sq, dl = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    out = torch.empty((b, hq, sq, skv), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out  # a 0-block grid is a launch error
    dev, es = q.device.index, k.element_size()
    plan = dh_plan("logits", b, hq, hkv, sq, dl, es, _dh_ring(k), _build.sm_count(dev), 0,
                   -(-skv // KEY_TILE))
    args = (q.data_ptr(), k.data_ptr(), out.data_ptr(), *_dh_strides(q), *_dh_strides(k),
            b, hq, hkv, sq, skv, dl, plan.hg, int(plan.form == "ring"), plan.stages,
            _dh_elems(dl), plan.ctas, plan.per, int(q.dtype == torch.bfloat16),
            float(scale))
    _launch(_dh_kernel("blaze_dh_logits"), args, dev, "dh_logits")
    dh_logits.launches += 1
    dh_logits.forms[plan.form] += 1
    return out


def _dh_pv_plan(logits: torch.Tensor, v: torch.Tensor, off: int, causal: bool,
                window: int | None, sm_count: int) -> DhPlan:
    """:func:`dh_plan` for ``dh_softmax_pv`` at these tensors: the ring form
    where bulk copies can take ``v`` and the logits rows (contiguous along
    the keys, 16-byte aligned data)."""
    b, hq, sq, skv = logits.shape
    t_lo, t_hi = key_tiles(sq, skv, off, causal, window)
    ring = (_dh_ring(v) and (skv == 1 or logits.stride(3) == 1)
            and logits.data_ptr() % 16 == 0)
    return dh_plan("softmax_pv", b, hq, v.shape[1], sq, v.shape[3], v.element_size(), ring,
                   sm_count, t_lo, max(t_lo, t_hi))


def dh_softmax_pv(logits: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  window: int | None = None, softcap: float = 0.0,
                  q_offset: int | None = None) -> torch.Tensor:
    """``[B, Hq, Sq, Dl]`` in ``v``'s dtype: the softmax of the summed f32
    ``logits [B, Hq, Sq, Skv]`` (softcap ``c·tanh(s/c)`` first, then the
    causal rule and the window, query row ``i`` at ``q_offset + i``, default
    ``Skv - Sq``) times this slice of ``v [B, Hkv, Skv, Dl]``
    (``kernels.ref.attention_from_logits``); a row with no live key gives
    zeros.  ``v`` is read through its strides.

    On CPU tensors the plain version runs; on a CUDA device the kernel
    ``dh_softmax_pv_kernel``, one launch: split over the live key tiles
    (:func:`dh_plan`), the splits merged by the group's last CTA
    (:func:`dh_softmax_pv_tiled` is the same arithmetic in plain PyTorch);
    in the ring form where bulk copies can take ``v`` and the logits, else
    the element form; counted in ``dh_softmax_pv.launches`` and
    ``dh_softmax_pv.forms``."""
    _dh_check("dh_softmax_pv", logits, v, "logits", "v")
    if logits.dtype != torch.float32 or logits.shape[3] != v.shape[2]:
        raise TypeError(f"dh_softmax_pv: need f32 logits [B, Hq, Sq, Skv] over v's Skv, "
                        f"got {logits.dtype} {tuple(logits.shape)}, v {tuple(v.shape)}")
    if window is not None and window < 0:
        raise ValueError(f"dh_softmax_pv: window must be None or >= 0, got {window}")
    b, hq, sq, skv = logits.shape
    off = skv - sq if q_offset is None else int(q_offset)
    if _dh_device("dh_softmax_pv", logits, v):
        return attention_from_logits(logits, v, v.dtype, causal=causal, window=window,
                                     softcap=softcap, q_offset=off)
    hkv, dl = v.shape[1], v.shape[3]
    out = torch.empty((b, hq, sq, dl), dtype=v.dtype, device=v.device)
    if out.numel() == 0:
        return out
    dev = v.device.index
    plan = _dh_pv_plan(logits, v, off, causal, window, _build.sm_count(dev))
    ws = tickets = None
    if plan.splits > 1:
        ws = torch.empty(plan.ctas * plan.hg * (hq // hkv) * sq * (dl + 2),
                         dtype=torch.float32, device=v.device)
        tickets = _dh_tickets(dev, b * plan.groups)
    extent = 1 + sum((n - 1) * st for n, st in zip(logits.shape, logits.stride()))
    args = (logits.data_ptr(), v.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            tickets.data_ptr() if tickets is not None else None,
            *_dh_strides(logits), extent, *_dh_strides(v), b, hq, hkv, sq, skv, dl, plan.hg,
            int(plan.form == "ring"), plan.stages, int(v.dtype == torch.bfloat16),
            int(causal), int(window is not None), window or 0, off, float(softcap),
            plan.t_lo, plan.t_hi, plan.splits, plan.per)
    _launch(_dh_kernel("blaze_dh_softmax_pv"), args, dev, "dh_softmax_pv")
    dh_softmax_pv.launches += 1
    dh_softmax_pv.forms[plan.form] += 1
    return out


def dh_softmax_pv_tiled(logits: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, softcap: float = 0.0,
                        q_offset: int | None = None, sm_count: int = 132) -> torch.Tensor:
    """``dh_softmax_pv``'s arithmetic in plain PyTorch (f32), for the tests
    and the smoke: the live key tiles cut into the plan's splits
    (:func:`dh_plan` on a card of ``sm_count`` SMs), each split's tiles
    taken in order by the online softmax (softcapped, masked logits at
    -inf; running max from -1e30, sum and accumulators rescaled a tile at a
    time), then the splits merged in split order: ``M = max m``, ``out = Σ
    e^{m−M} acc / max(Σ e^{m−M} l, 1e-30)``, in ``v``'s dtype."""
    b, hq, sq, skv = logits.shape
    hkv, dl = v.shape[1], v.shape[3]
    off = skv - sq if q_offset is None else int(q_offset)
    plan = _dh_pv_plan(logits, v, off, causal, window, sm_count)
    n_tiles = max(1, plan.t_hi)
    s = logits.float()
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=s.device)[:, None] + off
    key = torch.arange(skv, device=s.device)
    live = torch.ones((sq, skv), dtype=torch.bool, device=s.device)
    if causal:
        live &= key[None, :] <= qpos
    if window is not None:
        live &= key[None, :] > qpos - window
    pad = n_tiles * KEY_TILE - skv  # keys past the end: masked, v zero
    s = torch.nn.functional.pad(s.masked_fill(~live, -math.inf), (0, pad), value=-math.inf)
    s = s.view(b, hq, sq, n_tiles, KEY_TILE)
    vv = torch.nn.functional.pad(v.float().repeat_interleave(hq // hkv, 1), (0, 0, 0, pad))
    vv = vv.view(b, hq, n_tiles, KEY_TILE, dl)
    splits = torch.arange(plan.splits, device=s.device)
    m = s.new_full((plan.splits, b, hq, sq), NEG_INF)
    l = torch.zeros_like(m)
    acc = s.new_zeros((plan.splits, b, hq, sq, dl))
    for i in range(plan.per):
        t = plan.t_lo + splits * plan.per + i
        ok = t < plan.t_hi  # a split's run may end before its per-th tile
        tc = t.clamp(max=n_tiles - 1)
        st = s[:, :, :, tc].permute(3, 0, 1, 2, 4)                       # [S, B, Hq, Sq, 64]
        st = st.masked_fill(~ok[:, None, None, None, None], -math.inf)
        vt = vv[:, :, tc].permute(2, 0, 1, 3, 4)                         # [S, B, Hq, 64, Dl]
        m_new = torch.maximum(m, st.amax(-1))
        p = torch.exp(st - m_new[..., None])
        c = torch.exp(m - m_new)
        l = l * c + p.sum(-1)
        acc = acc * c[..., None] + torch.einsum("sbhqk,sbhkd->sbhqd", p, vt)
        m = m_new
    w = torch.exp(m - m.amax(0))
    total, num = torch.zeros_like(l[0]), torch.zeros_like(acc[0])
    for sp in range(plan.splits):  # in split order
        total = total + w[sp] * l[sp]
        num = num + w[sp][..., None] * acc[sp]
    return (num / total.clamp_min(1e-30)[..., None]).to(v.dtype)


dh_logits.launches = 0  # kernel launches since the caller last reset it
dh_logits.forms = dict.fromkeys(DH_FORMS, 0)  # the same, by form
dh_softmax_pv.launches = 0  # the same (one launch a call, the merge inside it)
dh_softmax_pv.forms = dict.fromkeys(DH_FORMS, 0)
