"""Flash attention: online-softmax attention with causal, GQA, sliding-window,
softcap and offset masking (the LM stack's attention kernel).

The counterpart of the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``.  On a CUDA tensor :func:`flash_attention` launches the
hand-written kernel in ``csrc/flash_attention.cu`` (the source says how it
is built and why); on a CPU tensor it runs ``kernels.ref.attention_ref``,
the same function in plain PyTorch.

Unlike the TPU kernel, which takes ``q_offset`` as a compile-time constant
and so cannot serve from a KV cache whose length is a traced value, this
one takes it as a run-time argument of the launch.  Inputs are read through
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
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

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
                       q_offset: int | None = None) -> torch.Tensor:
    """The decode form's arithmetic in plain PyTorch (f32): the key tiles of
    :func:`key_tiles` cut into ``splits`` runs of whole tiles, each run into
    4 partials (keys ``16w..16w+15`` of every 64-key tile, the kernel's
    warps), each partial's ``(m, l, acc)`` of every row with masked logits at
    -1e30, ``p`` rounded to ``q``'s dtype for ``acc``; then the combine: ``M
    = max m``, ``out = Σ e^{m−M} acc / max(Σ e^{m−M} l, 1e-30)``.  A
    partial with no live key (``m = -1e30, l = 0``) weighs 0; a row with no
    live key gives zeros.  ``splits`` may exceed the tiles (empty splits)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = hq // hkv
    off = skv - sq if q_offset is None else int(q_offset)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
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


@functools.cache
def _kernel() -> ctypes._CFuncPtr:
    """The C entry point, built, loaded and typed once per process."""
    ll, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    return _build.entry("flash_attention", "blaze_flash_attention", [
        ptr, ptr, ptr, ptr, *[ll] * 12, *[i32] * 10, ctypes.c_float, ctypes.c_float,
        i32, i32, i32, ptr, ptr,
    ])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float = 0.0, scale: float | None = None,
                    q_offset: int | None = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Attention of ``q [B, Hq, Sq, D]`` over ``k, v [B, Hkv, Skv, D]``, f32
    or bf16 (all three alike), output in ``q``'s dtype.

    Query row ``i`` sits at absolute position ``q_offset + i`` (default
    ``Skv - Sq``), an ``int`` read at run time.  ``block_q``/``block_k``
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
    off = skv - sq if q_offset is None else int(q_offset)
    if q.device.type == k.device.type == v.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                             q_offset=off, scale=scale)
    if not (q.device == k.device == v.device and q.device.type == "cuda"):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}: need "
                         "all on one CUDA device (or all on the CPU)")
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
        t_lo, t_hi = key_tiles(sq, skv, off, causal, window)
        splits, per = decode_splits(b, hkv, t_hi - t_lo, _build.sm_count(q.device.index))
        ws = torch.empty(b * hkv * SPLIT_PARTS * splits * (hq // hkv) * sq * (d + 2),
                         dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
            b, hq, hkv, sq, skv, d, int(causal), int(window is not None), window or 0, off,
            float(scale), float(softcap), FORMS.index(kind), splits, per,
            ws.data_ptr() if ws is not None else None)
    dev = q.device.index
    if dev == torch.cuda.current_device():  # the launch goes to the current device
        err = _kernel()(*args, _build.raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            err = _kernel()(*args, _build.raw_stream(dev))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.forms[kind] += 1
    return out


flash_attention.launches = 0  # kernel launches since the caller last reset it
flash_attention.forms = dict.fromkeys(FORMS, 0)  # the same, by form
