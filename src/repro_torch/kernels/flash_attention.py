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
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

MAX_D = 256
DTYPES = (torch.float32, torch.bfloat16)


def _strides(x: torch.Tensor) -> list[int]:
    """``[batch, head, seq]`` strides in elements; 0 for a dimension of
    size 1, which the kernel never steps along."""
    return [s if n > 1 else 0 for n, s in zip(x.shape[:3], x.stride()[:3])]


def _check_layout(name: str, x: torch.Tensor) -> None:
    if x.stride(-1) != 1:
        raise ValueError(f"{name}: the last dimension must be contiguous")
    if any(s % 8 for s in _strides(x)) or x.data_ptr() % 16:
        raise ValueError(f"{name}: strides must be multiples of 8 elements and "
                         "the data 16-byte aligned (16-byte vector loads)")


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
    if all(x.device.type == "cpu" for x in (q, k, v)):
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
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, x)
    out = torch.empty_like(q)  # keeps q's strides when q is dense
    _check_layout("out", out)
    if out.numel() == 0:
        return out  # a 0-block grid is a launch error
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    ll, i32 = ctypes.c_longlong, ctypes.c_int
    fn = _build.entry("flash_attention", "blaze_flash_attention", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        *[ll] * 12, *[i32] * 10, ctypes.c_float, ctypes.c_float, i32,
        ctypes.c_void_p,
    ])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *_strides(q), *_strides(k), *_strides(v), *_strides(out),
                 b, hq, hkv, sq, skv, d, int(causal), int(window is not None),
                 window or 0, off, float(scale), float(softcap),
                 int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0  # kernel launches since the caller last reset it
