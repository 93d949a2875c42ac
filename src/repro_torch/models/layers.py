"""Shared model layers: initialisers, RMSNorm, rotary embeddings and the
SwiGLU MLP (the port of ``repro/models/layers.py``).

Parameters are plain dicts of tensors, as in the JAX package, and a weight
keeps JAX's ``[d_in, d_out]`` layout, so ``x @ W`` reads the same in both.
Initialisers draw from an explicit ``torch.Generator`` on the device the
tensors are made on; the same seed gives other numbers than ``jax.random``,
so tests carry weights across with ``convert.lm_params_from_jax``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as SH


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype) -> torch.Tensor:
    scale = (1.0 / d_in) ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device) * scale
    return w.to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=gen.device) * 0.02).to(dtype)


def rmsnorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) · (1 + scale)`` in f32, back to ``x``'s dtype: the scale
    starts at zero and multiplies as ``1 + scale`` (not HF's ``scale · x``)."""
    xf = x.float()
    normed = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (normed * (1.0 + params["scale"].float())).to(x.dtype)


def _rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """``x [B, S, H, D]`` rotated pairwise by ``angles [B, S, D/2]``, in f32.
    On a ``DTensor`` the angles (the same on every rank) join as a replicated
    one, so the backward needs no plain tensor."""
    cos = SH.replicated(torch.cos(angles)[:, :, None, :], x)
    sin = SH.replicated(torch.sin(angles)[:, :, None, :], x)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding of ``x [B, S, H, D]`` at ``positions [B, S]``, with
    split halves (dims ``i`` and ``i + D/2`` rotate together), in f32."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    if positions.stride(0) == 0:  # the same positions in every row: one row
        positions = positions[:1]
    angles = positions.float()[..., None] * freqs  # [B, S, D/2]
    return _rotate(x, angles)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections: tuple[int, ...],
                theta: float = 10_000.0) -> torch.Tensor:
    """Qwen2-VL's multimodal rotary embedding of ``x [B, S, H, D]`` at
    ``positions [3, B, S]`` (``(t, h, w)`` triples): the ``D/2`` rotary
    pairs are split into ``sections`` (summing to ``D/2``), and the pairs of
    section ``i`` rotate by coordinate ``i``; otherwise as :func:`apply_rope`."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to D/2 = {half}")
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    if positions.stride(1) == 0:  # the same positions in every row: one row
        positions = positions[:, :1]
    angles = torch.cat([positions[i].float()[..., None] * f
                        for i, f in enumerate(freqs.split(list(sections)))], -1)  # [B, S, D/2]
    return _rotate(x, angles)


def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype) -> dict:
    return {
        "w_gate": dense_init(gen, d, d_ff, dtype),
        "w_up": dense_init(gen, d, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d, dtype),
    }


def mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) · x W_up) W_down``."""
    gate = F.silu(x @ params["w_gate"])
    return ((gate * (x @ params["w_up"])) @ params["w_down"]).to(x.dtype)
