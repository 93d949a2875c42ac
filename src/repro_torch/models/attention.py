"""Attention block: GQA/MHA with RoPE or M-RoPE, qk-norm, softcap, a sliding
window and a KV cache (the port of ``repro/models/attention.py``).

The attention itself runs through ``kernels.ops.attention``: the
hand-written flash-attention kernel on the card, ``attention_ref`` on the
CPU.  The cache keeps JAX's ``[B, S_max, Hkv, Dh]`` layout and is written in
place (JAX returns an updated copy); the kernel reads it through a
transposed view, so no step copies it.  The sharding constraints of the JAX
block are gone: the port runs on one card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    apply_mrope,
    apply_rope,
    dense_init,
    rmsnorm,
    rmsnorm_init,
)


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S_max, Hkv, Dh]
    v: torch.Tensor  # [B, S_max, Hkv, Dh]


def attn_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": dense_init(gen, d, hq * dh, cfg.pdtype),
        "wk": dense_init(gen, d, hkv * dh, cfg.pdtype),
        "wv": dense_init(gen, d, hkv * dh, cfg.pdtype),
        "wo": dense_init(gen, hq * dh, d, cfg.pdtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(dh, cfg.pdtype, gen.device)
        p["k_norm"] = rmsnorm_init(dh, cfg.pdtype, gen.device)
    return p


def attn_apply(params: dict, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor, *, local: bool = False,
               cache: KVCache | None = None, cache_len: int | None = None,
               attn_impl: str = "auto") -> tuple[torch.Tensor, KVCache | None]:
    """``x [B, S, d]`` at ``positions [B, S]`` → ``([B, S, d], cache)``.
    Where the config has M-RoPE sections, ``positions [3, B, S]`` are
    ``(t, h, w)`` triples; ``[B, S]`` positions take plain RoPE, which is
    M-RoPE at equal coordinates (text).

    With a cache, the new K/V are written at rows ``[cache_len, cache_len +
    S)`` and the queries attend over the cache, at ``q_offset = cache_len``.
    A write past the cache's ``S_max`` rows raises ``ValueError`` (the
    reference's ``dynamic_update_slice`` clamps the start instead, and so
    overwrites the last rows).
    """
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ params["wq"]).reshape(b, s, hq, dh)
    k = (x @ params["wk"]).reshape(b, s, hkv, dh)
    v = (x @ params["wv"]).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if cfg.mrope_sections is not None and positions.dim() == 3:
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
        idx = int(cache_len)
        if idx + s > cache.k.shape[1]:
            raise ValueError(f"KV cache of {cache.k.shape[1]} rows: cannot write {s} "
                             f"rows at cache_len {idx}")
        cache.k[:, idx:idx + s] = k.to(cache.k.dtype)
        cache.v[:, idx:idx + s] = v.to(cache.v.dtype)
        k_all, v_all, q_offset = cache.k, cache.v, idx
        if local and cfg.window is not None and cache.k.shape[1] > cfg.window + s:
            # Only the last `window + s` rows can be in the window: a view of
            # them keeps a local layer's step O(window), not O(cache).
            sw = cfg.window + s
            start = min(max(idx + s - sw, 0), cache.k.shape[1] - sw)
            k_all, v_all = cache.k[:, start:start + sw], cache.v[:, start:start + sw]
            q_offset = idx - start
    else:
        k_all, v_all, q_offset = k, v, 0

    out = ops.attention(
        q.transpose(1, 2), k_all.transpose(1, 2), v_all.transpose(1, 2),
        causal=True, window=cfg.window if local else None,
        softcap=cfg.attn_softcap, q_offset=q_offset, impl=attn_impl,
    )  # [B, Hq, S, Dh]
    out = out.transpose(1, 2).reshape(b, s, hq * dh)
    return (out @ params["wo"]).to(x.dtype), cache


def make_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return KVCache(k=torch.zeros(shape, dtype=cfg.cdtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.cdtype, device=device))
