"""Attention block: GQA/MHA with RoPE or M-RoPE, qk-norm, softcap, a sliding
window and a KV cache (the port of ``repro/models/attention.py``).

The attention itself runs through ``kernels.ops.attention``: the
hand-written flash-attention kernel on the card, ``attention_ref`` on the
CPU.  The cache keeps JAX's ``[B, S_max, Hkv, Dh]`` layout and is written in
place (JAX returns an updated copy); the kernel reads it through a
transposed view, so no step copies it.

``cache_len`` is a host ``int`` or a 0-d integer tensor on the step's device
(a captured decode step's position, ``launch.serve_lm.DecodeGraph``).  With
a tensor nothing is read on the host: the new rows go in by ``index_copy_``
at the device index, a local layer passes the whole cache and its window to
K4, which skips the tiles outside the window (so the step stays O(window)
and copies no rows), and K4 reads the offset on the device.  The ``int``
route keeps the window's view of the last ``window + S`` rows.

On ``DTensor`` inputs (a model sharded over a ``DeviceMesh``) the block
keeps the reference's constraints (``distributed.sharding.constrain``): q,
k and v over (dp, heads on model), or, for decode with kv heads that do not
divide the model axis, over (dp, ``d_head`` on model), matching the caches
``sharding.cache_pspecs`` gives.  The new rows are written into each rank's
shard of the cache (a sequence-sharded cache takes the rows that fall in
its range).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import constrain
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
               cache: KVCache | None = None,
               cache_len: int | torch.Tensor | None = None,
               attn_impl: str = "auto") -> tuple[torch.Tensor, KVCache | None]:
    """``x [B, S, d]`` at ``positions [B, S]`` → ``([B, S, d], cache)``.
    Where the config has M-RoPE sections, ``positions [3, B, S]`` are
    ``(t, h, w)`` triples; ``[B, S]`` positions take plain RoPE, which is
    M-RoPE at equal coordinates (text).

    With a cache, the new K/V are written at rows ``[cache_len, cache_len +
    S)`` and the queries attend over the cache, at ``q_offset = cache_len``.
    A write past the cache's ``S_max`` rows raises ``ValueError`` (the
    reference's ``dynamic_update_slice`` clamps the start instead, and so
    overwrites the last rows); a tensor ``cache_len`` is not read on the
    host, so its caller checks that (``DecodeGraph`` does, before each
    step).  A tensor ``cache_len`` with ``DTensor`` inputs raises
    ``ValueError``: the sharded route writes each rank's rows by host
    index.
    """
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    at = cache is not None and isinstance(cache_len, torch.Tensor)
    if at and (isinstance(x, DTensor) or isinstance(cache.k, DTensor)):
        raise ValueError("attn_apply: a tensor cache_len needs plain tensors; the "
                         "sharded route takes an int")
    q = SH.split_heads(x @ params["wq"], hq, dh)
    k = SH.split_heads(x @ params["wk"], hkv, dh)
    v = SH.split_heads(x @ params["wv"], hkv, dh)
    # The layout must match the cache's (sharding.cache_pspecs): decode with
    # kv heads that don't divide the model axis shards d_head (the logits'
    # partial sums then cross the wire, not the cache); else heads.
    msize = _model_size(x)
    dh_layout = (cache is not None and s <= 8 and msize > 1 and hkv % msize != 0
                 and dh % msize == 0)
    shard_hint = "dh" if dh_layout else ("heads" if msize > 1 and hq % msize == 0 else None)
    axes = (SH.DP, None, None, SH.MODEL) if dh_layout else (SH.DP, None, SH.MODEL, None)
    if not dh_layout:
        q, k, v = (constrain(t, *axes) for t in (q, k, v))
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if cfg.mrope_sections is not None and positions.dim() == 3:
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if dh_layout:  # after the rotary pairs (i, i + D/2) have met
        q, k, v = (constrain(t, *axes) for t in (q, k, v))

    if at:
        rows = cache_len + torch.arange(s, device=cache.k.device)
        cache.k.index_copy_(1, rows, k.to(cache.k.dtype))
        cache.v.index_copy_(1, rows, v.to(cache.v.dtype))
        k_all, v_all, q_offset = cache.k, cache.v, cache_len
    elif cache is not None:
        idx = int(cache_len)
        if idx + s > cache.k.shape[1]:
            raise ValueError(f"KV cache of {cache.k.shape[1]} rows: cannot write {s} "
                             f"rows at cache_len {idx}")
        _write_rows(cache.k, k, idx)
        _write_rows(cache.v, v, idx)
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
        shard_hint=shard_hint,
    )  # [B, Hq, S, Dh]
    out = SH.merge_last(out.transpose(1, 2), 2)  # [B, S, Hq·Dh]
    return (out @ params["wo"]).to(x.dtype), cache


def _model_size(x) -> int:
    if not isinstance(x, DTensor):
        return 1
    i = SH.axis_index(x.device_mesh, SH.MODEL)
    return 1 if i is None else x.device_mesh.shape[i]


def _write_rows(buf: torch.Tensor, new: torch.Tensor, idx: int) -> None:
    """``buf[:, idx:idx + S] = new`` in place.  A ``DTensor`` cache is
    written shard by shard: ``new`` takes the cache's placements with the
    sequence whole, and each rank writes the rows that fall in its shard."""
    if not isinstance(buf, DTensor):
        buf[:, idx:idx + new.shape[1]] = new.to(buf.dtype)
        return
    target = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
                   for p in buf.placements)
    new = new.to(buf.dtype).redistribute(buf.device_mesh, target).to_local()
    local = buf.to_local()
    off = SH.shard_offset(buf, 1)
    lo, hi = max(idx, off), min(idx + new.shape[1], off + local.shape[1])
    if lo < hi:
        local[:, lo - off:hi - off] = new[:, lo - idx:hi - idx]


def make_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return KVCache(k=torch.zeros(shape, dtype=cfg.cdtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.cdtype, device=device))
