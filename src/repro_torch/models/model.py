"""Model assembly: blocks → layers → LM (the port of ``repro/models/
model.py`` for the dense attention, Mamba-2 and RWKV-6 architectures).

The JAX package stacks each stage's parameters and scans over them; the
port keeps one parameter dict and one cache per layer and runs a Python
loop, in the same layer order (stage by stage, slot by slot, then the tail).
zamba2's shared attention block is one dict, ``params["shared_attn"]``,
that every ``SHARED_ATTN`` position of ``params["layers"]`` refers to; each
application keeps its own KV cache, as the reference's per-slot caches do.

Public entry points:
  init(gen, cfg)                                → params
  forward(params, cfg, tokens, ...)             → (hidden [B, S, d], caches, aux)
  logits_fn(params, cfg, hidden)                → f32 logits
  prefill(...) / decode_step(...)               → the serving path with caches
  make_caches(cfg, batch, max_len, device)      → one cache per layer
  param_count(params)
The MoE block kinds raise ``NotImplementedError`` naming their slice;
``loss_fn`` comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import (
    ATTN,
    ATTN_LOCAL,
    ATTN_LOCAL_MOE,
    ATTN_MOE,
    MAMBA2,
    RWKV6,
    SHARED_ATTN,
    ArchConfig,
)
from repro_torch.models import attention as A
from repro_torch.models import rwkv as RW
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import embed_init, dense_init, mlp, mlp_init, rmsnorm, rmsnorm_init

_LATER_SLICES = {
    ATTN_MOE: "the MoE slice (mixtral-8x22b, grok-1)",
    ATTN_LOCAL_MOE: "the MoE slice (mixtral-8x22b, grok-1)",
}
_ATTN_KINDS = (ATTN, ATTN_LOCAL, SHARED_ATTN)


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """Every layer's block kind, in order; raises for a kind not ported yet."""
    kinds = list(cfg.stage_pattern) * cfg.n_stages + list(cfg.tail_pattern)
    for kind in kinds:
        if kind in _LATER_SLICES:
            raise NotImplementedError(
                f"block kind {kind!r} ({cfg.name}) comes with {_LATER_SLICES[kind]}")
        if kind not in _ATTN_KINDS + (MAMBA2, RWKV6):
            raise ValueError(f"unknown block kind {kind!r}")
    return kinds


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def block_init(gen: torch.Generator, cfg: ArchConfig, kind: str) -> dict:
    def ln():
        return rmsnorm_init(cfg.d_model, cfg.pdtype, gen.device)

    if kind in _ATTN_KINDS:
        return {"ln1": ln(), "attn": A.attn_init(gen, cfg), "ln2": ln(),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.pdtype)}
    if kind == MAMBA2:
        return {"ln1": ln(), "mamba": SSM.mamba_init(gen, cfg)}
    if kind == RWKV6:
        return {"ln1": ln(), "ln2": ln(), "rwkv": RW.rwkv_init(gen, cfg)}
    raise ValueError(kind)


def block_apply(params: dict, cfg: ArchConfig, kind: str, h: torch.Tensor,
                positions: torch.Tensor, *, cache=None, cache_len: int | None = None,
                attn_impl: str = "auto", scan_impl: str = "auto"):
    """Pre-norm residual block; returns ``(h, cache)``, the cache (if any)
    updated in place.  Attention kinds: attention, then the SwiGLU MLP
    (``attn_impl``); Mamba-2: the SSM mixer; RWKV-6: time-mix, then
    channel-mix (``scan_impl`` for both recurrences)."""
    if kind in _ATTN_KINDS:
        a_out, new_kv = A.attn_apply(
            params["attn"], cfg, rmsnorm(params["ln1"], h), positions,
            local=kind == ATTN_LOCAL, cache=cache, cache_len=cache_len,
            attn_impl=attn_impl,
        )
        h = h + a_out
        return h + mlp(params["mlp"], rmsnorm(params["ln2"], h)), new_kv
    if kind == MAMBA2:
        m_out, cache = SSM.mamba_apply(params["mamba"], cfg, rmsnorm(params["ln1"], h),
                                       cache=cache, scan_impl=scan_impl)
        return h + m_out, cache
    if kind == RWKV6:
        tm_out, shift_tm, _ = RW.time_mix(params["rwkv"]["tm"], cfg,
                                          rmsnorm(params["ln1"], h), cache,
                                          scan_impl=scan_impl)
        h = h + tm_out
        cm_out, shift_cm = RW.channel_mix(params["rwkv"]["cm"], cfg,
                                          rmsnorm(params["ln2"], h), cache)
        if cache is not None:  # after channel-mix has read the old row
            cache.shift_tm.copy_(shift_tm)
            cache.shift_cm.copy_(shift_cm)
        return h + cm_out, cache
    raise ValueError(kind)


def make_caches(cfg: ArchConfig, batch: int, max_len: int, device) -> list:
    """One cache per layer, in layer order: a ``KVCache`` of ``max_len``
    rows for each attention application, a ``MambaCache`` or ``RWKVCache``
    for each recurrent layer (their size does not depend on ``max_len``)."""
    def one(kind):
        if kind in _ATTN_KINDS:
            return A.make_cache(cfg, batch, max_len, device)
        if kind == MAMBA2:
            return SSM.make_mamba_cache(cfg, batch, device)
        return RW.make_rwkv_cache(cfg, batch, device)

    return [one(kind) for kind in layer_kinds(cfg)]


# ---------------------------------------------------------------------------
# Model init / forward
# ---------------------------------------------------------------------------


def init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters drawn from ``gen``, on ``gen``'s device.  Every
    ``SHARED_ATTN`` layer is the one dict ``params["shared_attn"]``."""
    kinds = layer_kinds(cfg)
    params: dict = {}
    if SHARED_ATTN in kinds:
        params["shared_attn"] = block_init(gen, cfg, SHARED_ATTN)
    params["layers"] = [params["shared_attn"] if kind == SHARED_ATTN
                        else block_init(gen, cfg, kind) for kind in kinds]
    params["embed"] = embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdtype)
    params["final_norm"] = rmsnorm_init(cfg.d_model, cfg.pdtype, gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, cfg.pdtype)
    return params


def forward(params: dict, cfg: ArchConfig, inputs: torch.Tensor, *,
            positions: torch.Tensor | None = None,
            caches: list | None = None, cache_len: int | None = None,
            attn_impl: str = "auto", scan_impl: str = "auto"):
    """``(hidden [B, S, d], caches, aux)`` of tokens ``[B, S]`` (or embeds
    ``[B, S, d]`` where the config does not embed).  With ``caches``, the
    inputs continue a sequence of ``cache_len`` tokens already cached, and
    every cache is updated in place.  ``attn_impl`` goes to the attention
    kernels (``ops.attention``), ``scan_impl`` to the recurrences
    (``ops.ssd``, ``ops.rwkv6``).  ``aux`` is the MoE balance loss of the
    JAX model: 0 for these blocks."""
    if cfg.embed_inputs:
        h = params["embed"][inputs].to(cfg.cdtype)
    else:
        h = inputs.to(cfg.cdtype)
    b, s = h.shape[0], h.shape[1]
    if positions is None:
        start = 0 if cache_len is None else int(cache_len)
        positions = (torch.arange(s, device=h.device) + start).expand(b, s)
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        h, _ = block_apply(p, cfg, kind, h, positions,
                           cache=None if caches is None else caches[i],
                           cache_len=cache_len, attn_impl=attn_impl,
                           scan_impl=scan_impl)
    h = rmsnorm(params["final_norm"], h)
    return h, caches, torch.zeros((), device=h.device)


def logits_fn(params: dict, cfg: ArchConfig, hidden: torch.Tensor) -> torch.Tensor:
    """f32 logits ``hidden · W_head``.  The JAX model upcasts both operands
    to f32; a bf16 product is exact in f32, so on the card the port asks
    cuBLAS for an f32 result from the bf16 operands (``torch.mm`` with
    ``out_dtype``) and never writes an f32 copy of the ``[V, d]`` head."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]  # [d, V]
    h2 = hidden.reshape(-1, hidden.shape[-1])
    if h2.device.type == "cuda" and h2.dtype == head.dtype != torch.float32:
        logits = torch.mm(h2, head, out_dtype=torch.float32)
    else:
        logits = h2.float() @ head.float()
    logits = logits.reshape(*hidden.shape[:-1], -1)
    if cfg.final_softcap > 0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def prefill(params: dict, cfg: ArchConfig, inputs: torch.Tensor, caches: list, *,
            attn_impl: str = "auto", scan_impl: str = "auto"):
    """Fill the caches from a prompt; ``(last-token logits [B, V], caches)``."""
    hidden, caches, _ = forward(params, cfg, inputs, caches=caches, cache_len=0,
                                attn_impl=attn_impl, scan_impl=scan_impl)
    return logits_fn(params, cfg, hidden[:, -1:])[:, 0], caches


def decode_step(params: dict, cfg: ArchConfig, inputs: torch.Tensor, caches: list,
                cache_len: int, *, attn_impl: str = "auto", scan_impl: str = "auto"):
    """One token for every sequence: ``inputs [B, 1]`` at position
    ``cache_len``; ``(logits [B, V], caches)``."""
    hidden, caches, _ = forward(params, cfg, inputs, caches=caches,
                                cache_len=cache_len, attn_impl=attn_impl,
                                scan_impl=scan_impl)
    return logits_fn(params, cfg, hidden[:, -1:])[:, 0], caches


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)


def param_count(params: dict) -> int:
    """Parameters, each tensor counted once: zamba2's shared block, which
    every ``SHARED_ATTN`` layer refers to, counts once, as in JAX's pytree."""
    return sum(x.numel() for x in {id(x): x for x in _leaves(params)}.values())
