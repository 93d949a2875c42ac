"""Mixture-of-Experts FFN (grok-1, mixtral): top-k routing with capacity
(the port of ``repro/models/moe.py``).

Dispatch is group-local: the ``T = B·S`` tokens are split into ``G`` groups
of ``T/G`` whole batch rows, and ranking, sorting and gathering run within a
group.  This is Blaze's small-fixed-key-range MapReduce with key = expert
id: a group's choices are combined eagerly into dense per-expert buffers
``[E, G·C, d]``, then every expert's FFN is one batched product over them.
Every expert computes all ``C`` rows of its buffer, used or not, as the
reference's dense einsums do.

Token dropping: each (group, expert) holds ``C = min(max(1, ceil(T_g·k/E ·
capacity_factor)), T_g)`` choices, taken in token order; a choice past them
goes to the drop slot, and a dropped choice adds nothing (the token passes
through the residual only), as in GShard/Switch.  The expert products are
plain matrix products (the reference computes them outside any Pallas
kernel).

:func:`route` and :func:`dispatch` are the two halves of the routing that
:func:`moe_apply` runs; :func:`routes` gives a call's choices, probabilities
and kept choices without computing the experts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense_init


def moe_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """``router [d, E]`` f32; ``w_gate``/``w_up [E, d, ff]`` and ``w_down
    [E, ff, d]`` in the parameter dtype, one expert at a time."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def experts(d_in, d_out):
        w = torch.empty((e, d_in, d_out), dtype=cfg.pdtype, device=gen.device)
        for i in range(e):
            w[i] = dense_init(gen, d_in, d_out, cfg.pdtype)
        return w

    return {"router": dense_init(gen, d, e, torch.float32),
            "w_gate": experts(d, ff), "w_up": experts(d, ff), "w_down": experts(ff, d)}


def groups(b: int, t: int, dispatch_groups: int) -> int:
    """``G``: ``dispatch_groups`` where it divides both the tokens ``t`` and
    the batch ``b`` (each group whole rows), else 1."""
    return dispatch_groups if t % dispatch_groups == 0 and b % dispatch_groups == 0 else 1


def capacity(cfg: ArchConfig, tg: int) -> int:
    """Choices an expert holds in a group of ``tg`` tokens."""
    cap = max(1, math.ceil(tg * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return min(cap, tg)


def route(params: dict, cfg: ArchConfig, xt: torch.Tensor):
    """The router on ``xt [G, Tg, d]``, in f32: ``(probs [G, Tg, E], top_p,
    top_e [G, Tg, k])``.  The top ``k`` are taken from a stable descending
    sort, so a tie goes to the lower expert index (as ``lax.top_k``); their
    weights are renormalised by ``max(Σ, 1e-9)``."""
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)
    top_e = torch.argsort(probs, dim=-1, descending=True, stable=True)[..., :cfg.top_k]
    top_p = probs.gather(-1, top_e)
    return probs, top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9), top_e


def dispatch(cfg: ArchConfig, top_e: torch.Tensor, cap: int):
    """Each group's ``Tg·k`` choices (token-major) sorted by expert:
    ``(order, slot)``, both ``[G, Tg·k]`` in sorted order.  A choice's rank
    within its expert is its sorted position less the expert's first one
    (the sort is stable, so earlier tokens rank first); ``slot = expert·cap
    + rank`` for a kept choice, the drop slot ``E·cap`` for one ranked at
    ``cap`` or beyond."""
    g, tg, k = top_e.shape
    flat_e = top_e.reshape(g, tg * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, order).contiguous()
    first = torch.searchsorted(sorted_e, sorted_e)  # side="left"
    rank = torch.arange(tg * k, device=top_e.device) - first
    slot = torch.where(rank < cap, sorted_e * cap + rank,
                       torch.full_like(rank, cfg.n_experts * cap))
    return order, slot


def routes(params: dict, cfg: ArchConfig, x: torch.Tensor, *,
           dispatch_groups: int = 1) -> dict:
    """What :func:`moe_apply` routes for ``x [B, S, d]``, without the
    experts: ``probs [G, Tg, E]``, ``top_e [G, Tg, k]`` and ``kept [G, Tg,
    k]`` (False for a choice sent to the drop slot), and ``cap``."""
    b, s, d = x.shape
    g = groups(b, b * s, dispatch_groups)
    tg = b * s // g
    probs, _, top_e = route(params, cfg, x.reshape(g, tg, d))
    cap = capacity(cfg, tg)
    order, slot = dispatch(cfg, top_e, cap)
    kept = torch.empty_like(slot, dtype=torch.bool)
    kept.scatter_(1, order, slot < cfg.n_experts * cap)
    return {"probs": probs, "top_e": top_e, "kept": kept.reshape(top_e.shape), "cap": cap}


def moe_apply(params: dict, cfg: ArchConfig, x: torch.Tensor, *,
              dispatch_groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, d]`` → ``(output [B, S, d], load-balance aux loss)``,
    ``aux = E · Σ_e f_e · p̄_e`` with ``f_e`` the share of primary choices
    of expert ``e`` and ``p̄_e`` its mean router probability.  The expert
    FFN ``silu(x W_g) · (x W_u) W_d`` runs in ``x``'s dtype over ``[E, G·C,
    d]``; tokens move by gathers only, and each token's output is ``Σ_j w_j
    · y_j`` over its kept choices, in the experts' output dtype."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = groups(b, b * s, dispatch_groups)
    tg = b * s // g
    xt = x.reshape(g, tg, d)
    probs, top_p, top_e = route(params, cfg, xt)

    f_e = F.one_hot(top_e[..., 0], e).float().mean((0, 1))  # primary choices
    aux = e * (f_e * probs.mean((0, 1))).sum()

    cap = capacity(cfg, tg)
    order, slot = dispatch(cfg, top_e, cap)
    sorted_tok = torch.arange(tg, device=x.device).repeat_interleave(k)[order]
    # The slot -> token map (the drop slot's writes are cut off), then every
    # expert's rows by one gather; token tg is a zero row.
    token_of_slot = torch.full((g, e * cap + 1), tg, dtype=torch.long, device=x.device)
    token_of_slot.scatter_(1, slot, sorted_tok)
    tos = token_of_slot[:, :e * cap].reshape(g, e, cap)
    xt_pad = torch.cat([xt, xt.new_zeros(g, 1, d)], dim=1)
    rows = torch.arange(g, device=x.device)[:, None, None]
    xe = xt_pad[rows, tos]  # [G, E, C, d]
    xe = xe.transpose(0, 1).reshape(e, g * cap, d)
    gate = F.silu(torch.bmm(xe, params["w_gate"].to(x.dtype)))
    up = torch.bmm(xe, params["w_up"].to(x.dtype))
    ye = torch.bmm(gate * up, params["w_down"].to(x.dtype))  # [E, G·C, d]
    ye = ye.reshape(e, g, cap, d).transpose(0, 1).reshape(g, e * cap, d)

    # Combine: each token's k slots and weights (the dispatch order
    # inverted), its k expert rows gathered (the drop slot reads a zero
    # row), then the elementwise mix.
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(tg * k, device=x.device).expand(g, -1))
    slot_by_tok = slot.gather(1, inv)  # [G, Tg·k], token-major
    w_by_tok = top_p.reshape(g, tg * k)  # the choices' weights, token-major
    ye_pad = torch.cat([ye, ye.new_zeros(g, 1, d)], dim=1)
    picked = ye_pad[rows[:, :, 0], slot_by_tok].reshape(g, tg, k, d)
    out = (picked * w_by_tok.reshape(g, tg, k, 1).to(picked.dtype)).sum(2)
    return out.reshape(b, s, d).to(x.dtype), aux
