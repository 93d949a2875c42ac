"""Plain PyTorch oracles for the kernels.

The counterpart of ``repro/kernels/ref.py``: each function is the semantic
ground truth, small and obviously right, written without regard to speed.  Tests hold the kernels' wrappers against
these; ``kernels.ops`` reaches them with ``impl="ref"``.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  softcap: float = 0.0, q_offset: int | torch.Tensor | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """Attention of ``q [B, Hq, Sq, D]`` over ``k, v [B, Hkv, Skv, D]``
    (GQA: query head ``h`` reads kv head ``h // (Hq / Hkv)``), with the whole
    ``[Sq, Skv]`` logits materialised in f32.

    Query row ``i`` sits at absolute position ``q_offset + i`` (default
    ``Skv - Sq``; an int or a 0-d integer tensor); key ``j`` at ``j``.  Causal keeps ``j <= pos``, a window
    ``j > pos - window``, a softcap maps logits through ``c·tanh(s/c)``.
    Masked logits are ``-inf``; a row with every key masked gives zeros.
    The output is in ``q``'s dtype.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return attention_from_logits(attention_logits(q, k, scale), v, q.dtype, causal=causal,
                                 window=window, softcap=softcap, q_offset=q_offset)


def attention_logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """:func:`attention_ref`'s f32 logits ``[B, Hq, Sq, Skv]`` before the
    softcap and the masks (a sum over ``D``: over a slice of ``D``, a
    partial sum)."""
    kk = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1).float()
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale


def attention_from_logits(logits: torch.Tensor, v: torch.Tensor, dtype, *,
                          causal: bool = True, window: int | None = None,
                          softcap: float = 0.0,
                          q_offset: int | torch.Tensor | None = None) -> torch.Tensor:
    """The rest of :func:`attention_ref` from its logits: softcap, masks,
    softmax and the product with ``v [B, Hkv, Skv, Dv]``, in ``dtype``."""
    sq, skv = logits.shape[2], logits.shape[3]
    vv = v.repeat_interleave(logits.shape[1] // v.shape[1], dim=1).float()
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    off = skv - sq if q_offset is None else q_offset
    qpos = torch.arange(sq, device=logits.device)[:, None] + off
    kpos = torch.arange(skv, device=logits.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=logits.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1).nan_to_num(nan=0.0)  # fully-masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(dtype)


def segment_reduce_ref(ids: torch.Tensor, vals: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Sum ``vals`` rows into ``num_segments`` dense buckets, in ``vals``'
    dtype; ids outside ``[0, num_segments)`` are dropped."""
    keep = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, ids[keep].long(), vals[keep])


def kmeans_assign_ref(points: torch.Tensor, centers: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(assign [N] int32, stats [K, D+1])``: the nearest centre by the full
    ``‖x‖² − 2x·cᵀ + ‖c‖²`` (first index on ties), and per centre ``Σx`` and
    the count, from a one-hot product."""
    d2 = ((points ** 2).sum(1, keepdim=True) - 2.0 * points @ centers.T
          + (centers ** 2).sum(1)[None, :])
    assign = torch.argmin(d2, dim=1)
    onehot = torch.nn.functional.one_hot(assign, centers.shape[0]).to(points.dtype)
    sums = onehot.T @ points
    counts = onehot.sum(0)[:, None]
    return assign.to(torch.int32), torch.cat([sums, counts], dim=1)


def _state_dtype(*xs: torch.Tensor) -> torch.dtype:
    """f32, or f64 where an input is f64 (the float64 oracle of the smoke)."""
    return torch.float64 if any(x.dtype == torch.float64 for x in xs) else torch.float32


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, *, init_state: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD, one step at a time: ``h_t = exp(a·dt_t)·h_{t-1} + dt_t·
    x_t ⊗ B_t``, ``y_t = C_t · h_t``.

    ``x [B, S, H, P]``, ``dt [B, S, H]``, ``a [H]`` (negative), ``b, c [B, S,
    G, N]`` (group ``g`` serves heads ``g·H/G …``), ``init_state [B, H, P,
    N]``.  The state is f32 (f64 where an input is f64); returns ``(y`` in
    ``x``'s dtype``, h_T)``.
    """
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    f = _state_dtype(x, dt, a, b, c, *(() if init_state is None else (init_state,)))
    bb = b.repeat_interleave(h // g, dim=2).to(f)  # [B, S, H, N]
    cc = c.repeat_interleave(h // g, dim=2).to(f)
    dtf = dt.to(f)
    decay = torch.exp(a.to(f)[None, None, :] * dtf)  # [B, S, H]
    state = (torch.zeros((bsz, h, p, n), dtype=f, device=x.device)
             if init_state is None else init_state.to(f))
    ys = []
    for t in range(s):
        dx = dtf[:, t, :, None] * x[:, t].to(f)  # [B, H, P]
        state = state * decay[:, t, :, None, None] + dx[..., :, None] * bb[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cc[:, t]))
    return torch.stack(ys, 1).to(x.dtype), state


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, *, init_state: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 wkv, one step at a time: ``out_t = r_t · (S_{t-1} + u ∘ k_t
    v_tᵀ)``, ``S_t = diag(w_t)·S_{t-1} + k_t v_tᵀ``.

    ``r, k, w [B, S, H, K]`` (``w`` the decay in (0, 1)), ``v [B, S, H, V]``,
    ``u [H, K]``, ``init_state [B, H, K, V]``.  No floor on the decay (the
    chunked forms floor ``log w``).  The state is f32 (f64 where an input is
    f64); returns ``(out`` in ``v``'s dtype``, S_T)``.
    """
    bsz, s, h, kd = r.shape
    vd = v.shape[-1]
    f = _state_dtype(r, k, v, w, u, *(() if init_state is None else (init_state,)))
    state = (torch.zeros((bsz, h, kd, vd), dtype=f, device=r.device)
             if init_state is None else init_state.to(f))
    uf = u.to(f)[None, :, :, None]
    outs = []
    for t in range(s):
        kv = k[:, t].to(f)[..., :, None] * v[:, t].to(f)[..., None, :]  # [B, H, K, V]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t].to(f), state + uf * kv))
        state = state * w[:, t].to(f)[..., :, None] + kv
    return torch.stack(outs, 1).to(v.dtype), state
