"""RWKV-6 "Finch" block: time-mix (the wkv recurrence with data-dependent
decay) and channel-mix, both with token-shift (the port of
``repro/models/rwkv.py``).

The wkv recurrence runs through ``kernels.ops.rwkv6``.  The data-dependent
parts (the ddlerp token-shift interpolators and the decay ``w``) use the
paper's low-rank adapters.  Decode carries an ``RWKVCache``: two token-shift
rows and the ``[B, H, K, V]`` f32 wkv state.  The port writes all three in
place (JAX returns updated copies): the wkv kernel writes its final state
into the cache's own buffer, and ``models.model`` copies the shift rows over.
Sharded (``DTensor`` inputs), the wkv runs with its heads over model
(``ops.rwkv6``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init

_LORA = 32  # low-rank width for the ddlerp / decay adapters
_MIX = 5  # r, k, v, w, g token-shift lanes


class RWKVCache(NamedTuple):
    shift_tm: torch.Tensor  # [B, d]   last token entering time-mix
    shift_cm: torch.Tensor  # [B, d]   last token entering channel-mix
    state: torch.Tensor  # [B, H, K, V] f32 wkv state


def rwkv_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    hk = cfg.rwkv_head_dim
    h = d // hk
    dev, pd = gen.device, cfg.pdtype
    mix_w2 = torch.randn((_MIX, _LORA, d), generator=gen, device=dev) * 0.02
    return {
        "tm": {
            "mix_base": torch.zeros((_MIX, d), dtype=pd, device=dev),
            "mix_w1": dense_init(gen, d, _MIX * _LORA, pd),
            "mix_w2": mix_w2.to(pd),
            "wr": dense_init(gen, d, d, pd),
            "wk": dense_init(gen, d, d, pd),
            "wv": dense_init(gen, d, d, pd),
            "wg": dense_init(gen, d, d, pd),
            "w0": torch.full((d,), -6.0, dtype=torch.float32, device=dev),  # slow decay
            "w_lora1": dense_init(gen, d, _LORA, pd),
            "w_lora2": dense_init(gen, _LORA, d, pd),
            "u": torch.randn((h, hk), generator=gen, device=dev) * 0.1,
            "ln_x": rmsnorm_init(d, pd, dev),
            "wo": dense_init(gen, d, d, pd),
        },
        "cm": {
            "mix_k": torch.zeros((d,), dtype=pd, device=dev),
            "mix_r": torch.zeros((d,), dtype=pd, device=dev),
            "wk": dense_init(gen, d, cfg.d_ff, pd),
            "wv": dense_init(gen, cfg.d_ff, d, pd),
            "wr": dense_init(gen, d, d, pd),
        },
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """shift(x)[t] = x[t-1]; position 0 takes ``last`` (decode) or zeros."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def time_mix(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: RWKVCache | None, *,
             scan_impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out [B, S, d], new shift row [B, d], new state)``.  With a cache the
    new state is written into ``cache.state`` in place; the shift row is
    left for the caller to store.

    ``scan_impl`` goes to ``ops.rwkv6`` and defaults to ``"auto"`` (the K6
    kernel on a CUDA tensor): the port differs here on purpose from the
    reference, which pins ``impl="chunked"`` and so never reaches its own
    kernel.
    """
    b, s, d = x.shape
    hk = cfg.rwkv_head_dim
    h = d // hk
    sx = _token_shift(x, cache.shift_tm if cache is not None else None)
    delta = sx - x

    # ddlerp: per-lane data-dependent interpolation between x and shift(x)
    base = x + delta * p["mix_base"][0][None, None]  # shared first-stage mix
    lora = SH.split_heads(torch.tanh(base @ p["mix_w1"]), _MIX, _LORA)
    dyn = torch.einsum("bsml,mld->bsmd", lora, p["mix_w2"].to(x.dtype))
    mixed = x[:, :, None] + delta[:, :, None] * (p["mix_base"][None, None] + dyn)
    xr, xk, xv, xw, xg = mixed.unbind(2)

    r = SH.split_heads(xr @ p["wr"], h, hk)
    k = SH.split_heads(xk @ p["wk"], h, hk)
    v = SH.split_heads(xv @ p["wv"], h, hk)
    g = xg @ p["wg"]
    # data-dependent decay w ∈ (0, 1): exp(−exp(w0 + lora(xw)))
    wlog = p["w0"][None, None] + torch.tanh(xw @ p["w_lora1"]) @ p["w_lora2"]
    w = SH.split_heads(torch.exp(-torch.exp(wlog.float())), h, hk)

    state = cache.state if cache is not None else None
    y, state = ops.rwkv6(r, k, v, w, p["u"], init_state=state, out_state=state,
                         impl=scan_impl)
    y = SH.merge_last(y, 2)  # [B, S, d]
    y = rmsnorm(p["ln_x"], y) * F.silu(g)
    out = (y @ p["wo"]).to(x.dtype)
    return out, x[:, -1], state


def channel_mix(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: RWKVCache | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, S, d], new shift row [B, d])``."""
    del cfg
    sx = _token_shift(x, cache.shift_cm if cache is not None else None)
    delta = sx - x
    xk = x + delta * p["mix_k"][None, None]
    xr = x + delta * p["mix_r"][None, None]
    k = torch.square(torch.relu(xk @ p["wk"]))
    kv = k @ p["wv"]
    return (torch.sigmoid(xr @ p["wr"]) * kv).to(x.dtype), x[:, -1]


def make_rwkv_cache(cfg: ArchConfig, batch: int, device) -> RWKVCache:
    d = cfg.d_model
    hk = cfg.rwkv_head_dim
    h = d // hk
    return RWKVCache(
        shift_tm=torch.zeros((batch, d), dtype=cfg.cdtype, device=device),
        shift_cm=torch.zeros((batch, d), dtype=cfg.cdtype, device=device),
        state=torch.zeros((batch, h, hk, hk), dtype=torch.float32, device=device),
    )
