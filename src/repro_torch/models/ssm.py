"""Mamba-2 block (zamba2's SSM component; the port of ``repro/models/ssm.py``).

in_proj → split (z gate | xBC | dt) → causal depthwise conv on xBC → SSD
(``kernels.ops.ssd``) → gated RMSNorm → out_proj.

Decode carries a ``MambaCache``: the conv tail (the last ``conv_width − 1``
xBC rows) and the SSD state ``[B, H, P, N]`` f32.  The port writes both in
place (JAX returns an updated copy): the conv tail is copied over, and the
SSD kernel writes its final state into the cache's own buffer.  Sharded
(``DTensor`` inputs), the SSD runs with its heads over model
(``ops.ssd``) and each rank writes its shards of the cache.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rmsnorm, rmsnorm_init


class MambaCache(NamedTuple):
    conv: torch.Tensor  # [B, conv_width-1, conv_dim] in the compute dtype
    h: torch.Tensor  # [B, H, P, N] f32


def _dims(cfg: ArchConfig) -> tuple[int, int, int]:
    """``(d_inner, SSM heads, conv_dim)``."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def mamba_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d = cfg.d_model
    d_inner, h, conv_dim = _dims(cfg)
    dev = gen.device
    d_proj = 2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + h
    conv_w = torch.randn((cfg.conv_width, conv_dim), generator=gen, device=dev)
    return {
        "in_proj": dense_init(gen, d, d_proj, cfg.pdtype),
        "conv_w": (conv_w * (1.0 / cfg.conv_width) ** 0.5).to(cfg.pdtype),
        "conv_b": torch.zeros((conv_dim,), dtype=cfg.pdtype, device=dev),
        # A = −exp(a_log) ∈ [−16, −1]
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=dev)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm": rmsnorm_init(d_inner, cfg.pdtype, dev),
        "out_proj": dense_init(gen, d_inner, d, cfg.pdtype),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along S, as the reference's shifted sum in
    ``xbc``'s dtype (not ``F.conv1d``: cuDNN would take f32 in TF32 and sum
    in another order).  Returns ``(silu(out + b) [B, S, C], new tail)``."""
    cw, s = w.shape[0], xbc.shape[1]
    hist = (torch.zeros((xbc.shape[0], cw - 1, xbc.shape[2]), dtype=xbc.dtype,
                        device=xbc.device)
            if tail is None else tail.to(xbc.dtype))
    full = torch.cat([hist, xbc], dim=1)  # [B, S+cw-1, C]
    out = full[:, 0:s] * w[0][None, None, :]
    for j in range(1, cw):  # out[t] = Σ_j w[j]·full[t+j]
        out = out + full[:, j:j + s] * w[j][None, None, :]
    return F.silu(out + b[None, None, :]), full[:, full.shape[1] - (cw - 1):]


def mamba_apply(params: dict, cfg: ArchConfig, x: torch.Tensor, *,
                cache: MambaCache | None = None, scan_impl: str = "auto"
                ) -> tuple[torch.Tensor, MambaCache | None]:
    """``x [B, S, d]`` → ``([B, S, d], cache)``; with a cache, the inputs
    continue its sequence and the cache is updated in place.

    ``scan_impl`` goes to ``ops.ssd`` and defaults to ``"auto"`` (the K5
    kernel on a CUDA tensor).  This is where the port differs on purpose
    from the reference, which pins ``impl="chunked"`` and so never reaches
    its own kernel: here K5 serves every Mamba-2 layer, in prefill and in
    every decode step.
    """
    b, s, _ = x.shape
    d_inner, h, conv_dim = _dims(cfg)
    g, n, p = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim

    proj = x @ params["in_proj"]  # [B, S, d_proj]
    z, xbc, dt = torch.split(proj, [d_inner, conv_dim, h], dim=-1)
    xbc, new_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 cache.conv if cache is not None else None)
    # Views of the conv output: the kernel reads them through their strides.
    xs, bmat, cmat = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    xs = SH.split_heads(xs, h, p)
    bmat = SH.split_heads(bmat, g, n)
    cmat = SH.split_heads(cmat, g, n)
    dt = F.softplus(dt.float() + params["dt_bias"])  # [B, S, H]
    a = -torch.exp(params["a_log"])  # [H]

    state = cache.h if cache is not None else None
    y, _ = ops.ssd(xs, dt, a, bmat, cmat, init_state=state, out_state=state,
                   impl=scan_impl)  # [B, S, H, P]
    y = y + params["d_skip"][None, None, :, None] * xs
    y = SH.merge_last(y, 2)  # [B, S, d_inner]
    y = rmsnorm(params["norm"], y) * F.silu(z)
    # The reference's f32 y times the bf16 weight is an f32 product.
    out = (y @ params["out_proj"].to(y.dtype)).to(x.dtype)
    if cache is not None:
        SH.write_into(cache.conv, new_tail)
    return out, cache


def make_mamba_cache(cfg: ArchConfig, batch: int, device) -> MambaCache:
    _, h, conv_dim = _dims(cfg)
    return MambaCache(
        conv=torch.zeros((batch, cfg.conv_width - 1, conv_dim), dtype=cfg.cdtype,
                         device=device),
        h=torch.zeros((batch, h, cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32,
                      device=device),
    )
