"""Architecture and shape configuration (the port's copy of
``repro/configs/base.py``).

Every architecture is an ``ArchConfig``: its repeating layer pattern is a
list of block kinds (one *stage*), repeated ``n_stages`` times and followed
by an optional tail.  ``reduced()`` derives the small same-family config the
CPU tests run.  Only the dtype properties differ from the JAX file: they
return ``torch`` dtypes.  The registry holds the reference's ten
architectures.
"""
from __future__ import annotations

import dataclasses

import torch

# Block kinds (per layer slot within a stage)
ATTN = "attn"  # global self-attention + dense MLP
ATTN_LOCAL = "attn_local"  # sliding-window self-attention + dense MLP
ATTN_MOE = "attn_moe"  # global self-attention + MoE MLP
ATTN_LOCAL_MOE = "attn_local_moe"  # SWA + MoE MLP (mixtral)
MAMBA2 = "mamba2"  # Mamba-2 SSD block
RWKV6 = "rwkv6"  # RWKV-6 time-mix + channel-mix
SHARED_ATTN = "shared_attn"  # zamba2: shared-parameter attention block


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int  # total layer slots (stages × len(stage_pattern) + tail)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    stage_pattern: tuple[str, ...]  # block kinds repeated n_stages times
    n_stages: int
    tail_pattern: tuple[str, ...] = ()  # leftover layers after the stages
    # attention options
    window: int | None = None  # sliding-window size for *_local blocks
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] | None = None  # qwen2-vl M-RoPE
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # Mamba-2
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    conv_width: int = 4
    # RWKV-6
    rwkv_head_dim: int = 64
    # embeddings / head
    tie_embeddings: bool = False
    embed_inputs: bool = True  # False: a frontend feeds [B, S, d] embeds
    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # long-context eligibility (sub-quadratic decode memory/compute)
    supports_long_context: bool = False
    notes: str = ""

    @property
    def layers_total(self) -> int:
        return self.n_stages * len(self.stage_pattern) + len(self.tail_pattern)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def has_kind(self, *kinds: str) -> bool:
        return any(k in self.stage_pattern + self.tail_pattern for k in kinds)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the JAX rule, unchanged)."""
        scale = dict(
            d_model=min(self.d_model, 64),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_head=16,
            d_ff=min(self.d_ff, 128),
            vocab=min(self.vocab, 512),
            n_stages=min(self.n_stages, 2),
            window=min(self.window, 16) if self.window else None,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            rwkv_head_dim=16,
            param_dtype="float32",
            compute_dtype="float32",
            capacity_factor=8.0 if self.n_experts else self.capacity_factor,
        )
        if scale["n_kv_heads"] > scale["n_heads"]:
            scale["n_kv_heads"] = scale["n_heads"]
        if self.mrope_sections is not None:
            scale["mrope_sections"] = (2, 3, 3)  # sums to d_head/2 = 8
        return dataclasses.replace(
            self, name=self.name + "-reduced",
            n_layers=scale["n_stages"] * len(self.stage_pattern) + len(self.tail_pattern),
            **scale,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

SHAPES: dict[str, ShapeSpec] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}



def cells(arch: ArchConfig) -> list[ShapeSpec]:
    """The shape cells this arch runs (long_500k only if sub-quadratic)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch.supports_long_context:
        out.append(LONG_500K)
    return out


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from repro_torch.configs import (  # noqa: F401
        gemma2_9b,
        grok_1_314b,
        mixtral_8x22b,
        musicgen_medium,
        qwen2_vl_2b,
        qwen3_0_6b,
        rwkv6_1_6b,
        stablelm_3b,
        starcoder2_15b,
        zamba2_7b,
    )
