"""zamba2-7b — hybrid Mamba-2 + shared attention [arXiv:2411.15242].

81 layer slots, d_model=3584, 32 heads (MHA), d_ff=14336, vocab=32000,
ssm_state=64.  Every 7th slot applies the SHARED attention block (one set of
parameters reused across all its applications — Zamba's signature trick);
the rest are Mamba-2 blocks.  Sub-quadratic (SSM) ⇒ runs long_500k.
"""
from repro_torch.configs.base import MAMBA2, SHARED_ATTN, ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="zamba2-7b",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_head=112,
        d_ff=14336,
        vocab=32000,
        stage_pattern=(MAMBA2,) * 6 + (SHARED_ATTN,),
        n_stages=11,  # 77 slots
        tail_pattern=(MAMBA2,) * 4,  # 81 total
        ssm_state=64,
        ssm_head_dim=64,
        ssm_groups=2,
        ssm_expand=2,
        supports_long_context=True,
        notes="shared attention params across all SHARED_ATTN applications",
    )
)
