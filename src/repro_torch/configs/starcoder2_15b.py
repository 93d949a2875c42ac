"""starcoder2-15b — dense, GQA kv=4, RoPE [arXiv:2402.19173].

40L, d_model=6144, 48 heads (d_head=128), d_ff=24576, vocab=49152.
"""
from repro_torch.configs.base import ATTN, ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="starcoder2-15b",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        d_head=128,
        d_ff=24576,
        vocab=49152,
        stage_pattern=(ATTN,),
        n_stages=40,
        rope_theta=100_000.0,
        supports_long_context=False,
    )
)
