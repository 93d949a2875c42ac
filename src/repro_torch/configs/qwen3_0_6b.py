"""qwen3-0.6b — dense GQA with qk-norm [hf:Qwen/Qwen3-0.6B].

28L, d_model=1024, 16 heads (GQA kv=8, d_head=128), d_ff=3072, vocab=151936.
"""
from repro_torch.configs.base import ATTN, ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen3-0.6b",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_head=128,
        d_ff=3072,
        vocab=151936,
        stage_pattern=(ATTN,),
        n_stages=28,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        supports_long_context=False,
    )
)
