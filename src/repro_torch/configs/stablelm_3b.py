"""stablelm-3b — dense MHA [hf:stabilityai/stablelm-2-1_6b family].

32L, d_model=2560, 32 heads (kv=32, d_head=80), d_ff=6912, vocab=50304.
"""
from repro_torch.configs.base import ATTN, ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="stablelm-3b",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_head=80,
        d_ff=6912,
        vocab=50304,
        stage_pattern=(ATTN,),
        n_stages=32,
        supports_long_context=False,
    )
)
