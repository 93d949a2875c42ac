"""mixtral-8x22b — MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

56L, d_model=6144, 48 heads (GQA kv=8, d_head=128), expert d_ff=16384,
vocab=32768, window=4096.  SWA ⇒ decode KV is O(window): runs long_500k.
"""
from repro_torch.configs.base import ATTN_LOCAL_MOE, ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="mixtral-8x22b",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        d_ff=16384,
        vocab=32768,
        stage_pattern=(ATTN_LOCAL_MOE,),
        n_stages=56,
        window=4096,
        n_experts=8,
        top_k=2,
        supports_long_context=True,
        notes="SWA bounds the decode KV cache to the window",
    )
)
