"""grok-1-314b — MoE, 8 experts top-2 [hf:xai-org/grok-1].

64L, d_model=6144, 48 heads (GQA kv=8, d_head=128), expert d_ff=32768,
vocab=131072.  Full attention ⇒ long_500k skipped (decode KV grows with the context).
"""
from repro_torch.configs.base import ATTN_MOE, ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="grok-1-314b",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        d_ff=32768,
        vocab=131072,
        stage_pattern=(ATTN_MOE,),
        n_stages=64,
        n_experts=8,
        top_k=2,
        supports_long_context=False,
    )
)
