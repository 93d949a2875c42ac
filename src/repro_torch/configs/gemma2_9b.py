"""gemma2-9b — local+global alternating attention, logit softcaps
[arXiv:2408.00118].

42L, d_model=3584, 16 heads (GQA kv=8, d_head=256), d_ff=14336, vocab=256000.
Stage = (local SWA-4096 layer, global layer) × 21.  Global layers are full
attention ⇒ long_500k skipped.
"""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="gemma2-9b",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        d_head=256,
        d_ff=14336,
        vocab=256000,
        stage_pattern=(ATTN_LOCAL, ATTN),
        n_stages=21,
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        tie_embeddings=True,
        supports_long_context=False,
    )
)
