"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

Backbone only: 48L, d_model=1536, 24 heads (MHA, d_head=64), d_ff=6144,
vocab=2048.  The EnCodec/codebook frontend is a STUB: callers feed precomputed frame
embeddings ``[B, S, d]`` to ``models.model.prefill``/``decode_step``.
"""
from repro_torch.configs.base import ATTN, ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="musicgen-medium",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_head=64,
        d_ff=6144,
        vocab=2048,
        stage_pattern=(ATTN,),
        n_stages=48,
        embed_inputs=False,  # frame-embedding stub frontend
        supports_long_context=False,
    )
)
