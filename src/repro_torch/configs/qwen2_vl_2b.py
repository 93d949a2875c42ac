"""qwen2-vl-2b — VLM backbone with M-RoPE [arXiv:2409.12191].

Backbone only: 28L, d_model=1536, 12 heads (GQA kv=2, d_head=128), d_ff=8960,
vocab=151936.  The vision frontend (dynamic-resolution patcher) is a STUB:
callers feed precomputed patch embeddings ``[B, S, d]`` and, for M-RoPE,
``(t, h, w)`` position triples ``[3, B, S]`` (``models.model.forward(
positions=)``).
"""
from repro_torch.configs.base import ATTN, ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen2-vl-2b",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_head=128,
        d_ff=8960,
        vocab=151936,
        stage_pattern=(ATTN,),
        n_stages=28,
        mrope_sections=(16, 24, 24),  # sums to d_head/2 = 64
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        embed_inputs=False,  # patch-embedding stub frontend
        supports_long_context=False,
    )
)
