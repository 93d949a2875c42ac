"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay [arXiv:2404.05892].

24L, d_model=2048, d_ff=7168, vocab=65536.  32 wkv heads of dim 64.
Attention-free recurrence ⇒ O(1) decode state: runs long_500k.
"""
from repro_torch.configs.base import RWKV6, ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="rwkv6-1.6b",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_head=64,
        d_ff=7168,
        vocab=65536,
        stage_pattern=(RWKV6,),
        n_stages=24,
        rwkv_head_dim=64,
        supports_long_context=True,
    )
)
