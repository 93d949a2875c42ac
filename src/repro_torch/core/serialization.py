"""Wire dtypes of the shuffle (``repro/core/serialization.py``; the codec and
the narrowed value formats come with the wire-format slice)."""
from __future__ import annotations

import torch


def narrowest_int_dtype(key_range: int) -> torch.dtype:
    """Smallest integer dtype that can index ``key_range`` dense keys."""
    if key_range <= (1 << 7):
        return torch.int8
    if key_range <= (1 << 15):
        return torch.int16
    if key_range <= (1 << 31):
        return torch.int32
    return torch.int64
