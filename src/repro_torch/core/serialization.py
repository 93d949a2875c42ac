"""Fast serialization: the wire formats of the shuffle (``repro/core/
serialization.py``).

The paper's fast serialization strips Protobuf's per-field tags and wire
types (fields always go in a fixed order), halving small messages: an
``(int, int)`` pair takes 2 bytes instead of Protobuf's 4.  Inside one
process there is no byte stream to shorten; what a collective moves is an
element type times an element count.  So this module is two things, as in
the JAX package:

1. **The device formats** used by ``distributed.collectives`` and the
   MapReduce shuffle: dense keys cost no bytes on the wire (the accumulator
   index is the key); explicit keys narrow to the smallest integer type of
   their range; values narrow from f32 to bf16, or to int8 with a per-block
   scale, with error-feedback residuals so iterative jobs stay unbiased.
2. **A host-side reference** of the paper's byte format (varint, tag-free,
   fixed field order) beside a Protobuf-style tagged encoding, on numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ---------------------------------------------------------------------------
# 1) Device-side narrowing / quantization (the collective path)
# ---------------------------------------------------------------------------


def narrowest_int_dtype(key_range: int) -> torch.dtype:
    """Smallest integer dtype that can index ``key_range`` dense keys."""
    if key_range <= (1 << 7):
        return torch.int8
    if key_range <= (1 << 15):
        return torch.int16
    if key_range <= (1 << 31):
        return torch.int32
    return torch.int64


@dataclasses.dataclass(frozen=True)
class Quantized:
    """A value tensor narrowed for the wire, plus what is needed to undo it."""

    payload: torch.Tensor  # narrow dtype ("int8": [blocks, block])
    scale: torch.Tensor | None  # per-block f32 scales for "int8", else None
    mode: str  # "none" | "bf16" | "int8"

    def wire_bytes(self) -> int:
        n = self.payload.numel() * self.payload.element_size()
        if self.scale is not None:
            n += self.scale.numel() * self.scale.element_size()
        return n


def quantize(x: torch.Tensor, mode: str, block: int = 256) -> Quantized:
    """Narrow ``x`` for the wire. ``mode`` in {"none", "bf16", "int8"}.

    ``"int8"``: ``x`` flattened and zero-padded to whole blocks of
    ``block``; each block's scale is its largest magnitude over 127 (at
    least the dtype's smallest normal), and each element rounds half to
    even onto the lattice, clipped to ±127.
    """
    if mode == "none":
        return Quantized(x, None, "none")
    if mode == "bf16":
        return Quantized(x.to(torch.bfloat16), None, "bf16")
    if mode == "int8":
        flat = x.reshape(-1)
        pad = (-flat.shape[0]) % block
        flat = torch.nn.functional.pad(flat, (0, pad))
        blocks = flat.reshape(-1, block)
        scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
        scale = torch.clamp(scale, min=torch.finfo(x.dtype).tiny)
        q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
        return Quantized(q, scale.to(torch.float32), "int8")
    raise ValueError(f"unknown quantization mode {mode!r}")


def dequantize(q: Quantized, like: torch.Tensor) -> torch.Tensor:
    """Undo :func:`quantize`: ``like``'s shape and dtype."""
    if q.mode == "none":
        return q.payload
    if q.mode == "bf16":
        return q.payload.to(like.dtype)
    blocks = q.payload.to(torch.float32) * q.scale
    flat = blocks.reshape(-1)[: like.numel()]
    return flat.reshape(like.shape).to(like.dtype)


def quantize_with_feedback(x: torch.Tensor, residual: torch.Tensor, mode: str,
                           block: int = 256) -> tuple[Quantized, torch.Tensor]:
    """Quantize ``x + residual``; return (wire payload, new residual).

    Error feedback keeps iterative reductions (PageRank's power iteration,
    gradient descent) unbiased: what this round's narrowing dropped is
    added back next round instead of being lost.
    """
    target = x + residual
    q = quantize(target, mode, block)
    return q, target - dequantize(q, target)


# ---------------------------------------------------------------------------
# 2) Host-side reference of the paper's byte format
# ---------------------------------------------------------------------------


def _varint_len(v: int) -> int:
    v = int(v)
    if v < 0:
        return 10  # protobuf semantics: negatives take the full 10 bytes
    n = 1
    while v >= 0x80:
        v >>= 7
        n += 1
    return n


def varint_encode(v: int) -> bytes:
    """LEB128 varint (shared by both formats below)."""
    v = int(v)
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def varint_decode(buf: bytes, pos: int) -> tuple[int, int]:
    shift, result = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            if result >= 1 << 63:
                result -= 1 << 64
            return result, pos
        shift += 7


def blaze_encode_pairs(keys: np.ndarray, vals: np.ndarray) -> bytes:
    """The paper's format: varints in fixed field order, no tags."""
    out = bytearray()
    for k, v in zip(keys.tolist(), vals.tolist()):
        out += varint_encode(k)
        out += varint_encode(v)
    return bytes(out)


def blaze_decode_pairs(buf: bytes, n: int) -> tuple[np.ndarray, np.ndarray]:
    keys, vals, pos = np.empty(n, np.int64), np.empty(n, np.int64), 0
    for i in range(n):
        keys[i], pos = varint_decode(buf, pos)
        vals[i], pos = varint_decode(buf, pos)
    return keys, vals


def protobuf_encode_pairs(keys: np.ndarray, vals: np.ndarray) -> bytes:
    """Protobuf-style encoding: each field after a (tag, wire-type) byte."""
    out = bytearray()
    for k, v in zip(keys.tolist(), vals.tolist()):
        out.append((1 << 3) | 0)  # field 1, varint
        out += varint_encode(k)
        out.append((2 << 3) | 0)  # field 2, varint
        out += varint_encode(v)
    return bytes(out)


def message_sizes(keys: np.ndarray, vals: np.ndarray) -> dict[str, int]:
    """Byte counts of both formats (the paper's §2.3.2 comparison)."""
    blaze = sum(_varint_len(k) + _varint_len(v) for k, v in zip(keys, vals))
    proto = blaze + 2 * len(keys)  # one tag byte per field, two fields a pair
    return {"blaze_bytes": int(blaze), "protobuf_bytes": int(proto)}
