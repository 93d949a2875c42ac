"""The port's serialization (``repro_torch.core.serialization``) against the
JAX package's: the host-side byte format (varint, tag-free pairs, the
Protobuf-style encoding and the paper's 2-byte-vs-4-byte claim), mirroring
``tests/test_serialization.py``, and the device formats on the same numpy
arrays.

Tolerances: the byte formats are exact.  ``quantize`` / ``dequantize`` /
``wire_bytes`` are bit-equal to JAX's (the same f32 operations, elementwise,
rounding half to even).  ``quantize_with_feedback``'s telescoping holds
within ``rtol=1e-4, atol=1e-4`` over 10 rounds (f32 sums of ten terms), as
in ``tests/test_program.py``.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import serialization as JS
from repro_torch.core.serialization import (
    Quantized,
    blaze_decode_pairs,
    blaze_encode_pairs,
    dequantize,
    message_sizes,
    protobuf_encode_pairs,
    quantize,
    quantize_with_feedback,
    varint_decode,
    varint_encode,
)

try:
    import hypothesis  # noqa: F401
except ImportError as e:
    if os.environ.get("REQUIRE_HYPOTHESIS"):
        raise ImportError(
            "REQUIRE_HYPOTHESIS is set but hypothesis failed to import"
        ) from e
    pytest.skip("hypothesis not installed", allow_module_level=True)
from hypothesis import given, settings, strategies as st

I64 = st.integers(min_value=-(2**63), max_value=2**63 - 1)


# -- the host byte format (mirrors tests/test_serialization.py) ---------------


@settings(max_examples=200, deadline=None)
@given(I64)
def test_varint_roundtrip_any_int64(v):
    buf = varint_encode(v)
    got, pos = varint_decode(buf, 0)
    assert got == v and pos == len(buf)
    assert buf == JS.varint_encode(v)


@settings(max_examples=100, deadline=None)
@given(st.lists(I64, min_size=1, max_size=50))
def test_varint_stream_roundtrip(vs):
    """Concatenated varints decode back in order with no framing bytes."""
    buf = b"".join(varint_encode(v) for v in vs)
    pos, got = 0, []
    for _ in vs:
        v, pos = varint_decode(buf, pos)
        got.append(v)
    assert got == vs and pos == len(buf)


def test_varint_length_brackets():
    for v, want in [(0, 1), (127, 1), (128, 2), (16383, 2), (16384, 3),
                    (2**63 - 1, 9)]:
        assert len(varint_encode(v)) == want, v
    assert len(varint_encode(-1)) == 10  # negatives take the full 10 bytes


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(I64, I64), min_size=0, max_size=40))
def test_blaze_pairs_roundtrip(pairs):
    keys = np.asarray([p[0] for p in pairs], np.int64)
    vals = np.asarray([p[1] for p in pairs], np.int64)
    buf = blaze_encode_pairs(keys, vals)
    assert buf == JS.blaze_encode_pairs(keys, vals)
    k2, v2 = blaze_decode_pairs(buf, len(pairs))
    np.testing.assert_array_equal(k2, keys)
    np.testing.assert_array_equal(v2, vals)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(I64, I64), min_size=0, max_size=40))
def test_message_sizes_match_real_encoders(pairs):
    keys = np.asarray([p[0] for p in pairs], np.int64)
    vals = np.asarray([p[1] for p in pairs], np.int64)
    sizes = message_sizes(keys, vals)
    assert sizes == JS.message_sizes(keys, vals)
    assert sizes["blaze_bytes"] == len(blaze_encode_pairs(keys, vals))
    assert sizes["protobuf_bytes"] == len(protobuf_encode_pairs(keys, vals))
    assert protobuf_encode_pairs(keys, vals) == JS.protobuf_encode_pairs(keys, vals)


def test_small_int_pair_is_2_bytes_vs_protobufs_4():
    """The paper's headline: a small (int, int) pair takes 2 bytes tag-free
    against Protobuf's 4."""
    keys = np.arange(128, dtype=np.int64)
    vals = np.ones(128, dtype=np.int64)
    sizes = message_sizes(keys, vals)
    assert sizes["blaze_bytes"] == 2 * len(keys)
    assert sizes["protobuf_bytes"] == 4 * len(keys)
    assert len(blaze_encode_pairs(keys, vals)) == 2 * len(keys)
    assert len(protobuf_encode_pairs(keys, vals)) == 4 * len(keys)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(I64, I64), min_size=1, max_size=40))
def test_tag_free_always_two_bytes_per_pair_smaller(pairs):
    keys = np.asarray([p[0] for p in pairs], np.int64)
    vals = np.asarray([p[1] for p in pairs], np.int64)
    sizes = message_sizes(keys, vals)
    assert sizes["protobuf_bytes"] - sizes["blaze_bytes"] == 2 * len(pairs)


# -- the device formats, bit-equal to JAX's --------------------------------------


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return [
        rng.randn(300).astype(np.float32),
        (rng.randn(7, 33) * 1e3).astype(np.float32),  # a partial last block
        np.zeros(256, np.float32),  # all-zero block: scale floors at tiny
        np.concatenate([rng.randn(256) * 1e-30, rng.randn(200) * 5.0]).astype(np.float32),
        np.full(5, 127.5, np.float32),  # exact ties round half to even
    ]


@pytest.mark.parametrize("mode", ("none", "bf16", "int8"))
@pytest.mark.parametrize("block", (256, 64))
def test_quantize_bit_equal_to_jax(mode, block):
    for x in _arrays(0):
        q = quantize(torch.from_numpy(x), mode, block)
        jq = JS.quantize(jnp.asarray(x), mode, block)
        assert q.mode == jq.mode == mode
        assert q.wire_bytes() == jq.wire_bytes()
        got = q.payload.float().numpy() if mode == "bf16" else q.payload.numpy()
        np.testing.assert_array_equal(got, np.asarray(jq.payload, got.dtype))
        if mode == "int8":
            np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jq.scale))
        back = dequantize(q, torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(back, np.asarray(JS.dequantize(jq, jnp.asarray(x))))


def test_quantized_wire_bytes_counts_payload_and_scales():
    x = torch.randn(1000)
    assert quantize(x, "none").wire_bytes() == 4000
    assert quantize(x, "bf16").wire_bytes() == 2000
    # 4 blocks of 256 int8 values, plus 4 f32 scales
    assert quantize(x, "int8").wire_bytes() == 4 * 256 + 4 * 4
    q = Quantized(torch.zeros(3, dtype=torch.int8), None, "int8")
    assert q.wire_bytes() == 3


def test_quantize_with_feedback_matches_jax_and_telescopes():
    """Bit-equal to JAX round by round, and over 10 rounds Σ recovered +
    final residual == 10·x: the narrowing error is always re-injected."""
    x_np = np.random.RandomState(0).randn(300).astype(np.float32)
    x, jx = torch.from_numpy(x_np), jnp.asarray(x_np)
    residual, jres = torch.zeros_like(x), jnp.zeros_like(jx)
    total = torch.zeros_like(x)
    for _ in range(10):
        q, residual = quantize_with_feedback(x, residual, "int8")
        jq, jres = JS.quantize_with_feedback(jx, jres, "int8")
        np.testing.assert_array_equal(q.payload.numpy(), np.asarray(jq.payload))
        np.testing.assert_array_equal(residual.numpy(), np.asarray(jres))
        total = total + dequantize(q, x)
    np.testing.assert_allclose((total + residual).numpy(), 10.0 * x_np,
                               rtol=1e-4, atol=1e-4)
    step = np.abs(x_np).max() / 127.0
    assert float(residual.abs().max()) <= 2 * step


def test_quantize_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown quantization mode"):
        quantize(torch.zeros(4), "fp8")
