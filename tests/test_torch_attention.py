"""The port's attention (``kernels.ref.attention_ref`` and ``kernels.ops.
attention``) against the JAX package's, on the same numpy inputs.

JAX's Pallas flash-attention kernel runs in interpret mode on the CPU, as its
own tests run it; the port's entry points take their plain PyTorch version
on CPU tensors (``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the
CUDA kernel against it on the card).

Tolerances: f32 within ``atol=3e-5``, as the JAX package's kernel tests
(both sides compute the logits and the weighted sum in f32, in other
orders).  bf16 inputs: every version upcasts to f32 and rounds the output
to bf16 once, so two of them may differ by one bf16 step of the output,
``2^-8·|out|``, plus the f32 term.  JAX's chunked path also rounds the
probabilities to bf16 before the ``p·v`` product (relative ``2^-9`` of each
weight), which moves the output by up to ``2^-9·max|v|`` more.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as JR
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import attention_ref

ATTN_CASES = [
    # B, Hq, Hkv, Sq, Skv, D, causal, window, softcap
    (2, 4, 2, 64, 64, 32, True, None, 0.0),
    (1, 8, 8, 128, 128, 64, True, None, 0.0),
    (2, 4, 4, 96, 96, 32, True, 32, 0.0),
    (1, 4, 2, 64, 64, 32, False, None, 0.0),
    (1, 4, 2, 64, 64, 32, True, None, 20.0),
    (2, 8, 2, 1, 256, 64, True, None, 0.0),  # decode
    (1, 4, 4, 7, 133, 32, True, None, 0.0),  # ragged
    (1, 2, 1, 33, 65, 16, True, 16, 5.0),  # window + softcap + ragged
]
F32_ATOL = 3e-5
BF16_STEP = 2.0 ** -8


def _qkv(case, seed=0):
    b, hq, hkv, sq, skv, d = case[:6]
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(*shape) * 0.5).astype(np.float32)
                 for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


def _port(q, k, v, dtype=torch.float32, **kw):
    """The port's ref and ops entry point (both impls on the CPU) and the
    kernel's wrapper; all must agree exactly on the CPU."""
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    outs = [attention_ref(*t, **kw), ops.attention(*t, impl="auto", **kw),
            ops.attention(*t, impl="pallas", **kw), flash_attention(*t, **kw)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert outs[0].dtype == dtype
    return outs[0].float().numpy()


def _jax(q, k, v, dtype=jnp.float32):
    return tuple(jnp.asarray(x).astype(dtype) for x in (q, k, v))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_matches_jax_flash_interpret(case):
    causal, window, cap = case[6:]
    q, k, v = _qkv(case)
    want = jflash(*_jax(q, k, v), causal=causal, window=window, softcap=cap,
                  block_q=32, block_k=32)
    got = _port(q, k, v, causal=causal, window=window, softcap=cap)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_matches_jax_chunked(case):
    causal, window, cap = case[6:]
    q, k, v = _qkv(case, seed=1)
    want = jops.attention_chunked(*_jax(q, k, v), causal=causal, window=window,
                                  softcap=cap, block_q=32, block_k=32)
    got = _port(q, k, v, causal=causal, window=window, softcap=cap)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("case", [ATTN_CASES[0], ATTN_CASES[5], ATTN_CASES[7]])
def test_attention_bf16_matches_jax(case):
    causal, window, cap = case[6:]
    q, k, v = _qkv(case, seed=2)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = _port(q, k, v, dtype=torch.bfloat16, **kw)
    jq = _jax(q, k, v, jnp.bfloat16)
    flash = np.asarray(jflash(*jq, block_q=32, block_k=32, **kw), np.float32)
    np.testing.assert_allclose(got, flash, rtol=BF16_STEP, atol=F32_ATOL)
    chunked = np.asarray(jops.attention_chunked(*jq, block_q=32, block_k=32, **kw),
                         np.float32)
    vmax = float(np.abs(np.asarray(jq[2], np.float32)).max())
    np.testing.assert_allclose(got, chunked, rtol=BF16_STEP,
                               atol=F32_ATOL + 2.0 ** -9 * vmax)


# Integer q_offset, as the serving path passes it: prefill into the front of
# a cache whose later rows hold garbage, decode at a position, a window
# read through an offset, and rows with no live key.
OFFSET_CASES = [
    # B, Hq, Hkv, Sq, Skv, D, q_offset, window, softcap
    (2, 4, 2, 8, 20, 16, 0, None, 0.0),    # prefill into a 20-row cache
    (2, 4, 2, 1, 20, 16, 13, None, 0.0),   # decode at position 13
    (1, 4, 1, 3, 40, 32, 10, 4, 0.0),      # window 4 at positions 10-12
    (1, 2, 2, 5, 24, 16, 17, 6, 5.0),      # window + softcap + offset
    (1, 2, 1, 4, 16, 16, -2, None, 0.0),   # rows 0-1 see no key: zeros
]


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_attention_q_offset_matches_jax(case):
    off, window, cap = case[6:]
    q, k, v = _qkv(case[:6] + (True, window, cap), seed=3)
    kw = dict(causal=True, window=window, softcap=cap)
    got = _port(q, k, v, q_offset=off, **kw)
    ref = JR.attention_ref(*_jax(q, k, v), q_offset=off, **kw)
    np.testing.assert_allclose(got, np.asarray(ref), atol=F32_ATOL, rtol=0)
    # JAX's chunked path (like its TPU kernel) leaves a row with no live key
    # at the mean of the values it masked: compare the other rows.
    live = max(0, -off)
    chunked = jops.attention_chunked(*_jax(q, k, v), q_offset=off, block_q=32,
                                     block_k=32, **kw)
    np.testing.assert_allclose(got[:, :, live:], np.asarray(chunked)[:, :, live:],
                               atol=F32_ATOL, rtol=0)
    if off >= 0:  # JAX's Pallas kernel takes the offset as a static int
        flash = jflash(*_jax(q, k, v), q_offset=off, block_q=32, block_k=32, **kw)
        np.testing.assert_allclose(got, np.asarray(flash), atol=F32_ATOL, rtol=0)
    assert not got[:, :, :live].any()


def test_attention_reads_cache_views_in_place():
    """k/v as ``[B, S, H, D]`` caches seen through ``.transpose(1, 2)`` and a
    row slice (the local layers' fast path): the same result as contiguous
    copies."""
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(2, 1, 4, 16).astype(np.float32)).transpose(1, 2)
    ck = torch.from_numpy(rng.randn(2, 30, 2, 16).astype(np.float32))
    cv = torch.from_numpy(rng.randn(2, 30, 2, 16).astype(np.float32))
    k, v = ck[:, 5:25].transpose(1, 2), cv[:, 5:25].transpose(1, 2)
    assert not k.is_contiguous()
    got = ops.attention(q, k, v, window=8, q_offset=17)
    want = attention_ref(q.contiguous(), k.contiguous(), v.contiguous(), window=8,
                         q_offset=17)
    assert torch.equal(got, want)


def test_attention_refuses_bad_arguments():
    q = torch.zeros(1, 4, 2, 16)
    k = torch.zeros(1, 3, 2, 16)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention(q, k, k)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=-1)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.attention(q, q, q, impl="chunked")
