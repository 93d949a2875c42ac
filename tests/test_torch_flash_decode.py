"""K4's bf16 forms on the CPU: the split-KV decode's arithmetic
(``flash_decode_plain``: partials per key split, then the merge), the split
count and the form dispatch, and the tolerance the card checks hold the
tensor-core forms to.

The plain split decode is held against ``attention_ref`` and against JAX's
Pallas kernel in interpret mode (as the JAX package's own tests run it), in
f32 within ``atol=3e-5`` as ``tests/test_torch_attention.py``: every version
computes the logits and the weighted sums in f32, in other orders.  The
CUDA kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels.flash_attention import (
    decode_splits,
    flash_decode_plain,
    form,
    key_tiles,
)
from repro_torch.kernels.ref import attention_ref

F32_ATOL = 3e-5

# B, Hq, Hkv, Sq, Skv, D, q_offset, window, softcap, splits
DECODE_CASES = [
    (2, 4, 4, 1, 64, 32, 0, None, 0.0, 1),       # rep 1, offset 0: one live key
    (1, 4, 2, 1, 120, 32, 77, None, 0.0, 2),     # rep 2, offset 77
    (1, 8, 2, 1, 560, 32, 543, None, 0.0, 3),    # rep 4, 9 tiles in 3 splits
    (1, 8, 1, 2, 560, 16, 543, None, 5.0, 4),    # rep 8 × 2 positions = 16 rows
    (1, 2, 2, 16, 700, 32, 600, 40, 0.0, 2),     # window: later rows see no key of split 0
    (1, 4, 2, 1, 100, 32, 77, None, 0.0, 8),     # more splits than tiles
    (1, 4, 1, 1, 600, 32, 543, 200, 0.0, 1),     # one split over a window's tiles
    (1, 2, 2, 5, 16, 8, -2, None, 0.0, 1),       # rows 0-1 see no key: zeros
]


def _qkv(case, seed=0, dtype=torch.float32):
    b, hq, hkv, sq, skv, d = case[:6]
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32)).to(dtype)
                 for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


@pytest.mark.parametrize("case", DECODE_CASES)
def test_split_decode_matches_attention_ref_and_jax(case):
    off, window, cap, splits = case[6:]
    q, k, v = _qkv(case)
    kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
    got = flash_decode_plain(q, k, v, splits=splits, **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = attention_ref(q, k, v, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL, rtol=0)
    if off >= 0:  # JAX's Pallas kernel takes the offset as a static int
        flash = jflash(*(jnp.asarray(x.numpy()) for x in (q, k, v)), block_q=32,
                       block_k=32, interpret=True, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(flash), atol=F32_ATOL, rtol=0)
    else:
        assert not got[:, :, :-off].any()  # no live key: zeros, not NaN


def test_split_decode_window_empties_the_first_split_for_later_rows():
    # DECODE_CASES[4]: rows at 600..615, window 40, tiles 8 and 9 in two
    # splits; row 15 sees keys 576..615, all in tile 9, so its partials of
    # split 0 are empty and must weigh nothing.
    case = DECODE_CASES[4]
    sq, skv, off, window = case[3], case[4], case[6], case[7]
    assert key_tiles(sq, skv, off, True, window) == (8, 10)
    q, k, v = _qkv(case, seed=7)
    kw = dict(causal=True, window=window, q_offset=off)
    got = flash_decode_plain(q, k, v, splits=2, **kw)
    want = attention_ref(q[:, :, 15:], k[:, :, 576:], v[:, :, 576:], causal=True,
                         window=window, q_offset=off + 15 - 576)
    np.testing.assert_allclose(got[:, :, 15:].numpy(), want.numpy(), atol=F32_ATOL, rtol=0)


def test_split_counts_at_the_paths_decode_shapes():
    # qwen3-0.6b: B 8, 8 kv-heads, one query at 543 over 545 cached rows.
    assert key_tiles(1, 545, 543, True, None) == (0, 9)
    assert decode_splits(8, 8, 9, 132) == (5, 2)
    # zamba2-7b: B 8, 32 kv-heads (MHA), the same cache length.
    assert decode_splits(8, 32, 9, 132) == (2, 5)
    # gemma2-9b local: B 1, 8 kv-heads, window 1024 at offset 2047.
    assert key_tiles(1, 2048, 2047, True, 1024) == (16, 32)
    assert decode_splits(1, 8, 16, 132) == (16, 1)
    assert decode_splits(2, 2, 0, 132) == (1, 1)  # no live key: one empty split


@pytest.mark.parametrize("shape, hkv, dtype, want", [
    ((8, 16, 512, 128), 8, torch.bfloat16, "bf16-prefill"),  # qwen3 prefill
    ((8, 16, 1, 128), 8, torch.bfloat16, "bf16-decode"),     # qwen3 decode: 2 rows
    ((8, 32, 1, 112), 32, torch.bfloat16, "bf16-decode"),    # zamba2 decode: 1 row
    ((1, 16, 2, 64), 2, torch.bfloat16, "bf16-decode"),      # rep 8 × 2 = 16 rows
    ((1, 16, 3, 64), 2, torch.bfloat16, "bf16-prefill"),     # 24 rows
    ((8, 16, 1, 128), 8, torch.float32, "f32"),
])
def test_form_follows_dtype_and_packed_rows(shape, hkv, dtype, want):
    q = torch.zeros(shape, dtype=dtype)
    k = torch.zeros((shape[0], hkv, 4, shape[3]), dtype=dtype)
    assert form(q, k) == want


def _p_rounded(q, k, v, *, causal, window, softcap, q_offset):
    """``attention_ref`` in f32 with each p rounded to bf16 before ``p·v``
    while ``l`` sums the f32 p: the tensor-core forms' arithmetic."""
    rep = q.shape[1] // k.shape[1]
    kk, vv = (x.repeat_interleave(rep, 1).float() for x in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / q.shape[-1] ** 0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(q.shape[2])[:, None] + q_offset
    kpos = torch.arange(k.shape[2])[None, :]
    live = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
    if window is not None:
        live &= kpos > qpos - window
    s = s.masked_fill(~live, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True)).nan_to_num(0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), vv)
    return (out / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


@pytest.mark.parametrize("case", [
    (1, 4, 2, 64, 200, 32, 136, None, 0.0),      # prefill over a cache
    (1, 4, 2, 1, 300, 64, 250, 128, 20.0),       # decode, window and softcap
])
def test_bf16_tolerance_takes_p_rounding_and_still_bites(case):
    off, window, cap = case[6:]
    q, k, v = _qkv(case, seed=5, dtype=torch.bfloat16)
    kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
    want = attention_ref(q, k, v, **kw)
    sq, skv = q.shape[2], k.shape[2]
    qpos = torch.arange(sq)[:, None] + off
    kpos = torch.arange(skv)[None, :]
    live = kpos <= qpos
    if window is not None:
        live &= kpos > qpos - window
    tol = chip_smoke.attention_tolerance(q, k, v, want,
                                         live.sum(1)[None, None, :, None].double(), **kw)

    def inside(out):
        return bool(((out.float() - want.float()).abs() <= tol).all())

    assert inside(_p_rounded(q, k, v, **kw))
    assert inside(flash_decode_plain(q, k, v, splits=3, **kw))
    assert not inside(torch.zeros_like(want))
    seen = live.any(0).nonzero()[:, 0]
    lo = int(seen[0]) // 64 * 64 + 64
    assert not inside(attention_ref(q, k[:, :, lo:], v[:, :, lo:],
                                    **{**kw, "q_offset": off - lo}))
    hi = int(seen[-1]) // 64 * 64
    assert not inside(attention_ref(q, k[:, :, :hi], v[:, :, :hi], **kw))
