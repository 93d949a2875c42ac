"""Tests of the port that need a CUDA card; each skips without one.

This file imports only ``torch`` and ``repro_torch`` (no JAX), so it runs on a
machine that has the card but not the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The kernels are held against their plain PyTorch versions on the same device
tensors; integer results and min/max are exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import BlazeSession
from repro_torch.core.algorithms import pagerank
from repro_torch.data.synthetic import rmat_edges
from repro_torch.kernels import hash_combine as HK
from repro_torch.kernels.segment_reduce import segment_reduce, segment_reduce_plain


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def test_kernels_match_plain_versions_on_the_card(dev):
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(-2, 70, (5000,), generator=g, dtype=torch.int32).to(dev)
    vals = torch.randint(-8, 9, (5000, 3), generator=g).to(dev)
    for dtype in (torch.float32, torch.int32):
        for reducer in ("sum", "min", "max"):
            got = segment_reduce(ids, vals.to(dtype), 64, reducer=reducer)
            want = segment_reduce_plain(ids, vals.to(dtype), 64, reducer=reducer)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    keys = torch.where(ids < 0, HK.EMPTY_KEY, ids * 7919).to(torch.int32)
    got = HK.hash_aggregate(keys, vals.to(torch.int32), 256)
    want = HK.hash_aggregate_plain(keys, vals.to(torch.int32), 256)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    ids = torch.zeros(8, dtype=torch.int32, device=dev)
    vals = torch.ones((8, 2), device=dev)
    with pytest.raises(ValueError, match="CUDA device"):
        segment_reduce(ids.cpu(), vals, 4)
    with pytest.raises(TypeError, match="int32"):
        segment_reduce(ids.long(), vals, 4)
    with pytest.raises(TypeError, match="f32/bf16/i32"):
        HK.hash_aggregate(ids, vals.double(), 16)
    with pytest.raises(ValueError, match="contiguous"):
        segment_reduce(ids, torch.ones((2, 8), device=dev).t(), 4)


def test_empty_stream_launches_nothing(dev):
    before = segment_reduce.launches
    out = segment_reduce(torch.zeros(0, dtype=torch.int32, device=dev),
                         torch.zeros((0, 2), device=dev), 3, reducer="min")
    assert segment_reduce.launches == before
    assert torch.equal(out, torch.full((3, 2), float("inf"), device=dev))


def test_session_defaults_to_the_card_and_launches_the_kernel(dev):
    sess = BlazeSession()
    assert sess.device.type == "cuda"
    edges = rmat_edges(8, 8, seed=1)
    segment_reduce.launches = 0
    got = pagerank(edges, 256, tol=0.0, max_iters=5, engine="pallas", session=sess)
    assert segment_reduce.launches == 5 and got.compiles == 3
    want = pagerank(edges, 256, tol=0.0, max_iters=5, engine="eager",
                    session=BlazeSession(device="cpu"))
    assert float(np.abs(got.scores - want.scores).max()) <= 1e-6
