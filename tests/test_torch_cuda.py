"""Tests of the port that need a CUDA card; each skips without one.

This file imports only ``torch`` and ``repro_torch`` (no JAX), so it runs on a
machine that has the card but not the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The kernels are held against their plain PyTorch versions on the same device
tensors; integer results and min/max are exact.  K3's assignments are exact
except at near ties (``near_ties``), and its sums within ``1e-5`` relative
plus ``1e-5`` of the sum of the addends' magnitudes (f32 atomics in an order
the kernel does not fix, against float64).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import BlazeSession
from repro_torch.core.algorithms import gmm_em, pagerank
from repro_torch.data.synthetic import cluster_points, rmat_edges
from repro_torch.kernels import hash_combine as HK
from repro_torch.kernels import ops
from repro_torch.kernels.kmeans_assign import (
    kmeans_assign,
    kmeans_assign_plain,
    launch_shape,
    near_ties,
)
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


def _check_kmeans(pts, ctr):
    got_a, got_s = kmeans_assign(pts, ctr)
    want_a, _ = kmeans_assign_plain(pts, ctr)
    torch.cuda.synchronize()
    decided = ~near_ties(pts, ctr)
    assert torch.equal(got_a[decided], want_a[decided])
    # Sums under the kernel's own assignment, in float64.
    x1 = torch.cat([pts, torch.ones_like(pts[:, :1])], 1).double()
    k = ctr.shape[0]
    want = torch.zeros((k, x1.shape[1]), dtype=torch.float64, device=pts.device)
    want.index_add_(0, got_a.long(), x1)
    mag = torch.zeros_like(want).index_add_(0, got_a.long(), x1.abs())
    assert bool(((got_s.double() - want).abs() <= 1e-5 * want.abs() + 1e-5 * mag).all())
    return got_a, got_s


@pytest.mark.parametrize("n,d,k,form", [
    (1000, 3, 5, "registers"), (70_001, 3, 5, "registers"),
    (3001, 4, 8, "registers"), (777, 8, 13, "shared"), (50_003, 5, 2, "shared"),
    (5000, 16, 600, "global"),
])
def test_kmeans_kernel_matches_plain_version(dev, n, d, k, form):
    """N off the tile, every form: [600, 16] needs 600·34·4 B of shared
    memory, over the 48 KiB budget, so it runs the global form."""
    g = torch.Generator().manual_seed(n)
    pts = torch.randn((n, d), generator=g).to(dev)
    ctr = torch.randn((k, d), generator=g).to(dev)
    assert launch_shape(n, d, k, dev)[0] == form
    before = kmeans_assign.launches
    _check_kmeans(pts, ctr)
    assert kmeans_assign.launches == before + 1


def test_kmeans_kernel_ties_pick_the_first_index(dev):
    ctr = torch.tensor([[0.0, 2.0], [0.5, -1.0], [0.5, -1.0]], device=dev)
    pts = torch.tensor([0.5, -1.0], device=dev) + 0.1 * torch.randn(
        (4099, 2), generator=torch.Generator().manual_seed(0)).to(dev)
    a, s = _check_kmeans(pts, ctr)
    assert bool((a == 1).all()) and float(s[1, -1]) == 4099.0


def test_kmeans_kernel_empty_input_launches_nothing(dev):
    before = kmeans_assign.launches
    a, s = kmeans_assign(torch.zeros((0, 3), device=dev), torch.ones((5, 3), device=dev))
    assert kmeans_assign.launches == before
    assert a.shape == (0,) and torch.equal(s, torch.zeros((5, 4), device=dev))
    with pytest.raises(TypeError, match="f32"):
        kmeans_assign(torch.zeros((4, 3), device=dev).double(), torch.ones((5, 3), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        kmeans_assign(torch.zeros((3, 4), device=dev).t(), torch.ones((5, 3), device=dev))


def test_ops_auto_launches_the_kernels_on_the_card(dev):
    pts = torch.randn((4096, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    before = kmeans_assign.launches
    ops.kmeans_assign(pts, pts[:5].contiguous(), impl="auto")
    assert kmeans_assign.launches == before + 1
    ids = torch.zeros(4096, dtype=torch.int32, device=dev)
    before = segment_reduce.launches
    ops.segment_reduce(ids, pts, 2, impl="auto")
    assert segment_reduce.launches == before + 1


def test_gmm_on_the_card_launches_three_segment_reduces_per_round(dev):
    pts, _ = cluster_points(3000, 2, 3, seed=1)
    segment_reduce.launches = 0
    got = gmm_em(pts, 3, init_mu=pts[:3].copy(), tol=0.0, max_iters=4,
                 engine="pallas", session=BlazeSession())
    assert segment_reduce.launches == 3 * 4 and got.compiles == 4
    want = gmm_em(pts, 3, init_mu=pts[:3].copy(), tol=0.0, max_iters=4,
                  engine="eager", session=BlazeSession(device="cpu"))
    assert abs(got.log_likelihood - want.log_likelihood) <= 1e-5 * abs(want.log_likelihood)
    np.testing.assert_allclose(got.mu, want.mu, atol=1e-4, rtol=0)
