"""The port's narrowed wires (``map_reduce(..., wire="bf16" | "int8")``)
against the JAX package's, on the same numpy rows, at 1 shard (in this
process) and 4 (JAX on four forced CPU devices in a subprocess, the port's
shards stacked): the stats' byte counts exactly, the values within the
wire's own rounding; and PageRank and k-means with both wires, per op and
as programs, against float64 references.

Tolerances.  Shard ``s``'s partial ``p_s`` (its rows' sum per key, in f32)
crosses the collective.  ``"int8"``: both packages put every partial on one
lattice of step ``scale = max|p| / 127`` (the largest magnitude over all
shards) and sum in int32, so they differ by at most one lattice step per
shard, ``S·scale``.  ``"bf16"``: each rounds every partial to bf16 and adds
in bf16, in its own order, so they differ by at most one bf16 rounding
(``2^-8`` relative) per partial, ``S·2^-8·Σ_s|p_s|``.  ``"none"``: the f32
sums' order, ``1e-5`` of the magnitudes.  The partials themselves are f32
sums in each package's order, so every tolerance adds ``1e-5·Σ|x|`` over
the key's rows.  The jobs: within ``2e-2`` relative of the float64
reference, the reference package's own wire tolerance
(``tests/test_mapreduce.py::test_wire_modes_close_to_exact``), except where
one int8 scale spans values of very different sizes, as in the reference.
Per op, int8 PageRank is held per page to the same shared-scale wire
computed in float64 apart from the engine
(``chip_smoke.pagerank_int8_emulation``): within one lattice step an
iteration, ``Σ_t step_t``, plus ``1e-5`` of the score for the f32 sums, and
so is JAX's, and the two packages within that of each other.  k-means'
centres with int8 in both modes are held per centre
(``chip_smoke.kmeans_int8_reach``: the counts and the inertia share a scale
with the coordinate sums).
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import BlazeSession as JaxSession
from repro.core import distribute as jdistribute
from repro.core.algorithms.pagerank import pagerank_reference
from repro.data.synthetic import cluster_points, rmat_edges
from repro_torch.core import BlazeSession
from repro_torch.core.algorithms import kmeans, pagerank
from repro_torch.distributed.collectives import (
    compressed_psum,
    psum_with_feedback,
    wire_bytes,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIRES = ("none", "bf16", "int8")
N_ROWS, K = 256, 8


def _rows():
    rows = np.random.RandomState(2).randn(N_ROWS, 4).astype(np.float32)
    rows[::7] *= 40.0  # keys of very different magnitudes
    return rows


def _tdyn(i, x, emit):
    emit(i % K, x)


def _tstatic(i, x, emit):
    emit(0, x[:2])


MAPPERS = {"dynamic": (_tdyn, (K, 4)), "static": (_tstatic, (1, 2))}

_JAX = """
import json, sys, numpy as np, jax, jax.numpy as jnp
from repro.core import BlazeSession, distribute
from repro.core.algorithms import kmeans, pagerank
from repro.data.synthetic import cluster_points, rmat_edges
assert len(jax.devices()) == 4
rows = np.asarray(json.loads(sys.argv[1]), np.float32)
def dyn(i, x, emit):
    emit(i % 8, x)
def static(i, x, emit):
    emit(0, x[:2])
out = {}
sess = BlazeSession()
v = distribute(rows, sess.mesh)
for name, m, shape in (("dynamic", dyn, (8, 4)), ("static", static, (1, 2))):
    for engine in ("eager", "pallas"):
        for wire in ("none", "bf16", "int8"):
            got, st = sess.map_reduce(v, m, "sum", jnp.zeros(shape, jnp.float32),
                                      engine=engine, wire=wire, return_stats=True)
            st = st.finalize()
            out[f"{name}/{engine}/{wire}"] = {
                "vals": np.asarray(got).tolist(), "payload": int(st.shuffle_payload_bytes),
                "intra": int(st.intra_bytes), "inter": int(st.inter_bytes),
                "shipped": int(st.pairs_shipped), "collective": st.collective}
edges = rmat_edges(8, 8, seed=5)
pts, _ = cluster_points(2000, 3, 4, seed=3)
for wire in ("bf16", "int8"):
    for mode in ("per_op", "program"):
        pr = pagerank(edges, 256, tol=0.0, max_iters=5, wire=wire, mode=mode,
                      unroll=5, session=BlazeSession())
        km = kmeans(pts, 4, init_centers=pts[:4].copy(), tol=0.0, max_iters=5,
                    wire=wire, mode=mode, unroll=5, session=BlazeSession())
        out[f"pagerank/{wire}/{mode}"] = pr.scores.tolist()
        out[f"kmeans/{wire}/{mode}"] = km.centers.tolist()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax4():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run([sys.executable, "-c", _JAX, json.dumps(_rows().tolist())],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _jax1(name, engine, wire):
    mapper_j = {
        "dynamic": (lambda i, x, emit: emit(i % K, x), (K, 4)),
        "static": (lambda i, x, emit: emit(0, x[:2]), (1, 2)),
    }[name]
    sess = JaxSession()
    got, st = sess.map_reduce(jdistribute(_rows(), sess.mesh), mapper_j[0], "sum",
                              jnp.zeros(mapper_j[1], jnp.float32), engine=engine,
                              wire=wire, return_stats=True)
    st = st.finalize()
    return {"vals": np.asarray(got), "payload": int(st.shuffle_payload_bytes),
            "intra": int(st.intra_bytes), "inter": int(st.inter_bytes),
            "shipped": int(st.pairs_shipped), "collective": st.collective}


def _partials(name, n_shards):
    """Each shard's f32 partial per key, and each key's Σ|x|, in float64."""
    rows = _rows().astype(np.float64)
    idx = np.arange(N_ROWS)
    per = N_ROWS // n_shards
    if name == "dynamic":
        parts = np.zeros((n_shards, K, 4))
        np.add.at(parts, (idx // per, idx % K), rows)
        absum = np.zeros((K, 4))
        np.add.at(absum, idx % K, np.abs(rows))
    else:
        parts = np.zeros((n_shards, 1, 2))
        np.add.at(parts, (idx // per, 0), rows[:, :2])
        absum = np.abs(rows[:, :2]).sum(0, keepdims=True)
    return parts, absum


@pytest.mark.parametrize("n_shards", (1, 4))
@pytest.mark.parametrize("name", sorted(MAPPERS))
@pytest.mark.parametrize("engine", ("eager", "pallas"))
@pytest.mark.parametrize("wire", WIRES)
def test_wire_matches_jax(jax4, n_shards, name, engine, wire):
    mapper, shape = MAPPERS[name]
    sess = BlazeSession(device="cpu", n_shards=n_shards)
    got, st = sess.map_reduce(sess.distribute(_rows()), mapper, "sum",
                              torch.zeros(shape), engine=engine, wire=wire,
                              return_stats=True)
    st = st.finalize()
    want = jax4[f"{name}/{engine}/{wire}"] if n_shards == 4 else _jax1(name, engine, wire)
    assert st.shuffle_payload_bytes == want["payload"]
    assert (st.intra_bytes, st.inter_bytes) == (want["intra"], want["inter"])
    assert st.pairs_shipped == want["shipped"]
    assert st.collective == want["collective"]
    parts, absum = _partials(name, n_shards)
    slack = 1e-5 * absum
    if wire == "int8":
        scale = np.abs(parts.astype(np.float32)).max() / 127.0
        tol = n_shards * scale * (1 + 1e-5) + slack
    elif wire == "bf16":
        tol = n_shards * 2.0 ** -8 * np.abs(parts).sum(0) + slack
    else:
        tol = 1e-5 * np.abs(parts.sum(0)) + slack
    err = np.abs(got.numpy().astype(np.float64) - np.asarray(want["vals"], np.float64))
    assert (err <= tol).all(), (wire, float(err.max()), float(tol.min()))


def test_wire_payload_bytes_scale_with_the_wire():
    """Per op, shards × elements × the wire's width (JAX counts no int8
    scale bytes in the shuffle stats)."""
    sess = BlazeSession(device="cpu", n_shards=4)
    v = sess.distribute(_rows())
    got = {}
    for wire in WIRES:
        _, st = sess.map_reduce(v, _tdyn, "sum", torch.zeros(K, 4), wire=wire,
                                return_stats=True)
        got[wire] = st.finalize().shuffle_payload_bytes
    assert got == {"none": 4 * 32 * 4, "bf16": 4 * 32 * 2, "int8": 4 * 32}


@pytest.mark.parametrize("wire", ("bf16", "int8"))
@pytest.mark.parametrize("mode", ("per_op", "program"))
@pytest.mark.parametrize("n_shards", (1, 4))
def test_pagerank_and_kmeans_with_narrow_wires(jax4, wire, mode, n_shards):
    """Within 2e-2 relative of the float64 references, as JAX's; per-op
    int8 PageRank within one lattice step an iteration of its float64
    emulation, and JAX's too; k-means with int8 within the lattice's reach
    (module docstring)."""
    edges = rmat_edges(8, 8, seed=5)
    ref = pagerank_reference(edges, 256, tol=0.0, max_iters=5).astype(np.float64)
    if wire == "int8" and mode == "per_op":
        deg = np.bincount(edges[:, 0], minlength=256).astype(np.int32)
        emu, steps = chip_smoke.pagerank_int8_emulation(
            torch.from_numpy(edges), torch.from_numpy(deg), 256, n_shards, 5)
        ref = emu.numpy()
        pr_tol = sum(steps) + 1e-5 * ref  # a step an iteration, and the f32 sums
    else:
        pr_tol = 2e-2 * ref.max()
    pr = pagerank(edges, 256, tol=0.0, max_iters=5, wire=wire, mode=mode, unroll=5,
                  session=BlazeSession(device="cpu", n_shards=n_shards))
    assert (np.abs(pr.scores - ref) <= pr_tol).all()
    if n_shards == 4:
        jscores = np.asarray(jax4[f"pagerank/{wire}/{mode}"])
        assert (np.abs(jscores - ref) <= pr_tol).all()
        if wire == "int8" and mode == "per_op":
            assert (np.abs(pr.scores - jscores) <= pr_tol).all()
    pts, _ = cluster_points(2000, 3, 4, seed=3)
    exact = kmeans(pts, 4, init_centers=pts[:4].copy(), tol=0.0, max_iters=5,
                   session=BlazeSession(device="cpu"))
    if wire == "int8":
        km_tol = chip_smoke.kmeans_int8_reach(torch.from_numpy(pts), exact.centers,
                                              n_shards, 5, mode == "program")
    else:
        km_tol = 2e-2 * np.abs(exact.centers).max()
    km = kmeans(pts, 4, init_centers=pts[:4].copy(), tol=0.0, max_iters=5, wire=wire,
                mode=mode, unroll=5, session=BlazeSession(device="cpu", n_shards=n_shards))
    assert (np.abs(km.centers - exact.centers) <= km_tol).all()
    if n_shards == 4:
        jc = np.asarray(jax4[f"kmeans/{wire}/{mode}"])
        assert (np.abs(jc - exact.centers) <= km_tol).all()


@pytest.mark.parametrize("wire", WIRES)
def test_compressed_psum_and_feedback_telescope(wire):
    """``compressed_psum`` over stacked shards, and ``psum_with_feedback``:
    over 10 rounds Σ reduced + Σ_shards final residual == 10·Σ_shards x
    (f32 sums of ten terms: rtol 1e-4, atol 1e-4).  The residual covers
    the narrowing of each shard's value; a bf16 sum also rounds each of its
    additions, which no residual sees: 10 rounds of ``S·2^-8·Σ_s|x_s|``
    more."""
    x = torch.from_numpy(np.random.RandomState(4).randn(4, 300).astype(np.float32))
    exact = x.double().sum(0)
    red = compressed_psum(x, wire=wire)
    scale = float(x.abs().max()) / 127.0
    tol = {"none": 1e-5, "bf16": 4 * 2.0 ** -8 * float(x.abs().sum(0).max()),
           "int8": 4 * scale}[wire]
    assert float((red.double() - exact).abs().max()) <= tol
    residual = torch.zeros_like(x)
    total = torch.zeros(300, dtype=torch.float64)
    for _ in range(10):
        red, residual = psum_with_feedback(x, residual, wire=wire)
        total += red.double()
    sums = 10 * 4 * 2.0 ** -8 * float(x.abs().sum(0).max()) if wire == "bf16" else 0.0
    np.testing.assert_allclose((total + residual.double().sum(0)).numpy(),
                               10.0 * exact.numpy(), rtol=1e-4, atol=1e-4 + sums)
    # The hierarchical form (2 node rows of 2 shards): each node's shards at
    # full precision, then the wire over the node partials, bit for bit.
    nodes = x.reshape(2, 2, 300).sum(1)
    assert torch.equal(compressed_psum(x, wire=wire, n_nodes=2),
                       compressed_psum(nodes, wire=wire))


def test_wire_bytes_counts_width_and_scales():
    x = torch.zeros(10, 5, dtype=torch.float32)
    assert wire_bytes(x, "none") == 200
    assert wire_bytes(torch.zeros(10, dtype=torch.float64), "none") == 80
    assert wire_bytes(x, "bf16") == 100
    assert wire_bytes(x, "int8") == 50 + 4
    assert wire_bytes(x, "int8", n_scales=3) == 50 + 12
    assert wire_bytes(np.zeros((4, 2), np.int16), "none") == 16
    with pytest.raises(ValueError, match="unknown wire"):
        wire_bytes(x, "fp8")


def test_program_int8_feedback_beats_no_feedback():
    """The residual is carried: ten iterations accumulating one int8 sum
    (the reference's form of the check, ``tests/test_program.py``) land
    closer to 10× the exact sum than the same program with its residual
    reset after every dispatch, and Σ acc + Σ_shards residual == 10× the
    exact sum within f32 rounding."""
    sess = BlazeSession(device="cpu", n_shards=4)
    rows = (np.random.RandomState(1).rand(256, 4).astype(np.float32) - 0.3) * 1e-2
    v = sess.distribute(rows)

    def step(ctx, s):
        inc = ctx.map_reduce(v, _tdyn, "sum", torch.zeros(K, 4), wire="int8")
        return {"acc": s["acc"] + inc}

    exact = np.zeros((K, 4))
    np.add.at(exact, np.arange(256) % K, rows.astype(np.float64))
    errs = {}
    for carried in (True, False):
        prog = sess.program(step)
        state = {"acc": torch.zeros(K, 4)}
        for _ in range(10):
            state = prog(state, 1)
            if not carried:
                prog.reset_carry()
        errs[carried] = np.abs(state["acc"].numpy() - 10 * exact).max()
        if carried:
            (res,) = prog.export_carry(state)["residual"]
            np.testing.assert_allclose(state["acc"].numpy() + res.sum(0).numpy(),
                                       10 * exact, rtol=1e-4, atol=1e-6)
    assert errs[True] < errs[False]
