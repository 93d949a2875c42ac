"""The port's multi-node topology against the JAX package's, mirroring
``tests/test_multihost.py`` (all but its four ``launch.simulate`` helper
tests, which have no counterpart: the port's topology needs no XLA flags)
and ``tests/test_multidevice.py`` (all but ``test_sharded_train_step_8dev``,
which waits for LM training).

The JAX side runs once, in a subprocess with eight forced CPU devices, on
``("node", "data")`` meshes of (1, 8), (2, 4) and (4, 2) (``jax8``); the
port runs here with eight shards stacked on the CPU, split into the same
node rows (``launch.mesh.make_node_data_mesh``).  Both build their inputs
from the same seeded NumPy code (``_DATA``).

Tolerances.  Integer-valued f32 sums, min and max: bit for bit, hierarchical
against flat, against the NumPy oracle and against JAX (every partial and
total is an integer below 2^24, so no order of addition rounds).  Hash
targets: dict-exact.  Float sums: ``rtol=1e-6`` against JAX where both add
the same f32 values in another order (``wire="none"``); the int8 wire
within one lattice step per addend of its last hop (``n_nodes`` addends on
the hierarchical wire, 8 on the flat one) of the scale both packages share,
``max|partial| / 127``.  Byte counts: the dense reduce's edges exactly;
the shuffles' inter-node share within one byte, because JAX forms it as an
f32 product and the port in float64.  EXPLAIN: line for line, the header's
hash and the ``cost~N`` figures masked as in ``tests/test_torch_plan.py``.
The jobs (PageRank, k-means) within the reference test's own tolerances
against their float64 references.
"""
from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.algorithms.kmeans import kmeans_reference
from repro.core.algorithms.pagerank import pagerank_reference
from repro_torch.core import BlazeSession, data_mesh
from repro_torch.core import faults as tf
from repro_torch.core.algorithms import kmeans, pagerank, wordcount
from repro_torch.distributed.collectives import (
    compressed_psum,
    psum_with_feedback,
    wire_bytes,
)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import make_node_data_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = (2, 4)  # node rows of the 8 shards

# The inputs, built alike in this process and in the JAX subprocess.
_DATA = """
import numpy as np
from repro.data.synthetic import cluster_points, rmat_edges
DATA = dict(
    ints=np.random.RandomState(0).randint(-50, 50, (64, 4)).astype(np.float32),
    floats=np.random.RandomState(1).randn(64, 8).astype(np.float32),
    prog=np.random.RandomState(2).randint(0, 100, (64, 4)).astype(np.float32),
    fault=np.random.RandomState(3).randint(0, 100, (64, 4)).astype(np.float32),
    x=np.random.RandomState(0).randn(8, 128).astype(np.float32),
    words=np.random.RandomState(0).randint(0, 100, 5000).astype(np.int32),
    words2=np.random.RandomState(0).randint(0, 100, 4000).astype(np.int32),
    edges=rmat_edges(7, 8, seed=2),
    pts=cluster_points(2000, 3, 4, seed=0)[0],
)
_rng = np.random.RandomState(0)
DATA["mvals"] = _rng.randint(0, 100, (128, 4)).astype(np.float32)
DATA["mwords"] = _rng.randint(0, 100, 4000).astype(np.int32)
"""
_ns: dict = {}
exec(_DATA, _ns)
DATA = _ns["DATA"]

_JAX = _DATA + """
import collections, json
import jax, jax.numpy as jnp
from repro.core import BlazeSession, data_mesh, distribute, faults, make_dist_hashmap
from repro.core.algorithms import kmeans, pagerank, wordcount
from repro.distributed.collectives import compressed_psum, psum_with_feedback
from repro.launch.mesh import init_distributed, make_node_data_mesh
from repro.compat import shard_map
from jax.sharding import PartitionSpec as P
assert len(jax.devices()) == 8
out = {"shapes": {}}
for n in (1, 2, 4, 8):
    m = make_node_data_mesh(n)
    out["shapes"][str(n)] = [dict(m.shape)["node"], dict(m.shape)["data"]]
try:
    make_node_data_mesh(3)
except ValueError as e:
    out["split_error"] = str(e)
out["initialized"] = init_distributed()

def _row(i, r, emit):
    emit(0, r)

def _tok(i, w, emit):
    emit(w, 1)

def np_(x):
    return np.asarray(x).tolist()

for n in (2, 4):
    mesh = make_node_data_mesh(n)
    s = BlazeSession(mesh=mesh)
    res = {}
    v = s.distribute(DATA["ints"])
    for red in ("sum", "min", "max"):
        fill = {"sum": 0.0, "min": np.inf, "max": -np.inf}[red]
        t = jnp.full((1, 4), fill, jnp.float32)
        for hier in (True, False):
            got, st = s.map_reduce(v, _row, red, t, return_stats=True, hierarchical=hier)
            st = st.finalize()
            res[f"{red}/{hier}"] = {"vals": np_(got), "coll": st.collective,
                                    "intra": int(st.intra_bytes),
                                    "inter": int(st.inter_bytes)}
    v = s.distribute(DATA["floats"])
    for hier in (True, False):
        got, st = s.map_reduce(v, _row, "sum", jnp.zeros((1, 8), jnp.float32), wire="int8",
                               return_stats=True, hierarchical=hier)
        st = st.finalize()
        res[f"int8/{hier}"] = {"vals": np_(got), "coll": st.collective,
                               "intra": int(st.intra_bytes), "inter": int(st.inter_bytes)}
    v = s.distribute(DATA["prog"])

    def step(ctx, state):
        t = ctx.map_reduce(v, _row, "sum", jnp.zeros((1, 4), jnp.float32))
        return {"acc": state["acc"] + t[0]}

    state0 = {"acc": jnp.zeros((4,), jnp.float32)}
    for hier in (True, False):
        p = s.program(step, hierarchical=hier)
        res[f"prog/{hier}"] = {"acc": np_(p(dict(state0), 3)["acc"]),
                               "explain": s.explain(p, dict(state0))}
    # collective.inter: a transient on the first inter-node hop retries
    faults.reset(env=False)
    fast = faults.RetryPolicy(attempts=3, backoff_s=0.0, multiplier=1.0, deadline_s=None)
    fs = BlazeSession(mesh=mesh, retry=fast)
    fv = fs.distribute(DATA["fault"])
    faults.configure("collective.inter", at=1)
    got = fs.map_reduce(fv, _row, "sum", jnp.zeros((1, 4), jnp.float32))
    snap = faults.snapshot()
    res["fault"] = {"vals": np_(got), "retries": fs.stats.retries,
                    "balanced": snap["balanced"],
                    "retried": snap["dispositions"]["retried"]}
    faults.reset(env=False)
    # the differential matrix: dense eager/naive, hash eager/pallas
    v = s.distribute(DATA["mvals"])
    wv = s.distribute(DATA["mwords"])
    for engine in ("eager", "naive"):
        for hier in (True, False):
            got, st = s.map_reduce(v, _row, "sum", jnp.zeros((1, 4), jnp.float32),
                                   engine=engine, hierarchical=hier, return_stats=True)
            st = st.finalize()
            res[f"matrix/{engine}/{hier}"] = {
                "vals": np_(got), "coll": st.collective,
                "intra": int(st.intra_bytes), "inter": int(st.inter_bytes)}
    for engine in ("eager", "pallas"):
        hm = make_dist_hashmap(mesh, 1024, (), jnp.int32, "sum")
        hm, st = s.map_reduce(wv, _tok, "sum", hm, engine=engine, key_range=100,
                              return_stats=True)
        st = st.finalize()
        res[f"hash/{engine}"] = {"counts": {str(k): int(c) for k, c in hm.to_dict().items()},
                                 "overflow": hm.total_overflow(), "engine": st.engine,
                                 "coll": st.collective, "intra": int(st.intra_bytes),
                                 "inter": int(st.inter_bytes)}
    out[str(n)] = res

# compressed_psum on (2, 4) under shard_map: hierarchical and flat
mesh = make_node_data_mesh(2)
x = jnp.asarray(DATA["x"])
spec = P(("node", "data"))
for wire in ("none", "int8"):
    hier_fn = lambda v, w=wire: compressed_psum(v[0], "node", wire=w, intra_axis="data")[None]
    flat_fn = lambda v, w=wire: compressed_psum(v[0], ("node", "data"), wire=w)[None]
    for name, fn in (("hier", hier_fn), ("flat", flat_fn)):
        got = jax.jit(shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                                check_vma=False))(x)
        out[f"psum/{wire}/{name}"] = np_(got[0])

def fb(v, r):
    red, nr = psum_with_feedback(v[0], r[0], "node", wire="int8", intra_axis="data")
    return red[None], nr[None]

red_fb, resid = jax.jit(shard_map(fb, mesh=mesh, in_specs=(spec, spec),
                                  out_specs=(spec, spec), check_vma=False))(x, jnp.zeros_like(x))
out["feedback"] = {"reduced": np_(red_fb[0]), "residual": np_(resid)}
# the flat wires on the 1-D mesh of 8
mesh1 = data_mesh()
for wire in ("none", "bf16", "int8"):
    f = shard_map(lambda v, w=wire: compressed_psum(v[0], "data", wire=w)[None], mesh=mesh1,
                  in_specs=P("data"), out_specs=P("data"), check_vma=False)
    out[f"psum8/{wire}"] = np_(jax.jit(f)(x)[0])

# test_multidevice: the 1-D mesh of 8
wv = distribute(DATA["words"], mesh1)
for engine in ("eager", "naive"):
    hm = make_dist_hashmap(mesh1, 1024, (), jnp.int32, "sum")
    hm, st = BlazeSession(mesh1).map_reduce(wv, _tok, "sum", hm, engine=engine,
                                            return_stats=True)
    st = st.finalize()
    out[f"md/{engine}"] = {"counts": {str(k): int(c) for k, c in hm.to_dict().items()},
                           "shipped": int(st.pairs_shipped),
                           "emitted": int(st.pairs_emitted)}
sess = BlazeSession()
wv = distribute(DATA["words2"], sess.mesh)
hm = make_dist_hashmap(sess.mesh, 256, (), jnp.int32, "sum")
hm, st = sess.map_reduce(wv, _tok, "sum", hm, engine="pallas", key_range=100,
                         return_stats=True)
st = st.finalize()
out["md/pallas"] = {"payload": int(st.shuffle_payload_bytes), "shipped": int(st.pairs_shipped)}
pr = pagerank(DATA["edges"], 128, tol=1e-7, max_iters=80, mesh=mesh1)
out["md/pagerank"] = {"scores": np_(pr.scores), "iters": pr.iterations}
sess = BlazeSession(mesh1)
pr = pagerank(DATA["edges"], 128, tol=0.0, max_iters=10, mesh=mesh1, session=sess,
              mode="program", unroll=5)
pr8 = pagerank(DATA["edges"], 128, tol=0.0, max_iters=10, mesh=mesh1, session=sess,
               mode="program", unroll=2, wire="int8")
km = kmeans(DATA["pts"], 4, init_centers=DATA["pts"][:4].copy(), tol=0.0, max_iters=10,
            mesh=mesh1, session=sess, mode="program", unroll=5)
out["md/program"] = {"pr": np_(pr.scores), "pr8": np_(pr8.scores), "km": np_(km.centers)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax8():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.pop("BLAZE_FAULTS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX], capture_output=True, text=True,
                          env=env, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _mesh(n_nodes):
    return make_node_data_mesh(n_nodes, n_shards=8, device="cpu")


def _row(i, r, emit):
    emit(0, r)


def _tok(i, w, emit):
    emit(w, 1)


def _counts(hm) -> dict:
    return {int(k): int(v) for k, v in hm.to_dict().items()}


def _masked(render: str) -> list[str]:
    """EXPLAIN with the header's hash and the cost figures masked."""
    lines = render.splitlines()
    lines[0] = re.sub(r"\(hash [0-9a-f]{12}\)", "(hash MASKED)", lines[0])
    return [re.sub(r" cost~\d+", " cost~MASKED", line) for line in lines]


def _fill(red):
    return {"sum": 0.0, "min": float("inf"), "max": float("-inf")}[red]


# -- wire-byte accounting -----------------------------------------------------


def test_wire_bytes_derive_from_dtype():
    from repro.distributed.collectives import wire_bytes as jwire_bytes

    for x in (torch.zeros(100), np.zeros((100,), np.float64), np.zeros((100,), np.int16)):
        want = jwire_bytes(np.zeros(100, np.float32) if isinstance(x, torch.Tensor) else x,
                           "none")
        assert wire_bytes(x, "none") == want
    assert wire_bytes(torch.zeros(100), "none") == 400
    assert wire_bytes(np.zeros((100,), np.float64), "none") == 800
    assert wire_bytes(np.zeros((100,), np.int16), "none") == 200
    assert wire_bytes(torch.zeros(100), "bf16") == 200


def test_wire_bytes_int8_frames_ship_their_scales():
    from repro.distributed.collectives import wire_bytes as jwire_bytes

    x = torch.zeros(100)
    assert wire_bytes(x, "int8") == jwire_bytes(jnp.zeros(100), "int8") == 104
    assert wire_bytes(x, "int8", n_scales=3) == 112
    with pytest.raises(ValueError):
        wire_bytes(x, "int8", n_scales=0)
    with pytest.raises(ValueError):
        wire_bytes(x, "fp4")


def test_reduce_edge_bytes_combine_edge_model():
    from repro.core.mapreduce import reduce_edge_bytes as jreb
    from repro_torch.core.mapreduce import reduce_edge_bytes

    cases = [(10, 4, 4, 8, 1, False), (10, 4, 4, 8, 1, True), (10, 4, 4, 8, 2, False),
             (10, 4, 1, 8, 2, True), (10, 4, 2, 8, 4, True), (7, 8, 1, 8, 8, True)]
    for case in cases:
        assert reduce_edge_bytes(*case) == jreb(*case), case
    assert reduce_edge_bytes(10, 4, 4, 8, 1, False) == (10 * 4 * 7, 0)
    assert reduce_edge_bytes(10, 4, 4, 8, 2, False) == (0, 10 * 4 * 7)
    assert reduce_edge_bytes(10, 4, 1, 8, 2, True) == (10 * 4 * 6, 10 * 1)
    assert reduce_edge_bytes(10, 4, 2, 8, 4, True) == (10 * 4 * 4, 10 * 2 * 3)


# -- the hierarchical-collectives pass (plan layer) ---------------------------


def _node_pair(n_nodes, *, engine="eager", hierarchical=True, wire="none", red_name="sum"):
    """The same node built by both packages (one mapper object, and an env
    of one tensor, so the stable descriptions agree to the byte)."""
    from repro.core.plan import build_mapreduce_node as jbuild
    from repro.core.reducers import get_reducer as jget
    from repro_torch.core.plan import build_mapreduce_node
    from repro_torch.core.reducers import get_reducer

    kw = dict(idx=0, kind="range", src="range[0:64:1]", source_key=None, mapper=_row_env,
              engine=engine, wire=wire, key_range=None, n_nodes=n_nodes,
              hierarchical=hierarchical)
    return (build_mapreduce_node(red=get_reducer(red_name), target=torch.zeros(4),
                                 env=torch.zeros(2), **kw),
            jbuild(red=jget(red_name), target=jnp.zeros((4,), jnp.float32),
                   env=jnp.zeros((2,), jnp.float32), **kw))


def _row_env(v, emit, env):
    emit(0, v + env[0])


def test_pass_rewrites_eligible_nodes_only():
    for kw, hier, coll in (
        (dict(n_nodes=1), False, "psum[4x4B]"),
        (dict(n_nodes=2), True, "psum[node×data, hier]"),
        (dict(n_nodes=2, engine="naive"), False, "all_gather[raw pairs]"),
        (dict(n_nodes=2, hierarchical=False), False, "psum[4x4B]"),
        (dict(n_nodes=4, wire="int8"), True, "psum[node×data, hier, wire=int8@inter]"),
        (dict(n_nodes=2, red_name="min"), True, "min-reduce[node×data, hier]"),
    ):
        node, jnode = _node_pair(**kw)
        assert (node.hier, node.collective) == (jnode.hier, jnode.collective) == (hier, coll)


def test_hier_node_is_a_distinct_plan_identity():
    (flat, jflat), (hier, jhier) = _node_pair(1), _node_pair(2)
    assert flat.stable_desc() != hier.stable_desc() and flat.tune_key != hier.tune_key
    assert hier.stable_desc().endswith(" hier")
    assert (flat.stable_desc(), hier.stable_desc()) == (jflat.stable_desc(),
                                                        jhier.stable_desc())
    assert (flat.hash, hier.hash) == (jflat.hash, jhier.hash)


def test_plan_hash_and_render_multinode():
    from repro.core.plan import single_op_plan as jsingle
    from repro_torch.core.plan import single_op_plan

    (n1, j1), (n2, j2) = _node_pair(1), _node_pair(2)
    p1, p2 = single_op_plan(n1, n_shards=8), single_op_plan(n2, n_shards=8, n_nodes=2)
    assert p1.hash != p2.hash
    assert (p1.hash, p2.hash) == (jsingle(j1, n_shards=8).hash,
                                  jsingle(j2, n_shards=8, n_nodes=2).hash)
    r1, r2 = p1.render(), p2.render()
    assert "node[" not in r1 and "hierarchical-collectives" not in r1
    assert "mesh: node[2]×data[4]" in r2
    assert "passes: resolve-engines, hierarchical-collectives" in r2
    assert "psum[node×data, hier]" in r2
    assert _masked(r2) == _masked(jsingle(j2, n_shards=8, n_nodes=2).render())


# -- process bring-up and mesh construction -----------------------------------


def test_distributed_initialize_single_process_noop():
    from repro import compat

    assert mesh_mod.init_distributed() is False is compat.distributed_initialize()
    assert mesh_mod.process_count() == 1 == compat.process_count()
    assert mesh_mod.process_index() == 0 == compat.process_index()


def test_make_node_data_mesh_shapes_8dev(jax8, monkeypatch):
    from repro_torch.core import containers as C

    shapes = {}
    for n in (1, 2, 4, 8):
        m = _mesh(n)
        shapes[str(n)] = [m.n_nodes, m.n_data]
        assert C.n_nodes(m) == n and C.shard_count(m) == 8
        assert C.data_axes(m) == (("node", "data") if n > 1 else ("data",))
    assert shapes == jax8["shapes"]
    assert make_node_data_mesh(device="cpu", n_shards=8) == data_mesh(8, "cpu")
    with pytest.raises(ValueError) as err:
        _mesh(3)
    assert str(err.value) == "cannot split 8 shards into 3 node rows"
    assert "3 node" in jax8["split_error"]
    assert jax8["initialized"] is False
    # more than one process: one node row a process, so n_nodes must be P
    monkeypatch.setattr(mesh_mod, "_group_up", lambda: True)
    monkeypatch.setattr(mesh_mod, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="one node row a process"):
        _mesh(4)
    monkeypatch.undo()
    _assert_process_mesh_refusals()


def _assert_process_mesh_refusals():
    """A gloo group cannot carry CUDA tensors; on a mesh of several
    processes a chunked vector keeps this rank's rows and one made without
    the mesh is refused, and the server raises, naming its ROADMAP item."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import containers as C
    from repro_torch.launch.serve import build_server

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "s"), 1),
                                world_size=1, rank=0)
        try:
            with pytest.raises(ValueError, match="gloo.*cannot carry"):
                C.Mesh(1, 8, torch.device("cuda"), group=dist.group.WORLD)
            assert make_node_data_mesh(device="cpu").process
        finally:
            dist.destroy_process_group()
    # two ranks, as rank 0 sees them (no collective runs before the refusal)
    two = C.Mesh(2, 4, torch.device("cpu"), group=object(), rank=0, n_ranks=2)
    mine = BlazeSession(mesh=two).chunked(DATA["ints"], 16)
    assert mine.local_rows == 8 and mine.block_base(1) == 16
    np.testing.assert_array_equal(mine.block_host(1), DATA["ints"][16:24])
    np.testing.assert_array_equal(C.chunked(DATA["ints"], 16, mesh=two).block_host(0),
                                  DATA["ints"][:8])
    with pytest.raises(ValueError, match="not this rank's"):
        BlazeSession(mesh=two).map_reduce(C.chunked(DATA["ints"], 16, 8, "cpu"), _row,
                                          "sum", torch.zeros(1, 4))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6d"):
        build_server(mesh=two)


# -- hierarchical against flat on (2, 4) and (4, 2) ---------------------------


@pytest.mark.parametrize("red", ("sum", "min", "max"))
@pytest.mark.parametrize("n_nodes", SPLITS)
def test_hier_matches_flat_and_oracle_8dev(jax8, n_nodes, red):
    vals = DATA["ints"]
    oracle = {"sum": vals.sum(0), "min": vals.min(0), "max": vals.max(0)}[red]
    s = BlazeSession(mesh=_mesh(n_nodes))
    v = s.distribute(vals)
    t = torch.full((1, 4), _fill(red))
    got = {}
    for hier in (True, False):
        out, st = s.map_reduce(v, _row, red, t, return_stats=True, hierarchical=hier)
        st = st.finalize()
        got[hier] = out
        want = jax8[str(n_nodes)][f"{red}/{hier}"]
        assert (st.collective, st.intra_bytes, st.inter_bytes) == (
            want["coll"], want["intra"], want["inter"])
        assert np.array_equal(out.numpy(), np.asarray(want["vals"], np.float32))
    assert torch.equal(got[True], got[False])
    assert np.array_equal(got[True].numpy()[0], oracle)
    assert "hier" in jax8[str(n_nodes)][f"{red}/True"]["coll"]
    # combine-edge model: 4 f32 elements, 8 shards
    assert jax8[str(n_nodes)][f"{red}/True"]["intra"] == 16 * (8 - n_nodes)
    assert jax8[str(n_nodes)][f"{red}/True"]["inter"] == 16 * (n_nodes - 1)
    assert jax8[str(n_nodes)][f"{red}/False"]["inter"] == 16 * 7


@pytest.mark.parametrize("n_nodes", SPLITS)
def test_hier_int8_wire_narrows_inter_only_8dev(jax8, n_nodes):
    vals = DATA["floats"]
    exact = vals.astype(np.float64).sum(0)
    s = BlazeSession(mesh=_mesh(n_nodes))
    v = s.distribute(vals)
    err = {}
    for hier in (True, False):
        out, st = s.map_reduce(v, _row, "sum", torch.zeros(1, 8), wire="int8",
                               return_stats=True, hierarchical=hier)
        st = st.finalize()
        want = jax8[str(n_nodes)][f"int8/{hier}"]
        assert (st.collective, st.intra_bytes, st.inter_bytes) == (
            want["coll"], want["intra"], want["inter"])
        # one lattice step of the shared scale per addend of the narrowed hop
        parts = vals.reshape(8, 8, 8).sum(1)  # each shard's f32 partial
        if hier:
            parts = parts.reshape(n_nodes, -1, 8).sum(1)
        step = np.abs(parts).max() / 127.0
        tol = parts.shape[0] * step * (1 + 1e-5) + 1e-5 * np.abs(vals).sum(0)
        assert (np.abs(out.numpy()[0] - np.asarray(want["vals"])[0]) <= tol).all()
        err[hier] = float(np.abs(out.numpy()[0] - exact).max() / np.abs(exact).max())
        assert err[hier] < 0.05
    assert jax8[str(n_nodes)]["int8/True"]["coll"] == "psum[node×data, hier, wire=int8@inter]"
    assert jax8[str(n_nodes)]["int8/True"]["intra"] == 8 * 4 * (8 - n_nodes)
    assert jax8[str(n_nodes)]["int8/True"]["inter"] == 8 * 1 * (n_nodes - 1)
    assert jax8[str(n_nodes)]["int8/False"]["inter"] == 8 * 1 * 7


@pytest.mark.parametrize("n_nodes", SPLITS)
def test_program_hier_vs_flat_bit_equal_8dev(jax8, n_nodes):
    vals = DATA["prog"]
    s = BlazeSession(mesh=_mesh(n_nodes))
    v = s.distribute(vals)

    def step(ctx, state):
        t = ctx.map_reduce(v, _row, "sum", torch.zeros(1, 4))
        return {"acc": state["acc"] + t[0]}

    state0 = {"acc": torch.zeros(4)}
    progs, outs = {}, {}
    for hier in (True, False):
        progs[hier] = s.program(step, hierarchical=hier)
        outs[hier] = progs[hier](dict(state0), 3)["acc"]
        want = jax8[str(n_nodes)][f"prog/{hier}"]
        assert np.array_equal(outs[hier].numpy(), np.asarray(want["acc"], np.float32))
        assert _masked(s.explain(progs[hier], dict(state0))) == _masked(want["explain"])
    assert torch.equal(outs[True], outs[False])
    assert np.array_equal(outs[True].numpy(), 3 * vals.sum(0))
    assert progs[True].plan.hash != progs[False].plan.hash
    render_h = s.explain(progs[True], dict(state0))
    assert f"mesh: node[{n_nodes}]×data[{8 // n_nodes}]" in render_h
    assert "hierarchical-collectives" in render_h and "psum[node×data, hier]" in render_h
    assert "hierarchical-collectives" not in s.explain(progs[False], dict(state0))


@pytest.mark.parametrize("n_nodes", SPLITS)
def test_collective_inter_fault_retries_bit_equal_8dev(jax8, n_nodes):
    tf.reset(env=False)
    fast = tf.RetryPolicy(attempts=3, backoff_s=0.0, multiplier=1.0, deadline_s=None)
    try:
        mesh = _mesh(n_nodes)
        ref_s = BlazeSession(mesh=mesh, retry=fast)
        ref = ref_s.map_reduce(ref_s.distribute(DATA["fault"]), _row, "sum", torch.zeros(1, 4))
        s = BlazeSession(mesh=mesh, retry=fast)
        v = s.distribute(DATA["fault"])
        tf.configure("collective.inter", at=1)
        got = s.map_reduce(v, _row, "sum", torch.zeros(1, 4))
        snap = tf.snapshot()
    finally:
        tf.reset(env=False)
    want = jax8[str(n_nodes)]["fault"]
    assert torch.equal(got, ref)
    assert np.array_equal(got.numpy(), np.asarray(want["vals"], np.float32))
    assert s.stats.retries == want["retries"] == 1
    assert snap["balanced"] and want["balanced"]
    assert snap["dispositions"]["retried"] == want["retried"] == 1
    assert snap["hits"]["collective.inter"] == 2  # the faulted hop, then the retry's


def test_compressed_psum_hierarchical_8dev(jax8):
    x = torch.from_numpy(DATA["x"])
    exact = DATA["x"].astype(np.float64).sum(0)
    scale = np.abs(exact).max()
    for wire in ("none", "int8"):
        hier = compressed_psum(x, wire=wire, n_nodes=2).numpy()
        flat = compressed_psum(x, wire=wire).numpy()
        assert np.abs(hier - exact).max() / scale < (1e-6 if wire == "none" else 0.05)
        assert np.abs(flat - exact).max() / scale < (1e-6 if wire == "none" else 0.05)
        for name, got, addends in (("hier", hier, 2), ("flat", flat, 8)):
            want = np.asarray(jax8[f"psum/{wire}/{name}"])
            if wire == "none":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)
            else:
                parts = DATA["x"].reshape(addends, -1, 128).sum(1)
                step = np.abs(parts).max() / 127.0
                assert np.abs(got - want).max() <= addends * step * (1 + 1e-5)
    red, resid = psum_with_feedback(x, torch.zeros_like(x), wire="int8", n_nodes=2)
    resid = resid.numpy()
    # the residual is the node's, on every shard of that node
    assert np.array_equal(resid[0], resid[1]) and np.array_equal(resid[1], resid[3])
    assert np.array_equal(resid[4], resid[7]) and not np.array_equal(resid[0], resid[4])
    jres = np.asarray(jax8["feedback"]["residual"])
    parts = DATA["x"].reshape(2, 4, 128).sum(1)
    step = np.abs(parts).max() / 127.0
    assert np.abs(resid - jres).max() <= step * (1 + 1e-5)
    assert np.abs(red.numpy() - np.asarray(jax8["feedback"]["reduced"])).max() <= 2 * step


# -- tests/test_multidevice.py: the 1-D mesh of 8 -----------------------------


@pytest.mark.parametrize("engine", ("eager", "naive"))
def test_mapreduce_8dev_matches_oracle(jax8, engine):
    words = DATA["words"]
    s = BlazeSession(mesh=data_mesh(8, "cpu"))
    hm = s.make_dist_hashmap(1024, (), torch.int32, "sum")
    hm, st = s.map_reduce(s.distribute(words), _tok, "sum", hm, engine=engine,
                          return_stats=True)
    st = st.finalize()
    want = jax8[f"md/{engine}"]
    assert _counts(hm) == dict(collections.Counter(words.tolist()))
    assert _counts(hm) == {int(k): v for k, v in want["counts"].items()}
    assert hm.total_overflow() == 0
    assert (st.pairs_shipped, st.pairs_emitted) == (want["shipped"], want["emitted"])
    if engine == "eager":
        assert st.pairs_shipped < st.pairs_emitted
        assert st.pairs_shipped <= jax8["md/naive"]["shipped"]


def test_hash_kernel_8dev_matches_oracle(jax8):
    words = DATA["words2"]
    ref = dict(collections.Counter(words.tolist()))
    s = BlazeSession(mesh=data_mesh(8, "cpu"))
    hm = s.make_dist_hashmap(256, (), torch.int32, "sum")
    hm, st = s.map_reduce(s.distribute(words), _tok, "sum", hm, engine="pallas",
                          key_range=100, return_stats=True)
    st = st.finalize()
    assert _counts(hm) == ref and st.engine == "pallas" and hm.total_overflow() == 0
    assert st.shuffle_payload_bytes == st.pairs_shipped * 5  # int8 key + int32 value
    assert (st.shuffle_payload_bytes, st.pairs_shipped) == (jax8["md/pallas"]["payload"],
                                                           jax8["md/pallas"]["shipped"])
    res = wordcount(words.reshape(-1, 16), engine="pallas", mode="program", iters=10,
                    unroll=5, session=BlazeSession(mesh=data_mesh(8, "cpu")))
    assert _counts(res.counts) == {k: 10 * c for k, c in ref.items()}
    assert (res.program_compiles, res.dispatches, res.host_syncs) == (1, 2, 0)


def test_pagerank_8dev_matches_reference(jax8):
    mesh = data_mesh(8, "cpu")
    res = pagerank(DATA["edges"], 128, tol=1e-7, max_iters=80, mesh=mesh,
                   session=BlazeSession(mesh=mesh))
    ref = pagerank_reference(DATA["edges"], 128, tol=1e-7, max_iters=80)
    assert float(np.abs(res.scores - ref).max() / ref.max()) < 1e-4
    jscores = np.asarray(jax8["md/pagerank"]["scores"])
    assert float(np.abs(res.scores - jscores).max() / jscores.max()) < 1e-4


def test_fused_program_8dev_matches_reference(jax8):
    mesh = data_mesh(8, "cpu")
    sess = BlazeSession(mesh=mesh)
    edges, pts = DATA["edges"], DATA["pts"]
    pr = pagerank(edges, 128, tol=0.0, max_iters=10, mesh=mesh, session=sess,
                  mode="program", unroll=5)
    pr_ref = pagerank_reference(edges, 128, tol=0.0, max_iters=10)
    pr8 = pagerank(edges, 128, tol=0.0, max_iters=10, mesh=mesh, session=sess,
                   mode="program", unroll=2, wire="int8")
    km = kmeans(pts, 4, init_centers=pts[:4].copy(), tol=0.0, max_iters=10, mesh=mesh,
                session=sess, mode="program", unroll=5)
    km_ref, _ = kmeans_reference(pts, pts[:4].copy(), tol=0.0, max_iters=10)
    assert float(np.abs(pr.scores - pr_ref).max() / pr_ref.max()) < 1e-4
    assert (pr.program_compiles, pr.dispatches) == (1, 2)
    assert float(np.abs(pr8.scores - pr_ref).max() / pr_ref.max()) < 2e-2
    assert float(np.abs(km.centers - km_ref).max()) < 1e-2
    assert (km.program_compiles, km.dispatches) == (1, 3)
    want = jax8["md/program"]
    np.testing.assert_allclose(pr.scores, np.asarray(want["pr"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(km.centers, np.asarray(want["km"]), atol=1e-4)


@pytest.mark.parametrize("wire", ("none", "bf16", "int8"))
def test_compressed_psum_8dev(jax8, wire):
    x = torch.from_numpy(DATA["x"])
    exact = DATA["x"].astype(np.float64).sum(0)
    got = compressed_psum(x, wire=wire).numpy()
    rel = float(np.abs(got - exact).max() / np.abs(exact).max())
    assert rel < (1e-6 if wire == "none" else 0.05)
    want = np.asarray(jax8[f"psum8/{wire}"])
    # the same f32 addends in another order; bf16: one rounding per addend
    # each; int8: one lattice step per addend each
    absx = np.abs(DATA["x"]).astype(np.float64)
    tol = {"none": 1e-6 * absx.sum(0),
           "bf16": 8 * 2.0 ** -8 * absx.sum(0),
           "int8": np.full(128, 8 * np.abs(DATA["x"]).max() / 127.0 * (1 + 1e-5))}[wire]
    assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("n_nodes", SPLITS)
def test_node_data_mesh_differential_matrix_8dev(jax8, n_nodes):
    vals, words = DATA["mvals"], DATA["mwords"]
    ref_counts = dict(collections.Counter(words.tolist()))
    s = BlazeSession(mesh=_mesh(n_nodes))
    v, wv = s.distribute(vals), s.distribute(words)
    want = jax8[str(n_nodes)]
    for engine in ("eager", "naive"):
        got = {}
        for hier in (True, False):
            out, st = s.map_reduce(v, _row, "sum", torch.zeros(1, 4), engine=engine,
                                   hierarchical=hier, return_stats=True)
            st = st.finalize()
            got[hier] = out
            w = want[f"matrix/{engine}/{hier}"]
            assert np.array_equal(out.numpy(), np.asarray(w["vals"], np.float32))
            assert st.collective == w["coll"]
            assert abs(st.intra_bytes - w["intra"]) <= 1
            assert abs(st.inter_bytes - w["inter"]) <= 1
        assert torch.equal(got[True], got[False])
        assert np.array_equal(got[True].numpy()[0], vals.sum(0))
    for engine in ("eager", "pallas"):
        hm = s.make_dist_hashmap(1024, (), torch.int32, "sum")
        hm, st = s.map_reduce(wv, _tok, "sum", hm, engine=engine, key_range=100,
                              return_stats=True)
        st = st.finalize()
        w = want[f"hash/{engine}"]
        assert _counts(hm) == ref_counts == {int(k): c for k, c in w["counts"].items()}
        assert hm.total_overflow() == 0 and st.engine == engine == w["engine"]
        assert st.collective == w["coll"]
        tot = st.intra_bytes + st.inter_bytes
        frac = (8 - 8 // n_nodes) / 8
        assert tot > 0 and abs(st.inter_bytes - tot * frac) <= 1
        assert abs(st.intra_bytes - w["intra"]) <= 1 and abs(st.inter_bytes - w["inter"]) <= 1


# -- the 1-node mesh: nothing moves -------------------------------------------


@pytest.mark.parametrize("spelling", ("per_op", "program"))
def test_one_node_mesh_keeps_every_hash_and_explain_line(spelling):
    """A 1-node (node, data) mesh, hierarchical or not, is the n_shards
    session it replaces: the same stage-cache keys, plan hashes and EXPLAIN
    lines, and bit-equal results."""
    vals = DATA["prog"]

    def run(sess, **kw):
        v = sess.distribute(vals)
        if spelling == "per_op":
            out, st = sess.map_reduce(v, _row, "sum", torch.zeros(1, 4), engine="pallas",
                                      wire="int8", return_stats=True, **kw)
            return out, st.plan_hash, st.collective, sorted(map(repr, sess._exec_cache))

        def step(ctx, state):
            t = ctx.map_reduce(v, _row, "sum", torch.zeros(1, 4), engine="pallas")
            return {"acc": state["acc"] + t[0]}

        prog = sess.program(step, **kw)
        out = prog({"acc": torch.zeros(4)}, 2)["acc"]
        return out, prog.plan.hash, prog.plan.render(), None

    base = run(BlazeSession(device="cpu", n_shards=8))
    for kw in ({}, {"hierarchical": False}):
        got = run(BlazeSession(mesh=_mesh(1)), **kw)
        assert torch.equal(got[0], base[0])
        assert got[1:] == base[1:]
    if spelling == "program":
        assert "mesh: data[8]" in base[2] and "hierarchical" not in base[2]
