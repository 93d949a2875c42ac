"""Streams and checkpoints across processes, on the CPU.

``P`` real processes over ``gloo`` (``launch.simulate.spawn_local``), one
node row a process, (2 x 4) and (4 x 2) of 8 shards: each rank keeps its own
rows of every block of a chunked source (``session.chunked``), runs one
stage a block per op (dense and hash targets) and one graph replay a block
in ``run_stream`` (the drivers' ``mode="stream"``: k-means, PageRank with
the none and int8 wires, chunked word count), and checkpoints.

Held:

* every rank's result is the same, bit for bit, and equals the in-process
  mesh of the same split (``make_node_data_mesh(P, n_shards=8)`` in this
  process) bit for bit;
* integers equal the dict oracle (word counts, per op and streamed; the
  ranks' local tables split the keys between them);
* JAX's stream (one device) is within ``tests/test_torch_streaming.py``'s
  tolerances: k-means centres on integer-valued points exactly, its
  inertia ``rtol=1e-5``, PageRank ``atol=1e-7``, counts exactly;
* checkpoints written by 2 processes (a ``run_stream`` of k-means with the
  int8 wire's residual carried, a streamed word count's hash tables, a
  ``run_loop`` of k-means with the int8 residual) resume on 4 processes and
  on one (the in-process (1 x 8) mesh) with the uninterrupted run's bits.
  Their collectives are flat (``hierarchical=False``), whose sums and
  per-shard residuals do not depend on the node split, so one uninterrupted
  run stands for every process count;
* a rank that fails mid-save fails the save on every rank and leaves the
  previous checkpoint, which the run then resumes from.
"""
from __future__ import annotations

import collections
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from repro.core import BlazeSession as JaxSession
from repro.core.algorithms.kmeans import kmeans as jkmeans
from repro.core.algorithms.pagerank import pagerank as jpagerank
from repro.core.algorithms.wordcount import counts_dict as jcounts_dict
from repro.core.algorithms.wordcount import wordcount as jwordcount
from repro.data.synthetic import rmat_edges
from repro_torch.launch.mesh import make_node_data_mesh
from repro_torch.launch.simulate import spawn_local

DATA = dict(
    pts=(np.random.RandomState(3).randn(1000, 3) * 4).astype(np.float32),
    ipts=np.random.RandomState(1).randint(-20, 20, (900, 4)).astype(np.float32),
    edges=rmat_edges(7, 8, seed=2),
    lines=np.random.RandomState(5).randint(0, 60, (600, 8)).astype(np.int32),
)
VOCAB = 60
EDGE_BLOCK = -(-DATA["edges"].shape[0] // 8)  # 8 blocks
RESUME = dict(stream=(2, 5), wordcount=(2, 4), loop=(4, 6))  # saved at, run to


def _sq_mapper(i, x, emit):
    emit(i % 7, x * x)


def _counts(hm) -> dict:
    return {int(k): int(v) for k, v in hm.to_dict().items()}


def _stream_jobs(mesh, D) -> dict:
    """The stream matrix on ``mesh``; host values.  Keys under ``local/``
    are this rank's own rows."""
    from repro_torch.core import BlazeSession
    from repro_torch.core.algorithms import kmeans, pagerank, wordcount

    s = BlazeSession(mesh=mesh)
    out = {}
    pts_c = s.chunked(D["pts"], 256)
    # per op over blocks: a dense float sum, and a hash target
    out["map_reduce/dense"] = s.map_reduce(pts_c, _sq_mapper, "sum",
                                           torch.zeros(7, 3)).numpy()
    for engine in ("eager", "pallas"):
        km = kmeans(pts_c, 4, init_centers=D["pts"][:4].copy(), tol=0.0, max_iters=5,
                    mode="stream", engine=engine, session=s)
        out[f"kmeans/{engine}"] = (km.centers, km.inertia, km.iterations)
    km = kmeans(pts_c, 4, tol=0.0, max_iters=3, seed=3, mode="stream", session=s)
    out["kmeans/drawn_centres"] = (km.centers, km.inertia)  # from block 0's head
    km = kmeans(s.chunked(D["ipts"], 256), 5, init_centers=D["ipts"][:5].copy(),
                max_iters=6, mode="stream", engine="pallas", session=s)
    out["kmeans/ints"] = (km.centers, km.inertia, km.iterations)
    edges_c = s.chunked(D["edges"], EDGE_BLOCK)
    for engine, wire in (("eager", "none"), ("pallas", "none"), ("pallas", "int8")):
        pr = pagerank(edges_c, 128, tol=0.0, max_iters=10, mode="stream", engine=engine,
                      wire=wire, session=s)
        out[f"pagerank/{engine}/{wire}"] = (pr.scores, pr.iterations)
    out["pagerank/per_op"] = pagerank(edges_c, 128, tol=0.0, max_iters=5,
                                      session=s).scores
    lines_c = s.chunked(D["lines"], 128)
    for engine in ("eager", "pallas"):
        hm = wordcount(lines_c, engine=engine, vocab_size=VOCAB, session=s)
        out[f"wordcount/per_op/{engine}"] = (_counts(hm), hm.total_overflow())
        t = hm.table
        live = (t.keys != -(2 ** 31)).numpy()
        out[f"local/wordcount/{engine}"] = dict(zip(t.keys.numpy()[live].tolist(),
                                                    t.vals.numpy()[live].tolist()))
        res = wordcount(lines_c, engine=engine, vocab_size=VOCAB, mode="program", iters=2,
                        session=s)
        out[f"wordcount/stream/{engine}"] = (_counts(res.counts),
                                             res.counts.total_overflow(), res.iterations)
    out["wordcount/dense"] = wordcount(lines_c, target="dense", vocab_size=VOCAB,
                                       session=s).numpy()
    out["collect"] = lines_c.collect()
    return out


def _programs(s, D):
    """The three checkpointed programs on session ``s``, flat collectives:
    ``{name: (program, initial state, runner)}``; a runner is ``run_stream``
    or ``run_loop`` with its own position keywords."""
    from repro_torch.core.algorithms.kmeans import _program_step, _stream_step
    from repro_torch.core.algorithms.wordcount import _program_step as _wc_step

    c0 = torch.from_numpy(D["pts"][:4].copy())
    cv = s.chunked(D["pts"], 256)
    step, state0 = _stream_step(cv, 4, 3, "pallas", "int8", s.device)
    progs = {"stream": (s.program(step, hierarchical=False), state0(c0), "stream")}
    hm = s.make_dist_hashmap(4 * VOCAB, (), torch.int32, "sum")
    wstep, wstate = _wc_step(s.chunked(D["lines"], 128), hm, VOCAB, "pallas")
    progs["wordcount"] = (s.program(wstep, hierarchical=False), wstate, "stream", hm)
    lstep, lstate0 = _program_step(s.distribute(D["pts"]), 4, 3, "pallas", "int8")
    progs["loop"] = (s.program(lstep, hierarchical=False), lstate0(c0), "loop")
    return progs


def _drive(s, entry, upto, **kw) -> dict:
    """Run one checkpointed program to ``upto`` (epochs or iterations);
    host values of its state (and of the word count's table)."""
    prog, state, how = entry[:3]
    if how == "stream":
        state, info = s.run_stream(prog, state, max_epochs=upto, **kw)
    else:
        state, info = s.run_loop(prog, state, max_iters=upto, unroll=2, **kw)
    out = {k: v.numpy() for k, v in state.items()}
    if len(entry) > 3:
        out["counts"] = _counts(prog.hash_result(entry[3]))
    out["resumed_from"] = info.resumed_from
    return out


def _checkpoint_jobs(mesh, D, root, write: bool) -> dict:
    """``write``: each program run to its save point with a checkpoint
    every epoch (every 2 iterations), under ``root/<name>``, and the
    mid-save failure; otherwise each program resumed from ``root/<name>``
    and run to its end (no more saves)."""
    from repro_torch.core import BlazeSession
    from repro_torch.checkpoint.manager import CheckpointManager

    s = BlazeSession(mesh=mesh)
    out = {}
    for name, entry in _programs(s, D).items():
        saved, end = RESUME[name]
        d = os.path.join(root, name)
        if write:
            _drive(s, entry, saved, checkpoint=d,
                   checkpoint_every=1 if entry[2] == "stream" else 2)
            out[f"steps/{name}"] = CheckpointManager(d).all_steps()
        else:
            out[f"resumed/{name}"] = _drive(s, entry, end, checkpoint=d, resume=True)
    if write:
        out["fail"] = _failed_save(s, D, mesh.rank, os.path.join(root, "fail"))
    return out


def _failed_save(s, D, rank: int, d: str):
    """The run_loop program checkpointed every 2 iterations to 4, rank 1's
    file write failing on the second save; then resumed from what is left,
    to 6 iterations."""
    entry = _programs(s, D)["loop"]
    real, calls = np.savez, []

    def savez(*args, **kwargs):
        calls.append(1)
        if rank == 1 and len(calls) == 2:
            raise OSError("rank 1's disk fails in the middle of the save")
        return real(*args, **kwargs)

    np.savez = savez
    try:
        _drive(s, entry, 4, checkpoint=d, checkpoint_every=2)
        err = None
    except (OSError, RuntimeError) as e:
        err = f"{type(e).__name__}: {e}"
    finally:
        np.savez = real
    listing = sorted(os.listdir(d))
    entry = _programs(s, D)["loop"]
    return err, listing, _drive(s, entry, 6, checkpoint=d, resume=True)


def _rank_run(rank, n_procs, data, root):
    mesh = make_node_data_mesh(n_procs, n_shards=8, device="cpu")
    out = _stream_jobs(mesh, data)
    out.update(_checkpoint_jobs(mesh, data, root, write=n_procs == 2))
    return out


# -- fixtures -------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs():
    """``{P: (the ranks' results, the in-process (P x 8/P) mesh's)}`` for P
    = 2 (which writes the checkpoints) and 4 (which resumes them), and
    ``"one"``: the in-process (1 x 8) mesh's uninterrupted runs and its
    resumes of the 2-process checkpoints."""
    root = tempfile.mkdtemp(prefix="blaze_stream_ckpt_")
    try:
        out = {}
        for n in (2, 4):
            ranks = spawn_local(n, _rank_run, n, DATA, root, timeout=240)
            out[n] = (ranks, _stream_jobs(make_node_data_mesh(n, n_shards=8, device="cpu"),
                                          DATA))
        from repro_torch.core import BlazeSession

        one = make_node_data_mesh(1, n_shards=8, device="cpu")
        s = BlazeSession(mesh=one)
        whole = {name: _drive(s, entry, RESUME[name][1])
                 for name, entry in _programs(s, DATA).items()}
        resumed = _checkpoint_jobs(one, DATA, root, write=False)
        out["one"] = (whole, resumed)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_stream():
    js = JaxSession()
    out = {}
    km = jkmeans(js.chunked(DATA["ipts"], block_rows=256), 5,
                 init_centers=DATA["ipts"][:5].copy(), max_iters=6, mode="stream",
                 engine="pallas", session=js)
    out["kmeans/ints"] = (np.asarray(km.centers), float(km.inertia), km.iterations)
    pr = jpagerank(js.chunked(DATA["edges"], block_rows=EDGE_BLOCK), 128, tol=0.0,
                   max_iters=10, mode="stream", session=js)
    out["pagerank"] = np.asarray(pr.scores)
    res = jwordcount(js.chunked(DATA["lines"], block_rows=128), session=js,
                     vocab_size=VOCAB, mode="program")
    out["wordcount"] = jcounts_dict(res.counts)
    return out


def _same(a, b) -> bool:
    """Bit-for-bit equality of nested host results."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    return a == b


# -- the tests ------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4], ids=["2x4", "4x2"])
def test_every_rank_streams_the_in_process_bits(runs, n):
    ranks, local = runs[n]
    assert len(ranks) == n
    for key, want in local.items():
        if key.startswith("local/"):
            continue
        for r, res in enumerate(ranks):
            assert _same(res[key], want), f"rank {r} differs from the in-process mesh on {key}"


@pytest.mark.parametrize("n", [2, 4], ids=["2x4", "4x2"])
def test_streamed_integers_equal_the_dict_oracle(runs, n):
    """Word counts per op and streamed (two epochs: twice the counts), the
    dense counts, the gathered dataset, and each rank's tables holding its
    own keys: the union over the ranks is the whole map."""
    ranks, _ = runs[n]
    ref = dict(collections.Counter(DATA["lines"].reshape(-1).tolist()))
    res = ranks[0]
    for engine in ("eager", "pallas"):
        assert res[f"wordcount/per_op/{engine}"] == (ref, 0)
        assert res[f"wordcount/stream/{engine}"] == ({k: 2 * c for k, c in ref.items()}, 0, 2)
        union = {}
        for r in ranks:
            part = r[f"local/wordcount/{engine}"]
            assert not union.keys() & part.keys()
            union.update(part)
        assert union == ref
    np.testing.assert_array_equal(res["wordcount/dense"],
                                  np.bincount(DATA["lines"].reshape(-1), minlength=VOCAB))
    np.testing.assert_array_equal(res["collect"], DATA["lines"])
    want = np.zeros((7, 3), np.float64)
    np.add.at(want, np.arange(1000) % 7, DATA["pts"].astype(np.float64) ** 2)
    np.testing.assert_allclose(res["map_reduce/dense"], want, rtol=1e-5)


@pytest.mark.parametrize("n", [2, 4], ids=["2x4", "4x2"])
def test_streams_across_processes_match_jax(runs, jax_stream, n):
    res = runs[n][0][0]
    centers, inertia, iters = res["kmeans/ints"]
    jc, ji, jit = jax_stream["kmeans/ints"]
    np.testing.assert_array_equal(jc, centers)
    assert iters == jit
    np.testing.assert_allclose(ji, inertia, rtol=1e-5)
    for key in ("pagerank/eager/none", "pagerank/pallas/none"):
        np.testing.assert_allclose(jax_stream["pagerank"], res[key][0], rtol=0, atol=1e-7)
    assert res["wordcount/per_op/pallas"][0] == jax_stream["wordcount"]


def test_checkpoints_of_two_processes_resume_on_four_and_on_one(runs):
    """Written by 2 processes (every epoch, every 2 iterations), resumed on
    4 and on the in-process (1 x 8) mesh: the uninterrupted run's bits,
    the int8 residuals and the hash tables restored as each rank's rows."""
    ranks2, ranks4 = runs[2][0], runs[4][0]
    whole, one = runs["one"]
    assert ranks2[0]["steps/stream"] == [1, 2] and ranks2[0]["steps/loop"] == [2, 4]
    assert ranks2[0]["steps/wordcount"] == [1, 2]
    for name, (saved, _) in RESUME.items():
        want = dict(whole[name])
        assert want.pop("resumed_from") is None
        for where, res in [("4 processes", r) for r in ranks4] + [("one process", one)]:
            got = dict(res[f"resumed/{name}"])
            assert got.pop("resumed_from") == saved, (name, where)
            assert _same(got, want), f"{name} resumed on {where}"
    counts = dict(collections.Counter(DATA["lines"].reshape(-1).tolist()))
    assert whole["wordcount"]["counts"] == {k: 4 * c for k, c in counts.items()}


def test_a_rank_failing_mid_save_leaves_the_previous_checkpoint(runs):
    ranks2 = runs[2][0]
    whole = runs["one"][0]["loop"]
    errors = [r["fail"][0] for r in ranks2]
    assert errors[1].startswith("OSError: rank 1's disk fails")
    assert errors[0].startswith("RuntimeError: checkpoint 4 was not committed: rank(s) [1]")
    for err, listing, resumed in (r["fail"] for r in ranks2):
        assert listing == ["step_00000002"]  # no tmp- directory left behind
        resumed = dict(resumed)
        assert resumed.pop("resumed_from") == 2
        assert _same(resumed, {k: v for k, v in whole.items() if k != "resumed_from"})
