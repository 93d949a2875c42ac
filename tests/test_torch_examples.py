"""The port's copies of the six examples (``examples_torch/``) against the
reference's API on the same numpy inputs, on the CPU at reduced sizes.

Each copy's ``run(device="cpu", ...)`` is held against the calls the JAX
example makes through ``repro`` (not the JAX script itself), with the
tolerances of ``tests/test_torch_algorithms.py``,
``tests/test_torch_models.py`` and ``tests/test_torch_train.py``:

* quickstart: π's hit count, the word counts, Σ v² by key and the 5
  nearest points exactly (counter-based samples with the same bits; integer
  sums; rows copied from the input); the scaled sum exactly too (every
  addend is an integer times a power of 2 and every partial sum stays below
  2^24 of that power, so f32 adds it without rounding in any order);
* data_mining: PageRank scores within ``1e-5`` max-abs and the same
  iteration count, k-means centres within ``1e-4`` and inertia within
  ``rtol = 1e-4``, GMM's log-likelihood within ``1e-5`` relative and its
  parameters within ``1e-4``, kNN's rows exactly;
* streaming_aggregation: the word counts and the histogram exactly (integer
  sums), with the loop's contract (1 compile, ``ROUNDS // UNROLL``
  dispatches, no host sync) asserted by the copy itself;
* serve_queries: every tenant's reply against ``repro.serve``'s
  ``run_direct`` on the same server datasets, with
  ``tests/test_torch_serve.py``'s tolerances (π and word counts exactly,
  PageRank's scores and delta within ``1e-5``, k-means' centres within
  ``1e-4`` and inertia ``rtol = 1e-4``, GMM's parameters within ``1e-4``
  and log-likelihood ``rtol = 1e-5``, kNN's rows as a set and distances
  ``rtol = 1e-6``), 6 compiles for the 12 queries of two tenants;
* serve_lm: JAX's weights carried across (``convert.lm_params_from_jax``),
  the greedy tokens equal to JAX's ``generate``'s except where the port's
  own top-2 logits at the first difference lie within ``2e-4``
  (``tests/test_torch_models.py``'s ``atol = 1e-4``, twice);
* train_lm: the ~100M config shrunk to reduced qwen3's widths, JAX's
  weights carried across, the first loss within ``rtol = 1e-5`` of JAX's
  ``train``; the second within the reach of one AdamW step: a parameter
  moves by at most ``lr(1)`` in either package, so the two packages'
  parameters differ by at most ``2·lr(1)`` an entry and the loss by at most
  ``2·lr(1)·‖∇L‖₁`` (held with a factor 2 for the second-order term, plus
  ``1e-5`` relative).

Each copy also raises from ``main([])`` without CUDA: its default device is
the card, and there is no silent fallback to the CPU.
"""
import dataclasses
import importlib.util
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.convert import lm_params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
EXAMPLES = ("quickstart", "data_mining", "streaming_aggregation", "serve_queries",
            "serve_lm", "train_lm")


def _example(name):
    """``examples_torch/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(ROOT, "examples_torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_cuda_unless_cpu_is_named(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])


def test_quickstart_matches_the_reference():
    from repro.core import BlazeSession as JSession
    from repro.core import DistRange as JRange
    from repro.core import data_mesh as jdata_mesh
    from repro.core import distribute as jdistribute
    from repro.core import make_dist_hashmap as jmake_dist_hashmap
    from repro.core import map_reduce as jmap_reduce
    from repro.core import topk as jtopk
    from repro.core.algorithms import estimate_pi as jestimate_pi

    ex = _example("quickstart")
    got = ex.run(device="cpu", pi_samples=100_000, n_points=2000, iters=10)
    assert got["pi"] == jestimate_pi(100_000)
    assert got["pi_hits"] * 4 / 100_000 == got["pi"]

    def wc(line_idx, tokens, emit):
        emit(tokens, 1, mask=tokens >= 0)

    counts = jmap_reduce(jdistribute(ex.LINES), wc, "sum",
                         jmake_dist_hashmap(jdata_mesh(), 64, (), jnp.int32, "sum"))
    assert got["word_counts"] == {int(k): int(v) for k, v in counts.to_dict().items()}
    sums = jmap_reduce(JRange(0, 100, 1), lambda v, emit: emit(v % 4, v * v), "sum",
                       jnp.zeros((4,), jnp.int32))
    assert got["squares"] == [int(x) for x in sums]
    pts = jdistribute(np.random.RandomState(0).randn(2000, 3).astype(np.float32))
    want = jtopk(pts, 5, score_fn=lambda x: -jnp.sum(x * x))
    np.testing.assert_array_equal(got["closest"], np.asarray(want))
    sess, scale = JSession(), jnp.asarray(1.0)
    for _ in range(10):
        total = sess.map_reduce(JRange(0, 1000, 1), lambda v, emit, env: emit(0, v * env),
                                "sum", jnp.zeros((1,), jnp.float32), env=scale)
        scale = scale * 0.5
    assert got["total"] == float(total[0])
    assert got["session"]["compiles"] == 1 and got["session"]["cache_hits"] == 9


def test_data_mining_matches_the_reference():
    from repro.core import BlazeSession as JSession
    from repro.core.algorithms import gmm_em, kmeans, knn, pagerank
    from repro.data.synthetic import cluster_points, rmat_edges

    sizes = dict(rmat_scale=7, km_points=3000, gmm_points=900, knn_points=5000)
    got = _example("data_mining").run(device="cpu", **sizes)
    sess = JSession()
    edges = rmat_edges(scale=7, edges_per_node=16, seed=0)
    pr = pagerank(edges, 1 << 7, tol=1e-5, session=sess)
    assert got["pagerank"].iterations == pr.iterations
    np.testing.assert_allclose(got["pagerank"].scores, np.asarray(pr.scores), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got["pagerank_program"].scores, np.asarray(pr.scores),
                               atol=1e-5, rtol=0)
    km = kmeans(cluster_points(3000, 3, 5, seed=0)[0], 5, max_iters=30, session=sess)
    assert got["kmeans"].iterations == km.iterations
    np.testing.assert_allclose(got["kmeans"].centers, np.asarray(km.centers), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got["kmeans"].inertia, float(km.inertia), rtol=1e-4)
    gm = gmm_em(cluster_points(900, 2, 3, seed=1)[0], 3, max_iters=20, session=sess)
    g = got["gmm"]
    assert g.iterations == gm.iterations
    assert abs(g.log_likelihood - float(gm.log_likelihood)) <= 1e-5 * abs(
        float(gm.log_likelihood))
    for name in ("alpha", "mu", "sigma"):
        np.testing.assert_allclose(getattr(g, name), np.asarray(getattr(gm, name)),
                                   atol=1e-4, rtol=0, err_msg=name)
    nn = knn(cluster_points(5000, 4, 3, seed=2)[0], np.zeros(4, np.float32), k=100,
             session=sess)
    np.testing.assert_array_equal(got["knn"].neighbors, np.asarray(nn.neighbors))
    assert got["knn"].wire_candidates == nn.wire_candidates


def test_streaming_aggregation_matches_the_reference():
    from repro.core import BlazeSession as JSession
    from repro.core import make_dist_hashmap as jmake_dist_hashmap
    from repro.core.algorithms.wordcount import wordcount_mapper as jwordcount_mapper

    ex = _example("streaming_aggregation")
    got = ex.run(device="cpu")
    rng = np.random.RandomState(0)
    lines = rng.zipf(1.5, size=(256, 16)).clip(max=ex.VOCAB - 1).astype(np.int32)
    sess = JSession()
    lines_v = sess.distribute(lines)
    hm = jmake_dist_hashmap(sess.mesh, 4 * ex.VOCAB, (), jnp.int32, "sum")

    def hist_mapper(word, count, emit):
        emit(jnp.minimum(jnp.log2(jnp.maximum(count, 1)).astype(jnp.int32), 15), 1)

    def step(ctx, s):
        counts = ctx.map_reduce(lines_v, jwordcount_mapper, "sum", hm, engine="pallas",
                                key_range=ex.VOCAB)
        hist = ctx.map_reduce(counts, hist_mapper, "sum", jnp.zeros((16,), jnp.int32))
        return {"hist": hist, "round": s["round"] + 1}

    prog = sess.program(step)
    state = {"hist": jnp.zeros((16,), jnp.int32), "round": jnp.zeros((), jnp.int32)}
    state, info = sess.run_loop(prog, state, max_iters=ex.ROUNDS, unroll=ex.UNROLL)
    want = {int(k): int(v) for k, v in prog.hash_result(hm).to_dict().items()}
    assert got["counts"] == want
    np.testing.assert_array_equal(got["hist"], np.asarray(state["hist"]))
    assert (got["info"].iterations, got["info"].dispatches) == (info.iterations,
                                                               info.dispatches)


def test_serve_queries_matches_the_reference():
    """Every reply against the reference's ``run_direct`` on the same
    datasets (the standard smoke-scale ones, seed 0), on a fresh session."""
    from repro.core import BlazeSession as JSession
    from repro.launch.serve import build_server as jbuild_server
    from repro.serve import run_direct

    ex = _example("serve_queries")
    got = ex.run(device="cpu", tenants=("alice", "bob"))
    assert got["stats"]["completed"] == 12 and got["stats"]["compiles"] == 6
    datasets = jbuild_server(scale="smoke").datasets
    want_of = {}
    for query, params in ex.QUERIES:
        jsess = JSession()
        want_of[query] = run_direct(jsess, jsess.mesh, datasets, query, params)
    for (tenant, query), (res, meta) in got["results"].items():
        want = want_of[query]
        if query == "pi":
            assert res["pi"] == want["pi"]
        elif query == "wordcount":
            np.testing.assert_array_equal(res["keys"], np.asarray(want["keys"]))
            np.testing.assert_array_equal(res["counts"], np.asarray(want["counts"]))
        elif query == "pagerank":
            assert float(np.abs(np.asarray(res["scores"]) - np.asarray(want["scores"]))
                         .max()) <= 1e-5
            assert abs(res["delta"] - want["delta"]) <= 1e-5
        elif query == "kmeans":
            assert float(np.abs(np.asarray(res["centers"]) - np.asarray(want["centers"]))
                         .max()) <= 1e-4
            assert abs(res["inertia"] - want["inertia"]) <= 1e-4 * abs(want["inertia"])
        elif query == "gmm":
            for name in ("alpha", "mu", "sigma"):
                np.testing.assert_allclose(res[name], np.asarray(want[name]), atol=1e-4,
                                           rtol=0, err_msg=name)
            assert abs(res["log_likelihood"] - want["log_likelihood"]) <= 1e-5 * abs(
                want["log_likelihood"])
        else:
            assert {tuple(r) for r in np.asarray(res["neighbors"]).tolist()} == {
                tuple(r) for r in np.asarray(want["neighbors"]).tolist()}
            np.testing.assert_allclose(np.sort(res["distances"]),
                                       np.sort(np.asarray(want["distances"])), rtol=1e-6)


def test_serve_lm_matches_the_reference():
    from repro.configs.base import get_arch as jget_arch
    from repro.launch import serve_lm as jserve
    from repro.models import model as JM
    from repro_torch.configs.base import get_arch

    ex = _example("serve_lm")
    cfgs, params, jparams = {}, {}, {}
    for arch in ex.ARCHS:
        cfg_j = jget_arch(arch).reduced()
        jparams[arch] = JM.init(jax.random.PRNGKey(0), cfg_j)
        cfgs[arch] = get_arch(arch).reduced()
        params[arch] = lm_params_from_jax(jax.tree.map(np.asarray, jparams[arch]),
                                          cfgs[arch], CPU)
    got = ex.run(device="cpu", params=params, cfg=cfgs, gen=8, max_len=32)
    for arch in ex.ARCHS:
        r = got[arch]
        assert r["tokens"].shape == (ex.BATCH, 8)
        want, _ = jserve.generate(jget_arch(arch).reduced(), jparams[arch],
                                  jnp.asarray(r["prompts"].numpy().astype(np.int32)), 32, 8)
        want = np.asarray(want)
        for row in range(ex.BATCH):
            differ = np.nonzero(r["tokens"][row].numpy() != want[row])[0]
            if len(differ):  # only where the port's own top-2 were within 2e-4
                top2 = torch.topk(r["logits"][row, differ[0]], 2).values
                assert float(top2[0] - top2[1]) <= 2e-4, (arch, row, differ)


def test_train_lm_matches_the_reference():
    from repro.configs.base import get_arch as jget_arch
    from repro.data.pipeline import TokenPipeline as JPipeline
    from repro.models import model as JM
    from repro.optim.adamw import AdamW as JAdamW
    from repro.optim.adamw import warmup_cosine as jwarmup_cosine
    from repro.runtime.train_loop import train as jtrain
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import warmup_cosine
    from repro_torch.runtime.train_loop import value_and_grad

    ex = _example("train_lm")
    small = dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
                 n_stages=2, n_layers=2)
    cfg = dataclasses.replace(ex.config(), **small)
    cfg_j = dataclasses.replace(jget_arch("qwen3-0.6b"), name="qwen3-100m",
                                param_dtype="float32", compute_dtype="float32", **small)
    params_j = JM.init(jax.random.PRNGKey(0), cfg_j)
    params = lm_params_from_jax(jax.tree.map(np.asarray, params_j), cfg, CPU)
    horizon, batch, seq = 300, 4, 32
    got = ex.run(device="cpu", steps=2, batch=batch, seq=seq, grad_accum=2,
                 params=params, cfg=cfg, horizon=horizon)
    with tempfile.TemporaryDirectory() as d:
        want = jtrain(cfg_j, steps=2, batch=batch, seq_len=seq, pipeline=JPipeline(
            cfg_j, batch=batch, seq_len=seq, seed=0), ckpt_dir=d, ckpt_every=25,
            optimizer=JAdamW(lr=jwarmup_cosine(3e-4, horizon // 10, horizon)),
            grad_accum=2, params=params_j)
    assert got.final_step == want.final_step == 2
    np.testing.assert_allclose(got.losses[0], want.losses[0], rtol=1e-5)
    # the second loss: within one AdamW step's reach of the reference's
    lr1 = float(warmup_cosine(3e-4, horizon // 10, horizon)(torch.tensor(1)))
    inputs = TokenPipeline(cfg, batch=batch, seq_len=seq, seed=0).device_batch(1, CPU)
    _, grads = value_and_grad(params, lambda p, x, y: M.loss_fn(p, cfg, x, y),
                              inputs["inputs"], inputs["labels"])
    g1 = sum(float(g.abs().sum()) for g in M.distinct_leaves(grads))
    bound = 2 * (2 * lr1 * g1) + 1e-5 * abs(want.losses[1])
    assert abs(got.losses[1] - want.losses[1]) <= bound, (got.losses, want.losses, bound)
