"""The port's optimiser and training loop against the JAX package's:
``optim.adamw`` (``AdamW``, ``warmup_cosine``), ``runtime.train_loop``
(``make_train_step`` with gradient accumulation, ``train`` with restarts)
and ``launch.train``, at ``reduced()`` size on the CPU.

Tolerances, stated per check:

* AdamW, 3 steps from the reference's state at step 5 (non-zero moments,
  so bias correction matters): both run the same f32 formula; XLA may
  round a fused expression differently by an ulp (a fused multiply-add
  rounds once where PyTorch rounds twice), so ``m`` and ``v`` agree within
  ``rtol = 1e-6`` plus ``2^-20·max|ref|`` a leaf (where ``b1·m`` and
  ``(1 − b1)·g`` nearly cancel, an ulp of the addends, not of the sum), the
  parameters within ``rtol = 1e-6`` plus ``atol = 1e-6·lr`` (a few ulps of
  the O(1) step ``m̂/√v̂``, times ``lr``).  With bf16 moments an ulp in f32 can flip a bf16 rounding: ``m`` and
  ``v`` within one bf16 step (``2^-7`` relative), the parameters within
  ``lr·2^-6`` (a step's ``m̂/√v̂`` moves by at most two bf16 steps).
* A training step (reduced qwen3-0.6b, f32): the loss within ``rtol =
  1e-5`` (as ``tests/test_torch_train.py``); the parameters, one AdamW step
  of ``lr = 1e-3`` from the same point, within ``atol = 1e-3·lr``.  The
  first step moves each parameter by ``lr·g/(|g| + eps)``, whose slope in
  ``g`` is up to ``1/eps``: with the default ``eps = 1e-8`` a gradient's
  f32 rounding (~1e-9 absolute here) could move an entry near 0 by a
  sizeable part of ``lr``, so these steps take ``eps = 1e-4``, and a
  rounding of ``δ`` moves a parameter by at most ``lr·δ/1e-4``.
* ``grad_accum = 2`` against 1 on the same batch: the same sums
  regrouped, the same bounds.
* Resumed against uninterrupted runs, inside the port: bit for bit.
"""
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.models import model as JM
from repro.optim import adamw as JO
from repro.runtime import train_loop as JT
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import SHARED_ATTN, get_arch
from repro_torch.convert import lm_params_from_jax, opt_state_from_jax
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.runtime import train_loop as T

CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               want.detach().float().numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference_from_a_mid_run_state(moment_dtype, schedule):
    """zamba2 (its shared block is one entry of the JAX tree and one set of
    tensors in the port's), 5 reference steps, then 3 in both packages on
    the same gradients.

    Weight decay applies to tensors of 2 or more dimensions.  The reference
    tests the dimension of its stacked ``[n_stages, ...]`` leaves, so it
    also decays the norm scales and the other 1-D parameters of its scanned
    stages (ROADMAP Queue 3 item 13); the port tests each layer's own
    tensor.  So a port tensor of fewer than 2 dimensions is held to the
    reference's run with ``weight_decay = 0`` from the same state (where
    the reference's own rule agrees: its tail and final norms), the others
    to its run with the decay."""
    cfg_j, cfg_t = jget_arch("zamba2-7b").reduced(), get_arch("zamba2-7b").reduced()
    lr, wd = 1e-2, 0.1
    sched_j = lr if schedule == "constant" else JO.warmup_cosine(lr, 6, 10)
    sched_t = lr if schedule == "constant" else warmup_cosine(lr, 6, 10)
    opt_j = {w: JO.AdamW(lr=sched_j, weight_decay=w, moment_dtype=moment_dtype)
             for w in (wd, 0.0)}
    update_j = {w: jax.jit(o.update) for w, o in opt_j.items()}
    opt_t = AdamW(lr=sched_t, weight_decay=wd, moment_dtype=moment_dtype)
    params_j = JM.init(jax.random.PRNGKey(0), cfg_j)
    state_j = opt_j[wd].init(params_j)
    rng = np.random.RandomState(0)

    def grads():
        return jax.tree.map(lambda p: (0.1 * rng.randn(*p.shape)).astype(np.float32),
                            params_j)

    for _ in range(5):
        params_j, state_j = update_j[wd](jax.tree.map(jnp.asarray, grads()), state_j,
                                         params_j)
    params_t = lm_params_from_jax(_np_tree(params_j), cfg_t, CPU)
    state_t = opt_state_from_jax(_np_tree(state_j), cfg_t, CPU)
    assert int(state_t["step"]) == 5 and float(M.distinct_leaves(state_t["m"])[0]
                                                 .abs().max()) > 0
    runs = {w: (params_j, state_j) for w in opt_j}  # w -> (params, state)
    for _ in range(3):
        g = grads()
        runs = {w: update_j[w](jax.tree.map(jnp.asarray, g), s, p)
                for w, (p, s) in runs.items()}
        out = opt_t.update(lm_params_from_jax(g, cfg_t, CPU), state_t, params_t)
        assert out[0] is params_t and out[1] is state_t  # updated in place
    assert int(state_t["step"]) == 8
    want_p = {w: M.distinct_leaves(lm_params_from_jax(_np_tree(runs[w][0]), cfg_t, CPU))
              for w in runs}
    want_s = opt_state_from_jax(_np_tree(runs[wd][1]), cfg_t, CPU)
    bf16 = moment_dtype == "bfloat16"
    for i, got in enumerate(M.distinct_leaves(params_t)):
        want = want_p[wd if got.ndim >= 2 else 0.0][i]
        _close(got, want, 0 if bf16 else 1e-6, lr * 2 ** -6 if bf16 else 1e-6 * lr)
    for key in ("m", "v"):
        for got, want in zip(M.distinct_leaves(state_t[key]),
                             M.distinct_leaves(want_s[key])):
            assert got.dtype == getattr(torch, moment_dtype)
            _close(got, want, 2 ** -7 if bf16 else 1e-6,
                   2 ** -20 * float(want.float().abs().max()))
    shared = [i for i, k in enumerate(M.layer_kinds(cfg_t)) if k == SHARED_ATTN]
    assert all(params_t["layers"][i] is params_t["shared_attn"] for i in shared)
    assert all(state_t["m"]["layers"][i] is state_t["m"]["shared_attn"] for i in shared)


def test_adamw_decays_matrices_only():
    cfg = get_arch("qwen3-0.6b").reduced()
    params = M.init(torch.Generator().manual_seed(0), cfg)
    before = [t.clone() for t in M.distinct_leaves(params)]
    opt = AdamW(lr=0.1, weight_decay=0.5)
    state = opt.init(params)
    opt.update(M.map_tree(torch.zeros_like, params), state, params)
    for old, new in zip(before, M.distinct_leaves(params)):
        if old.ndim >= 2:
            torch.testing.assert_close(new, old * (1 - 0.1 * 0.5), rtol=1e-6, atol=0)
        else:
            assert torch.equal(new, old)


def test_warmup_cosine_matches_reference():
    sched_j, sched_t = JO.warmup_cosine(3e-4, 5, 50), warmup_cosine(3e-4, 5, 50)
    for step in (0, 1, 4, 5, 6, 27, 50, 60):
        want = float(sched_j(jnp.asarray(step, jnp.int32)))
        assert float(sched_t(torch.tensor(step, dtype=torch.int32))) == pytest.approx(
            want, rel=1e-6)


def _step_setup(seed=0):
    cfg_j, cfg_t = jget_arch("qwen3-0.6b").reduced(), get_arch("qwen3-0.6b").reduced()
    params_np = _np_tree(JM.init(jax.random.PRNGKey(seed), cfg_j))
    batch = TokenPipeline(cfg_t, batch=4, seq_len=16, seed=seed).host_batch(3)
    return cfg_j, cfg_t, params_np, batch


@pytest.mark.parametrize("accum_mode", ["eager", "per_microbatch"])
def test_train_step_with_grad_accum_matches_reference(accum_mode):
    cfg_j, cfg_t, params_np, batch = _step_setup()
    lr = 1e-3
    # No decay: the reference decays its stacked 1-D leaves (Queue 3 item 13),
    # which the AdamW test covers; this one is about the accumulation.
    opt_j = JO.AdamW(lr=lr, weight_decay=0.0, eps=1e-4)
    step_j = jax.jit(JT.make_train_step(cfg_j, opt_j, grad_accum=2,
                                        accum_mode=accum_mode))
    pj = jax.tree.map(jnp.asarray, params_np)
    pj, sj, loss_j = step_j(pj, opt_j.init(pj), jax.tree.map(jnp.asarray, batch))
    params = lm_params_from_jax(params_np, cfg_t, CPU)
    opt_t = AdamW(lr=lr, weight_decay=0.0, eps=1e-4)
    step_t = T.make_train_step(cfg_t, opt_t, grad_accum=2, accum_mode=accum_mode,
                               device="cpu")
    params, state, loss = step_t(params, opt_t.init(params),
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    want = M.distinct_leaves(lm_params_from_jax(_np_tree(pj), cfg_t, CPU))
    for got, w in zip(M.distinct_leaves(params), want):
        _close(got, w, 0, 1e-3 * lr)
    assert int(state["step"]) == 1


def test_grad_accum_two_equals_one():
    _, cfg, params_np, batch = _step_setup(seed=1)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for accum in (1, 2):
        params = lm_params_from_jax(params_np, cfg, CPU)
        opt = AdamW(lr=1e-3, eps=1e-4)
        step = T.make_train_step(cfg, opt, grad_accum=accum, device="cpu")
        params, _, loss = step(params, opt.init(params), batch)
        out.append((loss, M.distinct_leaves(params)))
    np.testing.assert_allclose(float(out[1][0]), float(out[0][0]), rtol=1e-5)
    for a, b in zip(out[0][1], out[1][1]):
        _close(b, a, 0, 1e-6)


def test_training_reduces_loss(tmp_path):
    """Mirrors ``tests/test_models.py::test_training_reduces_loss``."""
    cfg = get_arch("qwen3-0.6b").reduced()
    pipe = TokenPipeline(cfg, batch=4, seq_len=16)
    res = T.train(cfg, steps=25, batch=4, seq_len=16, pipeline=pipe,
                  ckpt_dir=str(tmp_path), ckpt_every=10, optimizer=AdamW(lr=1e-3),
                  device="cpu")
    assert res.losses[-1] < res.losses[0]
    assert [c["step"] for c in res.checkpoints] == [10, 20, 25]


def _checkpoint_leaves(directory, step):
    with np.load(os.path.join(directory, f"step_{step:08d}", "arrays.npz")) as f:
        return [f[k] for k in sorted(f.files, key=lambda k: int(k.split("_")[1]))]


def test_training_restart_resumes_not_restarts(tmp_path):
    """Mirrors ``tests/test_models.py::test_training_restart_resumes_not_restarts``;
    the resumed run's final parameters and optimiser state (its step-20
    checkpoint) equal an uninterrupted run's bit for bit."""
    cfg = get_arch("qwen3-0.6b").reduced()
    pipe = TokenPipeline(cfg, batch=2, seq_len=8)
    kw = dict(steps=20, batch=2, seq_len=8, pipeline=pipe, ckpt_every=5, device="cpu")
    res = T.train(cfg, ckpt_dir=str(tmp_path / "crash"), crash_at_step=12, **kw)
    assert res.restarts == 1
    assert res.final_step == 20
    # resumed from step 10 (last ckpt), not from scratch: 12 + (20-10)
    assert res.steps_run == 12 + 10
    full = T.train(cfg, ckpt_dir=str(tmp_path / "full"), **kw)
    assert full.steps_run == 20 and full.losses == res.losses[:12] + res.losses[12:][-8:]
    got = _checkpoint_leaves(str(tmp_path / "crash"), 20)
    want = _checkpoint_leaves(str(tmp_path / "full"), 20)
    assert len(got) == len(want) > 0
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_zamba2_restart_keeps_the_shared_block_shared(tmp_path, monkeypatch):
    cfg = get_arch("zamba2-7b").reduced()
    shared = [i for i, k in enumerate(M.layer_kinds(cfg)) if k == SHARED_ATTN]
    seen = []
    make = T.make_train_step

    def watching(*a, **kw):
        step = make(*a, **kw)

        def run(params, opt_state, batch):
            out = step(params, opt_state, batch)
            seen.append(all(params["layers"][i] is params["shared_attn"]
                            and opt_state["m"]["layers"][i] is opt_state["m"]["shared_attn"]
                            for i in shared))
            return out

        return run

    monkeypatch.setattr(T, "make_train_step", watching)
    pipe = TokenPipeline(cfg, batch=2, seq_len=8)
    res = T.train(cfg, steps=6, batch=2, seq_len=8, pipeline=pipe, ckpt_every=2,
                  crash_at_step=3, ckpt_dir=str(tmp_path), device="cpu",
                  optimizer=AdamW(lr=1e-3))
    assert res.restarts == 1 and res.steps_run == 3 + 4 and all(seen) and len(seen) == 7
    # the checkpoint holds the shared block once: params, m, v and the step
    params = M.init(torch.Generator().manual_seed(0), cfg)
    n = len(M.distinct_leaves(params))
    assert len(_checkpoint_leaves(str(tmp_path), 6)) == 3 * n + 1
    # and a restore into a fresh tree keeps it shared, with the trained values
    p0 = M.init(torch.Generator().manual_seed(0), cfg)
    opt = AdamW(lr=1e-3)
    view = T._ckpt_tree(p0, opt.init(p0))
    _, restored = CheckpointManager(str(tmp_path)).restore_latest(view)
    leaves = torch.utils._pytree.tree_leaves(restored)
    assert len(leaves) == 3 * n + 1


def test_train_leaves_callers_params_unchanged(tmp_path):
    cfg = get_arch("qwen3-0.6b").reduced()
    params = M.init(torch.Generator().manual_seed(3), cfg)
    before = [t.clone() for t in M.distinct_leaves(params)]
    res = T.train(cfg, steps=2, batch=2, seq_len=8, params=params,
                  pipeline=TokenPipeline(cfg, batch=2, seq_len=8),
                  ckpt_dir=str(tmp_path), device="cpu", optimizer=AdamW(lr=1e-2))
    assert res.final_step == 2
    for old, new in zip(before, M.distinct_leaves(params)):
        assert torch.equal(old, new) and not new.requires_grad


def test_launch_train_prints_the_reference_keys(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main(["--arch", "qwen3-0.6b", "--steps", "3", "--batch", "2",
                           "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    res = json.loads(out.getvalue())
    assert set(res) == {"arch", "steps", "loss_first", "loss_last", "restarts",
                        "straggler"}
    assert res["arch"] == "qwen3-0.6b-reduced" and res["steps"] == 3
    assert res["straggler"]["steps"] == 3


def test_launch_train_takes_an_moe_arch(tmp_path):
    """Reduced mixtral-8x22b (MoE, sliding window) through ``launch.train``:
    its loss carries the balance term and falls in 8 steps."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main(["--arch", "mixtral-8x22b", "--steps", "8", "--batch", "2",
                           "--seq", "16", "--lr", "1e-3", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)])
    res = json.loads(out.getvalue())
    assert res["arch"] == "mixtral-8x22b-reduced" and res["steps"] == 8
    assert np.isfinite(res["loss_first"]) and res["loss_last"] < res["loss_first"]


def test_train_defaults_to_the_card():
    cfg = get_arch("qwen3-0.6b").reduced()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.make_train_step(cfg, AdamW())
