"""The captured training step (``runtime.train_loop.TrainGraph``, the
counterpart of the reference's ``jax.jit(step_fn, donate_argnums=(0, 1))``)
and ``train(jit=...)``, on the CPU.

A CUDA graph needs a card, so here the step runs through its eager twin,
``TrainGraph(capture=False)``: ``make_train_step``'s own step over the same
static batch buffers, op by op.  It must equal the step called directly bit
for bit (losses, every distinct parameter, ``m``, ``v`` and ``step``), and
``train(jit=True)`` on the CPU must equal ``train(jit=False)`` bit for bit
(losses and checkpoints), with no capture.  The graph itself, replays and
launch counts included, is held to its eager twin in
``tests/test_torch_cuda.py``.

Against the reference: the port's ``train(jit=True)`` and the reference's
``train(jit=True)`` (``jax.jit`` of its step) on reduced qwen3-0.6b, the same
weights and batches, 3 steps of AdamW with ``lr = 1e-3``, ``weight_decay =
0`` (the reference decays its stacked 1-D leaves: ROADMAP Queue 3 item 13)
and ``eps = 1e-4``: every loss within ``rtol = 1e-5``, the bound that
``tests/test_torch_train_loop.py``'s docstring states for a step.

Parameters come from ``M.init`` with a seeded ``torch.Generator`` (or the
reference's ``JM.init`` where JAX runs too), batches from numpy
(``TokenPipeline``, ``np.random.RandomState``).

Run on the CPU:  PYTHONPATH=src python -m pytest -q tests/test_torch_train_graph.py
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import model as JM
from repro.optim import adamw as JO
from repro.runtime import train_loop as JT
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import SHARED_ATTN, get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.program import GraphStats
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.runtime import train_loop as T

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5  # a step against the reference (tests/test_torch_train_loop.py)


def _batches(cfg, n, batch=4, seq=16, seed=0):
    rng = np.random.RandomState(seed)
    return [{"inputs": torch.from_numpy(rng.randint(0, cfg.vocab, (batch, seq)).astype(np.int32)),
             "labels": torch.from_numpy(rng.randint(0, cfg.vocab, (batch, seq)).astype(np.int32))}
            for _ in range(n)]


def _state(cfg, opt, seed=0):
    params = M.init(torch.Generator().manual_seed(seed), cfg)
    return params, opt.init(params)


def _bits(params, state) -> list:
    return (M.distinct_leaves(params) + M.distinct_leaves(state["m"])
            + M.distinct_leaves(state["v"]) + [state["step"]])


@pytest.mark.parametrize("arch,accum", [("qwen3-0.6b", 1), ("qwen3-0.6b", 2),
                                        ("zamba2-7b", 1)])
def test_eager_twin_equals_make_train_step_bit_for_bit(arch, accum):
    """3 steps of the twin against 3 calls of the step itself, from the same
    state and batches; zamba2's shared block stays one set of tensors."""
    cfg = get_arch(arch).reduced()
    opt = AdamW(lr=warmup_cosine(1e-2, 1, 3))
    batches = _batches(cfg, 3)
    step_fn = T.make_train_step(cfg, opt, grad_accum=accum, device="cpu")

    p_a, s_a = _state(cfg, opt)
    want = []
    for b in batches:
        p_a, s_a, loss = step_fn(p_a, s_a, b)
        want.append(loss.clone())

    p_b, s_b = _state(cfg, opt)
    twin = T.TrainGraph(step_fn, p_b, s_b, batches[0], capture=False, name=cfg.name)
    got = [twin.step(b).clone() for b in batches]
    assert twin.graph is None and twin.replays == 0 and twin.captured_launches == {}
    assert twin.params is p_b and twin.opt_state is s_b  # updated in place
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    a, b = _bits(p_a, s_a), _bits(p_b, s_b)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(s_b["step"]) == 3
    shared = [i for i, k in enumerate(M.layer_kinds(cfg)) if k == SHARED_ATTN]
    assert (arch == "zamba2-7b") == bool(shared)
    for i in shared:
        assert p_b["layers"][i] is p_b["shared_attn"]
        assert s_b["m"]["layers"][i] is s_b["m"]["shared_attn"]
        assert s_b["v"]["layers"][i] is s_b["v"]["shared_attn"]


def test_adamw_advances_the_step_counter_in_place():
    """A captured step reads and writes the counter's own storage, so the
    update must move it on in place, not rebind it."""
    cfg = get_arch("qwen3-0.6b").reduced()
    opt = AdamW(lr=warmup_cosine(1e-2, 2, 10))
    params, state = _state(cfg, opt)
    counter = state["step"]
    rng = np.random.RandomState(0)
    for n in (1, 2, 3):
        grads = M.map_tree(lambda p: torch.from_numpy(
            rng.randn(*p.shape).astype(np.float32)).to(p.dtype), params)
        out = opt.update(grads, state, params)
        assert out[1] is state and state["step"] is counter
        assert counter.dtype == torch.int32 and int(counter) == n


def test_capture_off_the_card_raises():
    cfg = get_arch("qwen3-0.6b").reduced()
    opt = AdamW()
    params, state = _state(cfg, opt)
    step_fn = T.make_train_step(cfg, opt, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        T.TrainGraph(step_fn, params, state, _batches(cfg, 1)[0], capture=True)
    # and the default asks for a capture
    with pytest.raises(ValueError, match="CUDA device"):
        T.TrainGraph(step_fn, params, state, _batches(cfg, 1)[0])


def test_graph_stats_count_captures_and_replays():
    st = GraphStats()
    st.captured({"flash_attention": 4, "flash_attention/f32": 4})
    for _ in range(3):
        st.replayed({"flash_attention": 4, "flash_attention/f32": 4})
    assert (st.captures, st.replays) == (1, 3)
    assert st.capture_launches == {"flash_attention": 4, "flash_attention/f32": 4}
    assert st.replay_launches == {"flash_attention": 12, "flash_attention/f32": 12}
    st.reset()
    assert (st.captures, st.replays, st.replay_launches, st.capture_launches) == (0, 0, {},
                                                                                 {})


def _leaves(directory, step):
    with np.load(os.path.join(directory, f"step_{step:08d}", "arrays.npz")) as f:
        return [f[k] for k in sorted(f.files, key=lambda k: int(k.split("_")[1]))]


def _restored_step(directory, cfg, opt):
    params, state = _state(cfg, opt)
    step, tree = CheckpointManager(directory).restore_latest(T._ckpt_tree(params, state))
    return step, int(tree["opt"]["step"])


@pytest.mark.parametrize("accum", [1, 2])
def test_train_jit_true_equals_jit_false_on_the_cpu(tmp_path, accum):
    """``jit=True`` on the CPU is the eager twin: the same losses and
    checkpoints as ``jit=False``, bit for bit, and no capture; a checkpoint
    after N steps holds step N."""
    cfg = get_arch("qwen3-0.6b").reduced()
    pipe = TokenPipeline(cfg, batch=4, seq_len=16)
    runs = {}
    for jit in (True, False):
        runs[jit] = T.train(cfg, steps=5, batch=4, seq_len=16, pipeline=pipe,
                            ckpt_dir=str(tmp_path / str(jit)), ckpt_every=2,
                            optimizer=AdamW(lr=1e-3), grad_accum=accum, jit=jit,
                            device="cpu")
    a, b = runs[True], runs[False]
    assert a.losses == b.losses and a.steps_run == b.steps_run == 5
    assert (a.captures, a.replays, b.captures, b.replays) == (0, 0, 0, 0)
    assert [c["step"] for c in a.checkpoints] == [2, 4, 5]
    for step in (4, 5):
        got, want = _leaves(str(tmp_path / "True"), step), _leaves(str(tmp_path / "False"),
                                                                  step)
        assert len(got) == len(want) > 0
        assert all(np.array_equal(x, y) for x, y in zip(got, want))
    assert _restored_step(str(tmp_path / "True"), cfg, AdamW(lr=1e-3)) == (5, 5)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b"])
def test_twin_crash_and_resume_equals_the_uninterrupted_run(tmp_path, arch):
    """A crash at step 5 resumes from the step-4 checkpoint through a new
    twin; its final checkpoint equals an uninterrupted run's bit for bit."""
    cfg = get_arch(arch).reduced()
    pipe = TokenPipeline(cfg, batch=2, seq_len=8)
    kw = dict(steps=7, batch=2, seq_len=8, pipeline=pipe, ckpt_every=2, device="cpu",
              optimizer=AdamW(lr=warmup_cosine(1e-3, 1, 7)))
    crash = T.train(cfg, ckpt_dir=str(tmp_path / "crash"), crash_at_step=5, **kw)
    full = T.train(cfg, ckpt_dir=str(tmp_path / "full"), **kw)
    assert (crash.restarts, crash.final_step, crash.steps_run) == (1, 7, 5 + 3)
    assert crash.losses == full.losses[:5] + full.losses[4:]
    got, want = _leaves(str(tmp_path / "crash"), 7), _leaves(str(tmp_path / "full"), 7)
    assert len(got) == len(want) > 0
    assert all(np.array_equal(x, y) for x, y in zip(got, want))
    assert _restored_step(str(tmp_path / "crash"), cfg, AdamW()) == (7, 7)


def test_train_jit_matches_the_reference_jitted_train(tmp_path):
    """The port's ``train(jit=True)`` against the reference's (its step under
    ``jax.jit``): reduced qwen3-0.6b, the same weights and batches, 3 steps,
    every loss within ``LOSS_RTOL``."""
    cfg_j, cfg_t = jget_arch("qwen3-0.6b").reduced(), get_arch("qwen3-0.6b").reduced()
    params_np = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), cfg_j))
    pipe_j, pipe_t = JPipeline(cfg_j, batch=4, seq_len=16), TokenPipeline(cfg_t, batch=4,
                                                                          seq_len=16)
    for step in range(3):
        for k in ("inputs", "labels"):
            assert np.array_equal(pipe_j.host_batch(step)[k], pipe_t.host_batch(step)[k])
    kw = dict(steps=3, batch=4, seq_len=16, ckpt_every=3, grad_accum=2, jit=True)
    res_j = JT.train(cfg_j, pipeline=pipe_j, ckpt_dir=str(tmp_path / "jax"),
                     optimizer=JO.AdamW(lr=1e-3, weight_decay=0.0, eps=1e-4),
                     params=jax.tree.map(jax.numpy.asarray, params_np), **kw)
    res_t = T.train(cfg_t, pipeline=pipe_t, ckpt_dir=str(tmp_path / "port"),
                    optimizer=AdamW(lr=1e-3, weight_decay=0.0, eps=1e-4),
                    params=lm_params_from_jax(params_np, cfg_t, CPU), device="cpu", **kw)
    assert res_t.steps_run == res_j.steps_run == 3 and res_t.captures == 0
    np.testing.assert_allclose(res_t.losses, res_j.losses, rtol=LOSS_RTOL)
