"""The port's LM stack against the JAX package's at the published head
geometry of the three dense configs served at full depth on the card:
gemma2-9b (16 query heads over 8 kv heads of 256, attention softcap 50,
final softcap 30, a local and a global layer a stage), stablelm-3b (32 MHA
heads of 80) and starcoder2-15b (48 query heads over 4 kv heads of 128,
``rope_theta`` 1e5).

``reduced()`` puts every model at ``d_head = 16`` with at most 4 query and
2 kv heads, so the CPU suites never run these heads.  Here each config
keeps its own ``n_heads``, ``n_kv_heads``, ``d_head``, softcaps,
``rope_theta`` and stage pattern, cut to 2 layers (gemma2: one local +
global stage), ``d_model = 256``, ``d_ff = 128``, ``vocab = 512``, in f32;
gemma2's window is 16, so it masks at the test's lengths (a 24-token prompt,
a 33-row cache: the local layers take the window's view).  The JAX
parameters come from ``jax.random.PRNGKey(0)`` and cross by
``convert.lm_params_from_jax``.

Tolerances: ``tests/test_torch_models.py``'s ``atol = rtol = 1e-4`` (the
same f32 sums in other orders over 2 layers of O(1) activations).  Greedy
tokens must be equal until a step whose top-2 logits lie within ``2·1e-4``.

Run on the CPU:  PYTHONPATH=src python -m pytest -q tests/test_torch_head_geometry.py
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.launch import serve_lm as jserve
from repro.models import model as JM
from repro_torch.configs.base import get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve_lm
from repro_torch.launch.serve_lm import DecodeGraph
from repro_torch.models import model as M

ARCHS = ["gemma2-9b", "stablelm-3b", "starcoder2-15b"]
TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")
PROMPT, STEPS = 24, 8
ROWS = PROMPT + STEPS + 1  # past gemma2's window of 16 + 1


def at_published_heads(cfg):
    """``cfg`` with its own heads, softcaps, ``rope_theta`` and stage
    pattern, cut to 2 layers of width 256 (``d_ff`` 128, vocab 512) in f32;
    a window cut to 16."""
    return dataclasses.replace(
        cfg, name=cfg.name + "-heads", n_layers=2, n_stages=2 // len(cfg.stage_pattern),
        d_model=256, d_ff=128, vocab=512, window=16 if cfg.window else None,
        param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """``(jax cfg, jax params, port cfg, port params)``, the same weights."""
    cfg_j = at_published_heads(jget_arch(request.param))
    params_np = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), cfg_j))
    cfg_t = at_published_heads(get_arch(request.param))
    return cfg_j, jax.tree.map(jnp.asarray, params_np), cfg_t, lm_params_from_jax(
        params_np, cfg_t, CPU)


def _tokens(cfg, b, s, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, s)).astype(np.int32)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_forward_matches_jax(lm):
    cfg_j, params_j, cfg, params = lm
    full = get_arch(cfg.name.removesuffix("-heads"))
    for field in ("n_heads", "n_kv_heads", "d_head", "attn_softcap", "final_softcap",
                  "rope_theta", "stage_pattern", "tie_embeddings"):
        assert getattr(cfg, field) == getattr(full, field), field
    assert M.layer_kinds(cfg) == list(full.stage_pattern) * (2 // len(full.stage_pattern))
    x = _tokens(cfg, 2, 40)
    want, _, _ = JM.forward(params_j, cfg_j, jnp.asarray(x))
    got, _, _ = M.forward(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(M.logits_fn(params, cfg, got)),
                               np.asarray(JM.logits_fn(params_j, cfg_j, want)), **TOL)
    assert M.param_count(params) == JM.param_count(params_j)


def test_decode_steps_match_jax_with_int_and_device_positions(lm):
    """A prefill, then 8 teacher-forced decode steps: the position as an
    ``int`` and as a 0-d tensor (``DecodeGraph``'s eager twin, which moves
    it on itself), every step's logits against JAX's."""
    cfg_j, params_j, cfg, params = lm
    x = _tokens(cfg, 2, PROMPT + STEPS, seed=1)
    xt = torch.from_numpy(x).long()
    by_int, by_tensor = M.make_caches(cfg, 2, ROWS, CPU), M.make_caches(cfg, 2, ROWS, CPU)
    cj = JM.make_caches(cfg_j, 2, ROWS)
    want, cj = JM.prefill(params_j, cfg_j, jnp.asarray(x[:, :PROMPT]), cj)
    for caches in (by_int, by_tensor):
        got, _ = M.prefill(params, cfg, xt[:, :PROMPT], caches)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    twin = DecodeGraph(cfg, params, by_tensor, xt[:, PROMPT:PROMPT + 1], PROMPT,
                       capture=False)
    for i in range(PROMPT, PROMPT + STEPS):
        want, cj = JM.decode_step(params_j, cfg_j, jnp.asarray(x[:, i:i + 1]), cj, i)
        got_int, _ = M.decode_step(params, cfg, xt[:, i:i + 1], by_int, i)
        got_tensor = twin.step(xt[:, i:i + 1])
        for got in (got_int, got_tensor):
            np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert twin.pos == int(twin.position) == PROMPT + STEPS


def test_decode_matches_forward(lm):
    """Inside the port: decode after a prefill equals the teacher-forced
    forward's logits."""
    _, _, cfg, params = lm
    x = torch.from_numpy(_tokens(cfg, 2, PROMPT + STEPS, seed=2)).long()
    full = M.logits_fn(params, cfg, M.forward(params, cfg, x)[0])
    caches = M.make_caches(cfg, 2, ROWS, CPU)
    step, _ = M.prefill(params, cfg, x[:, :PROMPT], caches)
    np.testing.assert_allclose(_np(step), _np(full[:, PROMPT - 1]), **TOL)
    for i in range(PROMPT, PROMPT + STEPS):
        step, _ = M.decode_step(params, cfg, x[:, i:i + 1], caches, i)
        np.testing.assert_allclose(_np(step), _np(full[:, i]), **TOL)


def test_generate_matches_jax(lm):
    """Greedy tokens of the port's ``generate`` against the reference's."""
    cfg_j, params_j, cfg, params = lm
    prompts = _tokens(cfg, 3, PROMPT, seed=3)
    want, _ = jserve.generate(cfg_j, params_j, jnp.asarray(prompts), ROWS, STEPS)
    got, _, logits = serve_lm.generate(cfg, params, torch.from_numpy(prompts).long(), ROWS,
                                       STEPS, return_logits=True)
    assert got.shape == (3, STEPS) and torch.equal(got, logits[:, :STEPS].argmax(-1))
    want = np.asarray(want)
    for row in range(3):
        differ = np.nonzero(_np(got[row]) != want[row])[0]
        if len(differ):  # only where the port's own top-2 were within tolerance
            top2 = torch.topk(logits[row, differ[0]], 2).values
            assert float(top2[0] - top2[1]) <= 2 * TOL["atol"], (row, differ)
