"""The port's LM stack (``repro_torch.models``, ``launch.serve_lm``) against
the JAX package's, on all ten architectures (the four dense attention ones,
the MoE ones mixtral-8x22b and grok-1-314b, zamba2-7b with Mamba-2 and
shared attention, rwkv6-1.6b, and qwen2-vl-2b (M-RoPE) and musicgen-medium,
which take embeddings) at ``reduced()`` size (f32), with the same weights:
JAX's ``M.init`` pytree, carried across by ``convert.lm_params_from_jax``
(norm scales perturbed off their zero init, so a misplaced ``1 + scale``
shows).  The archs that take embeddings are driven on random ``[B, S, d]``
embeddings; ``generate`` refuses them (it feeds tokens back) and
``serve_lm.serve_embeddings`` serves them.

Tolerances: everything is f32 on both sides; the two packages sum the same
products in other orders (XLA's and PyTorch's CPU matmuls, the chunked
against the materialised attention), ~1e-6 relative per op over 2–4 layers
of O(1) activations, so hidden states and logits must agree within
``atol = rtol = 1e-4``.  Inside the port, decode against teacher-forced
forward is held to the same bound.  Greedy tokens must be equal until a
step whose top-2 logits lie within ``2·1e-4`` of each other, where either
package may take either token.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.configs.base import list_archs as jlist_archs
from repro.launch import serve_lm as jserve
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs.base import MAMBA2, SHARED_ATTN, get_arch, list_archs
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve_lm
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M

ARCHS = ["gemma2-9b", "grok-1-314b", "mixtral-8x22b", "musicgen-medium", "qwen2-vl-2b",
         "qwen3-0.6b", "rwkv6-1.6b", "stablelm-3b", "starcoder2-15b", "zamba2-7b"]
ATTN_ARCHS = [a for a in ARCHS if a != "rwkv6-1.6b"]  # those with an attention block
TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """``(jax cfg, jax params, port cfg, port params)`` of one reduced arch."""
    cfg_j = jget_arch(request.param).reduced()
    params_np = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), cfg_j))
    rng = np.random.RandomState(1)

    def perturb(path, x):
        if getattr(path[-1], "key", None) == "scale":
            return (x + 0.1 * rng.randn(*x.shape)).astype(x.dtype)
        return x

    params_np = jax.tree_util.tree_map_with_path(perturb, params_np)
    params_j = jax.tree.map(jnp.asarray, params_np)
    cfg_t = get_arch(request.param).reduced()
    return cfg_j, params_j, cfg_t, lm_params_from_jax(params_np, cfg_t, CPU)


def _tokens(cfg, b, s, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (b, s)).astype(np.int32)


def _inputs(cfg, b, s, seed=0):
    """Tokens ``[B, S]``, or embeddings ``[B, S, d]`` where the config takes
    them (as ``tests/test_models.py``'s ``_inputs``)."""
    if cfg.embed_inputs:
        return _tokens(cfg, b, s, seed)
    return np.random.RandomState(seed).randn(b, s, cfg.d_model).astype(np.float32)


def _positions(cfg, pos):
    """``pos [B, S]`` as the attention block takes them: ``[3, B, S]`` text
    positions under M-RoPE."""
    return np.broadcast_to(pos, (3, *pos.shape)).copy() if cfg.mrope_sections else pos


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_configs_copied_field_for_field():
    assert list_archs() == ARCHS == jlist_archs()
    for name in ARCHS:
        j, t = jget_arch(name), get_arch(name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
        assert t.pdtype == torch.bfloat16 and t.reduced().cdtype == torch.float32
    with pytest.raises(KeyError):
        get_arch("llama-3-8b")


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    scale = (0.1 * rng.randn(16)).astype(np.float32)
    pos = np.tile(np.arange(7, 12, dtype=np.int32), (2, 1))
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = L.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6, rtol=1e-6)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def _attention_block_case(lm, local):
    cfg_j, params_j, cfg_t, params_t = lm
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, cfg_t.d_model).astype(np.float32)
    pos = _positions(cfg_t, np.tile(np.arange(6, dtype=np.int32), (2, 1)))
    if "shared_attn" in params_j:  # zamba2: the one shared block
        pj, pt = params_j["shared_attn"]["attn"], params_t["shared_attn"]["attn"]
    else:
        pj = jax.tree.map(lambda a: a[0], params_j["stages"]["slot0"]["attn"])
        pt = params_t["layers"][0]["attn"]
    want, _ = JA.attn_apply(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos), local=local)
    got, _ = A.attn_apply(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(pos),
                          local=local)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # The same tokens written into a cache, then one more at position 6
    # (a 40-row cache, so gemma2's local layers take the window slice).
    cj, ct = JA.make_cache(cfg_j, 2, 40), A.make_cache(cfg_t, 2, 40, CPU)
    _, cj = JA.attn_apply(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos), local=local,
                          cache=cj, cache_len=0)
    A.attn_apply(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(pos), local=local,
                 cache=ct, cache_len=0)
    x1 = rng.randn(2, 1, cfg_t.d_model).astype(np.float32)
    p1 = _positions(cfg_t, np.full((2, 1), 6, np.int32))
    want, cj = JA.attn_apply(pj, cfg_j, jnp.asarray(x1), jnp.asarray(p1), local=local,
                             cache=cj, cache_len=6)
    got, ct = A.attn_apply(pt, cfg_t, torch.from_numpy(x1), torch.from_numpy(p1),
                           local=local, cache=ct, cache_len=6)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(ct.k), np.asarray(cj.k), **TOL)


@pytest.mark.parametrize("lm", ATTN_ARCHS, indirect=True)
def test_attention_block_matches_jax(lm):
    """One attention block, without and with a cache; gemma2 and mixtral
    also as a sliding-window layer."""
    for local in ([False, True] if lm[2].window else [False]):
        _attention_block_case(lm, local)


def test_forward_matches_jax(lm):
    cfg_j, params_j, cfg_t, params_t = lm
    x = _inputs(cfg_t, 2, 24)
    want, _, _ = JM.forward(params_j, cfg_j, jnp.asarray(x))
    got, caches, _ = M.forward(params_t, cfg_t, torch.from_numpy(x))
    assert caches is None and got.shape == (2, 24, cfg_t.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(_np(M.logits_fn(params_t, cfg_t, got)),
                               np.asarray(JM.logits_fn(params_j, cfg_j, want)), **TOL)
    assert M.param_count(params_t) == JM.param_count(params_j)
    assert M.active_param_count(params_t, cfg_t) == JM.active_param_count(params_j, cfg_j)


def test_prefill_and_decode_chain_match_jax(lm):
    """Prefill 36 tokens into a 48-row cache, then 4 teacher-forced decode
    steps; every step's logits against JAX's."""
    cfg_j, params_j, cfg_t, params_t = lm
    x = _inputs(cfg_t, 2, 40, seed=1)
    cj, ct = JM.make_caches(cfg_j, 2, 48), M.make_caches(cfg_t, 2, 48, CPU)
    want, cj = JM.prefill(params_j, cfg_j, jnp.asarray(x[:, :36]), cj)
    got, ct = M.prefill(params_t, cfg_t, torch.from_numpy(x[:, :36]), ct)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for i in range(36, 40):
        want, cj = JM.decode_step(params_j, cfg_j, jnp.asarray(x[:, i:i + 1]), cj, i)
        got, ct = M.decode_step(params_t, cfg_t, torch.from_numpy(x[:, i:i + 1]), ct, i)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("lm", ["qwen3-0.6b"], indirect=True)
def test_cache_write_past_its_end_raises(lm):
    """A 4-token prompt in a 5-row cache: the step that fills the last row
    matches JAX, the next one raises (JAX clamps its write to the last row
    instead), and ``generate`` refuses a cache shorter than ``P + gen``."""
    cfg_j, params_j, cfg_t, params_t = lm
    x = _tokens(cfg_t, 2, 6, seed=4)
    cj, ct = JM.make_caches(cfg_j, 2, 5), M.make_caches(cfg_t, 2, 5, CPU)
    _, cj = JM.prefill(params_j, cfg_j, jnp.asarray(x[:, :4]), cj)
    M.prefill(params_t, cfg_t, torch.from_numpy(x[:, :4]), ct)
    want, _ = JM.decode_step(params_j, cfg_j, jnp.asarray(x[:, 4:5]), cj, 4)
    got, ct = M.decode_step(params_t, cfg_t, torch.from_numpy(x[:, 4:5]), ct, 4)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="cannot write 1 rows at cache_len 5"):
        M.decode_step(params_t, cfg_t, torch.from_numpy(x[:, 5:6]), ct, 5)
    with pytest.raises(ValueError, match="max_len 12 < prompt 10 \\+ gen 3"):
        serve_lm.generate(cfg_t, params_t, torch.from_numpy(x[:, :4]).repeat(1, 3)[:, :10],
                          12, 3)


def test_decode_matches_forward(lm):
    """Inside the port: 4 decode steps after an 8-token prefill equal the
    teacher-forced forward's logits (``tests/test_models.py``'s check)."""
    _, _, cfg, params = lm
    x = torch.from_numpy(_inputs(cfg, 2, 12, seed=2))
    hid, _, _ = M.forward(params, cfg, x)
    full = M.logits_fn(params, cfg, hid)
    caches = M.make_caches(cfg, 2, 16, CPU)
    step, caches = M.prefill(params, cfg, x[:, :8], caches)
    np.testing.assert_allclose(_np(step), _np(full[:, 7]), **TOL)
    for i in range(8, 12):
        step, caches = M.decode_step(params, cfg, x[:, i:i + 1], caches, i)
        np.testing.assert_allclose(_np(step), _np(full[:, i]), **TOL)


def test_generate_matches_jax(lm):
    """Greedy tokens against JAX's ``generate``; an arch that takes
    embeddings is refused by ``generate`` and served by
    ``serve_embeddings``, every step's logits against JAX's prefill and
    decode steps on the same embeddings."""
    cfg_j, params_j, cfg_t, params_t = lm
    if not cfg_t.embed_inputs:
        x = _inputs(cfg_t, 3, 18, seed=3)
        with pytest.raises(ValueError, match="takes embeddings"):
            serve_lm.generate(cfg_t, params_t, torch.zeros((3, 10), dtype=torch.long),
                              19, 8)
        got, dt = serve_lm.serve_embeddings(cfg_t, params_t, torch.from_numpy(x[:, :10]),
                                            torch.from_numpy(x[:, 10:]), 19)
        assert got.shape == (3, 9, cfg_t.vocab) and dt > 0
        cj = JM.make_caches(cfg_j, 3, 19)
        want, cj = JM.prefill(params_j, cfg_j, jnp.asarray(x[:, :10]), cj)
        np.testing.assert_allclose(_np(got[:, 0]), np.asarray(want), **TOL)
        for i in range(10, 18):
            want, cj = JM.decode_step(params_j, cfg_j, jnp.asarray(x[:, i:i + 1]), cj, i)
            np.testing.assert_allclose(_np(got[:, i - 9]), np.asarray(want), **TOL)
        return
    prompts = _tokens(cfg_t, 3, 10, seed=3)
    want, _ = jserve.generate(cfg_j, params_j, jnp.asarray(prompts), 19, 8)
    got, dt, logits = serve_lm.generate(cfg_t, params_t, torch.from_numpy(prompts),
                                        19, 8, return_logits=True)
    assert got.shape == (3, 8) and logits.shape == (3, 9, cfg_t.vocab) and dt > 0
    assert torch.equal(got, logits[:, :8].argmax(-1))
    want = np.asarray(want)
    for row in range(3):
        differ = np.nonzero(_np(got[row]) != want[row])[0]
        if len(differ):  # only where the port's own top-2 were within tolerance
            top2 = torch.topk(logits[row, differ[0]], 2).values
            assert float(top2[0] - top2[1]) <= 2 * TOL["atol"], (row, differ)


def test_serve_lm_main_runs_on_the_cpu(capsys):
    serve_lm.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    out = capsys.readouterr().out
    assert '"arch": "qwen3-0.6b-reduced"' in out and '"decode_steps": 3' in out


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_serve_lm_main_serves_the_recurrent_archs(arch, capsys):
    serve_lm.main(["--arch", arch, "--reduced", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "70", "--gen", "3"])
    out = capsys.readouterr().out
    assert f'"arch": "{arch}-reduced"' in out and '"generated_shape": [\n  2,\n  3\n ]' in out


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "musicgen-medium"])
def test_serve_lm_main_serves_the_moe_and_embedding_archs(arch, capsys):
    """mixtral through ``generate``; musicgen, which takes embeddings,
    through ``serve_embeddings`` (its logits, one row a step and the
    prefill's)."""
    serve_lm.main(["--arch", arch, "--reduced", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == f"{arch}-reduced" and out["decode_steps"] == 3
    if arch == "musicgen-medium":
        assert out["logits_shape"] == [2, 4, 512]
    else:
        assert out["generated_shape"] == [2, 3]


def test_zamba2_shared_attention_is_shared():
    """Every ``SHARED_ATTN`` layer is the one ``params["shared_attn"]`` dict
    (``tests/test_models.py::test_zamba2_shared_attention_is_shared``), in
    ``M.init`` and after ``convert``; ``param_count`` counts it once, as
    JAX's ``param_count`` does, and each application has its own KV cache."""
    full = M.layer_kinds(get_arch("zamba2-7b"))
    assert full.count(SHARED_ATTN) == 11 and full.count(MAMBA2) == 70
    cfg = get_arch("zamba2-7b").reduced()
    kinds = M.layer_kinds(cfg)
    assert kinds.count(SHARED_ATTN) == 2 and kinds.count(MAMBA2) == 16
    cfg_j = jget_arch("zamba2-7b").reduced()
    params_j = JM.init(jax.random.PRNGKey(0), cfg_j)
    converted = lm_params_from_jax(jax.tree.map(np.asarray, params_j), cfg, CPU)
    for params in (M.init(torch.Generator().manual_seed(0), cfg), converted):
        shared = [p for p, k in zip(params["layers"], kinds) if k == SHARED_ATTN]
        assert all(p is params["shared_attn"] for p in shared)
        assert M.param_count(params) == JM.param_count(params_j)
    caches = M.make_caches(cfg, 2, 8, CPU)
    kv = [c for c, k in zip(caches, kinds) if k == SHARED_ATTN]
    assert len({id(c.k) for c in kv}) == len(kv) == cfg.n_stages
