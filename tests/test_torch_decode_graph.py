"""The LM decode step with its position on the device, and the captured step
around it (``launch.serve_lm.DecodeGraph``), on the CPU.

``M.decode_step`` takes ``cache_len`` as a 0-d integer tensor as well as a
host ``int``.  On six reduced archs (qwen3-0.6b; gemma2-9b, whose local
layers see a cache longer than ``window + 1``; zamba2-7b; rwkv6-1.6b;
mixtral-8x22b; qwen2-vl-2b on embeddings) the tensor route is held against
the ``int`` route: bit for bit where the arithmetic is the same (every arch
without a local layer: the same K/V rows written, the same masks from the
same positions, the K5/K6 states updated alike), and on gemma2 and mixtral,
whose local layers take the whole cache with the window's mask in place of
the window's view, within ``atol = rtol = 1e-5`` (``attention_ref`` sums the
same f32 products over rows of other lengths: ~1e-7 per step on O(1)
logits).  Both routes are also held against the reference's own
``jax.jit(decode_step)`` with a traced ``cache_len``, within
``tests/test_torch_models.py``'s ``atol = rtol = 1e-4`` (same weights, f32).

K4's split decode with the offset on the device (``flash_decode_plain`` with
a tensor ``q_offset``: splits sized by ``static_tiles``, the first live tile
found from the offset) against ``attention_ref`` and JAX's Pallas kernel in
interpret mode, within ``tests/test_torch_flash_decode.py``'s ``3e-5``.

The captured step's host logic runs through its eager twin
(``DecodeGraph(capture=False)``): the same step, op by op, with the same
static buffers.  The graph itself needs a card (``tests/test_torch_cuda.py``).

Run on the CPU:  PYTHONPATH=src python -m pytest -q tests/test_torch_decode_graph.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jget_arch
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import model as JM
from repro_torch.configs.base import ATTN_LOCAL, ATTN_LOCAL_MOE, get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch import serve_lm
from repro_torch.launch.serve_lm import DecodeGraph
from repro_torch.models import model as M
from repro_torch.models.attention import KVCache

ARCHS = ["qwen3-0.6b", "gemma2-9b", "zamba2-7b", "rwkv6-1.6b", "mixtral-8x22b",
         "qwen2-vl-2b"]
TOL = dict(atol=1e-4, rtol=1e-4)  # against JAX (tests/test_torch_models.py)
LOCAL_TOL = dict(atol=1e-5, rtol=1e-5)  # whole cache against the window's view
F32_ATOL = 3e-5  # tests/test_torch_flash_decode.py
CPU = torch.device("cpu")
PROMPT, ROWS, STEPS = 20, 28, 4  # a cache longer than the reduced window (16) + 1


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """``(jax cfg, jax params, port cfg, port params)`` of one reduced arch,
    the same weights on both sides."""
    cfg_j = jget_arch(request.param).reduced()
    params_np = jax.tree.map(np.asarray, JM.init(jax.random.PRNGKey(0), cfg_j))
    cfg_t = get_arch(request.param).reduced()
    return cfg_j, jax.tree.map(jnp.asarray, params_np), cfg_t, lm_params_from_jax(
        params_np, cfg_t, CPU)


def _inputs(cfg, b, s, seed=0):
    rng = np.random.RandomState(seed)
    if cfg.embed_inputs:
        return rng.randint(0, cfg.vocab, (b, s)).astype(np.int64)
    return rng.randn(b, s, cfg.d_model).astype(np.float32)


def _has_local(cfg) -> bool:
    return any(k in (ATTN_LOCAL, ATTN_LOCAL_MOE) for k in M.layer_kinds(cfg))


def _leaves(caches):
    return [t for c in caches for t in c]


def test_device_position_decode_matches_the_int_step_and_jax_jit(lm):
    cfg_j, params_j, cfg, params = lm
    assert cfg.window is None or ROWS > cfg.window + 1
    x = _inputs(cfg, 2, PROMPT + STEPS, seed=1)
    xt = torch.from_numpy(x)
    by_int, by_tensor = (M.make_caches(cfg, 2, ROWS, CPU) for _ in range(2))
    M.prefill(params, cfg, xt[:, :PROMPT], by_int)
    M.prefill(params, cfg, xt[:, :PROMPT], by_tensor)
    cj = JM.make_caches(cfg_j, 2, ROWS)
    _, cj = JM.prefill(params_j, cfg_j, jnp.asarray(x[:, :PROMPT]), cj)
    jstep = jax.jit(lambda p, inp, c, n: JM.decode_step(p, cfg_j, inp, c, n))
    pos = torch.tensor(PROMPT, dtype=torch.int32)
    local = _has_local(cfg)
    for i in range(PROMPT, PROMPT + STEPS):
        step = xt[:, i:i + 1]
        want_int, _ = M.decode_step(params, cfg, step, by_int, i)
        got, _ = M.decode_step(params, cfg, step, by_tensor, pos)
        pos += 1
        want_jax, cj = jstep(params_j, jnp.asarray(x[:, i:i + 1]), cj, jnp.int32(i))
        if local:
            torch.testing.assert_close(got, want_int, **LOCAL_TOL)
        else:
            assert torch.equal(got, want_int), i
        for port in (got, want_int):
            np.testing.assert_allclose(port.numpy(), np.asarray(want_jax), **TOL)
    assert int(pos) == PROMPT + STEPS  # the caller moves the position on
    for a, b in zip(_leaves(by_tensor), _leaves(by_int)):
        if local:
            torch.testing.assert_close(a, b, **LOCAL_TOL)
        else:
            assert torch.equal(a, b)


# B, Hq, Hkv, Sq, Skv, D, q_offset, window, softcap
DEVICE_OFFSET_CASES = [
    (1, 8, 2, 1, 600, 32, 543, 64, 0.0),     # window of 64 over tiles 7-8
    (1, 8, 2, 1, 600, 32, 575, 64, 0.0),     # its first live key opens tile 8: a split empty
    (1, 8, 2, 1, 600, 32, 576, 64, 0.0),     # the window's edge one key on
    (2, 4, 4, 1, 700, 32, 100, None, 0.0),   # early in a long cache: most splits empty
    (2, 8, 8, 1, 2048, 32, 700, None, 0.0),  # 11 live tiles of 32 over 16 splits
    (1, 16, 2, 1, 300, 64, 299, None, 0.0),  # GQA, rep 8, the last row
    (1, 16, 2, 1, 300, 64, 250, 128, 20.0),  # GQA, window and softcap
    (1, 8, 1, 2, 560, 16, 543, None, 5.0),   # rep 8 × 2 positions = 16 rows
    (1, 2, 2, 16, 700, 32, 600, 40, 0.0),    # 16 positions under a window
    (1, 4, 2, 1, 64, 32, 0, 16, 0.0),        # one live key
]


def _qkv(case, seed=0):
    b, hq, hkv, sq, skv, d = case[:6]
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32))
                 for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


@pytest.mark.parametrize("case", DEVICE_OFFSET_CASES)
def test_split_decode_with_a_device_offset_matches_attention_ref_and_jax(case):
    b, hq, hkv, sq, skv, d, off, window, cap = case
    q, k, v = _qkv(case)
    n_static = FA.static_tiles(sq, skv, window)
    splits, per = FA.decode_splits(b, hkv, n_static, 132)
    t_lo, t_hi = FA.key_tiles(sq, skv, off, True, window)
    assert splits * per >= t_hi - t_lo  # the static grid covers the live tiles
    kw = dict(causal=True, window=window, softcap=cap)
    got = FA.flash_decode_plain(q, k, v, splits=splits,
                                q_offset=torch.tensor(off, dtype=torch.int32), **kw)
    want = attention_ref(q, k, v, q_offset=off, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL, rtol=0)
    flash = jflash(*(jnp.asarray(t.numpy()) for t in (q, k, v)), block_q=32, block_k=32,
                   interpret=True, q_offset=off, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(flash), atol=F32_ATOL, rtol=0)
    # the wrapper's CPU route takes the tensor offset too, with the int's bits
    at = FA.flash_attention(q, k, v, q_offset=torch.tensor(off), **kw)
    assert torch.equal(at, FA.flash_attention(q, k, v, q_offset=off, **kw))


def test_device_offset_cases_leave_splits_empty():
    """Where the live tiles are fewer than the static grid's splits, the
    last splits walk no tile (the kernel's empty partial, weighed 0)."""
    empty = 0
    for b, hq, hkv, sq, skv, d, off, window, cap in DEVICE_OFFSET_CASES:
        splits, _ = FA.decode_splits(b, hkv, FA.static_tiles(sq, skv, window), 132)
        t_lo, t_hi = FA.key_tiles(sq, skv, off, True, window)
        per = max(1, -(-(t_hi - t_lo) // splits))  # the live tiles spread over the grid
        empty += sum(i * per >= t_hi - t_lo for i in range(splits))
    assert empty >= 3


@pytest.mark.parametrize("sq, skv, window", [
    (1, 545, None), (1, 4625, 4096), (1, 2048, 1024), (2, 700, 40), (16, 700, 40),
    (1, 64, 16), (1, 100, 0), (3, 130, 63), (1, 129, 64),
])
def test_static_tiles_hold_every_offsets_live_tiles(sq, skv, window):
    n = FA.static_tiles(sq, skv, window)
    assert n <= -(-skv // FA.KEY_TILE)
    spans = [max(0, hi - lo) for lo, hi in
             (FA.key_tiles(sq, skv, off, True, window) for off in range(-sq, skv))]
    assert max(spans) <= n
    if window is not None and window + sq - 1 <= skv:
        assert max(spans) >= n - 1  # no more than one tile of slack


def test_ops_attention_takes_a_device_offset():
    q, k, v = _qkv((1, 4, 2, 1, 90, 32))
    off = torch.tensor(70, dtype=torch.int32)
    for window in (None, 16):
        got = ops.attention(q, k, v, q_offset=off, window=window)
        assert torch.equal(got, ops.attention(q, k, v, q_offset=70, window=window))
    fake = torch.ops.blaze.flash_attention_at
    with torch._subclasses.FakeTensorMode():
        out = fake(torch.empty(2, 4, 1, 32), torch.empty(2, 2, 90, 32),
                   torch.empty(2, 2, 90, 32), torch.empty((), dtype=torch.int32),
                   True, None, 0.0, None)
    assert out.shape == (2, 4, 1, 32)
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:  # the offset at its largest
        fake(q, k, v, off, True, None, 0.0, None)
    assert counter.get_total_flops() == 4 * 1 * 4 * 32 * 90  # the last row's 90 keys


def _served(arch, rows=ROWS, prompt=PROMPT):
    cfg = get_arch(arch).reduced()
    params = M.init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_inputs(cfg, 2, rows, seed=2))
    caches = M.make_caches(cfg, 2, rows, CPU)
    M.prefill(params, cfg, x[:, :prompt], caches)
    return cfg, params, x, caches


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b", "qwen2-vl-2b"])
def test_eager_twin_keeps_static_buffers_and_moves_the_position(arch):
    cfg, params, x, caches = _served(arch)
    twin_caches = [type(c)(*(t.clone() for t in c)) for c in caches]
    g = DecodeGraph(cfg, params, twin_caches, x[:, PROMPT:PROMPT + 1], PROMPT,
                    capture=False)
    assert g.graph is None and g.captured_launches == {} and g.replays == 0
    inputs_at, logits_at = g.inputs.data_ptr(), None
    for i in range(PROMPT, PROMPT + STEPS):
        want, _ = M.decode_step(params, cfg, x[:, i:i + 1], caches, i)
        got = g.step(x[:, i:i + 1])
        assert torch.equal(got, want)
        assert g.inputs.data_ptr() == inputs_at  # one static input buffer
        logits_at = logits_at or got.data_ptr()
        assert got.data_ptr() == logits_at  # one static output, as the graph's
        assert g.pos == int(g.position) == i + 1
        assert g.position.dtype == torch.int32 and g.position.dim() == 0
    for a, b in zip(_leaves(twin_caches), _leaves(caches)):
        assert torch.equal(a, b)
    g.seek(PROMPT)
    assert g.pos == int(g.position) == PROMPT


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_warm_up_leaves_the_live_state_where_it_was(arch):
    """The warm-up steps on clones of the recurrent caches and the position;
    of the live caches it writes only each KV cache's row ``pos``, which the
    first step writes again before reading it."""
    cfg, params, x, caches = _served(arch)
    before = [tuple(t.clone() for t in c) for c in caches]
    g = DecodeGraph(cfg, params, caches, x[:, PROMPT:PROMPT + 1], PROMPT, capture=False)
    g.warm_up()
    assert int(g.position) == g.pos == PROMPT
    for c, b in zip(caches, before):
        if isinstance(c, KVCache):
            for t, u in zip(c, b):
                assert torch.equal(t[:, :PROMPT], u[:, :PROMPT])
                assert torch.equal(t[:, PROMPT + 1:], u[:, PROMPT + 1:])
        else:
            assert all(torch.equal(t, u) for t, u in zip(c, b))


def _twin(cfg, params, caches, inputs, position, capture):
    return DecodeGraph(cfg, params, caches, inputs, position, capture=False)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b"])
def test_generate_clones_each_steps_logits_out_of_the_static_output(arch, monkeypatch):
    """``generate`` through the eager twin (in the captured step's place):
    tokens and every step's logits equal the eager step's, and each kept
    step is its own tensor, not the static output."""
    cfg = get_arch(arch).reduced()
    params = M.init(torch.Generator().manual_seed(0), cfg)
    prompts = torch.from_numpy(_inputs(cfg, 2, 6, seed=3))
    want = serve_lm.generate(cfg, params, prompts, 14, 7, return_logits=True,
                             capture=False)
    sampled = serve_lm.generate(cfg, params, prompts, 14, 7, greedy=False, seed=5,
                                capture=False)[0]
    monkeypatch.setattr(serve_lm, "_decode_graph", _twin)
    got = serve_lm.generate(cfg, params, prompts, 14, 7, return_logits=True)
    # a kept step aliasing the static output would repeat the last step
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    # token choice stays outside the step: the seeded draw is the eager one
    assert torch.equal(serve_lm.generate(cfg, params, prompts, 14, 7, greedy=False,
                                         seed=5)[0], sampled)


def test_serve_embeddings_clones_each_steps_logits(monkeypatch):
    cfg = get_arch("musicgen-medium").reduced()
    params = M.init(torch.Generator().manual_seed(0), cfg)
    emb = torch.from_numpy(_inputs(cfg, 2, 12, seed=4))
    want, _ = serve_lm.serve_embeddings(cfg, params, emb[:, :8], emb[:, 8:], 13,
                                        capture=False)
    monkeypatch.setattr(serve_lm, "_decode_graph", _twin)
    got, _ = serve_lm.serve_embeddings(cfg, params, emb[:, :8], emb[:, 8:], 13)
    assert torch.equal(got, want)  # an aliased step would repeat the last one


def test_a_step_past_the_cache_raises_before_it_runs():
    cfg, params, x, caches = _served("qwen3-0.6b", rows=5, prompt=4)
    g = DecodeGraph(cfg, params, caches, x[:, 4:5], 4, capture=False)
    g.step(x[:, 4:5])  # fills the last row
    before = [t.clone() for t in _leaves(caches)]
    with pytest.raises(ValueError, match="cannot write 1 rows at cache_len 5"):
        g.step(x[:, 4:5])
    assert g.pos == int(g.position) == 5
    assert all(torch.equal(a, b) for a, b in zip(_leaves(caches), before))
    with pytest.raises(ValueError, match="cannot write 1 rows at cache_len 5"):
        DecodeGraph(cfg, params, caches, x[:, 4:5], 5, capture=False)


def test_capture_on_the_cpu_raises():
    cfg, params, x, caches = _served("qwen3-0.6b")
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        serve_lm.generate(cfg, params, x[:, :4], 10, 3, capture=True)
    emb_cfg = get_arch("musicgen-medium").reduced()
    emb = torch.zeros((1, 5, emb_cfg.d_model))
    with pytest.raises(ValueError, match="capture=True needs a CUDA device"):
        serve_lm.serve_embeddings(emb_cfg, {}, emb[:, :3], emb[:, 3:], 6, capture=True)
    with pytest.raises(ValueError, match="capture needs a CUDA device"):
        DecodeGraph(cfg, params, caches, x[:, PROMPT:PROMPT + 1], PROMPT)


def test_replays_count_in_the_graph_stats_not_the_wrappers(monkeypatch):
    """A replay (a stand-in graph here: the real one needs a card) adds the
    captured step's launches to the object's and the module's stats, once a
    replay, and leaves the kernel wrappers' counts alone: no wrapper runs."""
    from types import SimpleNamespace

    from repro_torch.core.program import launch_counts

    cfg, params, x, caches = _served("zamba2-7b")
    monkeypatch.setattr(serve_lm, "stats", serve_lm.GraphStats())
    g = DecodeGraph(cfg, params, caches, x[:, PROMPT:PROMPT + 1], PROMPT, capture=False)
    replayed = []
    g.graph = SimpleNamespace(replay=lambda: replayed.append(int(g.position)))
    g.logits = torch.zeros(2, cfg.vocab)
    g.captured_launches = {"flash_attention": 3, "flash_attention/bf16-decode": 3,
                           "ssd_scan": 2, "ssd_scan/decode": 2}
    wrappers = launch_counts()
    for i in range(4):
        assert g.step(x[:, PROMPT + i:PROMPT + i + 1]) is g.logits
    assert launch_counts() == wrappers
    assert replayed == [PROMPT] * 4  # the graph moves its own position
    assert g.pos == PROMPT + 4 and g.replays == serve_lm.stats.replays == 4
    want = {k: 4 * n for k, n in g.captured_launches.items()}
    assert g.replay_launches == serve_lm.stats.replay_launches == want
    serve_lm.stats.reset()
    assert (serve_lm.stats.replays, serve_lm.stats.replay_launches) == (0, {})


def test_main_runs_eager_on_the_cpu(capsys):
    import json

    for extra in ([], ["--eager"]):
        serve_lm.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--batch",
                       "2", "--prompt-len", "5", "--gen", "3", *extra])
        out = json.loads(capsys.readouterr().out)
        assert out["captured"] is False and out["generated_shape"] == [2, 3]


def test_a_tensor_position_refuses_dtensors(tmp_path):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention as A

    cfg = get_arch("musicgen-medium").reduced()
    params = M.init(torch.Generator().manual_seed(0), cfg)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        x = distribute_tensor(torch.zeros((2, 1, cfg.d_model)), mesh,
                              (Replicate(), Replicate()))
        pos = torch.tensor(3, dtype=torch.int32)
        with pytest.raises(ValueError, match="sharded route takes an int"):
            M.decode_step(params, cfg, x, M.make_caches(cfg, 2, 8, CPU), pos)
        cache = A.make_cache(cfg, 2, 8, CPU)
        with pytest.raises(ValueError, match="sharded route takes an int"):
            A.attn_apply(params["layers"][0]["attn"], cfg, x, torch.zeros((2, 1)),
                         cache=cache, cache_len=pos)
        q = distribute_tensor(torch.zeros((2, 4, 1, 32)), mesh, (Replicate(), Replicate()))
        with pytest.raises(ValueError, match="sharded route takes an int"):
            ops.attention(q, q, q, q_offset=pos)
    finally:
        dist.destroy_process_group()
