"""K4, K5 and K6 as custom ops (``torch.ops.blaze.*``, ``kernels.ops``), on
the CPU, where each op's real implementation is its wrapper's plain
version.

* Fake implementations: under ``FakeTensorMode`` each op gives the real
  call's output shapes and dtypes and allocates nothing (what the dry run
  needs: a fake tensor has no ``data_ptr()``).
* Flop formulas: ``FlopCounterMode`` counts each call's operations — K4
  ``4·B·Hq·D`` a live (query, key) pair (causal and window masks counted
  exactly), K5 ``4·P·N`` and K6 ``4·K·V`` a step and head.
* The registered backward: the op differentiated on its own gives the
  plain version's gradients exactly (the same operations recomputed).
* The ``_into`` forms write the final state into ``out_state`` in place,
  equal to the plain version's.
* ``TokenPipeline(sharding=)`` yields the same batch placed over the dp
  axes (a gloo group of one process, a (1, 1) mesh).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops  # noqa: F401 - registers torch.ops.blaze
from repro_torch.kernels.ref import attention_ref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
from repro_torch.kernels.ssd_scan import ssd_scan_plain

BLAZE = torch.ops.blaze


def _t(rng, *shape, grad=False):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).requires_grad_(grad)


def _ssd_inputs(rng, grad=False):
    x, b, c = _t(rng, 2, 10, 4, 8, grad=grad), _t(rng, 2, 10, 2, 6), _t(rng, 2, 10, 2, 6)
    dt = torch.nn.functional.softplus(_t(rng, 2, 10, 4))
    a = -torch.arange(1.0, 5.0)
    return x, dt, a, b, c, _t(rng, 2, 4, 8, 6, grad=grad)


def _rwkv6_inputs(rng, grad=False):
    r, k, v = (_t(rng, 2, 10, 4, 8, grad=grad) for _ in range(3))
    w = torch.exp(-torch.exp(_t(rng, 2, 10, 4, 8) - 1.0))
    return r, k, v, w, _t(rng, 4, 8), _t(rng, 2, 4, 8, 8, grad=grad)


def test_fake_implementations_give_the_real_shapes():
    rng = np.random.RandomState(0)
    q, k = _t(rng, 2, 4, 9, 16), _t(rng, 2, 2, 11, 16)
    s_in, w_in = _ssd_inputs(rng), _rwkv6_inputs(rng)
    real = [BLAZE.flash_attention(q, k, k, True, 5, 0.0, None, 2),
            *BLAZE.ssd_scan(*s_in, 4), *BLAZE.rwkv6_scan(*w_in, 4)]
    with FakeTensorMode() as mode:
        fq, fk = mode.from_tensor(q), mode.from_tensor(k)
        fs = [mode.from_tensor(t) for t in s_in]
        fw = [mode.from_tensor(t) for t in w_in]
        fake = [BLAZE.flash_attention(fq, fk, fk, True, 5, 0.0, None, 2),
                *BLAZE.ssd_scan(*fs, 4), *BLAZE.rwkv6_scan(*fw, 4),
                BLAZE.ssd_scan_into(*fs, fs[5], 4), BLAZE.rwkv6_scan_into(*fw, fw[5], 4)]
    for f, r in zip(fake, real + [real[1], real[3]]):
        assert f.shape == r.shape and f.dtype == r.dtype


@pytest.mark.parametrize("causal,window,sq,skv,off", [
    (True, None, 9, 9, 0), (True, 5, 9, 20, 11), (False, None, 3, 7, 4), (True, 4, 1, 30, 29)])
def test_flash_attention_flops_count_the_live_pairs(causal, window, sq, skv, off):
    rng = np.random.RandomState(1)
    q, k = _t(rng, 2, 4, sq, 16), _t(rng, 2, 2, skv, 16)
    with FlopCounterMode(display=False) as fc:
        BLAZE.flash_attention(q, k, k, causal, window, 0.0, None, off)
    qpos = np.arange(sq)[:, None] + off
    kpos = np.arange(skv)[None, :]
    live = np.ones((sq, skv), bool)
    if causal:
        live &= kpos <= qpos
    if window is not None:
        live &= kpos > qpos - window
    assert fc.get_total_flops() == 4 * 2 * 4 * 16 * int(live.sum())


def test_scan_flops():
    rng = np.random.RandomState(2)
    with FlopCounterMode(display=False) as fc:
        BLAZE.ssd_scan(*_ssd_inputs(rng), 4)
    assert fc.get_total_flops() == 4 * 2 * 10 * 4 * 8 * 6
    with FlopCounterMode(display=False) as fc:
        BLAZE.rwkv6_scan(*_rwkv6_inputs(rng), 4)
    assert fc.get_total_flops() == 4 * 2 * 10 * 4 * 8 * 8


def _grads(outs, inputs):
    outs = outs if isinstance(outs, tuple) else (outs,)
    ups = [torch.full_like(o, 0.5) + torch.arange(o.numel()).reshape(o.shape) * 1e-3
           for o in outs]
    return torch.autograd.grad(outs, [t for t in inputs if t.requires_grad], ups)


def test_the_ops_differentiate_with_the_plain_versions_gradients():
    rng = np.random.RandomState(3)
    q, k, v = _t(rng, 2, 4, 9, 16, grad=True), _t(rng, 2, 2, 9, 16, grad=True), \
        _t(rng, 2, 2, 9, 16, grad=True)
    got = _grads(BLAZE.flash_attention(q, k, v, True, 5, 20.0, None, None), (q, k, v))
    want = _grads(attention_ref(q, k, v, window=5, softcap=20.0), (q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    s_in = _ssd_inputs(rng, grad=True)
    got = _grads(BLAZE.ssd_scan(*s_in, 4)[0], s_in)
    want = _grads(ssd_scan_plain(*s_in[:5], init_state=s_in[5], chunk=4)[0], s_in)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    w_in = _rwkv6_inputs(rng, grad=True)
    got = _grads(BLAZE.rwkv6_scan(*w_in, 4)[0], w_in)
    want = _grads(rwkv6_scan_plain(*w_in[:5], init_state=w_in[5], chunk=4)[0], w_in)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_into_forms_write_the_state_in_place():
    rng = np.random.RandomState(4)
    s_in = _ssd_inputs(rng)
    state = s_in[5].clone()
    y = BLAZE.ssd_scan_into(*s_in[:5], state, state, 4)
    wy, ws = ssd_scan_plain(*s_in[:5], init_state=s_in[5], chunk=4)
    assert torch.equal(y, wy) and torch.equal(state, ws)
    w_in = _rwkv6_inputs(rng)
    state = w_in[5].clone()
    y = BLAZE.rwkv6_scan_into(*w_in[:5], state, state, 4)
    wy, ws = rwkv6_scan_plain(*w_in[:5], init_state=w_in[5], chunk=4)
    assert torch.equal(y, wy) and torch.equal(state, ws)


def test_token_pipeline_shards_its_batches(tmp_path):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.configs.base import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.mesh import make_mesh

    cfg = get_arch("qwen3-0.6b").reduced()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1),
                            world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        plain = TokenPipeline(cfg, batch=4, seq_len=8, seed=3)
        placed = TokenPipeline(cfg, batch=4, seq_len=8, seed=3, sharding=mesh)
        got = placed.device_batch(2, torch.device("cpu"))
        want = plain.device_batch(2, torch.device("cpu"))
        for k in ("inputs", "labels"):
            assert isinstance(got[k], DTensor)
            assert torch.equal(got[k].full_tensor(), want[k])
        # a (1, 1) mesh shards nothing (a mesh axis of 1 divides nothing)
        assert not any(isinstance(p, Shard) for p in got["inputs"].placements)
    finally:
        dist.destroy_process_group()
