"""Gradients through the kernels (``repro_torch.kernels.autograd`` and its
use in ``kernels.ops``), on the CPU.

On a CPU tensor each kernel's wrapper runs its plain version, so with
``impl="pallas"`` the plain version stands in for the kernel in the
forward, and the backward recomputes the same plain version: the
gradients must equal the plain version's own autograd exactly (the same
operations on the same inputs in the same order).  A differentiated call
may not write a cache in place; a call with no input that requires grad
builds no graph.  The card cases are in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.autograd import kernel_with_grad
from repro_torch.kernels.ref import attention_ref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
from repro_torch.kernels.ssd_scan import ssd_scan_plain


def _t(rng, *shape, grad=True, dtype=torch.float32):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype).requires_grad_(grad)


def _grads(out, inputs, seed=7):
    outs = out if isinstance(out, tuple) else (out,)
    rng = np.random.RandomState(seed)
    ups = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32)).to(o.dtype)
           for o in outs]
    return torch.autograd.grad(outs, inputs, ups)


def _attention_case(rng):
    q, k, v = _t(rng, 2, 4, 9, 16), _t(rng, 2, 2, 9, 16), _t(rng, 2, 2, 9, 16)
    kw = dict(causal=True, window=5, softcap=20.0)
    return (q, k, v), (lambda *t: ops.attention(*t, impl="pallas", **kw),
                       lambda *t: attention_ref(*t, **kw))


def _ssd_case(rng):
    x, b, c = _t(rng, 2, 10, 4, 8), _t(rng, 2, 10, 2, 6), _t(rng, 2, 10, 2, 6)
    dt = torch.nn.functional.softplus(_t(rng, 2, 10, 4, grad=False)).requires_grad_()
    a = (-torch.arange(1.0, 5.0)).requires_grad_()
    h0 = _t(rng, 2, 4, 8, 6)
    return (x, dt, a, b, c, h0), (
        lambda *t: ops.ssd(*t[:5], init_state=t[5], chunk=4, impl="pallas"),
        lambda *t: ssd_scan_plain(*t[:5], init_state=t[5], chunk=4))


def _rwkv6_case(rng):
    r, k, v = _t(rng, 2, 10, 4, 8), _t(rng, 2, 10, 4, 8), _t(rng, 2, 10, 4, 8)
    w = torch.exp(-torch.exp(_t(rng, 2, 10, 4, 8, grad=False) - 1.0)).requires_grad_()
    u, s0 = _t(rng, 4, 8), _t(rng, 2, 4, 8, 8)
    return (r, k, v, w, u, s0), (
        lambda *t: ops.rwkv6(*t[:5], init_state=t[5], chunk=4, impl="pallas"),
        lambda *t: rwkv6_scan_plain(*t[:5], init_state=t[5], chunk=4))


CASES = {"attention": _attention_case, "ssd": _ssd_case, "rwkv6": _rwkv6_case}


@pytest.mark.parametrize("op", sorted(CASES))
def test_kernel_route_gradients_equal_plain_autograd(op):
    inputs, (kernel_route, plain) = CASES[op](np.random.RandomState(0))
    got = kernel_route(*inputs)
    want = plain(*inputs)
    outs = got if isinstance(got, tuple) else (got,)
    assert all("_KernelGrad" in type(o.grad_fn).__name__ for o in outs)
    for g, w in zip(outs, want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    for g, w in zip(_grads(got, inputs), _grads(want, inputs)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("op", ["ssd", "rwkv6"])
def test_unused_state_output_takes_no_gradient(op):
    """Training reads ``y`` only; the final state's gradient is absent."""
    inputs, (kernel_route, plain) = CASES[op](np.random.RandomState(1))
    y, _ = kernel_route(*inputs)
    want, _ = plain(*inputs)
    for g, w in zip(_grads(y, inputs), _grads(want, inputs)):
        assert torch.equal(g, w)


def test_bf16_inputs_get_bf16_gradients():
    rng = np.random.RandomState(2)
    q, k, v = (_t(rng, 1, 2, 8, 16, dtype=torch.bfloat16) for _ in range(3))
    got = ops.attention(q, k, v, impl="pallas")
    grads = _grads(got, (q, k, v))
    want = _grads(attention_ref(q, k, v), (q, k, v))
    assert all(g.dtype == torch.bfloat16 and torch.equal(g, w) for g, w in zip(grads, want))


@pytest.mark.parametrize("op", ["ssd", "rwkv6"])
def test_cache_write_with_grad_raises(op):
    inputs, _ = CASES[op](np.random.RandomState(3))
    fn = ops.ssd if op == "ssd" else ops.rwkv6
    state = torch.zeros(inputs[5].shape)
    with pytest.raises(ValueError, match="out_state"):
        fn(*inputs[:5], init_state=inputs[5], out_state=state, impl="pallas")
    with torch.no_grad():  # no grad: the cache is written, as when serving
        fn(*inputs[:5], init_state=inputs[5], out_state=state, impl="pallas")
    assert bool(state.abs().sum() > 0)


@pytest.mark.parametrize("op", sorted(CASES))
def test_no_input_requiring_grad_builds_no_graph(op):
    inputs, (kernel_route, _) = CASES[op](np.random.RandomState(4))
    detached = [t.detach() for t in inputs]
    out = kernel_route(*detached)
    assert all(o.grad_fn is None for o in (out if isinstance(out, tuple) else (out,)))
    with torch.no_grad():
        out = kernel_route(*inputs)
    assert all(o.grad_fn is None for o in (out if isinstance(out, tuple) else (out,)))


def test_kernel_runs_in_the_forward_and_plain_only_in_the_backward():
    calls = {"kernel": 0, "plain": 0}

    def kernel(x, y):
        calls["kernel"] += 1
        return (x * y).detach()  # a kernel's output carries no graph

    def plain(x, y):
        calls["plain"] += 1
        return x * y

    x = torch.randn(5, requires_grad=True)
    y = torch.randn(5)
    out = kernel_with_grad(kernel, plain, x, y)
    assert calls == {"kernel": 1, "plain": 0}
    (g,) = torch.autograd.grad(out.sum(), [x])
    assert calls == {"kernel": 1, "plain": 1}
    assert torch.equal(g, y)


def test_a_failing_kernel_fails_the_call():
    def kernel(x):
        raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        kernel_with_grad(kernel, lambda x: x * 2, torch.randn(3, requires_grad=True))
