"""Gradients through the hand-written kernels.

A kernel wrapper writes its outputs through raw pointers into tensors it
allocates, so autograd sees no graph through it.  The reference has no
backward kernel either (no ``custom_vjp`` under ``repro/kernels``): on a
TPU its training runs the forward kernel and XLA differentiates the plain
form.  :func:`kernel_with_grad` does the same here: the forward is the
kernel; the backward recomputes the kernel's plain PyTorch version from the
saved inputs under autograd and returns its gradients.  The plain version
runs only inside ``backward``: if the kernel fails, the call fails.

:func:`register_plain_backward` gives a kernel's custom op (``kernels.ops``)
the same backward, so the op differentiates on its own as well.
"""
from __future__ import annotations

from typing import Callable

import torch


class _KernelGrad(torch.autograd.Function):
    """``forward(kernel, plain, *inputs)`` returns ``kernel(*inputs)``;
    ``backward`` returns the gradients of ``plain(*inputs)``.  ``inputs`` may
    hold ``None`` (an absent optional tensor)."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        # An output that takes no gradient (a scan's final state in training)
        # arrives as None, and the recompute differentiates the others only.
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *plain_grads(ctx.plain, ctx.saved_tensors, grads))


def plain_grads(plain: Callable, inputs, grads) -> list:
    """The gradients of ``plain(*inputs)`` (one output or a tuple) against
    ``grads``, one per input (None where an input is None or takes no
    gradient), ``plain`` recomputed on detached copies under autograd."""
    wants = [t is not None and t.requires_grad for t in inputs]
    with torch.enable_grad():
        copies = [t.detach().requires_grad_(w) if t is not None else None
                  for t, w in zip(inputs, wants)]
        out = plain(*copies)
        outs = (out,) if isinstance(out, torch.Tensor) else tuple(out)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        leaves = [c for c, w in zip(copies, wants) if w]
        got = iter(torch.autograd.grad([o for o, _ in pairs], leaves,
                                       [g for _, g in pairs], allow_unused=True)
                   if pairs and leaves else [None] * len(leaves))
    return [next(got) if w else None for w in wants]


def register_plain_backward(op, plain_of: Callable, n_tensors: int) -> None:
    """Give custom op ``op`` (its first ``n_tensors`` arguments tensors or
    None, the rest options) the backward of :class:`_KernelGrad`:
    ``plain_of(*options)`` is the plain version taking the tensors."""

    def setup_context(ctx, inputs, output):
        ctx.set_materialize_grads(False)
        ctx.options = inputs[n_tensors:]
        ctx.save_for_backward(*inputs[:n_tensors])

    def backward(ctx, *grads):
        got = plain_grads(plain_of(*ctx.options), ctx.saved_tensors, grads)
        return (*got, *[None] * len(ctx.options))

    torch.library.register_autograd(op, backward, setup_context=setup_context)


def needs_grad(*inputs) -> bool:
    """Whether a call on ``inputs`` is to be differentiated: grad mode is on
    and some input requires grad.  Serving calls, made with no tensor that
    requires grad, launch the kernel alone and build no graph."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in inputs)


def kernel_with_grad(kernel: Callable, plain: Callable, *inputs):
    """``kernel(*inputs)``, with the gradients of ``plain(*inputs)``: the
    output (or each output of a tuple) carries a ``grad_fn`` whose backward
    re-runs ``plain`` on detached copies of the saved inputs.  ``kernel``
    and ``plain`` take the same positional tensors (or ``None``) and return
    the same structure."""
    return _KernelGrad.apply(kernel, plain, *inputs)
