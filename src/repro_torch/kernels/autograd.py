"""Gradients through the hand-written kernels.

A kernel wrapper writes its outputs through raw pointers into tensors it
allocates, so autograd sees no graph through it.  The reference has no
backward kernel either (no ``custom_vjp`` under ``repro/kernels``): on a
TPU its training runs the forward kernel and XLA differentiates the plain
form.  :func:`kernel_with_grad` does the same here: the forward is the
kernel; the backward recomputes the kernel's plain PyTorch version from the
saved inputs under autograd and returns its gradients.  The plain version
runs only inside ``backward``: if the kernel fails, the call fails.
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
        out = kernel(*inputs)
        ctx.single = isinstance(out, torch.Tensor)
        return out

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        wants = [t is not None and t.requires_grad for t in inputs]
        with torch.enable_grad():
            copies = [t.detach().requires_grad_(w) if t is not None else None
                      for t, w in zip(inputs, wants)]
            out = ctx.plain(*copies)
            outs = (out,) if ctx.single else tuple(out)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            leaves = [c for c, w in zip(copies, wants) if w]
            got = iter(torch.autograd.grad([o for o, _ in pairs], leaves,
                                           [g for _, g in pairs], allow_unused=True)
                       if pairs and leaves else [None] * len(leaves))
        return (None, None, *[next(got) if w else None for w in wants])


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
