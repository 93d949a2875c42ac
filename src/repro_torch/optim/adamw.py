"""AdamW with a configurable moment dtype (the port of
``repro/optim/adamw.py``).

Moments are kept in ``moment_dtype`` (bf16 for the giant configs, whose
f32 moments would not fit), the math runs in f32, and each new parameter is
cast back to its own dtype.  The state is a plain dict ``{"m", "v",
"step"}`` of tensors, ``m`` and ``v`` trees shaped like the parameters, so
``CheckpointManager`` saves it like any tree.

The reference returns new parameters and state; the port updates both in
place under ``torch.no_grad()`` (the step counter too), each *distinct*
tensor once: zamba2's shared block, which every ``SHARED_ATTN`` layer
refers to, is one set of tensors and takes one update, as it is one entry
of JAX's pytree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.models.model import distinct_leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    moment_dtype: str = "float32"

    def init(self, params) -> dict:
        """Zero moments shaped like ``params`` (sharing kept: a tensor that
        appears at several places has one moment) and step 0, on the
        parameters' device."""
        mdt = getattr(torch, self.moment_dtype)
        device = distinct_leaves(params)[0].device

        def zeros(p):
            return torch.zeros(p.shape, dtype=mdt, device=p.device)

        return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def _lr(self, step: torch.Tensor):
        if callable(self.lr):
            return self.lr(step)
        return self.lr

    @torch.no_grad()
    def update(self, grads, state: dict, params):
        """One step, in place: returns ``(params, state)``, the objects passed
        in.  ``grads`` is shaped like ``params`` (any dtype); the learning
        rate is ``lr(step + 1)``; decay applies to tensors of 2 or more
        dimensions only (norm scales and biases are left out).  The step
        counter advances in place, as the parameters and moments do, so it
        stays the same tensor: a captured step (``TrainGraph``) moves it on
        with every replay."""
        step = state["step"]
        step.add_(1)
        lr = self._lr(step)
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()
        ps, gs = distinct_leaves(params), distinct_leaves(grads)
        ms, vs = distinct_leaves(state["m"]), distinct_leaves(state["v"])
        if not len(ps) == len(gs) == len(ms) == len(vs):
            raise ValueError(f"{len(ps)} parameters, {len(gs)} gradients, {len(ms)} and "
                             f"{len(vs)} moments: the trees must share their shape")
        for p, g, m, v in zip(ps, gs, ms, vs):
            gf = g.float()
            mf = m.float() * b1 + gf * (1 - b1)
            vf = v.float() * b2 + gf * gf * (1 - b2)
            delta = (mf / c1) / (torch.sqrt(vf / c2) + self.eps)
            if p.ndim >= 2:  # decay matrices only (norms/bias excluded)
                delta = delta + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(mf)
            v.copy_(vf)
        return params, state


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """A schedule of the step: linear warm-up to ``peak`` over
    ``warmup_steps``, then a cosine down to ``floor · peak`` at
    ``total_steps``, in f32 on the step's device."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return sched
