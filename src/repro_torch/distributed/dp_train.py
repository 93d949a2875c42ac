"""Explicit data-parallel training with compressed gradient all-reduce (the
port of ``repro/distributed/dp_train.py``).

The Blaze gradient path on the port's shard model (a ``containers.Mesh``
of shards stacked on one device):

  map    = per-shard backward pass                (the mapper)
  reduce = compressed sum (bf16 / int8 + shared scale)   (fast serialization)
  key    = parameter index (dense, positional)    (small fixed key range)
  error feedback residuals keep SGD/Adam unbiased over steps.

The batch is split on dim 0 over the mesh's shards and each shard runs its
own backward; every gradient, stacked ``[S, ...]`` and divided by ``S``,
goes through ``psum_with_feedback`` with its residual, ``[S, ...]`` f32 one
row a shard.  A lossy wire narrows one frame with one scale: the
reference's frame is a leaf of its pytree, which stacks a stage slot's
parameters over the stages; given the model's ``cfg``, the port frames the
same groups (``models.model.reference_leaves``), else each tensor alone.

The reference keeps one residual a device too: its ``shard_map`` returns them under ``out_specs=P()`` with the replication
check off, so the "replicated" array holds a different buffer on each
device, and the next step's shard reads its own (found on 8 forced CPU
devices).  Used by the tests to show convergence parity between exact and
compressed wires, and to count the wire bytes saved.

**Across processes.**  On a mesh from ``launch.mesh.make_node_data_mesh``
with a group up (one node row a process, ``n_local`` shards each) the
``n_ranks × n_local`` shards are the reference's one ``"data"`` axis: every
rank is given the whole global batch and runs the backward passes of its
own shards' rows; each frame's gradients cross through
``psum_with_feedback(gather=)``, which gathers the ranks' rows (the
narrowed payload, and for int8 the ranks' maxima first) and folds them in
global shard order, so every rank holds the in-process sum's bits and
applies the same update.  Each rank keeps the ``[n_local, ...]`` residual
rows of its own shards; the loss is the mean over every shard's, gathered
and folded in the same order.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core.collectives import gather_rows
from repro_torch.core.containers import Mesh
from repro_torch.distributed.collectives import psum_with_feedback, wire_bytes
from repro_torch.models.model import distinct_leaves, map_tree, reference_leaves
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.train_loop import value_and_grad


def make_dp_train_step(
    loss_fn: Callable,  # loss_fn(params, inputs, labels) → scalar (per-shard mean)
    optimizer: AdamW,
    mesh: Mesh,
    *,
    wire: str = "none",
    cfg=None,
) -> Callable:
    """Returns ``step(params, opt_state, residuals, batch) → (params,
    opt_state, residuals, loss)``, all three trees updated in place.

    ``batch`` is ``{"inputs", "labels"}`` with a leading dim that the mesh's
    shards divide; ``residuals`` is :func:`init_residuals`'s tree.  The loss
    is the mean of the shards' losses.  The mesh's shards form one data
    axis, as the reference splits the batch over its ``"data"`` axis: a 1-D
    ``data_mesh``, or a process mesh (one node row a process; every rank
    passes the whole batch and keeps its shards' rows, module docstring).
    With an LM's ``cfg`` the wire's frames are the reference's leaves
    (:func:`frames`)."""
    if mesh.n_nodes != 1 and not mesh.process:
        raise ValueError(f"dp_train splits the batch over a 1-D data mesh, got "
                         f"{mesh.n_nodes} node rows in one process")
    n, n_local = mesh.n_shards, mesh.n_local
    first = mesh.rank * n_local  # this rank's first global shard
    gather = functools.partial(gather_rows, mesh) if mesh.process else None

    def step(params, opt_state, residuals, batch):
        inputs, labels = batch["inputs"], batch["labels"]
        if inputs.shape[0] % n:
            raise ValueError(f"batch {inputs.shape[0]} does not split over {n} shards")
        per = inputs.shape[0] // n
        losses, shard_grads = [], []
        for s in range(first, first + n_local):
            rows = slice(s * per, (s + 1) * per)
            loss, grads = value_and_grad(params, loss_fn, inputs[rows], labels[rows])
            losses.append(loss)
            shard_grads.append(grads)
        losses = torch.stack(losses)
        loss = (losses if gather is None else gather(losses)).sum() / n
        leaves = distinct_leaves(params)
        where = {id(t): i for i, t in enumerate(leaves)}
        res = distinct_leaves(residuals)
        reduced = [None] * len(leaves)
        for frame in frames(params, cfg):
            idx = [where[id(t)] for t in frame]
            g = torch.stack([torch.stack([sg[i] for sg in shard_grads]) for i in idx], 1)
            r = torch.stack([res[i] for i in idx], 1)  # [n_local, len(frame), ...]
            gr, rr = psum_with_feedback(g.float() / n, r, wire=wire, gather=gather)
            for k, i in enumerate(idx):
                reduced[i] = gr[k].to(g.dtype)
                res[i].copy_(rr[:, k])
        params, opt_state = optimizer.update(reduced, opt_state, params)
        return params, opt_state, residuals, loss

    return step


def frames(params, cfg=None) -> list[list[torch.Tensor]]:
    """The groups of distinct tensors a lossy wire narrows with one scale
    each: with an LM's ``cfg`` the reference's leaves (a stage slot's tensor
    over every stage), else each tensor alone."""
    if cfg is not None:
        return reference_leaves(params, cfg)
    return [[t] for t in distinct_leaves(params)]


def init_residuals(params, mesh: Mesh):
    """Zero f32 residuals ``[n_local, ...]`` for every parameter, one row a
    shard of this process (all ``S`` in one process; sharing kept, as in
    ``params``)."""
    return map_tree(lambda p: torch.zeros((mesh.n_local,) + tuple(p.shape),
                                          dtype=torch.float32, device=p.device), params)


def grad_wire_bytes(params, wire: str, cfg=None) -> int:
    """Bytes one gradient reduce moves per device under ``wire``, one frame
    of :func:`frames` at a time (an int8 frame carries one scale); a tensor
    that appears at several places (zamba2's shared block) counts once, as
    it is one gradient."""
    return sum(wire_bytes(torch.empty((sum(t.numel() for t in frame),),
                                      dtype=frame[0].dtype, device="meta"), wire)
               for frame in frames(params, cfg))
