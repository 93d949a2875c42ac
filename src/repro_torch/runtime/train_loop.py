"""Fault-tolerant training loop (the port of ``repro/runtime/train_loop.py``).

* auto-resume from the latest complete checkpoint (atomic manager),
* deterministic data (step-indexed) ⇒ restart-consistent streams,
* gradient-accumulation microbatching with EAGER local accumulation (sum
  locally in f32, reduce once: the Blaze eager-reduction plan for
  gradients; ``accum_mode="per_microbatch"`` is the conventional baseline
  that materialises the reduced gradient every microbatch, kept for the
  contrast),
* straggler monitor: per-step wall times, flags steps > ``k × median``,
* failure injection (``crash_at_step``) for the restart tests.

The port runs on one device (``device=None`` is the card; the CPU only
when asked).  Where the reference jits its step and donates the parameters
and optimiser state, the port updates its own copy of them in place;
``train(params=...)`` copies the caller's tensors first and leaves them as
they were.  With ``jit=True`` (the default, as the reference's) each step
on the card after the first of a start is one replay of a CUDA graph
(:class:`TrainGraph`: the counterpart of ``jax.jit(step_fn,
donate_argnums=(0, 1))``); on the CPU, which has no graphs, the same
object runs the step op by op.  A checkpoint holds the parameters and the
optimiser state with zamba2's shared block once (:func:`_unshared`), and a restore
copies into the live tensors, so every ``SHARED_ATTN`` layer still refers
to the one block.

Parameters of any sharding, as the reference's ``train(params=)`` takes
them: a tree of ``DTensor``s (``convert.distribute`` at
``sharding.param_pspecs``) trains through :func:`make_sharded_train_step`
on its ``DeviceMesh`` (every rank calls ``train``), each batch placed by
``sharding.batch_pspecs``, the optimiser state made at ``opt_pspecs``'
placements; its checkpoints are written shard by shard over the mesh and a
restart restores onto the live tree's placements
(``checkpoint/manager.py``), so a run resumes from a checkpoint that any
mesh shape, or an unsharded run, wrote.  A sharded tree's step stays eager
whatever ``jit`` says: capturing it would put NCCL and ``DTensor``'s
dispatch inside the graph (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core.containers import resolve_device
from repro_torch.core.program import GraphStats, add_launches, launch_counts
from repro_torch.distributed import sharding as SH
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0
    times: list = dataclasses.field(default_factory=list)
    flagged: list = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float):
        self.times.append(dt)
        if len(self.times) >= 8:
            med = float(np.median(self.times[-64:]))
            if dt > self.threshold * med:
                self.flagged.append((step, dt, med))

    def summary(self) -> dict:
        if not self.times:
            return {"steps": 0}
        return {
            "steps": len(self.times),
            "median_s": float(np.median(self.times)),
            "p99_s": float(np.percentile(self.times, 99)),
            "stragglers": len(self.flagged),
        }


def value_and_grad(params, loss_of: Callable, *args):
    """``(loss, grads)`` of ``loss_of(params, *args)``: ``grads`` a list over
    ``M.distinct_leaves(params)`` (zamba2's shared block once, its gradient
    summed over every use; zeros for a tensor the loss does not reach).
    The parameters are set to require grad."""
    leaves = M.distinct_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = loss_of(params, *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(t) if g is None else g
                           for t, g in zip(leaves, grads)]


def make_train_step(cfg: ArchConfig, optimizer: AdamW, *,
                    par: M.ParallelCfg = M.ParallelCfg(), grad_accum: int = 1,
                    accum_mode: str = "eager", remat: bool = True,
                    device=None) -> Callable:
    """Returns ``train_step(params, opt_state, batch) → (params, opt_state,
    loss)``; the parameters and state are updated in place and returned.
    ``batch`` is ``{"inputs", "labels"}`` ``[B, S]``, moved to ``device``
    (default the card).  With ``grad_accum = A > 1`` the batch is split into
    ``A`` microbatches of ``B / A`` rows and their gradients summed in f32,
    each scaled by ``1 / A`` (``"eager"``: into the running sum;
    ``"per_microbatch"``: materialised first, as a reduce per microbatch
    would), the loss likewise."""
    if accum_mode not in ("eager", "per_microbatch"):
        raise ValueError(f"accum_mode must be 'eager' or 'per_microbatch', got "
                         f"{accum_mode!r}")
    dev = resolve_device(device)

    def loss_of(params, inputs, labels):
        return M.loss_fn(params, cfg, inputs, labels, par=par, remat=remat)

    def to_device(batch):
        return batch["inputs"].to(dev), batch["labels"].to(dev)

    if grad_accum == 1:

        def train_step(params, opt_state, batch):
            loss, grads = value_and_grad(params, loss_of, *to_device(batch))
            params, opt_state = optimizer.update(grads, opt_state, params)
            return params, opt_state, loss

        return train_step

    def train_step(params, opt_state, batch):
        inputs, labels = to_device(batch)
        b = inputs.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} does not split into {grad_accum} microbatches")
        mb = b // grad_accum
        gsum = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                for t in M.distinct_leaves(params)]
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(grad_accum):
            rows = slice(i * mb, (i + 1) * mb)
            loss, g = value_and_grad(params, loss_of, inputs[rows], labels[rows])
            if accum_mode == "per_microbatch":
                g = [x * (1.0 / grad_accum) for x in g]
                gsum = [a + x for a, x in zip(gsum, g)]
            else:  # eager: local sum only; one reduce at the end
                gsum = [a + x * (1.0 / grad_accum) for a, x in zip(gsum, g)]
            lsum = lsum + loss / grad_accum
        params, opt_state = optimizer.update(gsum, opt_state, params)
        return params, opt_state, lsum

    return train_step


stats = GraphStats()  # every TrainGraph of the process


class TrainGraph:
    """One training step of :func:`make_train_step` as a CUDA graph, one
    replay a step: the counterpart of the reference's ``jax.jit(step_fn,
    donate_argnums=(0, 1))``.

    It keeps static batch buffers on the device (``inputs``, ``labels``,
    shaped as the first batch), into which :meth:`step` copies each batch,
    and captures ``step_fn`` itself (the micro-batch loop, the forward with
    remat, autograd's backward, the f32 gradient sums and the optimiser's
    update) over them.  The parameters and the optimiser state are updated
    in place by every replay (``AdamW`` advances its step counter in place
    too); ``loss`` is a static output, overwritten by the next step.

    The first :meth:`step` is the warm-up: a real step of the run, eager,
    on a side stream; the capture follows it and records the next step
    without running it, so every later step is one replay and the run's
    steps, checkpoints and losses are the eager step's.  The capture runs
    under sync-debug ``"error"`` into a private pool; a capture that fails
    raises ``RuntimeError`` naming the model and the step, and nothing falls
    back to the eager step.  ``captured_launches`` holds the kernel
    launches (K4, K5, K6, by form) the captured step records, from the
    wrappers' counts around the capture; each replay adds them to
    ``replay_launches`` and to the module's ``stats`` and leaves the
    wrappers' counts alone (no wrapper runs).

    With ``capture=False`` the same step runs op by op over the same static
    buffers (the eager twin, on any device, the CPU's included);
    ``capture=True`` off the card raises ``ValueError``.  Drop the object
    with the state it trains: the graph and its pool go with it."""

    def __init__(self, step_fn: Callable, params, opt_state, batch: dict, *,
                 capture: bool = True, name: str = "model", start: int = 0):
        dev = batch["inputs"].device
        if capture and dev.type != "cuda":
            raise ValueError(f"TrainGraph: capture needs a CUDA device, the batch is on "
                             f"{dev}")
        self.step_fn, self.params, self.opt_state = step_fn, params, opt_state
        self.inputs = torch.empty_like(batch["inputs"])
        self.labels = torch.empty_like(batch["labels"])
        self.capture, self.name = capture, name
        self.next_step = start  # the run's index of the next step taken
        self.graph = None
        self.loss = None
        self.capture_s = None  # the capture's seconds, the warm-up's not included
        self.captured_launches: dict = {}  # one replay's launches, by wrapper and form
        self.replays = 0
        self.replay_launches: dict = {}

    def _run(self) -> torch.Tensor:
        self.params, self.opt_state, loss = self.step_fn(
            self.params, self.opt_state, {"inputs": self.inputs, "labels": self.labels})
        return loss

    def _warm_up_and_capture(self) -> torch.Tensor:
        dev = self.inputs.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            loss = self._run()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        before = launch_counts()
        debug = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(),
                                  capture_error_mode="thread_local"):
                # a host sync inside the step raises here rather than
                # breaking the capture
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = self._run()
                finally:
                    torch.cuda.set_sync_debug_mode(debug)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {self.name}'s training step at "
                               f"step {self.next_step + 1} failed: {e}") from e
        after = launch_counts()
        self.capture_s = time.perf_counter() - t0
        self.captured_launches = {k: after[k] - before[k] for k in after
                                  if after[k] != before[k]}
        self.graph, self.loss = graph, out
        stats.captured(self.captured_launches)
        return loss

    def step(self, batch: dict) -> torch.Tensor:
        """One training step on ``batch`` (``{"inputs", "labels"}`` shaped as
        the buffers): its loss, a 0-d f32 tensor on the device (once the
        graph replays, the static output; read or clone it before the next
        step)."""
        self.inputs.copy_(batch["inputs"])
        self.labels.copy_(batch["labels"])
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            add_launches(self.replay_launches, self.captured_launches)
            stats.replayed(self.captured_launches)
            loss = self.loss
        else:  # the capture records the step after its warm-up
            loss = self._warm_up_and_capture() if self.capture else self._run()
        self.next_step += 1
        return loss


def _mesh_of(tree):
    """The ``DeviceMesh`` of the tree's ``DTensor`` leaves (None when it has
    none)."""
    return next((t.device_mesh for t in pytree.tree_leaves(tree)
                 if isinstance(t, DTensor)), None)


def _to_placements(grads, params):
    """Each gradient moved to its parameter's placements (a partial sum
    reduce-scatters), so the optimizer's update stays local."""
    out = []
    for g, p in zip(grads, M.distinct_leaves(params)):
        if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        out.append(g)
    return out


def make_sharded_train_step(cfg: ArchConfig, optimizer: AdamW, *,
                            par: M.ParallelCfg = M.ParallelCfg(), grad_accum: int = 1,
                            attn_impl: str = "auto", scan_impl: str = "auto") -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, loss)`` on
    ``DTensor``s: ``loss_fn`` with remat, gradients at their parameters'
    placements, AdamW in place; ``loss`` replicated.  A plain batch leaf is
    placed on the parameters' mesh by ``sharding.batch_pspecs`` (a
    ``DTensor`` one is taken as it is).  With ``grad_accum = A > 1`` the
    batch is cut into ``A`` micro-batches of ``B / A`` rows before it is
    placed, and their gradients, each scaled by ``1 / A``, summed in f32 at
    the placements the backward gives them, then moved to the parameters'
    once (:func:`make_train_step`'s ``"eager"`` plan)."""

    def loss_of(params, inputs, labels):
        return M.loss_fn(params, cfg, inputs, labels, par=par, remat=True,
                         attn_impl=attn_impl, scan_impl=scan_impl)

    def placed(mesh, inputs, labels):
        batch = {"inputs": inputs, "labels": labels}
        plain = {k: v for k, v in batch.items() if not isinstance(v, DTensor)}
        mi = SH.make_mesh_info(mesh)
        batch.update(convert.distribute(plain, SH.batch_pspecs(cfg, plain, mi), mesh))
        return batch["inputs"], batch["labels"]

    def step(params, opt_state, batch):
        mesh = _mesh_of(params)
        if grad_accum == 1:
            inputs, labels = placed(mesh, batch["inputs"], batch["labels"])
            with SH.mixing(inputs):  # the backward mixes plain tensors too
                loss, grads = value_and_grad(params, loss_of, inputs, labels)
                params, opt_state = optimizer.update(_to_placements(grads, params),
                                                     opt_state, params)
            return params, opt_state, loss
        whole = [x.full_tensor() if isinstance(x, DTensor) else x
                 for x in (batch["inputs"], batch["labels"])]
        b = whole[0].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} does not split into {grad_accum} microbatches")
        mb = b // grad_accum
        gsum = lsum = None
        for i in range(grad_accum):
            inputs, labels = placed(mesh, *(x[i * mb:(i + 1) * mb] for x in whole))
            with SH.mixing(inputs):
                loss, g = value_and_grad(params, loss_of, inputs, labels)
                g = [x * (1.0 / grad_accum) for x in g]
                gsum = ([x.float() for x in g] if gsum is None
                        else [a + x for a, x in zip(gsum, g)])
                lsum = loss / grad_accum if lsum is None else lsum + loss / grad_accum
        with SH.mixing(inputs):
            params, opt_state = optimizer.update(_to_placements(gsum, params), opt_state,
                                                 params)
        return params, opt_state, lsum

    return step


@dataclasses.dataclass
class TrainResult:
    steps_run: int
    final_step: int
    losses: list
    restarts: int
    straggler: dict
    # each step's wall seconds, in order (the straggler monitor's record)
    step_times: list = dataclasses.field(default_factory=list)
    # each save, {"step", "kind": "save", "bytes" (all its files), "seconds"},
    # and each restore, {"step", "kind": "restore", "seconds"}, in order
    checkpoints: list = dataclasses.field(default_factory=list)
    # CUDA-graph captures of the step (one a start or restart with jit=True
    # on the card), the steps that were replays of them, and each capture's
    # seconds (its warm-up step not included)
    captures: int = 0
    replays: int = 0
    capture_s: list = dataclasses.field(default_factory=list)


def _unshared(tree):
    """A view of ``tree`` holding each dict and tensor once: a later
    occurrence of one already seen (zamba2's shared block in ``layers``) is
    an empty dict, which flattens to no leaf.  Its tensors are the tree's
    own."""
    seen: set[int] = set()

    def go(x):
        if isinstance(x, (dict, torch.Tensor)):
            if id(x) in seen:
                return {}
            seen.add(id(x))
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(go(v) for v in x)
        return x

    return go(tree)


def _ckpt_tree(params, opt_state) -> dict:
    return _unshared({"params": params, "opt": opt_state})


def train(
    cfg: ArchConfig,
    *,
    steps: int,
    batch: int,
    seq_len: int,
    pipeline,
    ckpt_dir: str,
    optimizer: AdamW | None = None,
    ckpt_every: int = 50,
    seed: int = 0,
    grad_accum: int = 1,
    crash_at_step: int | None = None,
    max_restarts: int = 2,
    params=None,
    jit: bool = True,
    device=None,
) -> TrainResult:
    """Run (and if needed, resume) a training job to ``steps``.

    ``pipeline.device_batch(step, device)`` gives step ``step``'s batch
    (``batch`` rows of ``seq_len`` tokens).  Parameters are ``params``
    (copied) or ``M.init`` from ``seed``.  A checkpoint is written at every
    ``ckpt_every``-th step and the last; a start (and a restart after a
    ``SimulatedFailure``, at most ``max_restarts``) resumes from the newest.

    ``jit=True`` runs the step through a :class:`TrainGraph` made for each
    start and restart (the last one's graph and pool dropped with its
    state): on the card its first step is the warm-up and every later one
    a replay (``captures`` 1 a start, ``replays`` the replayed steps); on
    the CPU it runs op by op (``captures == 0``).  ``jit=False`` runs
    :func:`make_train_step`'s step eagerly everywhere.  Either way the loss
    is read on the host once a step.

    ``params`` of ``DTensor``s train sharded on their mesh (module
    docstring), on its device type, always eagerly (``captures == 0``); a
    ``device`` of another type raises ``ValueError``."""
    del batch, seq_len
    mesh = _mesh_of(params)
    if mesh is not None and device is not None and (
            resolve_device(device).type != mesh.device_type):
        raise ValueError(f"device={device!r} contradicts the parameters' mesh on "
                         f"{mesh.device_type!r}")
    dev = resolve_device(device if mesh is None else mesh.device_type)
    optimizer = optimizer or AdamW(lr=3e-4)
    mgr = CheckpointManager(ckpt_dir, keep=3)
    monitor = StragglerMonitor()
    losses: list[float] = []
    records: list[dict] = []
    restarts = captures = replays = 0
    capture_s: list[float] = []

    if mesh is None:
        step_fn = make_train_step(cfg, optimizer, grad_accum=grad_accum, device=dev)
    else:
        mi = SH.make_mesh_info(mesh)
        step_fn = make_sharded_train_step(
            cfg, optimizer, par=M.ParallelCfg(dispatch_groups=mi.dp_size),
            grad_accum=grad_accum)

    def fresh_state():
        if mesh is not None:
            p = M.map_tree(lambda t: t.detach().clone(), params)
            o = optimizer.init(p)
            return p, convert.distribute(o, SH.opt_pspecs(SH.param_pspecs(cfg, p, mi), o),
                                         mesh)
        if params is not None:
            p = M.map_tree(lambda t: t.detach().to(dev, copy=True), params)
        else:
            p = M.init(torch.Generator(device=dev).manual_seed(seed), cfg)
        return p, optimizer.init(p)

    graphed = jit and mesh is None
    while True:
        graph = None  # a restart drops the last start's graph with its state
        state_p, state_o = fresh_state()
        view = _ckpt_tree(state_p, state_o)
        t_restore = time.perf_counter()
        start, restored = mgr.restore_latest(view)
        if restored is not None:
            with torch.no_grad():
                for dst, src in zip(pytree.tree_leaves(view), pytree.tree_leaves(restored)):
                    SH.write_into(dst, src)
            records.append({"step": start, "kind": "restore",
                            "seconds": time.perf_counter() - t_restore})
            start_step = start
        else:
            start_step = 0

        try:
            step = start_step
            while step < steps:
                t0 = time.perf_counter()
                b = pipeline.device_batch(step, dev)
                if crash_at_step is not None and step == crash_at_step and restarts == 0:
                    restarts += 1
                    raise SimulatedFailure(f"injected failure at step {step}")
                if not graphed:
                    state_p, state_o, loss = step_fn(state_p, state_o, b)
                else:
                    if graph is None:
                        graph = TrainGraph(step_fn, state_p, state_o, b, name=cfg.name,
                                           capture=dev.type == "cuda", start=step)
                    replayed = graph.graph is not None
                    loss = graph.step(b)
                    replays += replayed
                    if not replayed and graph.graph is not None:
                        captures += 1
                        capture_s.append(graph.capture_s)
                losses.append(float(loss.to_local() if isinstance(loss, DTensor) else loss))
                step += 1
                monitor.record(step, time.perf_counter() - t0)
                if step % ckpt_every == 0 or step == steps:
                    t_save = time.perf_counter()
                    path = mgr.save(step, _ckpt_tree(state_p, state_o))
                    records.append({"step": step, "kind": "save",
                                    "seconds": time.perf_counter() - t_save,
                                    "bytes": sum(os.path.getsize(os.path.join(path, f))
                                                 for f in os.listdir(path))})
            mgr.wait()
            return TrainResult(
                steps_run=len(losses),
                final_step=step,
                losses=losses,
                restarts=restarts,
                straggler=monitor.summary(),
                step_times=list(monitor.times),
                checkpoints=records,
                captures=captures,
                replays=replays,
                capture_s=capture_s,
            )
        except SimulatedFailure:
            if restarts > max_restarts:
                raise
            continue  # auto-restart path: restore-from-latest and keep going
