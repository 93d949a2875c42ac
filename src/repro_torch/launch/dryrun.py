"""Production-mesh dry run: build and run every (arch × shape × mesh) cell's
sharded step on one rank of a fake process group (the port of
``repro/launch/dryrun.py``).

Per cell, in one process: a fake process group of 256 (one pod, 16×16) or
512 (two pods, 2×16×16) ranks comes up (``torch.distributed``'s ``"fake"``
backend: collectives move no bytes), ``launch.mesh.make_production_mesh``
builds the mesh, and :func:`build_cell` gives the cell's step (the train
step with its AdamW update, or the prefill / decode step with full caches)
and rank 0's local shards of every input, made directly (no full tensor)
as fake tensors (``FakeTensorMode``: no memory is allocated).  The step runs
once on them, with the fake mode no longer active, so DTensor derives its
shapes in a fake mode of its own that the counters tell apart, and records:

* ``memory.argument_bytes`` — the local shards of parameters, optimizer
  state, batch and caches; ``memory.peak_bytes_per_device`` — the peak of
  the live local storages (the arguments' and every one a local op makes,
  freed when its last tensor goes), from the dispatch mode below;
  ``memory.memtracker_peak_bytes`` — ``MemTracker``'s, beside it (torch
  2.13's agrees within a few percent; 2.11's also counts the global-shape
  tensors DTensor makes to propagate shapes);
* ``cost.flops_per_device`` — the local ops' FLOPs (``torch.utils.
  flop_counter``'s formulas, the kernels' own for K4–K6);
  ``cost.bytes_accessed_per_device`` is null: no PyTorch counter reports
  the bytes an op reads and writes;
* collectives — payload bytes (each collective's output) and op count by
  kind, from a dispatch mode over the ``_c10d_functional`` ops the step
  dispatches (the reference parses them from compiled HLO);
* ``params`` (total and active), ``analytic_flops`` (the reference's
  formula), timings, ``ok`` or the error.

The port loops over its layers and never scans, so every count covers
every layer: ``--unroll`` changes nothing, and the record says so.  The
kernels run as themselves (``attn_impl="pallas"``, ``scan_impl="pallas"``:
their fake implementations give the shapes), so the memory is the card's
route's, not ``attention_ref``'s ``[B, H, S, S]`` buffer.

Results stream to ``results/dryrun_torch/<cell>.json`` as they finish, so
a crashed sweep resumes where it left off (``--force`` recomputes); the
sweep goes on past a failed cell and exits 1 if any failed.  ``--device``
names the mesh's device type (no memory is allocated on it): the card by
default, which raises without one (``containers.resolve_device``); ``--device
cpu`` runs it on the CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both] --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref
from typing import Callable

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, cells, get_arch, list_archs
from repro_torch.core.containers import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.train_loop import make_sharded_train_step as make_train_step

RESULTS_DIR = "results/dryrun_torch"
#: Decode keeps parameters TP-only (replicated over data) when the TP shard
#: of the weights fits under this many bytes, as the reference decides.
SERVING_BYTES = 12 * 2**30


# ---------------------------------------------------------------------------
# Counting (the reference's arithmetic, copied)
# ---------------------------------------------------------------------------


def param_shapes(cfg: ArchConfig) -> dict:
    """The model's parameters as fake tensors (shapes and dtypes, no memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return M.init(torch.Generator(), cfg)


def param_counts(cfg: ArchConfig, shapes: dict | None = None) -> dict:
    shapes = param_shapes(cfg) if shapes is None else shapes
    return {"total": M.param_count(shapes), "active": M.active_param_count(shapes, cfg)}


def analytic_flops(cfg: ArchConfig, shape: ShapeSpec, params: dict | None = None) -> dict:
    """MODEL_FLOPS: 6·N·D (train) / 2·N·D (forward only), N the active
    parameters, plus the attention's score and PV FLOPs (not in 6ND), as
    the reference computes them."""
    n_active = (params or param_counts(cfg))["active"]
    if shape.kind == "train":
        base = 6 * n_active * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        base = 2 * n_active * shape.global_batch * shape.seq_len
    else:
        base = 2 * n_active * shape.global_batch  # one token each
    attn = 0
    mult = 3 if shape.kind == "train" else 1
    for kind in cfg.stage_pattern * cfg.n_stages + cfg.tail_pattern:
        if kind not in M._ATTN_KINDS:
            continue
        local = kind in ("attn_local", "attn_local_moe")
        s_q = 1 if shape.is_decode else shape.seq_len
        s_kv = shape.seq_len
        if local and cfg.window:
            s_kv = min(s_kv, cfg.window)
        if not shape.is_decode and not (local and cfg.window):
            s_kv_eff = s_kv / 2  # causal half
        else:
            s_kv_eff = s_kv
        attn += 4 * cfg.n_heads * cfg.d_head * s_q * s_kv_eff * shape.global_batch * mult
    return {"model_flops": float(base), "attn_flops": float(attn),
            "total": float(base + attn)}


# ---------------------------------------------------------------------------
# Sharded steps
# ---------------------------------------------------------------------------


def serving_params(cfg: ArchConfig, shape: ShapeSpec, mi: SH.MeshInfo,
                   shapes: dict) -> bool:
    """Decode holds the weights TP-only when their model-axis shard fits
    under ``SERVING_BYTES``; every other cell keeps FSDP (the reference's
    rule)."""
    nbytes = sum(t.numel() * t.element_size() for t in M.distinct_leaves(shapes))
    return shape.kind == "decode" and nbytes / mi.model_size < SERVING_BYTES


def make_serve_steps(cfg: ArchConfig, mi: SH.MeshInfo, batch: int, *,
                     par: M.ParallelCfg, attn_impl: str = "auto",
                     scan_impl: str = "auto") -> tuple[Callable, Callable]:
    """``(prefill(params, inputs, caches), decode(params, inputs, caches,
    cache_len))``, each returning ``(logits, caches)``: the caches updated
    in place, the logits over (dp where the batch divides, vocab on model)."""
    dp = mi.fsdp if batch % mi.dp_size == 0 else None

    @torch.no_grad()
    def prefill(params, inputs, caches):
        logits, caches = M.prefill(params, cfg, inputs, caches, par=par,
                                   attn_impl=attn_impl, scan_impl=scan_impl)
        return SH.relayout(logits, dp, mi.model), caches

    @torch.no_grad()
    def decode(params, inputs, caches, cache_len):
        logits, caches = M.decode_step(params, cfg, inputs, caches, cache_len, par=par,
                                       attn_impl=attn_impl, scan_impl=scan_impl)
        return SH.relayout(logits, dp, mi.model), caches

    return prefill, decode


def input_shapes(cfg: ArchConfig, shape: ShapeSpec, device) -> dict:
    """Stand-ins (fake tensors) for every model input of the cell."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    b, s = shape.global_batch, shape.seq_len
    q = 1 if shape.is_decode else s
    with FakeTensorMode():
        if cfg.embed_inputs:
            inputs = torch.empty((b, q), dtype=torch.int32, device=device)
        else:
            inputs = torch.empty((b, q, cfg.d_model), dtype=cfg.cdtype, device=device)
        if shape.kind == "train":
            return {"inputs": inputs,
                    "labels": torch.empty((b, s), dtype=torch.int32, device=device)}
        return {"inputs": inputs, "caches": M.make_caches(cfg, b, s, device)}


@dataclasses.dataclass
class Cell:
    """A cell's step and rank-local inputs: ``step(*args)`` runs it."""

    step: Callable
    args: tuple
    serving: bool
    moment_dtype: str | None
    params: dict  # shapes (fake), for the counts


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *, make: Callable | None = None,
               attn_impl: str = "pallas", scan_impl: str = "pallas") -> Cell:
    """The cell's sharded step on ``mesh`` and this rank's shards of its
    inputs, each made by ``make(local_shape, dtype)`` (default: ``torch.
    empty`` on the mesh's device; under ``FakeTensorMode``, fake tensors).
    Placements are the policy's: parameters by ``param_pspecs`` (TP-only for
    decode where it fits), AdamW moments by ``opt_pspecs`` (bf16 above 3e10
    parameters), batch by ``batch_pspecs``, caches by ``cache_pspecs``;
    ``ParallelCfg(dispatch_groups=dp_size)``."""
    mi = SH.make_mesh_info(mesh)
    dev = mesh.device_type
    if make is None:
        def make(local, dtype):
            return torch.empty(local, dtype=dtype, device=dev)
    shapes = param_shapes(cfg)
    serving = serving_params(cfg, shape, mi, shapes)
    pspecs = SH.param_pspecs(cfg, shapes, mi, serving=serving)
    params = SH.shard_like(shapes, pspecs, mesh, make)
    par = M.ParallelCfg(dispatch_groups=mi.dp_size)
    inputs = input_shapes(cfg, shape, dev)
    if shape.kind == "train":
        moment_dtype = "bfloat16" if M.param_count(shapes) > 3e10 else "float32"
        opt = AdamW(lr=1e-4, moment_dtype=moment_dtype)
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode(allow_non_fake_inputs=True):
            oshapes = opt.init(shapes)
        ostate = SH.shard_like(oshapes, SH.opt_pspecs(pspecs, oshapes), mesh, make)
        batch = SH.shard_like(inputs, SH.batch_pspecs(cfg, inputs, mi), mesh, make)
        step = make_train_step(cfg, opt, par=par, attn_impl=attn_impl, scan_impl=scan_impl)
        return Cell(step, (params, ostate, batch), serving, moment_dtype, shapes)
    prefill, decode = make_serve_steps(cfg, mi, shape.global_batch, par=par,
                                       attn_impl=attn_impl, scan_impl=scan_impl)
    cspecs = SH.cache_pspecs(cfg, shape.global_batch, shape.seq_len, mi, kind=shape.kind)
    caches = SH.shard_like(inputs["caches"], cspecs, mesh, make)
    tokens = SH.shard_like(inputs["inputs"],
                           SH.batch_pspecs(cfg, inputs["inputs"], mi), mesh, make)
    if shape.kind == "prefill":
        return Cell(prefill, (params, tokens, caches), serving, None, shapes)
    # decode: one new token against a cache of seq_len rows, the last row free
    return Cell(decode, (params, tokens, caches, shape.seq_len - 1), serving, None, shapes)


# ---------------------------------------------------------------------------
# What a cell dispatches
# ---------------------------------------------------------------------------

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}


class DispatchCounter(TorchDispatchMode):
    """The local ops a step dispatches: FLOPs by ``torch.utils.
    flop_counter``'s formulas, each ``_c10d_functional`` collective's
    payload (its output's bytes) and count by kind, and the live bytes of
    the storages the ops make (their peak).  ``DTensor`` ops are
    passed down (``NotImplemented``) so the counter sees the local ops and
    collectives they become; ops DTensor runs on fake tensors to propagate
    shardings (another fake mode than the one active at entry) are not
    counted."""

    def __init__(self, held=()):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self._flops = FlopCounterMode(display=False)
        self.collectives: dict[str, float] = {}
        self.n_collectives = 0
        self.largest_collective = 0  # bytes of the largest one output
        # live storages of the step's local tensors: key -> [bytes, tensors];
        # the arguments' (``held``) stay live, and a view of one is no new
        # storage
        self._live: dict[int, list] = {}
        for t in held:
            st = t.untyped_storage()
            self._live.setdefault(st._cdata, [st.nbytes(), 1])
        self.live_bytes = self.peak_bytes = sum(b for b, _ in self._live.values())

    def _track(self, t: torch.Tensor) -> None:
        key = t.untyped_storage()._cdata
        ent = self._live.get(key)
        if ent is None:
            ent = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += ent[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        ent[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ent = self._live.get(key)
        if ent is not None:
            ent[1] -= 1
            if ent[1] == 0:
                self.live_bytes -= ent[0]
                del self._live[key]

    def __enter__(self):
        from torch._guards import active_fake_mode

        self._entry_fake = active_fake_mode()
        return super().__enter__()

    @property
    def flops(self) -> int:
        return self._flops.get_total_flops()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode

        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._entry_fake:
            return out
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
                self._track(t)
        packet = func._overloadpacket
        if packet in self._flops.flop_registry:
            self._flops._count_flops(packet, out, args, kwargs)
        if func.namespace == "_c10d_functional" and packet.__name__ in _COLLECTIVES:
            kind = _COLLECTIVES[packet.__name__]
            outs = out if isinstance(out, (list, tuple)) else [out]
            nbytes = sum(o.numel() * o.element_size() for o in outs)
            self.collectives[kind] = self.collectives.get(kind, 0.0) + float(nbytes)
            self.largest_collective = max(self.largest_collective, nbytes)
            self.n_collectives += 1
        return out


def _locals(tree) -> list:
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in SH.leaves(tree) if isinstance(t, torch.Tensor)]


def measure_cell(cell: Cell) -> dict:
    """Run the cell's step once, counting: ``{"memory", "cost",
    "collectives", "run_s"}``.  With fake shards (made under a
    ``FakeTensorMode``, which must not be active here) nothing of size is
    allocated."""
    from torch.distributed._tools.mem_tracker import MemTracker

    args = cell.args
    arg_bytes = sum(SH.local_bytes(a) for a in args if not isinstance(a, int))
    held = [t for a in args if not isinstance(a, int) for t in _locals(a)]
    tracker = MemTracker()
    tracker.track_external(*held)
    counter = DispatchCounter(held)
    t0 = time.perf_counter()
    with tracker, counter:
        cell.step(*args)
    run_s = time.perf_counter() - t0
    peak = tracker.get_tracker_snapshot("peak")
    dev_peak = max(peak.values(), key=lambda v: v.get("Total", 0)) if peak else {}
    coll = dict(counter.collectives)
    coll["n_collective_ops"] = counter.n_collectives
    coll["largest_output_bytes"] = counter.largest_collective
    return {
        "memory": {"argument_bytes": arg_bytes, "peak_bytes_per_device": counter.peak_bytes,
                   "memtracker_peak_bytes": int(dev_peak.get("Total", 0)),
                   "memtracker_peak_by_kind": {getattr(k, "value", str(k)): int(v)
                                               for k, v in dev_peak.items()}},
        "cost": {"flops_per_device": float(counter.flops),
                 "bytes_accessed_per_device": None,
                 "bytes_accessed_why": "no PyTorch counter reports the bytes an op "
                                       "reads and writes"},
        "collectives": coll, "run_s": run_s,
    }


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------


def fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, unroll: bool = False,
             variant: str = "baseline", out_dir: str = RESULTS_DIR, force: bool = False,
             device: str = "cpu") -> dict:
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_production_mesh

    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}_{shape_name}_{mesh_tag}_{variant}" + ("_unroll" if unroll else "")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, cell_id + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag, "variant": variant,
           "unroll": unroll, "device": device, "ok": False,
           "unroll_note": "the port loops over its layers: every count covers every "
                          "layer with or without --unroll"}
    t_start = time.time()
    fake_group(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        t0 = time.time()
        with FakeTensorMode(allow_non_fake_inputs=True):
            cell = build_cell(cfg, shape, mesh)
        rec["build_s"] = time.time() - t0
        # The step runs on the fake shards with no fake mode active: DTensor
        # then derives shapes in a fake mode of its own, which the counters
        # tell apart from the step's local ops.
        rec.update(measure_cell(cell))
        rec["serving"] = cell.serving
        rec["moment_dtype"] = cell.moment_dtype
        rec["params"] = param_counts(cfg, cell.params)
        rec["param_bytes_per_device"] = SH.local_bytes(cell.args[0])
        rec["analytic_flops"] = analytic_flops(cfg, shape, rec["params"])
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 - record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        dist.destroy_process_group()
    rec["total_s"] = time.time() - t_start
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    mem = rec.get("memory", {}).get("peak_bytes_per_device", 0) / 2**30
    print(f"[dryrun] {cell_id}: {'OK' if rec['ok'] else 'FAIL'} "
          f"(run {rec.get('run_s', 0):.0f}s peak {mem:.2f} GiB/dev)", flush=True)
    return rec


def peak_table(recs: list[dict]) -> str:
    """A markdown table of the records' per-device peaks in GiB (``FAIL``
    for a failed cell): one row an arch, one column a shape and mesh."""
    cols = sorted({(r["shape"], r["mesh"]) for r in recs},
                  key=lambda c: (list(SHAPES).index(c[0]), c[1]))
    rows: dict[str, dict] = {}
    for r in recs:
        rows.setdefault(r["arch"], {})[(r["shape"], r["mesh"])] = (
            f"{r['memory']['peak_bytes_per_device'] / 2**30:.2f}" if r["ok"] else "FAIL")
    lines = ["| arch | " + " | ".join(f"{s} {m}" for s, m in cols) + " |",
             "|---|" + "---|" * len(cols)]
    lines += [f"| {a} | " + " | ".join(row.get(c, "") for c in cols) + " |"
              for a, row in sorted(rows.items())]
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--unroll", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default: cuda, which raises without "
                         "a card; --device cpu runs the dry run on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]
    recs = []
    for arch in archs:
        cfg = get_arch(arch)
        for shape in ([SHAPES[args.shape]] if args.shape else cells(cfg)):
            if shape.name == "long_500k" and not cfg.supports_long_context:
                continue
            for mp in pods:
                recs.append(run_cell(arch, shape.name, multi_pod=mp, unroll=args.unroll,
                                     variant=args.variant, out_dir=args.out,
                                     force=args.force, device=device))
    print(peak_table(recs))
    n_fail = sum(not r["ok"] for r in recs)
    print(f"[dryrun] done: {len(recs) - n_fail} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
