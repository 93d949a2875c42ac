#!/usr/bin/env python3
"""Time K4's ``"dh"`` form on one card, alone and on the sharded decode path,
faster than the whole smoke.

Run from the repository root::

    python3 profiling/dh_probe.py [--steps N] [--no-kernels]

First (unless ``--no-kernels``) the smoke's own check of the form
(``chip_smoke.Smoke.dh_phase``: ``dh_logits`` and ``dh_softmax_pv`` at rank
0's local shapes of gemma2-9b's global and local layers, qwen3-0.6b and
musicgen-medium, ``d_head`` split into 16 slices, held to
``attention_ref``), one JSON line a kernel and shape.  Then rank 0 of the
16 × 16 production mesh over a fake group of 256 ranks (collectives move
nothing), gemma2-9b ``decode_32k`` on real local shards as the smoke's
shard phase builds them, its decode step with the two routes of the
``"dh"`` layout in turns (kernels, plain pair, plain pair, kernels): for
each turn one warm-up step, then N steps timed on the host clock around
a synchronised card (median and least), and one step under
``torch.profiler`` (the card's busy ms: kernel and copy intervals), with
the step's launches and plain calls.  Then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def busy_ms(torch, fn) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


def step_turns(torch, steps: int) -> None:
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model as M

    import chip_smoke

    cfg, shape = D.get_arch("gemma2-9b"), D.SHAPES["decode_32k"]
    D.fake_group(256)
    try:
        mesh = make_production_mesh(device="cuda")
        mi = D.SH.make_mesh_info(mesh)
        cell = D.build_cell(cfg, shape, mesh,
                            make=chip_smoke.shard_maker(cfg, torch.device("cuda")))
        par = M.ParallelCfg(dispatch_groups=mi.dp_size)
        routes = {impl: D.make_serve_steps(cfg, mi, shape.global_batch, par=par,
                                           attn_impl=impl)[1] for impl in ("pallas", "ref")}
        for impl in ("pallas", "ref", "ref", "pallas"):
            step = routes[impl]
            step(*cell.args)
            torch.cuda.synchronize()
            FA.dh_logits.launches = FA.dh_softmax_pv.launches = 0
            plain = ops.attention.dh_plain_calls
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(steps):
                t0 = time.perf_counter()
                step(*cell.args)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            counts = {"dh_logits": FA.dh_logits.launches / steps,
                      "dh_softmax_pv": FA.dh_softmax_pv.launches / steps,
                      "plain_calls": (ops.attention.dh_plain_calls - plain) / steps}
            print(json.dumps({
                "route": "kernels" if impl == "pallas" else "plain pair",
                "step_ms_median": statistics.median(times), "step_ms_min": min(times),
                "step_ms": times, "a_step": counts,
                "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                "busy_ms": busy_ms(torch, lambda: step(*cell.args))}), flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--no-kernels", action="store_true")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dh_probe.py: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build

    _build.build(["flash_attention", "flash_attention_dh"])
    if not args.no_kernels:
        chip_smoke.Smoke(torch).dh_phase()
    step_turns(torch, args.steps)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
