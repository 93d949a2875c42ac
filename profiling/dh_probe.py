#!/usr/bin/env python3
"""Time K4's ``"dh"`` form on one card, alone and on the sharded decode path,
faster than the whole smoke.

Run from the repository root::

    python3 profiling/dh_probe.py [--steps N] [--no-kernels] [--no-step] [--ablation]

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
the step's launches (by form: ``"ring"`` or ``"element"``) and plain calls.
``--no-step`` leaves the step out.

With ``--ablation`` it times both kernels with parts taken out, one library
each, built from ``csrc/flash_attention_dh.cu`` into ``build/profiling/``
(all ``nvcc`` processes started together): ``base`` (the source as it is),
``no_compute`` (``dh_logits``' products), ``no_store`` (its stores of the
logits), ``no_softmax`` (``dh_softmax_pv``'s softcap, masks and online
softmax), ``no_pv`` (its weights times v), ``no_merge`` (the last CTA's
merge), ``copies_only`` (neither kernel computes or stores: the ring's
copies and the barriers), ``no_copies`` (``dh_softmax_pv``'s consumers
alone, no copy), ``merge_only`` (no tile streamed: the tickets and the
merge alone) and ``merge_noload`` (the merge without its staging loads),
whose results are wrong by design; and ``ctas3`` (``dh_softmax_pv`` with
three resident CTAs an SM: launch bounds and plan), ``stages6`` (a ring of
up to 6 stages), ``one_cta_plan`` (``dh_softmax_pv`` planned for one CTA
an SM), ``fast_exp`` (the softmax's exponentials by ``__expf``) and
``evict_first_all`` (every bulk copy with an L2 evict-first hint, the
logits rows' too).
``--variants`` picks some.  Device ms
(``torch.profiler``: each kernel's mean over the launches of 20 calls that
it recorded, and their count) at rank 0's shapes of the smoke's
``dh_phase`` (gemma2-9b global and local, qwen3-0.6b, musicgen-medium), one
slice, one JSON line a variant and shape.  Then the card's name
and power limit.
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


def kernel_ms(torch, call, name: str, reps: int = 20) -> tuple[float, int]:
    """The mean device ms of kernel ``name`` over the launches of ``reps``
    calls that ``torch.profiler`` recorded (it may miss some), and their
    count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    return (sum(times) / len(times) if times else None), len(times)


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
            for fn in (FA.dh_logits, FA.dh_softmax_pv):
                fn.forms = dict.fromkeys(fn.forms, 0)
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
                      "plain_calls": (ops.attention.dh_plain_calls - plain) / steps,
                      "forms": {fn.__name__: {f: n / steps for f, n in fn.forms.items()}
                                for fn in (FA.dh_logits, FA.dh_softmax_pv)}}
            print(json.dumps({
                "route": "kernels" if impl == "pallas" else "plain pair",
                "step_ms_median": statistics.median(times), "step_ms_min": min(times),
                "step_ms": times, "a_step": counts,
                "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                "busy_ms": busy_ms(torch, lambda: step(*cell.args))}), flush=True)
    finally:
        dist.destroy_process_group()


_LG_COMPUTE = "      for (int kb = 0; kb < nk; kb += kl_n * KPT) {\n"
_LG_STORE = "    for (int e = tid; e < rows * (kTile / 4); e += kConsumers) {\n"
_PV_SOFTMAX = "    pv_softmax<RING>(a, c, lt, Pi, Ci, j0, inv_cap);\n"
_PV_PV = "          const int nk = min(kTile, a.skv - (j0 + t * kTile)), k1 = min(k0 + kb, nk);\n"
_PV_MERGE = "  if (!last) return;\n"
VARIANTS = {
    "base": [],
    "no_compute": [(_LG_COMPUTE, _LG_COMPUTE.replace("kb < nk", "kb < 0"))],
    "no_store": [(_LG_STORE, _LG_STORE.replace("e < rows * (kTile / 4)", "e < 0"))],
    "no_softmax": [(_PV_SOFTMAX, "")],
    "no_pv": [(_PV_PV, _PV_PV.replace("min(k0 + kb, nk)", "k0"))],
    "no_merge": [(_PV_MERGE, "  return;\n")],
}
VARIANTS["copies_only"] = [edit for name in ("no_compute", "no_store", "no_softmax", "no_pv",
                                             "no_merge") for edit in VARIANTS[name]]
# Three resident CTAs an SM (launch bounds and the plan), right results.
VARIANTS["ctas3"] = [("constexpr int kPvCtas = 2;", "constexpr int kPvCtas = 3;")]
PLAN_CTAS = {"ctas3": {"softmax_pv": 3}, "one_cta_plan": {"softmax_pv": 1}}
# A ring of up to 6 stages (the plan takes as many as keep two CTAs an SM).
VARIANTS["stages6"] = [("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 6;")]
PLAN_STAGES = {"stages6": 6}
# The logits rows' bulk copies with an L2 evict-first hint too (k's and v's
# have it).
VARIANTS["evict_first_all"] = [("#include \"tma_bulk.cuh\"\n", """#include "tma_bulk.cuh"
__device__ __forceinline__ void bulk_copy_g2s_ef(void* dst, const void* src, uint32_t bytes,
                                                 uint64_t* bar) {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\\n" : "=l"(pol));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)), "l"(pol) : "memory");
}
#define bulk_copy_g2s bulk_copy_g2s_ef
""")]
# dh_softmax_pv's consumers alone: no copy (each stage's barrier completes
# on the producer's arrival; the consumers read what the stage holds).
_PV_EXPECT = "          mbar_arrive_expect_tx(&full[s], bytes + uint32_t(nk) * key_bytes);\n"
_PV_VCOPY = "        if (a.v.ss == (long long)w) {  // the tile's keys are one run\n"
_PV_ROWCOPY = ("            bulk_copy_g2s(stage + v_words + r * kLdp, a.lg + a0, "
               "uint32_t(a1 - a0) * 4, &full[s]);\n")
VARIANTS["no_copies"] = [(_PV_EXPECT, "          mbar_arrive(&full[s]);\n"),
                         (_PV_VCOPY, "        if (false) {\n"),
                         ("            bulk_copy_g2s_evict_first(dst + kk * key_bytes, src + kk * "
                          "a.v.ss * es, key_bytes,\n                                      "
                          "&full[s]);\n", "            ;\n"),
                         (_PV_ROWCOPY, "            ;\n")]
# The softmax's exponentials by the approximate unit (__expf); dh_softmax_pv
# planned for one CTA an SM (half the splits).
VARIANTS["fast_exp"] = [("      p[u] = expf(x[u] - m_new);", "      p[u] = __expf(x[u] - m_new);"),
                        ("        const float cr = expf(m_old - m_new);",
                         "        const float cr = __expf(m_old - m_new);")]
VARIANTS["one_cta_plan"] = []
# No tile streamed (zero partials, then the tickets and the merge); the
# merge without its staging loads.
_PV_N = ("  const int t_begin = a.t_lo + split * a.per, "
         "n = max(0, min(a.t_hi, t_begin + a.per) - t_begin);\n")
VARIANTS["merge_only"] = [(_PV_N, _PV_N.replace("n = max(0,", "n = 0 * max(0,"))]
_PV_STAGE = ("    stage_l2(reinterpret_cast<float4*>(smem), reinterpret_cast<const float4*>(src), "
             "words / 4);\n")
VARIANTS["merge_noload"] = [(_PV_STAGE, "    ;\n")]


def ablation(torch, names=None) -> None:
    """Build the variants (``names``, default all), then time both kernels
    on each, in turns."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA

    out_dir = ROOT / "build" / "profiling"
    out_dir.mkdir(parents=True, exist_ok=True)
    base = (_build.CSRC / "flash_attention_dh.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        if names and name not in names:
            continue
        src = base
        for old, new in edits:
            assert src.count(old) == 1, f"{name}: text not found once: {old!r}"
            src = src.replace(old, new)
        (out_dir / f"dh_{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out_dir / f"dh_{name}.so"), str(out_dir / f"dh_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"dh variant {name}: nvcc exited {proc.returncode}\n{report}")
        libs[name] = ctypes.CDLL(str(out_dir / f"dh_{name}.so"))
    g = torch.Generator(device="cuda").manual_seed(3)
    shapes = {}
    # rank 0's slices: query heads, kv heads, d_head / 16, view start, window, softcap
    for key, hq, hkv, dl, start, window, cap in (
            ("gemma2-global", 16, 8, 16, 0, None, 50.0),
            ("gemma2-local", 16, 8, 16, 32768 - 4097, 4096, 50.0),
            ("qwen3", 16, 8, 8, 0, None, 0.0), ("musicgen", 24, 24, 4, 0, None, 0.0)):
        cache = torch.randn((8, 32768, hkv, dl), generator=g, device="cuda").to(torch.bfloat16)
        q = (torch.randn((8, 1, hq, dl), generator=g, device="cuda") * 3).to(
            torch.bfloat16).transpose(1, 2)
        kv = cache[:, start:].transpose(1, 2)
        skv = kv.shape[2]
        kw = dict(causal=True, window=window, softcap=cap, q_offset=skv - 1)
        shapes[key] = (q, kv, kw, FA.dh_logits(q, kv, 0.0625))
    entry, ctas, stages = FA._dh_kernel, dict(FA.DH_CTAS_PER_SM), FA.DH_STAGES
    try:
        for name, lib in libs.items():
            FA.DH_CTAS_PER_SM.update(PLAN_CTAS.get(name, ctas))
            FA.DH_STAGES = PLAN_STAGES.get(name, stages)
            FA.dh_plan.cache_clear()
            def variant(symbol, lib=lib):
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = entry(symbol).argtypes, entry(symbol).restype
                return fn
            FA._dh_kernel = variant
            FA._DH_TICKETS.clear()  # a variant without the merge leaves its counters set
            for key, (q, kv, kw, logits) in shapes.items():
                row = {"probe": "dh ablation", "variant": name, "shape": key}
                for kernel, call in (("dh_logits", lambda: FA.dh_logits(q, kv, 0.0625)),
                                     ("dh_softmax_pv", lambda: FA.dh_softmax_pv(logits, kv, **kw))):
                    call()
                    torch.cuda.synchronize()
                    row[kernel], row[kernel + " events"] = kernel_ms(torch, call, kernel)
                print(json.dumps(row), flush=True)
    finally:
        FA._dh_kernel = entry
        FA.DH_CTAS_PER_SM.update(ctas)
        FA.DH_STAGES = stages
        FA.dh_plan.cache_clear()
        FA._DH_TICKETS.clear()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--no-kernels", action="store_true")
    parser.add_argument("--no-step", action="store_true")
    parser.add_argument("--ablation", action="store_true")
    parser.add_argument("--variants", nargs="*", help="the ablation's variants (all by default)")
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
    if args.ablation:
        ablation(torch, args.variants)
    if not args.no_step:
        step_turns(torch, args.steps)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
