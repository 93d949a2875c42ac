#!/usr/bin/env python3
"""Time K2 (``hash_aggregate``) and K6 (``rwkv6_scan``) at the main path's
shapes on one card, faster than the whole smoke.

Run from the repository root::

    python3 profiling/k2_k6_probe.py [--src DIR] [--tag NAME] [--phases] [--wordcount RUNS]
                                     [--first-calls N] [--k6-ablation]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two trees can be compared in one run on
one card: unpack the other tree into a git-ignored directory and run the
probe once for each, in turns.  K2 at wordcount's combine (the smoke's
corpus: 2^21 lines of 64 Zipf(1.3) tokens over 2^19 words, ragged, dead
lanes included, i32 ones into 2^20 slots, 64 probes; and with one probe
round, which leaves the pre-combine and the first round) and merge (that table
into an empty 2^21-slot one); K6 at rwkv6-1.6b's prefill (r, k, v ``[8,
512, 32, 64]`` bf16) and decode (one step from the prefill's state).  Event
time (median of 10 after two warm-ups) and device time (``torch.profiler``,
every kernel on the card, mean per call), one JSON line each, then the
card's name and power limit.

With ``--wordcount RUNS`` it first runs the smoke's wordcount job (engine
``"pallas"``, the same corpus) RUNS times through one ``BlazeSession`` and
prints each run's wall time (host clock, the card synchronised), the first
run included.  With ``--phases`` it first times the phases of K2's combine: it copies
``csrc/hash_combine.cu`` into ``build/profiling/``, inserts ``%globaltimer``
reads in each CTA's thread 0 (start; the pre-combine's walk; the table's
flush and the grid barrier; round 0's claims and barrier; round 0; the
other rounds), builds it as ``_build`` does and prints each phase's median
over the CTAs that reached it (the last rounds run in CTA 0 alone) and the
kernel's span (the probes add a few instructions).

With ``--first-calls N`` it times, on the host clock with the card
synchronised, the first N calls of K2's combine in this process (its entry
already loaded), with the allocator's reserved bytes before and after each:
the first call takes its scratch (about 2.1 GB at wordcount's shape) with
``cudaMalloc``, the later ones from PyTorch's cache.  Run it without
``--wordcount``, which would warm the cache first.

With ``--k6-ablation`` it times K6's prefill form with parts of its chunk
program taken out, one library each, built from ``csrc/rwkv6_scan.cu`` into
``build/profiling/`` (all ``nvcc`` processes started together): ``base``
(the source as it is), ``no_exp`` (the floored logs and the exponentials
replaced by their arguments), ``no_loads`` (no chunk after the first is
loaded), ``no_scores`` (no score block and no scores·v product) and
``no_products`` (none of the four products).  The results are wrong by
design; each variant's event time (median and least of 20 after two
warm-ups) and device time are printed, the variants in turns.
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
REPS = 10
K2_PHASES = ["walk", "flush_and_sync", "claim0_and_sync", "round0", "other_rounds"]
# (marker in hash_aggregate_kernel, probe index recorded after it)
K2_PROBES = [
    ("  cg::grid_group grid = cg::this_grid();\n", 0),
    ("  // The table's slots follow the pass-through lanes.\n", 1),
    ("  int count = cursor;  // this CTA's compacted lanes\n  grid.sync();\n", 2),
    ("claim_slot(a.skey[lo + i], 0);\n  grid.sync();\n", 3),
    ("      if (tid == 0 && count) atomicAdd(a.live + round + 1, count);\n      grid.sync();\n"
     "    }\n", 4),
    ("  if (blockIdx.x == 0 && tid == 0) atomicAdd(a.rounds", 5),
]
MAX_CTAS = 4096
# (variant, [(text of csrc/rwkv6_scan.cu, what replaces it)])
_NO_SCORES = [("for (int kb = 0; kb <= (warp & 3); ++kb) {", "for (int kb = 0; kb < 0; ++kb) {")]
K6_VARIANTS = [
    ("base", []),
    ("no_exp", [
        ("floored_log(lw[i][0], a.floor)", "lw[i][0]"),
        ("floored_log(lw[i][1], a.floor)", "lw[i][1]"),
        ("dect[ch] = expf(tot);", "dect[ch] = tot;"),
        ("scl[ch] = expf(0.5f * tot);", "scl[ch] = 0.5f * tot;"),
        ("rv[i][e] * expf(prev - lamh[ch]);", "rv[i][e] * (prev - lamh[ch]);"),
        ("kv[i][e] * expf(lamh[ch] - lm[l * kLdLam + ch]);",
         "kv[i][e] * (lamh[ch] - lm[l * kLdLam + ch]);"),
    ]),
    ("no_loads", [("if (c0s + a.tile < a.s) load_chunk(c0s + a.tile);", "")]),
    ("no_scores", _NO_SCORES),
    ("no_products", _NO_SCORES + [
        ("gemm<false, true, 2, ORD>(acc, a_rows, s_cols, nk, lane);", ""),
        ("gemm<true, true, 2, ORD>(acc, b_cols, v_cols, ks, lane);", ""),
    ]),
]


def k2_instrumented_source(csrc: Path) -> str:
    src = (csrc / "hash_combine.cu").read_text()
    for marker, i in K2_PROBES:
        assert src.count(marker) == 1, f"probe marker not found once: {marker!r}"
        probe = f"  PROBE({i})\n" if i != 4 else "    if (round == 0) PROBE(4)\n"
        at = src.index(marker) + (len(marker) if i != 5 else 0)
        src = src[:at] + probe + src[at:]
    head = src.index("namespace {")
    return (src[:head]
            + f"__device__ unsigned long long g_probe[6 * {MAX_CTAS}];\n"
            + "#define PROBE(i) if (threadIdx.x == 0 && blockIdx.x < " + str(MAX_CTAS) + ") { "
              "unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
              "g_probe[6ull * blockIdx.x + (i)] = t_; }\n"
            + src[head:]
            + "\nextern \"C\" int blaze_probe_read(void* dst, size_t bytes) {\n"
              "  return int(cudaMemcpyFromSymbol(dst, g_probe, bytes));\n}\n")


def k2_phases(keys, ones, cap, probes):
    """Run the instrumented K2 on the combine and print its phases."""
    import ctypes

    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import hash_combine as HK

    out_dir = ROOT / "build" / "profiling"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "hash_combine_phases.cu").write_text(k2_instrumented_source(_build.CSRC))
    lib_path = out_dir / "hash_combine_phases.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(lib_path), str(out_dir / "hash_combine_phases.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.blaze_hash_aggregate
    fn.argtypes = HK._kernel().argtypes
    fn.restype = ctypes.c_int
    kernel = HK._kernel
    HK._kernel = lambda: fn  # the wrapper launches the instrumented library
    try:
        for _ in range(3):  # the last run's records are read
            HK.hash_aggregate(keys, ones, cap, max_probes=probes)
        torch.cuda.synchronize()
    finally:
        HK._kernel = kernel
    rec = np.zeros(6 * MAX_CTAS, dtype=np.uint64)
    _build.check(lib.blaze_probe_read(ctypes.c_void_p(rec.ctypes.data),
                                      ctypes.c_size_t(rec.nbytes)), "k2 phases")
    r = rec.reshape(-1, 6).astype(np.int64)
    r = r[r[:, 0] > 0]
    # A CTA that leaves once CTA 0 takes the last rounds alone records no
    # later phase: each phase's median is over the CTAs that recorded it.
    print(json.dumps({
        "probe": "hash_aggregate@wordcount-combine phases", "ctas": len(r),
        "kernel_us": float((r[:, 5].max() - r[:, 0].min()) / 1e3),
        "phase_us_median": {ph: float(np.median((r[:, i + 1] - r[:, i])[r[:, i + 1] > 0]) / 1e3)
                            for i, ph in enumerate(K2_PHASES)},
        "phase_ctas": {ph: int((r[:, i + 1] > 0).sum()) for i, ph in enumerate(K2_PHASES)},
    }), flush=True)


def k6_variant_sources(csrc: Path) -> dict[str, str]:
    base = (csrc / "rwkv6_scan.cu").read_text()
    out = {}
    for name, edits in K6_VARIANTS:
        src = base
        for old, new in edits:
            assert src.count(old) == 1, f"{name}: text not found once: {old!r}"
            src = src.replace(old, new)
        out[name] = src
    return out


def k6_ablation(prefill, event_times, device_ms):
    """Build the K6 variants, then time ``prefill`` on each."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv6_scan as RK

    out_dir = ROOT / "build" / "profiling"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in k6_variant_sources(_build.CSRC).items():
        (out_dir / f"rwkv6_{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out_dir / f"rwkv6_{name}.so"), str(out_dir / f"rwkv6_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"rwkv6 variant {name}: nvcc exited {proc.returncode}\n{report}")
        fn = ctypes.CDLL(str(out_dir / f"rwkv6_{name}.so")).blaze_rwkv6_scan
        fn.argtypes = RK._kernel().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    kernel = RK._kernel
    times = {name: [] for name in fns}
    try:
        for _ in range(2):  # the variants in turns, twice
            for name, fn in fns.items():
                RK._kernel = lambda fn=fn: fn
                times[name] += event_times(prefill)
        for name, fn in fns.items():
            RK._kernel = lambda fn=fn: fn
            print(json.dumps({"probe": "rwkv6_scan@rwkv6-prefill ablation", "variant": name,
                              "ms_median": statistics.median(times[name]),
                              "ms_min": min(times[name]), "device_ms": device_ms(prefill)}),
                  flush=True)
    finally:
        RK._kernel = kernel


def k2_first_calls(calls, combine):
    """Host time of the first ``calls`` combines in this process."""
    import torch
    from repro_torch.kernels import hash_combine as HK

    HK._kernel()  # built and loaded before the clock starts
    torch.cuda.synchronize()
    walls, reserved = [], [torch.cuda.memory_reserved()]
    for _ in range(calls):
        t0 = time.perf_counter()
        combine()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        reserved.append(torch.cuda.memory_reserved())
    print(json.dumps({"probe": "hash_aggregate@wordcount-combine, first calls",
                      "wall_ms": [1e3 * t for t in walls], "reserved_bytes": reserved}),
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--tag", default="this tree")
    parser.add_argument("--phases", action="store_true")
    parser.add_argument("--wordcount", type=int, default=0, metavar="RUNS")
    parser.add_argument("--first-calls", type=int, default=0, metavar="N")
    parser.add_argument("--k6-ablation", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("k2_k6_probe.py: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core import cost
    from repro_torch.data.synthetic import zipf_corpus
    from repro_torch.kernels.hash_combine import EMPTY_KEY, hash_aggregate
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan

    def event_times(fn) -> list[float]:
        for _ in range(2):
            fn()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return times

    def event_ms(fn) -> float:
        return statistics.median(event_times(fn))

    def device_ms(fn) -> float:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e3 / REPS

    def report(what, fn, **extra):
        print(json.dumps({"tree": args.tag, "probe": what, "ms": event_ms(fn),
                          "device_ms": device_ms(fn), **extra}), flush=True)

    dev = torch.device("cuda")
    lines, _ = zipf_corpus(1 << 21, 64, 1 << 19, seed=0)
    if args.wordcount:
        from repro_torch.core import BlazeSession
        from repro_torch.core.algorithms import wordcount

        sess = BlazeSession(device=dev)
        walls = []
        for _ in range(args.wordcount):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wordcount(lines, engine="pallas", vocab_size=1 << 19, session=sess)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(json.dumps({"tree": args.tag, "probe": "wordcount (pallas)", "wall_s": walls,
                          "median_s": statistics.median(walls)}), flush=True)
        del sess
    tokens = torch.from_numpy(lines).to(dev)
    keys = torch.where(tokens >= 0, tokens, EMPTY_KEY).reshape(-1).contiguous()
    del tokens, lines
    ones = torch.ones((keys.shape[0], 1), dtype=torch.int32, device=dev)
    cap = cost.table_capacity(keys.shape[0], 1 << 19)
    probes = cost.choose_probe_depth(keys.shape[0], cap)
    if args.first_calls:
        k2_first_calls(args.first_calls, lambda: hash_aggregate(keys, ones, cap, max_probes=probes))
    if args.phases:
        k2_phases(keys, ones, cap, probes)
    report("hash_aggregate@wordcount-combine",
           lambda: hash_aggregate(keys, ones, cap, max_probes=probes), shape=[keys.shape[0], cap])
    # The pre-combine and round 0 alone, and the compacted lanes each round.
    report("hash_aggregate@wordcount-combine, 1 round",
           lambda: hash_aggregate(keys, ones, cap, max_probes=1), shape=[keys.shape[0], cap])
    tk, tv, _ = hash_aggregate(keys, ones, cap, max_probes=probes)
    lanes = getattr(hash_aggregate, "lanes", None)
    if lanes is not None:
        print(json.dumps({"tree": args.tag, "combine_lanes": lanes.tolist()}), flush=True)
    target = 1 << 21

    def merge():
        init = (torch.full((target,), EMPTY_KEY, dtype=torch.int32, device=dev),
                torch.zeros((target, 1), dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
        return hash_aggregate(tk, tv, target, init=init, max_probes=16)

    report("hash_aggregate@wordcount-merge", merge, shape=[cap, target])
    del keys, ones, tk, tv

    g = torch.Generator(device=dev).manual_seed(1)
    b, s, h, d = 8, 512, 32, 64
    r, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + 0.6 * torch.randn((b, s, h, d), generator=g, device=dev)))
    u = 0.1 * torch.randn((h, d), generator=g, device=dev)
    state = torch.zeros((b, h, d, d), device=dev)
    report("rwkv6_scan@rwkv6-prefill", lambda: rwkv6_scan(r, k, v, w, u, init_state=state))
    if args.k6_ablation:
        k6_ablation(lambda: rwkv6_scan(r, k, v, w, u, init_state=state), event_times, device_ms)
    _, state = rwkv6_scan(r, k, v, w, u)
    one = [t[:, :1].contiguous() for t in (r, k, v, w)]
    report("rwkv6_scan@rwkv6-decode", lambda: rwkv6_scan(*one, u, init_state=state))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
