#!/usr/bin/env python3
"""Time K3 (``kmeans_assign``) at fig. 6's shape on one card, faster than
the whole smoke.

Run from the repository root::

    python3 profiling/k3_probe.py [--src DIR] [--tag NAME] [--ctas-per-sm N] [--ablation]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two trees can be compared in one run on
one card: unpack the other tree into a git-ignored directory and run the
probe once for each, in turns.  The points are the smoke's fig. 6 input
(``cluster_points(10^8, 3, 5, seed=0)``, its initial centres); event time
(median of 10 after two warm-ups) and device time (``torch.profiler``:
every kernel of the call, and K3's own, each over the launches the profile
recorded), one JSON line each, then
the card's name and power limit.  Beside it a read-rate yardstick: ``x.sum()``
reads the same 1.2 GB of points once.  It is not a library equivalent of K3
(no PyTorch call computes K3's function); it says what one full read of the
points costs on this card.

``--ctas-per-sm`` sets the stream form's persistent grid
(``kmeans_assign.STREAM_CTAS_PER_SM``) for this run.

With ``--ablation`` it times the stream form with parts taken out, one
library each, built from ``csrc/kmeans_assign.cu`` into ``build/profiling/``
(all ``nvcc`` processes started together): ``base`` (the source as it is),
``no_fold`` (no point added into the sums), ``no_stores`` (no assignment
written) and ``loads_only`` (the bulk copies and the shared-memory loads,
each loaded float added into one register; no distance, fold or store),
whose results are wrong by design; and three alternatives to the design
(right results): ``stcs`` (streaming stores of the assignments),
``evict_first`` (the bulk copies with an L2 evict-first hint) and
``ring192k`` (a 192 KB ring of up to 16 stages).  Each variant's event time
(median and least of 20 after two warm-ups) and device time are printed,
the variants in turns.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 10
_TILE_FOLD = "        fold_point<D, K>(acc, x[p], b[p]);\n"
_TILE_STORE = "      store4(a, a.head + tile * kTile + 4 * tid, b);\n"
_TILE_NEAREST = "        b[p] = nearest<D, K>(x[p], c, cn);\n"
_VEC_STORE = "    *reinterpret_cast<int4*>(a.assign + i0) = make_int4(b[0], b[1], b[2], b[3]);\n"
_COPY = ("        bulk_copy_g2s(ring + s * R::kStride, a.tiles + tile * R::kTileBytes, bytes, "
         "&full[s]);\n")
# (variant, [(text of csrc/kmeans_assign.cu, what replaces it)])
VARIANTS = [
    ("base", []),
    ("no_fold", [(_TILE_FOLD, "")]),
    ("no_stores", [(_TILE_STORE, "")]),
    ("loads_only", [
        (_TILE_FOLD, ""), (_TILE_STORE, ""),
        (_TILE_NEAREST, "        b[p] = 0;\n"
                        "        for (int j = 0; j < D; ++j) acc[0][0] += x[p][j];\n"),
    ]),
    # Alternatives to the design (right results): streaming stores of the
    # assignments; the bulk copies with an L2 evict-first hint; a 192 KB
    # ring of up to 16 stages.
    ("stcs", [(_VEC_STORE, _VEC_STORE.replace(
        "*reinterpret_cast<int4*>(a.assign + i0) = make_int4(b[0], b[1], b[2], b[3]);",
        "__stcs(reinterpret_cast<int4*>(a.assign + i0), make_int4(b[0], b[1], b[2], b[3]));"))]),
    ("evict_first", [(_COPY,
        '        { uint64_t pol; asm volatile("createpolicy.fractional.L2::evict_first.b64 '
        '%0, 1.0;\\n" : "=l"(pol));\n'
        '          asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::'
        'bytes.L2::cache_hint [%0], [%1], %2, [%3], %4;\\n" :: "r"(smem_u32(ring + s * '
        'R::kStride)), "l"(a.tiles + tile * R::kTileBytes), "r"(bytes), "r"(smem_u32(&full[s])), '
        '"l"(pol) : "memory"); }\n')]),
    ("ring192k", [("constexpr int kRingBytes = 96 * 1024;", "constexpr int kRingBytes = 192 * 1024;"),
                  ("kRingBytes / kTileBytes < 8 ? kRingBytes / kTileBytes : 8;",
                   "kRingBytes / kTileBytes < 16 ? kRingBytes / kTileBytes : 16;")]),
]


def variant_sources(csrc: Path) -> dict[str, str]:
    base = (csrc / "kmeans_assign.cu").read_text()
    out = {}
    for name, edits in VARIANTS:
        src = base
        for old, new in edits:
            assert src.count(old) == 1, f"{name}: text not found once: {old!r}"
            src = src.replace(old, new)
        out[name] = src
    return out


def ablation(call, event_times, device_ms):
    """Build the variants, then time ``call`` on each."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import kmeans_assign as KA

    out_dir = ROOT / "build" / "profiling"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variant_sources(_build.CSRC).items():
        (out_dir / f"kmeans_{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out_dir / f"kmeans_{name}.so"), str(out_dir / f"kmeans_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"kmeans variant {name}: nvcc exited {proc.returncode}\n{report}")
        fn = ctypes.CDLL(str(out_dir / f"kmeans_{name}.so")).blaze_kmeans_assign
        fn.argtypes = KA._kernel().argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    kernel = KA._kernel
    times = {name: [] for name in fns}
    try:
        for _ in range(2):  # the variants in turns, twice
            for name, fn in fns.items():
                KA._kernel = lambda fn=fn: fn
                times[name] += event_times(call)
        for name, fn in fns.items():
            KA._kernel = lambda fn=fn: fn
            print(json.dumps({"probe": "kmeans_assign@fig6 ablation", "variant": name,
                              "ms_median": statistics.median(times[name]),
                              "ms_min": min(times[name]),
                              "device_ms": device_ms(call, "kmeans_assign")}),
                  flush=True)
    finally:
        KA._kernel = kernel


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--tag", default="this tree")
    parser.add_argument("--ctas-per-sm", type=int, default=0)
    parser.add_argument("--ablation", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, args.src)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k3_probe.py: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.data.synthetic import cluster_points
    from repro_torch.kernels import kmeans_assign as KA

    if args.ctas_per_sm:
        KA.STREAM_CTAS_PER_SM = args.ctas_per_sm

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

    def device_ms(fn, name=None) -> dict:
        """Device time of REPS calls (``torch.profiler``): ``ms``, the mean
        duration of the kernels whose name holds ``name`` (every kernel
        with None) per launch the profile recorded, times the launches one
        call makes (``per_call``, from the launches recorded, rounded);
        ``events``, the launches recorded.  The profiler may miss a launch
        (one in ten of a variant's in an earlier run), so the mean is taken
        over the launches it recorded, not over REPS."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and (name is None or name in e.name)]
        per_call = max(1, round(len(spans) / REPS))
        ms = sum(spans) / len(spans) * per_call / 1e3 if spans else None
        return {"ms": ms, "events": len(spans), "per_call": per_call}

    dev = torch.device("cuda")
    pts, _ = cluster_points(100_000_000, 3, 5, seed=0)
    init = pts[np.random.RandomState(0).choice(4096, 5, replace=False)]
    x = torch.from_numpy(pts).to(dev)
    c = torch.from_numpy(init).to(dev)
    del pts
    n, d = x.shape

    def call():
        return KA.kmeans_assign(x, c)

    form, blocks = KA.launch_shape(n, d, c.shape[0], dev)
    print(json.dumps({
        "tree": args.tag, "probe": "kmeans_assign@fig6", "form": form, "blocks": blocks,
        "ms": statistics.median(event_times(call)), "device_ms": device_ms(call),
        "kernel_device_ms": device_ms(call, "kmeans_assign"),
        "bound_ms": (n * d * 4 + n * 4) / 3.35e12 * 1e3, "shape": [[n, d], list(c.shape)],
    }), flush=True)
    print(json.dumps({
        "tree": args.tag, "probe": "yardstick: x.sum(), one read of the points",
        "ms": statistics.median(event_times(x.sum)), "device_ms": device_ms(x.sum),
        "bound_ms": n * d * 4 / 3.35e12 * 1e3,
    }), flush=True)
    if args.ablation:
        ablation(call, event_times, device_ms)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
