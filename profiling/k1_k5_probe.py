#!/usr/bin/env python3
"""Time K5 (``ssd_scan``) and K1 (``segment_reduce``) at the main path's
shapes on one card, faster than the whole smoke.

Run from the repository root::

    python3 profiling/k1_k5_probe.py

K5 at zamba2-7b's prefill (x ``[8, 512, 112, 64]`` bf16, B and C ``[8, 512,
2, 64]``, as strided views of one conv output) and decode (one step from the
prefill's state) shapes, and the prefill in f32 at batch 2: event time
(median of 10) and device time (``torch.profiler``), with the largest error
against the plain chunked version relative to the largest |y|.  K1 at
k-means' ``[10^8, 4] → [5, 4]``, GMM op 5's ``[5·10^7, 9] → [5, 9]`` and
PageRank's ``[2^24, 1] → [2^20, 1]`` (R-MAT ids, then as many uniform ids),
each beside ``index_add_`` in turns over 5 rounds of the median of 10;
with the argument ``k1v``, K1's register form at several row widths.
Prints one JSON line per measurement and the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

REPS = 10


def event_ms(fn) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, names) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    busy: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            name = next((k for k in names if k in evt.name), "other")
            busy[name] = busy.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3 / REPS
    return busy


def in_turns(fns: dict) -> dict:
    rounds = {name: [] for name in fns}
    for r in range(5):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            rounds[name].append(event_ms(fns[name]))
    return {name: {"median": statistics.median(t), "spread": max(t) - min(t), "rounds": t}
            for name, t in rounds.items()}


def k5(dev) -> None:
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

    g = torch.Generator(device=dev).manual_seed(1)
    h, p, grp, n = 112, 64, 2, 64
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    for b, dtype in ((8, torch.bfloat16), (2, torch.float32)):
        state = torch.zeros((b, h, p, n), device=dev)
        for s in ((512, 1) if dtype == torch.bfloat16 else (512,)):
            conv = torch.randn((b, s, h * p + 2 * grp * n), generator=g, device=dev).to(dtype)
            x = conv[..., :h * p].unflatten(-1, (h, p))
            bm = conv[..., h * p:h * p + grp * n].unflatten(-1, (grp, n))
            cm = conv[..., h * p + grp * n:].unflatten(-1, (grp, n))
            dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g, device=dev))
            y, new = ssd_scan(x, dt, a, bm, cm, init_state=state)
            want, want_h = ssd_scan_plain(x, dt, a, bm, cm, init_state=state)
            err = float((y.float() - want.float()).abs().max() / want.float().abs().max())
            err_h = float((new - want_h).abs().max() / want_h.abs().max())

            def call():
                return ssd_scan(x, dt, a, bm, cm, init_state=state)

            print(json.dumps({"k5": [b, s, str(dtype)], "ms": event_ms(call),
                              "device_ms": device_ms(call, ("ssd_",)),
                              "rel_err_y": err, "rel_err_state": err_h}), flush=True)
            state = new


def k1(dev) -> None:
    from repro_torch.data.synthetic import rmat_edges
    from repro_torch.kernels.segment_reduce import segment_reduce

    g = torch.Generator(device=dev).manual_seed(2)
    cases = []
    x = torch.rand((10**8, 4), generator=g, device=dev)
    cases.append(("kmeans", torch.randint(0, 5, (10**8,), generator=g, device=dev,
                                          dtype=torch.int32), x, 5))
    cases.append(("gmm", torch.arange(5, dtype=torch.int32, device=dev).repeat(10**7),
                  torch.rand((5 * 10**7, 9), generator=g, device=dev), 5))
    dst = torch.from_numpy(rmat_edges(20, 16, seed=0)[:, 1].copy()).to(dev)
    contrib = torch.rand((dst.shape[0], 1), generator=g, device=dev)
    cases.append(("pagerank rmat", dst, contrib, 1 << 20))
    cases.append(("pagerank uniform", torch.randint(0, 1 << 20, dst.shape, generator=g,
                                                    device=dev, dtype=torch.int32),
                  contrib, 1 << 20))
    for name, ids, vals, k in cases:
        out = torch.zeros((k, vals.shape[1]), device=dev)
        fns = {"kernel": lambda: segment_reduce(ids, vals, k),
               "index_add_": lambda: out.index_add_(0, ids, vals)}
        res = in_turns(fns)
        res["device_ms"] = device_ms(fns["kernel"], ("segment_reduce",))
        print(json.dumps({"k1": name, **res}), flush=True)
        del out
    torch.cuda.empty_cache()


def k1_widths(dev) -> None:
    """The register form on 4.5·10^8 f32 values into 5 keys at several row
    widths V (ids cycling over the keys, as GMM's)."""
    from repro_torch.kernels.segment_reduce import segment_reduce

    total = 45 * 10**7
    for v in (4, 8, 9, 12, 16):
        n = total // v
        ids = torch.arange(n, device=dev, dtype=torch.int32) % 5
        vals = torch.ones((n, v), device=dev)
        call = lambda: segment_reduce(ids, vals, 5)  # noqa: E731
        print(json.dumps({"k1_width": v, "ms": event_ms(call),
                          "device_ms": device_ms(call, ("segment_reduce",))}), flush=True)
        del ids, vals
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_k5_probe.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    which = sys.argv[1:] or ["k5", "k1"]
    if "k5" in which:
        k5(dev)
    if "k1" in which:
        k1(dev)
    if "k1v" in which:
        k1_widths(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
