#!/usr/bin/env python3
"""Where K4's prefill form spends its time, on one NVIDIA GPU.

Run from the repository root::

    python3 profiling/k4_phases.py

It copies ``src/repro_torch/kernels/csrc/flash_attention.cu`` into
``build/profiling/``, inserts probes into the prefill form (``attend_wgmma``:
``%globaltimer`` at a CTA's start and end, ``clock64`` between the phases of
the key-tile loop), builds it with ``nvcc`` as ``_build`` does, and runs it at
the LM path's prefill shapes (qwen3-0.6b, zamba2-7b, gemma2-9b local).  Per
shape it prints one JSON line: the kernel's span, each CTA's median time by
its number of key tiles (and the least-squares fixed cost and cost a tile),
and the SM cycles a tile spends in each phase, averaged over all tiles: the
wait for the tile's copies and the barrier, S = Q·Kᵀ, the softmax, P·V, and
the closing barrier.  The probes add a few instructions a phase; the
uninstrumented times are the smoke's (``chip_smoke.py``).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (marker in attend_wgmma or the entry point, text inserted after it)
PROBES = [
    ("__device__ __forceinline__ void attend_wgmma(const Args& a) {\n",
     "  unsigned long long t_start;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_start));\n"),
    ("  for (int t = t0; t < t1; ++t) {\n",
     "    if (t == t0) c_last = clock64();\n"),
    ("    __syncthreads();\n    const uint32_t kt = ks", None),  # phase 0 ends before kt
    ("    pin(s);\n", "    PHASE(1)\n"),
    ("        for (int e = 0; e < 4; ++e) acc[j][n][e] *= corr[e >> 1];\n", "    PHASE(2)\n"),
    ("    pin(pa);\n", "    PHASE(3)\n"),
    ("    __syncthreads();  // slot (t − t0) % kRing is refilled next iteration\n",
     "    PHASE(4)\n"),
]
RECORD_AT = "  cp_async_wait<0>();\n\n#pragma unroll\n  for (int h = 0; h < 2; ++h) {\n    const int r = 16 * warp"
RECORD = """  if (tid == 0) {  // start, end, SM, tiles, cycles a phase: 10 words a CTA
    unsigned long long t_end;
    unsigned sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_end));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    unsigned long long* rec = reinterpret_cast<unsigned long long*>(a.ws_ml) +
        10ull * ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
    rec[0] = t_start; rec[1] = t_end; rec[2] = sm; rec[3] = t1 - t0;
    for (int i = 0; i < 5; ++i) rec[4 + i] = ph[i];
  }
"""
PHASES = ["copies_and_barrier", "qk", "softmax", "pv", "closing_barrier"]
SHAPES = {  # B, Hq, Hkv, Sq, Skv, D, window, softcap: the smoke's prefill shapes
    "qwen3-prefill": (8, 16, 8, 512, 545, 128, None, 0.0),
    "zamba2-prefill": (8, 32, 32, 512, 545, 112, None, 0.0),
    "gemma2-local bf16": (1, 16, 8, 2048, 2048, 256, 1024, 50.0),
}


def instrumented_source() -> str:
    src = (ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu").read_text()
    head = src.index("__device__ __forceinline__ void attend_wgmma(")
    tail = src.index("flash_prefill_kernel(Args a)")
    body = src[head:tail]
    for marker, text in PROBES:
        assert body.count(marker) == 1, f"probe marker not found once: {marker!r}"
        at = body.index(marker) + len(marker)
        if text is None:  # phase 0 ends after the barrier
            at = body.index(marker) + len("    __syncthreads();\n")
            text = "    PHASE(0)\n"
        body = body[:at] + text + body[at:]
    loop = "  for (int t = t0; t < t1; ++t) {\n"
    body = body.replace(loop, "  long long ph[5] = {0, 0, 0, 0, 0}, c_last = 0;\n" + loop)
    assert body.count(RECORD_AT) == 1
    body = body.replace(RECORD_AT, RECORD + RECORD_AT)
    entry = "  if (form == 1) {\n"
    assert src.count(entry) == 1
    out = (src[:head] + "#define PHASE(i) { const long long c_ = clock64(); ph[i] += c_ - c_last; "
           "c_last = c_; }\n" + body + src[tail:])
    return out.replace(entry, entry + "    a.ws_ml = static_cast<float*>(ws);\n")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA

    if not torch.cuda.is_available():
        print("k4_phases.py: no CUDA device is available", file=sys.stderr)
        return 2
    out_dir = ROOT / "build" / "profiling"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "flash_attention_phases.cu").write_text(instrumented_source())
    lib_path = out_dir / "flash_attention_phases.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", str(lib_path),
                    str(out_dir / "flash_attention_phases.cu")], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).blaze_flash_attention
    ll, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    fn.argtypes = ([ptr] * 4 + [ll] * 12 + [i32] * 10 + [ptr] + [ctypes.c_float] * 2
                  + [i32] * 3 + [ptr] * 2)
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, (b, hq, hkv, sq, skv, d, window, cap) in SHAPES.items():
        ck, cv = (torch.randn((b, skv, hkv, d), generator=g, device="cuda").bfloat16()
                  for _ in range(2))
        q = torch.randn((b, sq, hq, d), generator=g, device="cuda").bfloat16().transpose(1, 2)
        k, v = ck.transpose(1, 2), cv.transpose(1, 2)
        out = torch.empty_like(q)
        rec = torch.zeros(10 * b * hkv * sq, dtype=torch.int64, device="cuda")
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *FA._strides("q", q), *FA._strides("k", k), *FA._strides("v", v),
                *FA._strides("out", out), b, hq, hkv, sq, skv, d, 1, int(window is not None),
                window or 0, 0, None, d ** -0.5, cap, FA.FORMS.index("bf16-prefill"), 1, 1,
                rec.data_ptr(), torch.cuda.current_stream().cuda_stream]
        for _ in range(3):  # the last run's records are read
            _build.check(fn(*args), "k4_phases")
        torch.cuda.synchronize()
        r = rec.view(-1, 10).cpu().numpy()
        r = r[r[:, 0] > 0]
        start, end, tiles = r[:, 0], r[:, 1], r[:, 3]
        dur = (end - start) / 1e3
        slope, fixed = np.polyfit(tiles, dur, 1)
        print(json.dumps({
            "shape": name, "ctas": len(r), "kernel_us": float((end.max() - start.min()) / 1e3),
            "cta_us_by_tiles": {int(t): float(np.median(dur[tiles == t]))
                                for t in np.unique(tiles)},
            "cta_fixed_us": float(fixed), "cta_us_per_tile": float(slope),
            "cycles_per_tile": {p: float(r[:, 4 + i].sum() / tiles.sum())
                                for i, p in enumerate(PHASES)},
        }), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
