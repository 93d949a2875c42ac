#!/usr/bin/env python3
"""Where K5's prefill form spends its time, on one NVIDIA GPU.

Run from the repository root::

    python3 profiling/k5_phases.py

It copies ``src/repro_torch/kernels/csrc/ssd_scan.cu`` into
``build/profiling/``, inserts probes into the prefill form
(``ssd_chunk_kernel``: ``%globaltimer`` at a CTA's start and end, ``clock64``
in thread 0 between the phases of a chunk), builds it with ``nvcc`` as
``_build`` does, and runs it at zamba2-7b's prefill shape (x ``[8, 512, 112,
64]`` bf16, B and C strided views of one conv output) through the
``ssd_scan`` wrapper.  It prints one JSON line: the kernel's span, the median
CTA time, and the SM cycles a chunk spends in each phase (thread 0's view,
averaged over every chunk of every CTA): the wait for the chunk's copies and
the barrier, the running sum, C·hᵀ and C·Bᵀ, the barrier after the running
sum, forming W, M' with M'·x, y's stores and the barrier, issuing the next
chunk's copies, and the state update.  The probes add a few instructions a
phase; the uninstrumented times are ``profiling/k1_k5_probe.py``'s.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ["copies_and_barrier", "running_sum", "ch_and_cb", "sum_barrier", "w",
          "m_and_mx", "y_and_barrier", "next_copies", "state"]
KERNEL = "ssd_chunk_kernel(Args a) {\n"
# (marker inside ssd_chunk_kernel, text inserted after it)
PROBES = [
    (KERNEL, "  unsigned long long t_start;\n"
             "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_start));\n"
             "  long long ph[9] = {}, c_last = clock64();\n"),
    ("    __syncthreads();  // this chunk's tiles are in; the last chunk's state is written\n",
     "    PHASE(0)\n"),
    ("    // C·hᵀ, for y = exp(Δ_l)·(C·hᵀ) + M'·x.\n", "    PHASE(1)\n"),
    ("    gemm<false, false, ORD>(cb, c_rows, bs, nk, warp + 1, lane);\n", "    PHASE(2)\n"),
    ("    __syncthreads();  // cum is written\n", "    PHASE(3)\n"),
    ("      store8<NP>(ws, idx, v);\n    }\n", "    PHASE(4)\n"),
    ("    gemm_reg<ORD>(acc, mf, xs, warp + 1, lane);\n", "    PHASE(5)\n"),
    ("    __syncthreads();  // every read of the old state, B, C, dt and cum is done; W is "
     "written\n", "    PHASE(6)\n"),
    ("    if (XB == 2 && c0 + kL < a.s) load_chunk(c0 + kL, (buf + 1) % XB);\n",
     "    PHASE(7)\n"),
    ("      for (int e = 0; e < 4; ++e) st[j][e] = fmaf(st[j][e], et, acc[j][e]);\n    }\n",
     "    PHASE(8)\n"),
]
RECORD_AT = "#pragma unroll\n  for (int j = 0; j < 8; ++j) {\n#pragma unroll\n" \
            "    for (int e = 0; e < 4; ++e) {\n      const int row = r0 + g + (e >> 1) * 8, " \
            "col = 8 * j + 2 * t4 + (e & 1);\n      if (row < a.p && col < a.n) a.hT"
RECORD = """  if (threadIdx.x == 0) {  // start, end, SM, chunks, cycles a phase: 13 words a CTA
    unsigned long long t_end;
    unsigned sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_end));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    unsigned long long* rec = g_probe + 13ull * blockIdx.x;
    rec[0] = t_start; rec[1] = t_end; rec[2] = sm; rec[3] = (a.s + kL - 1) / kL;
    for (int i = 0; i < 9; ++i) rec[4 + i] = ph[i];
  }
"""
MAX_CTAS = 4096


def instrumented_source() -> str:
    src = (ROOT / "src/repro_torch/kernels/csrc/ssd_scan.cu").read_text()
    decl = src.index("template <typename T>\n__global__ void __launch_bounds__(kThreads, kMinCtas<T>)")
    head = src.index(KERNEL)
    tail = src.index("// Above 48 KB a launch must opt in")
    body = src[head:tail]
    for marker, text in PROBES:
        assert body.count(marker) == 1, f"probe marker not found once: {marker!r}"
        at = body.index(marker) + len(marker)
        body = body[:at] + text + body[at:]
    assert body.count(RECORD_AT) == 1
    body = body.replace(RECORD_AT, RECORD + RECORD_AT)
    return (src[:decl]
            + f"__device__ unsigned long long g_probe[13 * {MAX_CTAS}];\n"
            + "#define PHASE(i) if (threadIdx.x == 0) { const long long c_ = clock64(); "
              "ph[i] += c_ - c_last; c_last = c_; }\n"
            + src[decl:head] + body + src[tail:]
            + "\nextern \"C\" int blaze_probe_read(void* dst, size_t bytes) {\n"
              "  return int(cudaMemcpyFromSymbol(dst, g_probe, bytes));\n}\n")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as SS

    if not torch.cuda.is_available():
        print("k5_phases.py: no CUDA device is available", file=sys.stderr)
        return 2
    out_dir = ROOT / "build" / "profiling"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "ssd_scan_phases.cu").write_text(instrumented_source())
    lib_path = out_dir / "ssd_scan_phases.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                    "-o", str(lib_path),
                    str(out_dir / "ssd_scan_phases.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.blaze_ssd_scan
    fn.argtypes = SS._kernel().argtypes
    fn.restype = ctypes.c_int
    SS._kernel = lambda: fn  # the wrapper launches the instrumented library
    b, s, h, p, grp, n = 8, 512, 112, 64, 2, 64
    g = torch.Generator(device="cuda").manual_seed(1)
    conv = torch.randn((b, s, h * p + 2 * grp * n), generator=g, device="cuda").bfloat16()
    x = conv[..., :h * p].unflatten(-1, (h, p))
    bm = conv[..., h * p:h * p + grp * n].unflatten(-1, (grp, n))
    cm = conv[..., h * p + grp * n:].unflatten(-1, (grp, n))
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g, device="cuda"))
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    for _ in range(3):  # the last run's records are read
        SS.ssd_scan(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    rec = np.zeros(13 * b * h, dtype=np.uint64)
    _build.check(lib.blaze_probe_read(ctypes.c_void_p(rec.ctypes.data),
                                      ctypes.c_size_t(rec.nbytes)), "k5_phases")
    r = rec.reshape(-1, 13).astype(np.int64)
    start, end, chunks = r[:, 0], r[:, 1], r[:, 3]
    print(json.dumps({
        "shape": [b, s, h, p, grp, n], "ctas": len(r),
        "kernel_us": float((end.max() - start.min()) / 1e3),
        "cta_us_median": float(np.median((end - start) / 1e3)),
        "ctas_per_sm_max": int(np.bincount(r[:, 2]).max()),
        "cycles_per_chunk": {ph: float(r[:, 4 + i].sum() / chunks.sum())
                             for i, ph in enumerate(PHASES)},
    }), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
