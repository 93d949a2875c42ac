// Mamba-2 SSD scan (zamba2's Mamba-2 blocks) on Hopper.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel), which walked a (b·h, chunk) grid in order on one core and
// carried the [P, N] state across the chunk axis in VMEM scratch.  Unlike
// it, this one takes an initial state and writes the final one to a buffer
// that may be the same (a serving cache, updated in place): every element of
// a (b, h) state is read and written by the one thread that owns it.
//
// What it computes, per chunk of up to 64 steps (Δ_l = Σ_{r≤l} a·dt_r inside
// the chunk, taken in order, T = Δ of its last step):
//   y_l = exp(Δ_l)·(C_l·h) + Σ_{s≤l} (C_l·B_s)·exp(min(Δ_l − Δ_s, 0))·dt_s·x_s;
//   h'  = exp(T)·h + Σ_s exp(T − Δ_s)·dt_s·x_s ⊗ B_s,
// all in f32, as the reference's ops.ssd_chunked does.  The decay is taken
// pairwise, never as exp(Δ_l)·exp(−Δ_s): a ∈ [−16, −1] times a large dt
// overflows exp(−Δ), and inf·0 is NaN.  Steps past the end of the sequence
// are zeros with dt = 0, so they leave the state unchanged.  Exponentials are
// expf (CUDA's accurate one), never ex2.approx.
//
// Two forms, picked by the wrapper from S, with no fallback between them:
//
// * Decode (S = 1, ssd_step_kernel): h' = exp(a·dt)·h + (dt·x_p)·B_n, then
//   y_p = Σ_n h'_pn·C_n.  Bound by the state's bytes (zamba2: 14.7 MB read and
//   written a step).  16 lanes own a row p, 4 columns n each, read and
//   written in place with 16-byte loads and stores; the 16-lane shuffle tree
//   sums y_p.  One CTA per (b, h, 16 rows of p): 3,584 CTAs at zamba2's shape.
//
// * Prefill (S > 1, ssd_chunk_kernel): one CTA of 4 warps owns one (b, h) and
//   walks its 64-step chunks, so the f32 state stays in registers (as mma's
//   accumulator fragments) for the CTA's whole life and nothing crosses
//   CTAs.  The four 64 × 64 × 64 products of a chunk (C·Bᵀ; y's C·hᵀ and M·x;
//   the state's xᵀ·W) run on the tensor cores with mma.sync.m16n8k16 on
//   ldmatrix fragments: bf16 operands, f32 accumulation.  Warp w owns rows
//   16w..16w+15 of l (y) and of p (the state); C·Bᵀ is computed only up to
//   the warp's diagonal.  A CTA per head computes C·Bᵀ itself: heads of a
//   group live in other CTAs, and handing a 64 × 64 f32 product between warps
//   through shared memory costs more than the bf16 product it saves (one of
//   the seven products of the bf16 model, causal half).
//
//   Precision: bf16 products are exact in f32, so an operand that is exactly
//   bf16 (x, B, C in the bf16 model) goes in as it is, and an f32 operand v
//   goes in as parts: p_0 = bf16(v), p_i = bf16(what p_0..p_{i−1} left).  In
//   the bf16 model the f32 operands (M' = (C·Bᵀ)∘decay·dt in registers, the
//   state h, split into shared memory after every chunk, and W =
//   exp(T − Δ_s)·dt_s·B_s) take two parts, |v − p_0 − p_1| ≤ 2^-18·|v|, and
//   each of their products two mma (p_1·B, then p_0·B), so a term is off by at
//   most 2^-18 of its magnitude.  In the f32 model x, B and C are split as
//   well, everything in three parts (residue ≤ 2^-27), and a product keeps
//   the part pairs (i, j) with i + j ≤ 2 (six mma; the dropped pairs are
//   below 2^-26).  Every term of y or h' crosses at most two products with a
//   split operand (C·Bᵀ then M'·x, or xᵀ·W then C·hᵀ): at most 2·2^-18 of
//   its magnitude.  The products of the smaller parts run first into the
//   same accumulator, so their partial sums stay ~2^-8 of the total; the
//   tensor cores round their sums toward zero, one unit in the last place,
//   twice what a rounded f32 addition may lose, on the two sums (over n and
//   over a chunk's 64 steps) that a term crosses.  chip_smoke.ssd_tc_tau
//   states the resulting term of the bound.
//
//   What bounds it: at zamba2's prefill (x [8, 512, 112, 64] bf16) ~136 MB of
//   inputs and outputs (0.045 ms at 3.35 TB/s) against ~15 GFLOP of products
//   (~27 GFLOP of bf16 mma with the split operands, causal halves skipped),
//   so it is byte-bound at the card's rates, yet with mma.sync and three CTAs
//   an SM (74 KB of shared memory each) it takes ~6 times that:
//   profiling/k5_phases.py shows a chunk's cycles spread over the products,
//   forming W and M', and a long wait to issue the next chunk's copies
//   behind the SM's shared-memory traffic.  The next chunk's x (into a
//   second buffer), B, C and dt go to shared memory by cp.async (16-byte
//   copies where the strides allow them) during the state update; the
//   running sum of a·dt runs in one thread, in order, beside the first
//   products.  Tiles are bf16 [64][72] (144-byte rows: ldmatrix without bank
//   conflicts).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kL = 64;  // steps per chunk; also the largest P and N

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* h0;  // may be null (zeros), may alias hT
  void* y;
  float* hT;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
      y_sb, y_ss, y_sh;
  int s, h, g, p, n;
  int vec;  // 16-byte loads allowed (the wrapper checks alignment and strides)
};

// ---------------------------------------------------------------------------
// Decode form.
// ---------------------------------------------------------------------------
constexpr int kStepRows = 16;                  // rows p of the state per CTA
constexpr int kStepThreads = 16 * kStepRows;   // 16 lanes × 4 columns = N ≤ 64

template <typename T>
__global__ void __launch_bounds__(kStepThreads) ssd_step_kernel(Args a) {
  const int bh = blockIdx.x;
  const int bi = bh / a.h, hi = bh % a.h, gi = hi / (a.h / a.g);
  const int p = blockIdx.y * kStepRows + threadIdx.x / 16;
  const int q = threadIdx.x % 16;
  const int n0 = 4 * q;
  if (p >= a.p) return;  // the row's 16 lanes leave together
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  const float dt = a.dt[bi * a.dt_sb + hi * a.dt_sh];
  const float e = expf(a.a[hi] * dt);
  const float dx = dt * to_f32(static_cast<const T*>(a.x)[bi * a.x_sb + hi * a.x_sh + p]);
  const T* bp = static_cast<const T*>(a.b) + bi * a.b_sb + gi * a.b_sg;
  const T* cp = static_cast<const T*>(a.c) + bi * a.c_sb + gi * a.c_sg;
  const size_t off = (size_t(bh) * a.p + p) * a.n + n0;
  float hv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const bool whole = a.vec && n0 + 4 <= a.n;
  if (a.h0 != nullptr) {
    if (whole) {
      const float4 v = *reinterpret_cast<const float4*>(a.h0 + off);
      hv[0] = v.x, hv[1] = v.y, hv[2] = v.z, hv[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = n0 + j < a.n ? a.h0[off + j] : 0.0f;
    }
  }
  float y = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool live = n0 + j < a.n;
    const float bv = live ? to_f32(bp[n0 + j]) : 0.0f;
    const float cv = live ? to_f32(cp[n0 + j]) : 0.0f;
    hv[j] = fmaf(dx, bv, e * hv[j]);
    y = fmaf(hv[j], cv, y);
  }
  if (whole) {
    *reinterpret_cast<float4*>(a.hT + off) = make_float4(hv[0], hv[1], hv[2], hv[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n0 + j < a.n) a.hT[off + j] = hv[j];
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) y += __shfl_xor_sync(half, y, o, 16);
  if (q == 0) static_cast<T*>(a.y)[bi * a.y_sb + hi * a.y_sh + p] = from_f32<T>(y);
}

// ---------------------------------------------------------------------------
// Prefill form.
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = 72;           // bf16 row stride of every tile (144 bytes)
constexpr int kTile = kL * kLd;   // elements of one tile

// Parts of each operand: x, B, C are exact in the bf16 model (one part) and
// split in three in the f32 model; the f32 operands (M', the state, W) in two
// parts in the bf16 model and three in the f32 model.  A product keeps the
// part pairs (i, j) with i + j < kParts (the smaller terms first).
template <typename T> constexpr int kIn = std::is_same<T, float>::value ? 3 : 1;
template <typename T> constexpr int kParts = std::is_same<T, float>::value ? 3 : 2;
// x's tiles twice in the bf16 model (the next chunk's load behind the
// state update); the f32 model's 15 tiles leave no room for that.
template <typename T> constexpr int kXBufs = std::is_same<T, float>::value ? 1 : 2;
template <typename T> constexpr int kTiles = (kXBufs<T> + 2) * kIn<T> + 2 * kParts<T>;
template <typename T> constexpr int kMinCtas = std::is_same<T, float>::value ? 1 : 3;
template <typename T>
constexpr size_t kChunkSmem = size_t(kTiles<T>) * kTile * sizeof(bf16) + 2 * kL * sizeof(float);

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (v0, v1) as P bf16 pairs: part p = bf16 of what the earlier parts left
// (each residue is exact in f32).
template <int P>
__device__ __forceinline__ void split2(float v0, float v1, uint32_t (&part)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    const float2 f = __bfloat1622float2(h);
    part[p] = bits(h);
    v0 -= f.x;
    v1 -= f.y;
  }
}

// 8 values (a row's columns c .. c + 7) into the P tiles at idx.
template <int P>
__device__ __forceinline__ void store8(bf16* const (&tile)[P], int idx, const float (&v)[8]) {
  uint32_t part[4][P];
#pragma unroll
  for (int j = 0; j < 4; ++j) split2<P>(v[2 * j], v[2 * j + 1], part[j]);
#pragma unroll
  for (int p = 0; p < P; ++p)
    *reinterpret_cast<uint4*>(tile[p] + idx) =
        make_uint4(part[0][p], part[1][p], part[2][p], part[3][p]);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  const float4 w = *reinterpret_cast<const float4*>(p + 4);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w, v[4] = w.x, v[5] = w.y, v[6] = w.z,
  v[7] = w.w;
}

// The f32 model's chunk tiles: rows [0, 64) of a chunk's [steps × cols]
// slice at src (row stride ss), split into the tiles (rows >= live and
// columns >= cols are zeros), every load issued before any is split.
__device__ __forceinline__ void load_tile(const float* src, long long ss, int live, int cols,
                                          bool vec, bf16* const (&tile)[3]) {
  constexpr int kG = kL * 8 / kThreads;
  float v[kG][8];
#pragma unroll
  for (int k = 0; k < kG; ++k) {
    const int i = threadIdx.x + k * kThreads, r = i >> 3, c = (i & 7) * 8;
    const float* row = src + r * ss + c;
    if (vec && r < live && c + 8 <= cols) {
      load8(row, v[k]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[k][j] = r < live && c + j < cols ? row[j] : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < kG; ++k) {
    const int i = threadIdx.x + k * kThreads;
    store8<3>(tile, (i >> 3) * kLd + (i & 7) * 8, v[k]);
  }
}

// The bf16 model's chunk tiles: rows [0, 64) of a chunk's [steps × cols]
// slice at src (row stride ss) into the tile (rows >= live and columns >=
// cols are zeros), by cp.async where the strides allow 16-byte copies.
__device__ __forceinline__ void load_tile(const bf16* src, long long ss, int live, int cols,
                                          bool vec, bf16* const (&tile)[1]) {
#pragma unroll
  for (int k = 0; k < kL * 8 / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads, r = i >> 3, c = (i & 7) * 8;
    const bf16* row = src + r * ss + c;
    bf16* dst = tile[0] + r * kLd + c;
    const bool in = r < live && c < cols;
    if (vec && (c + 8 <= cols || c >= cols)) {
      cp_async16(dst, in ? row : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = r < live && c + j < cols ? row[j] : __float2bfloat16(0.0f);
    }
  }
}

// acc[16 × 64] += A · B over k steps [0, nk) of 16, for the warp's 16 rows,
// on the first jn pairs of 8-column tiles.  A: a tile whose rows are the
// warp's (a points at its first row) stored [m][k], or with A_T stored [k][m]
// (a points at the warp's first column).  B: stored [n][k], or with B_T
// [k][n].
template <bool A_T, bool B_T>
__device__ __forceinline__ void gemm1(float (&acc)[8][4], const bf16* a, const bf16* b, int nk,
                                      int jn, int lane) {
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t af[4];
    if (A_T)
      ldsm_x4_t(af, a + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8);
    else
      ldsm_x4(af, a + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (jj >= jn) break;
      uint32_t bf[4];
      if (B_T)
        ldsm_x4_t(bf, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + jj * 16 +
                          (lane >> 4) * 8);
      else
        ldsm_x4(bf, b + (jj * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + kk * 16 +
                        ((lane >> 3) & 1) * 8);
      mma(acc[2 * jj], af, bf[0], bf[1]);
      mma(acc[2 * jj + 1], af, bf[2], bf[3]);
    }
  }
}

// The same over split operands: the part pairs (i, j) with i + j < ORD + 1,
// the smaller terms (larger i + j) first.  `a` and `b` hold each part's
// pointer, already offset as gemm1 takes them.
template <bool A_T, bool B_T, int ORD, int PA, int PB>
__device__ __forceinline__ void gemm(float (&acc)[8][4], bf16* const (&a)[PA],
                                     bf16* const (&b)[PB], int nk, int jn, int lane) {
#pragma unroll
  for (int ord = ORD; ord >= 0; --ord) {
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const int j = ord - i;
      if (j >= 0 && j < PB) gemm1<A_T, B_T>(acc, a[i], b[j], nk, jn, lane);
    }
  }
}

// acc[16 × 64] += A · B with A in registers (PA parts of fragments of k steps
// [0, nk), nk <= 4) and B stored [k][n] in PB parts.
template <int ORD, int PA, int PB>
__device__ __forceinline__ void gemm_reg(float (&acc)[8][4], const uint32_t (&af)[PA][4][4],
                                         bf16* const (&b)[PB], int nk, int lane) {
#pragma unroll
  for (int ord = ORD; ord >= 0; --ord) {
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const int j = ord - i;
      if (j < 0 || j >= PB) continue;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= nk) break;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bf[4];
          ldsm_x4_t(bf, b[j] + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                            jj * 16 + (lane >> 4) * 8);
          mma(acc[2 * jj], af[i][kk], bf[0], bf[1]);
          mma(acc[2 * jj + 1], af[i][kk], bf[2], bf[3]);
        }
      }
    }
  }
}

// The warp's rows of the f32 state, split into the P tiles h.
template <int P>
__device__ __forceinline__ void store_state(const float (&st)[8][4], bf16* const (&h)[P],
                                            int r0, int g, int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t part[P];
      split2<P>(st[j][2 * half], st[j][2 * half + 1], part);
      const int idx = (r0 + g + 8 * half) * kLd + 8 * j + 2 * t4;
#pragma unroll
      for (int p = 0; p < P; ++p) *reinterpret_cast<uint32_t*>(h[p] + idx) = part[p];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinCtas<T>)
ssd_chunk_kernel(Args a) {
  constexpr int NI = kIn<T>, NP = kParts<T>, ORD = NP - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* base = reinterpret_cast<bf16*>(smem_raw);
  constexpr int XB = kXBufs<T>;
  bf16* xbuf[XB][NI];  // [s][p]  x (this chunk's and, in the bf16 model, the next's)
  bf16* bs[NI];        // [s][n]  B
  bf16* cs[NI];        // [l][n]  C
  bf16* hs[NP];        // [p][n]  the state
  bf16* ws[NP];        // [s][n]  W = exp(T − Δ_s)·dt_s·B_s
  bf16* next = base;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
#pragma unroll
    for (int xb = 0; xb < XB; ++xb, next += kTile) xbuf[xb][i] = next;
    bs[i] = next;
    cs[i] = next + kTile;
    next += 2 * kTile;
  }
#pragma unroll
  for (int i = 0; i < NP; ++i, next += 2 * kTile) {
    hs[i] = next;
    ws[i] = next + kTile;
  }
  float* dts = reinterpret_cast<float*>(base + kTiles<T> * kTile);  // [64] dt
  float* cum = dts + kL;                                             // [64] Δ

  const int bi = blockIdx.x / a.h;
  const int hi = blockIdx.x % a.h;
  const int gi = hi / (a.h / a.g);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp;  // the warp's rows of l and of p
  const float av = a.a[hi];
  const T* xp = static_cast<const T*>(a.x) + bi * a.x_sb + hi * a.x_sh;
  const float* dp = a.dt + bi * a.dt_sb + hi * a.dt_sh;
  const T* bp = static_cast<const T*>(a.b) + bi * a.b_sb + gi * a.b_sg;
  const T* cp = static_cast<const T*>(a.c) + bi * a.c_sb + gi * a.c_sg;
  T* yp = static_cast<T*>(a.y) + bi * a.y_sb + hi * a.y_sh;
  const size_t state_off = size_t(blockIdx.x) * a.p * a.n;
  const bool vec = a.vec != 0;
  const int nk = (a.n + 15) >> 4;  // k steps over n
  bf16* c_rows[NI];  // C's parts at the warp's rows
#pragma unroll
  for (int i = 0; i < NI; ++i) c_rows[i] = cs[i] + r0 * kLd;
  // A chunk's dt and x, B, C tiles; x into buffer `buf`.
  auto load_chunk = [&](int c0, int buf) {
    const int lc = min(kL, a.s - c0);
    if (threadIdx.x < kL) {
      const bool live = int(threadIdx.x) < lc;
      cp_async4(dts + threadIdx.x, live ? dp + (c0 + threadIdx.x) * a.dt_ss : dp, live ? 4 : 0);
    }
    load_tile(xp + c0 * a.x_ss, a.x_ss, lc, a.p, vec, xbuf[buf]);
    load_tile(bp + c0 * a.b_ss, a.b_ss, lc, a.n, vec, bs);
    load_tile(cp + c0 * a.c_ss, a.c_ss, lc, a.n, vec, cs);
  };

  // The state: rows r0 + g (+8) of p, columns 8j + 2t4 (+1) of n, in mma's
  // accumulator layout, for the CTA's whole life.
  float st[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + (e >> 1) * 8, col = 8 * j + 2 * t4 + (e & 1);
      st[j][e] = a.h0 != nullptr && row < a.p && col < a.n
                     ? a.h0[state_off + size_t(row) * a.n + col] : 0.0f;
    }
  }
  store_state<NP>(st, hs, r0, g, t4);

  load_chunk(0, 0);
  for (int c0 = 0, buf = 0; c0 < a.s; c0 += kL, buf = (buf + 1) % XB) {
    const int lc = min(kL, a.s - c0);  // live steps of this chunk
    bf16* const(&xs)[NI] = xbuf[buf];
    bf16* x_cols[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) x_cols[i] = xs[i] + r0;
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // this chunk's tiles are in; the last chunk's state is written
    if (threadIdx.x == 0) {  // the running sum, in order, beside the first products
      float run = 0.0f;
#pragma unroll
      for (int l = 0; l < kL; l += 4) {
        const float4 d = *reinterpret_cast<const float4*>(dts + l);
        run += av * d.x;
        cum[l] = run;
        run += av * d.y;
        cum[l + 1] = run;
        run += av * d.z;
        cum[l + 2] = run;
        run += av * d.w;
        cum[l + 3] = run;
      }
    }

    // C·hᵀ, for y = exp(Δ_l)·(C·hᵀ) + M'·x.
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    gemm<false, false, ORD>(acc, c_rows, hs, nk, 4, lane);
    // C·Bᵀ up to the warp's diagonal (columns s < 16·(warp + 1)).
    float cb[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) cb[j][0] = cb[j][1] = cb[j][2] = cb[j][3] = 0.0f;
    gemm<false, false, ORD>(cb, c_rows, bs, nk, warp + 1, lane);
    __syncthreads();  // cum is written
    const float total = cum[kL - 1];

    // W = B·exp(T − Δ_s)·dt_s, from B's parts, read by the state update
    // after the next barrier.
#pragma unroll
    for (int k = 0; k < kL * 8 / kThreads; ++k) {
      const int i = threadIdx.x + k * kThreads, r = i >> 3, idx = r * kLd + (i & 7) * 8;
      const float f = expf(total - cum[r]) * dts[r];
      float v[8] = {};
#pragma unroll
      for (int part = 0; part < NI; ++part) {
        const uint4 u = *reinterpret_cast<const uint4*>(bs[part] + idx);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
          v[2 * j] += b2.x;
          v[2 * j + 1] += b2.y;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] *= f;
      store8<NP>(ws, idx, v);
    }

    const float cum_r[2] = {cum[r0 + g], cum[r0 + g + 8]};
    const float ecum[2] = {expf(cum_r[0]), expf(cum_r[1])};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= ecum[e >> 1];
    }
    // M' = (C·Bᵀ)·exp(min(Δ_l − Δ_s, 0))·dt_s for s <= l, as A fragments.
    uint32_t mf[NP][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > warp) break;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 2 * kk + half;
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int l = r0 + g + 8 * rh;
          float m[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int s = 8 * j + 2 * t4 + e;
            m[e] = s <= l ? cb[j][2 * rh + e] * expf(fminf(cum_r[rh] - cum[s], 0.0f)) * dts[s]
                          : 0.0f;
          }
          uint32_t part[NP];
          split2<NP>(m[0], m[1], part);
#pragma unroll
          for (int p = 0; p < NP; ++p) mf[p][kk][2 * half + rh] = part[p];
        }
      }
    }
    gemm_reg<ORD>(acc, mf, xs, warp + 1, lane);
    // y, two neighbouring columns a store where they are both live and the
    // pair is aligned.
    const bool pairs = (a.y_ss & 1) == 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int l = r0 + g + 8 * rh, col = 8 * j + 2 * t4;
        if (l >= lc) continue;
        T* dst = yp + (c0 + l) * a.y_ss + col;
        const float v0 = acc[j][2 * rh], v1 = acc[j][2 * rh + 1];
        if (pairs && col + 1 < a.p) {
          if constexpr (std::is_same<T, float>::value) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
          }
        } else {
          if (col < a.p) dst[0] = from_f32<T>(v0);
          if (col + 1 < a.p) dst[1] = from_f32<T>(v1);
        }
      }
    }
    __syncthreads();  // every read of the old state, B, C, dt and cum is done; W is written
    // The next chunk's dt, B, C and x (into the other buffer) load during the
    // state update; with one x buffer (the f32 model), after it.
    if (XB == 2 && c0 + kL < a.s) load_chunk(c0 + kL, (buf + 1) % XB);

    // h' = exp(T)·h + xᵀ·W.
    const int ks = (lc + 15) >> 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    gemm<true, true, ORD>(acc, x_cols, ws, ks, 4, lane);
    const float et = expf(total);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = fmaf(st[j][e], et, acc[j][e]);
    }
    store_state<NP>(st, hs, r0, g, t4);
    if (XB == 1 && c0 + kL < a.s) {
      __syncthreads();  // every read of x is done
      load_chunk(c0 + kL, 0);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + (e >> 1) * 8, col = 8 * j + 2 * t4 + (e & 1);
      if (row < a.p && col < a.n) a.hT[state_off + size_t(row) * a.n + col] = st[j][e];
    }
  }
}

// Above 48 KB a launch must opt in, once per function and device.
template <typename T>
cudaError_t opt_in() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || done[dev]) return err;
  err = cudaFuncSetAttribute(ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kChunkSmem<T>));
  done[dev] = err == cudaSuccess;
  return err;
}

template <typename T>
int launch(const Args& a, int batch, int form, cudaStream_t stream) {
  if (form == 0) {
    const dim3 grid(batch * a.h, (a.p + kStepRows - 1) / kStepRows);
    ssd_step_kernel<T><<<grid, kStepThreads, 0, stream>>>(a);
  } else if (form == 1) {
    const cudaError_t err = opt_in<T>();
    if (err != cudaSuccess) return int(err);
    ssd_chunk_kernel<T><<<batch * a.h, kThreads, kChunkSmem<T>, stream>>>(a);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // namespace

// Strides are in elements: x and y [B, S, H, P] and b, c [B, S, G, N] by
// (batch, seq, head or group), dt [B, S, H] likewise, the last dimension
// contiguous; h0 (or null) and hT are contiguous [B, H, P, N] f32 and may be
// the same buffer.  form 0 is the decode form (S = 1), form 1 the prefill
// form; vec allows 16-byte loads (decode: of the state; prefill: of x, B,
// C).  The wrapper checks shapes, dtypes, P, N <= 64 and H a multiple of G,
// and never launches an empty grid or S = 0.
extern "C" int blaze_ssd_scan(
    const void* x, const void* dt, const void* a, const void* b, const void* c,
    const void* h0, void* y, void* hT,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    long long y_sb, long long y_ss, long long y_sh,
    int batch, int s, int h, int g, int p, int n, int is_bf16, int form, int vec,
    void* stream) {
  Args args{x, static_cast<const float*>(dt), static_cast<const float*>(a), b, c,
            static_cast<const float*>(h0), y, static_cast<float*>(hT),
            x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
            y_sb, y_ss, y_sh, s, h, g, p, n, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(args, batch, form, st) : launch<float>(args, batch, form, st);
}
