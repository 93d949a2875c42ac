// RWKV-6 wkv scan (rwkv6's time-mix recurrence) on Hopper.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_scan (body
// _rwkv6_kernel), which walked a (b·h, chunk) grid in order on one core and
// carried the [K, V] state across the chunk axis in VMEM scratch.  Unlike it,
// this one takes an initial state and writes the final one to a buffer that
// may be the same (a serving cache, updated in place): every element of a
// state is read and written by the one thread that owns it.
//
// What it computes, per chunk of up to 64 steps, with the decay floored as
// the reference floors it (log w ≥ floor = −88 / min(chunk, S), passed by
// the wrapper) and λ_l = Σ_{r≤l} log w_r inside the chunk, per channel k:
//   y_l = (r_l ∘ e^{λ_{l−1}})·S + Σ_{s<l} ((r_l ∘ e^{λ_{l−1}})·(k_s ∘ e^{−λ_s}))·v_s
//         + (Σ_k r_l u k_l)·v_l;
//   S'  = e^{λ_T} ∘ S + Σ_s (k_s ∘ e^{λ_T − λ_s}) ⊗ v_s,
// all in f32, the decomposition of the reference's ops.rwkv6_chunked.  Steps
// past the end are zeros with w = 1.  Exponentials are expf.
//
// Two forms, picked by the wrapper from S, with no fallback between them:
//
// * Decode (S = 1, rwkv6_step_kernel; L = 1, so the floor is −88):
//   y_v = Σ_k r_k S[k, v] + (Σ_k r_k u_k k_k)·v_v, S'[k, v] = w_k S[k, v] +
//   k_k v_v.  Bound by the state's bytes (rwkv6: 8.4 MB read and written a
//   step).  One CTA per (b, h, 16 columns of v): 64 rows × 4 lanes, each lane
//   one 16-byte load and store of the state, in place; y's sums over k run as
//   a shuffle tree over the warp's 8 rows and one shared-memory pass over the
//   warps.  1,024 CTAs at rwkv6's shape.
//
// * Prefill (S > 1, rwkv6_chunk_kernel): one CTA of 8 warps per (b, h) walks
//   the chunks, the f32 state [K, V] in registers (mma's accumulator layout:
//   warp w owns rows 16·(w mod 4) .. + 15 of k, and of l for y, and columns
//   32·(w div 4) .. + 31 of v).  A chunk's r, k, v and w arrive in shared
//   memory by cp.async while the last chunk's products run; w's floored log
//   replaces it in place, and
//   each warp runs the running sum λ of 8 channels as a shuffle scan over
//   the 64 rows (two rows a lane, the channels interleaved).  Then the four
//   products run on the tensor cores with mma.sync.m16n8k16 on ldmatrix
//   fragments:
//     A = r ∘ e^{λ_{l−1} − λ_T/2},  B = k ∘ e^{λ_T/2 − λ_s},
//     scores = A·Bᵀ (strictly below the diagonal, 16 steps s at a time up to
//              the warp's rows, each block taken into y at once),
//     y = A·(e^{λ_T/2} ∘ S) + scores·v + diag ∘ v,
//     S' = e^{λ_T} ∘ S + e^{λ_T/2} ∘ (Bᵀ·v)  (row k of Bᵀ·v scaled).
//   The factoring about λ_T/2, not 0, keeps every factor within e^{±44}
//   (|λ_T| ≤ 88 at the floor): r ∘ e^{λ_{l−1}} alone reaches e^{−88}, below
//   f32's smallest normal, where a bf16 part or the tensor cores may flush it
//   to zero, and k ∘ e^{−λ} reaches e^{88}.  The bonus diag_l = Σ_k r_l u_k
//   k_l is a shuffle reduction per row.  The two warps of a row block
//   compute its scores twice, which costs less than handing them over
//   through shared memory.  256 CTAs at rwkv6's shape, two an SM: one wave.
//
//   Precision: bf16 products are exact in f32, so an operand that is exactly
//   bf16 (v in the bf16 model) goes in as it is, and an f32 operand x goes in
//   as parts: p_0 = bf16(x), p_i = bf16(what p_0 .. p_{i−1} left).  In the
//   bf16 model A, B, the scaled state and the scores take two parts
//   (|x − p_0 − p_1| ≤ 2^-18·|x|), and a product keeps the part pairs (i, j)
//   with i + j ≤ 1: with both operands split (A·Bᵀ, A·S) a term is off by at
//   most 3·2^-18 of its magnitude (the pair (1, 1) and the two residues),
//   with one (scores·v, Bᵀ·v) by 2^-18.  A term of y crosses at most two
//   products, one of each kind (A·Bᵀ then scores·v; Bᵀ·v, carried in the
//   state, then A·S): 4·2^-18.  In the f32 model r, k, v are split too, in
//   three parts (residue ≤ 2^-27), keeping the pairs i + j ≤ 2.  The tensor
//   cores round their sums toward zero, one unit in the last place, twice
//   what a rounded f32 addition may lose, on the two sums (over k and over a
//   chunk's 64 steps) a term crosses; the products of the smaller parts run
//   first (within each 16-step block for scores·v).  chip_smoke.rwkv6_tc_tau
//   states the resulting term of the bound:
//   4·2^-18 + u·(K + 64 + 3).
//
//   What bounds it: at rwkv6's prefill (r, k, v [8, 512, 32, 64] bf16, w f32)
//   ~109 MB of inputs and outputs (0.033 ms at 3.35 TB/s) against ~2.1 GFLOP
//   of products (~6 GFLOP of bf16 mma with split operands and the scores
//   taken twice), so it is byte-bound at the card's rates, yet it takes
//   about four times that.  No one phase holds it back: with parts of the
//   chunk program taken out (profiling/k2_k6_probe.py --k6-ablation, device
//   time) it ran ~17% faster without the logs and exponentials, ~15%
//   without the next chunk's loads, ~21% without the score blocks and ~40%
//   without any product, and a CTA's chunks run these phases in turn,
//   hidden only by the SM's other CTA.  Tiles are bf16 [64][72] (144-byte
//   rows): ldmatrix without bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kL = 64;  // steps per chunk; also the largest K and V

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  const float* s0;  // may be null (zeros), may alias sT
  void* y;
  float* sT;
  long long r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh,
      y_sb, y_ss, y_sh;
  int s, h, kd, vd, tile;
  float floor;
  int vec;  // 16-byte accesses allowed: the state (decode), r, k, v (prefill)
};

__device__ __forceinline__ float floored_log(float w, float floor) {
  return fmaxf(logf(fmaxf(w, 1e-30f)), floor);
}

// ---------------------------------------------------------------------------
// Decode form.
// ---------------------------------------------------------------------------
constexpr int kStepCols = 16;                  // columns of v per CTA
constexpr int kStepThreads = kL * kStepCols / 4;  // 64 rows × 4 lanes of 4 columns

template <typename T>
__global__ void __launch_bounds__(kStepThreads) rwkv6_step_kernel(Args a) {
  __shared__ float part[kStepThreads / 32][kStepCols + 1];
  const int bh = blockIdx.x;
  const int bi = bh / a.h, hi = bh % a.h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = tid >> 2;                            // k
  const int c0 = blockIdx.y * kStepCols + 4 * (tid & 3);  // first of 4 columns of v
  const bool live = row < a.kd;
  const T* rp = static_cast<const T*>(a.r) + bi * a.r_sb + hi * a.r_sh;
  const T* kp = static_cast<const T*>(a.k) + bi * a.k_sb + hi * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + bi * a.v_sb + hi * a.v_sh;
  const float* wp = a.w + bi * a.w_sb + hi * a.w_sh;
  const float rk = live ? to_f32(rp[row]) : 0.0f;
  const float kk = live ? to_f32(kp[row]) : 0.0f;
  const float decay = live ? expf(floored_log(wp[row], a.floor)) : 0.0f;
  float vv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) vv[j] = c0 + j < a.vd ? to_f32(vp[c0 + j]) : 0.0f;
  const size_t off = (size_t(bh) * a.kd + row) * a.vd + c0;
  float sv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const bool whole = a.vec && live && c0 + 4 <= a.vd;
  if (a.s0 != nullptr && live) {
    if (whole) {
      const float4 x = *reinterpret_cast<const float4*>(a.s0 + off);
      sv[0] = x.x, sv[1] = x.y, sv[2] = x.z, sv[3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) sv[j] = c0 + j < a.vd ? a.s0[off + j] : 0.0f;
    }
  }
  // y's sums over k: this row's r_k·S[k, c] and (once a row) r_k·u_k·k_k.
  float acc[5];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[j] = rk * sv[j];
    sv[j] = fmaf(kk, vv[j], decay * sv[j]);
  }
  acc[4] = (tid & 3) == 0 && live ? rk * a.u[hi * a.kd + row] * kk : 0.0f;
  if (live) {
    if (whole) {
      *reinterpret_cast<float4*>(a.sT + off) = make_float4(sv[0], sv[1], sv[2], sv[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < a.vd) a.sT[off + j] = sv[j];
    }
  }
  // Over the warp's 8 rows (lanes 4 apart), then over the warps.
#pragma unroll
  for (int j = 0; j < 5; ++j) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) part[warp][4 * lane + j] = acc[j];
    if (lane == 0) part[warp][kStepCols] = acc[4];
  }
  __syncthreads();
  if (tid < kStepCols) {
    const int col = blockIdx.y * kStepCols + tid;
    float y = 0.0f, diag = 0.0f;
#pragma unroll
    for (int w = 0; w < kStepThreads / 32; ++w) {
      y += part[w][tid];
      diag += part[w][kStepCols];
    }
    if (col < a.vd) {
      const float vc = to_f32(vp[col]);
      static_cast<T*>(a.y)[bi * a.y_sb + hi * a.y_sh + col] = from_f32<T>(fmaf(diag, vc, y));
    }
  }
}

// ---------------------------------------------------------------------------
// Prefill form.
// ---------------------------------------------------------------------------
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 64;          // columns of v per CTA (two halves of 32, one per warp)
constexpr int kLd = 72;            // bf16 row stride of every tile (144 bytes)
constexpr int kTile = kL * kLd;
constexpr int kLdLam = kL + 1;     // f32 row stride of the log w / λ tile
constexpr int kRows = kL / kWarps;  // rows of a chunk each warp loads

// Parts of each operand: v is exact in the bf16 model (one part) and split in
// three in the f32 model; the f32 operands (A, B, the scaled state, the
// scores) take two parts in the bf16 model and three in the f32 model.
template <typename T> constexpr int kIn = std::is_same<T, float>::value ? 3 : 1;
template <typename T> constexpr int kParts = std::is_same<T, float>::value ? 3 : 2;
template <typename T> constexpr int kMinCtas = std::is_same<T, float>::value ? 1 : 2;
template <typename T>
constexpr size_t kChunkSmem = size_t(3 * kParts<T> + kIn<T>) * kTile * sizeof(bf16) +
                              size_t(kL * kLdLam + 4 * kL) * sizeof(float) +
                              size_t(3 * kL * kL) * sizeof(T);

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (v0, v1) as P bf16 pairs: part p = bf16 of what the earlier parts left.
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

// Two neighbouring values split into the P tiles at element idx.
template <int P>
__device__ __forceinline__ void store2(bf16* const (&tile)[P], int idx, float v0, float v1) {
  uint32_t part[P];
  split2<P>(v0, v1, part);
#pragma unroll
  for (int p = 0; p < P; ++p) *reinterpret_cast<uint32_t*>(tile[p] + idx) = part[p];
}

// acc[16 × 16·NT] += A · B over k steps [0, nk) of 16, for the warp's 16
// rows and NT groups of 16 columns.  A: stored [m][k] (a at the warp's first
// row) or with A_T [k][m] (a at the warp's first column).  B: stored [n][k]
// (b at the first row n), or with B_T [k][n] (b at the first column n).
template <bool A_T, bool B_T, int NT>
__device__ __forceinline__ void gemm1(float (&acc)[2 * NT][4], const bf16* a, const bf16* b,
                                      int nk, int lane) {
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t af[4];
    if (A_T)
      ldsm_x4_t(af, a + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + ((lane >> 3) & 1) * 8);
    else
      ldsm_x4(af, a + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < NT; ++jj) {
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

// The same over split operands (each part's pointer offset as gemm1 takes
// it): the part pairs (i, j) with i + j <= ORD, the smaller terms (larger
// i + j) first.
template <bool A_T, bool B_T, int NT, int ORD, int PA, int PB>
__device__ __forceinline__ void gemm(float (&acc)[2 * NT][4], const bf16* const (&a)[PA],
                                     const bf16* const (&b)[PB], int nk, int lane) {
#pragma unroll
  for (int ord = ORD; ord >= 0; --ord) {
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const int j = ord - i;
      if (j >= 0 && j < PB) gemm1<A_T, B_T, NT>(acc, a[i], b[j], nk, lane);
    }
  }
}

// acc[16 × 32] += P · V for one k step of 16: P in registers (PA parts of an
// A fragment), V stored [k][n] in PB parts (b at the step's first row and
// the warp's first column).
template <int ORD, int PA, int PB>
__device__ __forceinline__ void mma_step(float (&acc)[4][4], const uint32_t (&pf)[PA][4],
                                         const bf16* const (&b)[PB], int lane) {
#pragma unroll
  for (int ord = ORD; ord >= 0; --ord) {
#pragma unroll
    for (int i = 0; i < PA; ++i) {
      const int j = ord - i;
      if (j < 0 || j >= PB) continue;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t bf[4];
        ldsm_x4_t(bf, b[j] + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd + jj * 16 +
                          (lane >> 4) * 8);
        mma(acc[2 * jj], pf[i], bf[0], bf[1]);
        mma(acc[2 * jj + 1], pf[i], bf[2], bf[3]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinCtas<T>)
rwkv6_chunk_kernel(Args a) {
  constexpr int NI = kIn<T>, NP = kParts<T>, ORD = NP - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* next = reinterpret_cast<bf16*>(smem_raw);
  bf16* as[NP];  // [l][k]  A = r ∘ e^{λ_{l−1} − λ_T/2}
  bf16* bs[NP];  // [s][k]  B = k ∘ e^{λ_T/2 − λ_s}
  bf16* ss[NP];  // [k][c]  e^{λ_T/2} ∘ S
  bf16* vs[NI];  // [s][c]  v
#pragma unroll
  for (int i = 0; i < NP; ++i, next += 3 * kTile) {
    as[i] = next;
    bs[i] = next + kTile;
    ss[i] = next + 2 * kTile;
  }
#pragma unroll
  for (int i = 0; i < NI; ++i, next += kTile) vs[i] = next;
  float* lm = reinterpret_cast<float*>(next);  // [l][kLdLam]  log w, then λ
  float* lamh = lm + kL * kLdLam;              // [k]  λ_T / 2
  float* dect = lamh + kL;                     // [k]  e^{λ_T}
  float* scl = dect + kL;                      // [k]  e^{λ_T / 2}
  float* diag = scl + kL;                      // [l]  Σ_k r u k
  T* raw = reinterpret_cast<T*>(diag + kL);    // [3][l][64]  the next chunk's r, k, v

  const int bi = blockIdx.x / a.h, hi = blockIdx.x % a.h;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * (warp & 3);     // the warp's rows of l (y) and of k (the state)
  const int cofs = 32 * (warp >> 2);  // the warp's first column in the CTA's tiles
  const int vbase = blockIdx.y * kCols;
  const int v0 = vbase + cofs;        // ... and in v
  const T* rp = static_cast<const T*>(a.r) + bi * a.r_sb + hi * a.r_sh;
  const T* kp = static_cast<const T*>(a.k) + bi * a.k_sb + hi * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + bi * a.v_sb + hi * a.v_sh;
  const float* wp = a.w + bi * a.w_sb + hi * a.w_sh;
  T* yp = static_cast<T*>(a.y) + bi * a.y_sb + hi * a.y_sh;
  const size_t state_off = size_t(blockIdx.x) * a.kd * a.vd;
  const int nk = (a.kd + 15) >> 4;  // k steps over the channels
  const int c0 = 2 * lane;          // the lane's two channels in the elementwise passes
  const float u0 = c0 < a.kd ? a.u[hi * a.kd + c0] : 0.0f;
  const float u1 = c0 + 1 < a.kd ? a.u[hi * a.kd + c0 + 1] : 0.0f;
  const bf16* a_rows[NP];  // A's parts at the warp's rows
  const bf16* b_cols[NP];  // B's parts at the warp's columns (Bᵀ's rows)
  const bf16* s_cols[NP];  // the scaled state's parts at the warp's columns
  const bf16* v_cols[NI];  // v's parts at the warp's columns
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    a_rows[i] = as[i] + r0 * kLd;
    b_cols[i] = bs[i] + r0;
    s_cols[i] = ss[i] + cofs;
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) v_cols[i] = vs[i] + cofs;
  const bool pairs = ((a.y_sb | a.y_ss | a.y_sh) & 1) == 0;  // aligned two-column stores
  // A chunk's r, k and v (the CTA's columns) into raw, by 16-byte cp.async
  // where the wrapper found them aligned, and its w into lm by 4-byte ones;
  // rows past the end and columns past K or V are zeros.
  auto load_chunk = [&](int cs) {
    constexpr int E = 16 / sizeof(T);  // elements a 16-byte copy
    const int live = min(a.tile, a.s - cs);
    for (int q = threadIdx.x; q < 3 * kL * (kL / E); q += kThreads) {
      const int t = q / (kL * (kL / E)), row = (q / (kL / E)) % kL, col = (q % (kL / E)) * E;
      const T* src = t == 0 ? rp + (cs + row) * a.r_ss
                   : t == 1 ? kp + (cs + row) * a.k_ss : vp + (cs + row) * a.v_ss + vbase;
      const int cols = t == 2 ? a.vd - vbase : a.kd;
      T* dst = raw + (t * kL + row) * kL + col;
      if (a.vec) {
        const bool in = row < live && col < cols;
        cp_async16(dst, in ? src + col : rp, in ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j)
          dst[j] = row < live && col + j < cols ? src[col + j] : from_f32<T>(0.0f);
      }
    }
    for (int q = threadIdx.x; q < kL * kL; q += kThreads) {
      const int row = q / kL, col = q % kL;
      const bool in = row < live && col < a.kd;
      cp_async4(lm + row * kLdLam + col, in ? wp + (cs + row) * a.w_ss + col : wp, in ? 4 : 0);
    }
  };

  // The state: rows r0 + g (+8) of k, columns 8j + 2t4 (+1) of the warp's
  // 32, in mma's accumulator layout, for the CTA's whole life.
  float st[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + (e >> 1) * 8, col = v0 + 8 * j + 2 * t4 + (e & 1);
      st[j][e] = a.s0 != nullptr && row < a.kd && col < a.vd
                     ? a.s0[state_off + size_t(row) * a.vd + col] : 0.0f;
    }
  }

  load_chunk(0);
  cp_async_commit();
  for (int c0s = 0; c0s < a.s; c0s += a.tile) {
    const int lc = min(a.tile, a.s - c0s);  // live steps of this chunk
    cp_async_wait<0>();
    __syncthreads();  // this chunk's inputs are in; the last chunk's readers are done
    // The warp's 8 rows: floored log w in place in lm, v split into its
    // tiles (two columns a lane), r and k kept in registers (two channels a
    // lane), and the bonus diag.
    float rv[kRows][2], kv[kRows][2], lw[kRows][2], vv[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int l = kRows * warp + i;
      const bool live = l < lc;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        rv[i][e] = to_f32(raw[l * kL + c0 + e]);
        kv[i][e] = to_f32(raw[(kL + l) * kL + c0 + e]);
        lw[i][e] = live && c0 + e < a.kd ? lm[l * kLdLam + c0 + e] : 1.0f;
        vv[i][e] = to_f32(raw[(2 * kL + l) * kL + lane + 32 * e]);
      }
    }
    float dg[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int l = kRows * warp + i;
      lm[l * kLdLam + c0] = c0 < a.kd ? floored_log(lw[i][0], a.floor) : 0.0f;
      lm[l * kLdLam + c0 + 1] = c0 + 1 < a.kd ? floored_log(lw[i][1], a.floor) : 0.0f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float rest = vv[i][e];
#pragma unroll
        for (int p = 0; p < NI; ++p) {
          const bf16 h = __float2bfloat16(rest);
          vs[p][l * kLd + lane + 32 * e] = h;
          rest -= __bfloat162float(h);
        }
      }
      dg[i] = rv[i][0] * u0 * kv[i][0] + rv[i][1] * u1 * kv[i][1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) diag[kRows * warp + i] = dg[i];
    }
    __syncthreads();
    // λ: each warp scans 8 channels over the 64 rows, two rows a lane, the
    // channels' scans interleaved.
    {
      float x0[kRows], x1[kRows], incl[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int ch = kRows * warp + i;
        x0[i] = lm[(2 * lane) * kLdLam + ch];
        x1[i] = lm[(2 * lane + 1) * kLdLam + ch];
        incl[i] = x0[i] + x1[i];
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float y = __shfl_up_sync(0xffffffffu, incl[i], o);
          if (lane >= o) incl[i] += y;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int ch = kRows * warp + i;
        float excl = __shfl_up_sync(0xffffffffu, incl[i], 1);
        if (lane == 0) excl = 0.0f;
        const float lam0 = excl + x0[i];
        lm[(2 * lane) * kLdLam + ch] = lam0;
        lm[(2 * lane + 1) * kLdLam + ch] = lam0 + x1[i];
        if (lane == 31) {
          const float tot = lam0 + x1[i];
          lamh[ch] = 0.5f * tot;
          dect[ch] = expf(tot);
          scl[ch] = expf(0.5f * tot);
        }
      }
    }
    __syncthreads();
    // A and B for the warp's 8 rows; the scaled state for its rows and
    // columns.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int l = kRows * warp + i;
      float av[2], bv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = c0 + e;
        const float prev = l > 0 ? lm[(l - 1) * kLdLam + ch] : 0.0f;
        av[e] = rv[i][e] * expf(prev - lamh[ch]);
        bv[e] = kv[i][e] * expf(lamh[ch] - lm[l * kLdLam + ch]);
      }
      store2<NP>(as, l * kLd + c0, av[0], av[1]);
      store2<NP>(bs, l * kLd + c0, bv[0], bv[1]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = r0 + g + 8 * rh;
        const float f = scl[row];
        store2<NP>(ss, row * kLd + cofs + 8 * j + 2 * t4, st[j][2 * rh] * f,
                   st[j][2 * rh + 1] * f);
      }
    }
    __syncthreads();
    // The next chunk's inputs load during the products (raw and lm are
    // free: every read of them is behind the barrier).
    if (c0s + a.tile < a.s) load_chunk(c0s + a.tile);
    cp_async_commit();

    // y = A·(e^{λ_T/2} ∘ S) + scores·v + diag ∘ v.
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    gemm<false, true, 2, ORD>(acc, a_rows, s_cols, nk, lane);
    // The scores a block of 16 steps s at a time, up to the warp's diagonal,
    // each block strictly below it split as A fragments and taken into y.
    for (int kb = 0; kb <= (warp & 3); ++kb) {
      float sc[2][4] = {};
      const bf16* b_blk[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i) b_blk[i] = bs[i] + kb * 16 * kLd;
      gemm<false, false, 1, ORD>(sc, a_rows, b_blk, nk, lane);
      uint32_t pf[NP][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const int l = r0 + g + 8 * rh, s = 16 * kb + 8 * hf + 2 * t4;
          uint32_t part[NP];
          split2<NP>(s < l ? sc[hf][2 * rh] : 0.0f, s + 1 < l ? sc[hf][2 * rh + 1] : 0.0f, part);
#pragma unroll
          for (int p = 0; p < NP; ++p) pf[p][2 * hf + rh] = part[p];
        }
      }
      const bf16* v_blk[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) v_blk[i] = v_cols[i] + kb * 16 * kLd;
      mma_step<ORD>(acc, pf, v_blk, lane);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int l = r0 + g + 8 * rh, cl = cofs + 8 * j + 2 * t4, col = vbase + cl;
        if (l >= lc) continue;
        const float dgl = diag[l];
        float out[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = 0.0f;
#pragma unroll
          for (int p = 0; p < NI; ++p) x += __bfloat162float(vs[p][l * kLd + cl + e]);
          out[e] = fmaf(dgl, x, acc[j][2 * rh + e]);
        }
        T* dst = yp + (c0s + l) * a.y_ss + col;
        if (pairs && col + 1 < a.vd) {
          if constexpr (std::is_same<T, float>::value) {
            *reinterpret_cast<float2*>(dst) = make_float2(out[0], out[1]);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(out[0], out[1]);
          }
        } else {
          if (col < a.vd) dst[0] = from_f32<T>(out[0]);
          if (col + 1 < a.vd) dst[1] = from_f32<T>(out[1]);
        }
      }
    }

    // S' = e^{λ_T} ∘ S + e^{λ_T/2} ∘ (Bᵀ·v), the warp's rows of k.
    const int ks = (lc + 15) >> 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    gemm<true, true, 2, ORD>(acc, b_cols, v_cols, ks, lane);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = r0 + g + 8 * rh;
      const float d = dect[row], f = scl[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          st[j][2 * rh + e] = fmaf(st[j][2 * rh + e], d, f * acc[j][2 * rh + e]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + (e >> 1) * 8, col = v0 + 8 * j + 2 * t4 + (e & 1);
      if (row < a.kd && col < a.vd) a.sT[state_off + size_t(row) * a.vd + col] = st[j][e];
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
  err = cudaFuncSetAttribute(rwkv6_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kChunkSmem<T>));
  done[dev] = err == cudaSuccess;
  return err;
}

template <typename T>
int launch(const Args& a, int batch, int form, cudaStream_t stream) {
  if (form == 0) {
    const dim3 grid(batch * a.h, (a.vd + kStepCols - 1) / kStepCols);
    rwkv6_step_kernel<T><<<grid, kStepThreads, 0, stream>>>(a);
  } else if (form == 1) {
    const cudaError_t err = opt_in<T>();
    if (err != cudaSuccess) return int(err);
    const dim3 grid(batch * a.h, (a.vd + kCols - 1) / kCols);
    rwkv6_chunk_kernel<T><<<grid, kThreads, kChunkSmem<T>, stream>>>(a);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // namespace

// Strides are in elements, by (batch, seq, head), for r, k, w [B, S, H, K],
// v and y [B, S, H, V], the last dimension contiguous; u is contiguous
// [H, K] f32; s0 (or null) and sT are contiguous [B, H, K, V] f32 and may be
// the same buffer.  form 0 is the decode form (S = 1; vec allows 16-byte
// loads and stores of the state), form 1 the prefill form (vec allows
// 16-byte copies of r, k, v rows).  The wrapper
// checks shapes, dtypes and K, V <= 64, and never launches an empty grid or
// S = 0.  tile (1 to 64) is the chunk length, at most the L of the floor
// −88 / L.
extern "C" int blaze_rwkv6_scan(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* s0, void* y, void* sT,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh,
    long long y_sb, long long y_ss, long long y_sh,
    int batch, int s, int h, int kdim, int vdim, int tile, float floor, int is_bf16,
    int form, int vec, void* stream) {
  Args args{r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),
            static_cast<const float*>(s0), y, static_cast<float*>(sT),
            r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh,
            y_sb, y_ss, y_sh, s, h, kdim, vdim, tile, floor, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<bf16>(args, batch, form, st) : launch<float>(args, batch, form, st);
}
