// Flash attention (online softmax) on Hopper, in three forms.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel), which walked a (b, h, q-tile, kv-tile) grid in order
// on one core and carried the running (m, l, acc) of a q-tile across the
// kv-tile axis in VMEM scratch.  Here a CTA walks its kv-tiles in a loop, so
// the running state lives in registers for the CTA's whole life; only the
// decode form splits the keys across CTAs and merges in a second kernel.
//
// What it computes, per query row i at absolute position pos = q_offset + i
// and key j (query head h reads kv head h / (Hq / Hkv); no repeated K/V):
//   s = scale · q·k_j,  then softcap·tanh(s / softcap) when softcap > 0;
//   masked (j >= Skv, causal j > pos, window j <= pos − window) → -1e30;
//   m' = max(m, max_j s), p_j = exp(s_j − m'), corr = exp(m − m'),
//   l = l·corr + Σ p_j, acc = acc·corr + Σ p_j v_j, all in f32;
//   out = acc / max(l, 1e-30) in q's dtype.
// Masked logits are the TPU kernel's finite -1e30, so a row masked in one
// tile but not in all of them rescales exactly as it does there.  A masked
// entry adds p = 0 where the TPU kernel adds exp(-1e30 − (-1e30)) = 1 while
// its row has seen no live key; a later live key rescales that by
// exp(-1e30 − m') = 0, so the two agree on every row with a live key, and a
// row with none gives zeros here, as the plain version (attention_ref) does.
//
// The wrapper (kernels/flash_attention.py, `form`) picks the form from the
// dtype and the packed query rows R = (Hq / Hkv)·Sq:
//   f32                → flash_kernel, on the CUDA cores (exact f32 products);
//   bf16, R > 16       → flash_prefill_kernel, on the tensor cores;
//   bf16, R <= 16      → flash_decode_kernel (split over the keys) and
//                        flash_combine_kernel.
// What bounds them: at qwen3's prefill (Sq = 512 over 545 keys, D = 128,
// causal) the function does ~8.6 GFLOP against ~50 MB moved, 8.7 µs of bf16
// tensor-core work against 15 µs of bytes, so a fast form needs the tensor
// cores and overlapped loads to approach either; a decode step reads the
// cached K/V rows once and does ~2 flops a byte, so it is bound by bytes and
// needs enough CTAs with enough loads in flight to fill the card.
//
// Tiles the mask rules out are never read: a causal q-tile stops at the last
// key its last row sees (so a decode step over a [B, S_max, Hkv, D] cache
// costs O(position), not O(S_max)), and a window starts at the first key
// its first row sees.  The inputs are read through their strides, so the
// KV cache's [B, S, H, D] layout is read in place; q_offset is a run-time
// argument, or, where q_offset_ptr is set, an int32 the kernel reads from
// device memory (a decode step captured in a CUDA graph keeps its position
// there, so one graph serves every step).  D is any multiple of 8 up to 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 form on the CUDA cores.
//
// 256 threads as 16 (keys / head dims) × 16 (rows).  A thread holds RI query
// rows (ty + 16·r) × 4 keys (tx + 16·c) of the logits tile and RI rows × NCH
// head dims (tx + 16·n) of the accumulator; RI = 4 (64-row q-tiles) for
// prefill, RI = 1 (16 rows) when Sq <= 16, for decode.  Each kv-tile is 64
// keys.  Q, K and V tiles are staged in shared memory as f32 (16-byte loads
// from device memory; rows of Q and K padded to D + 1 floats so the dot
// products read without bank conflicts), the probabilities go through shared
// memory from the 16 lanes that own a row to the same lanes.  The products
// are exact f32 FMAs: a TF32 product would round q and k to 10 bits.  Shared
// memory is sized from D at launch (217,600 bytes at D = 256).
// ---------------------------------------------------------------------------
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kBK = 64;           // keys per kv-tile
constexpr int kRJ = kBK / kTX;    // keys per thread in a tile
constexpr int kLdp = kBK + 16;    // row stride of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int hq, hkv, sq, skv, d;
  int causal, has_window, window, q_offset;
  const int* q_offset_ptr;  // when set, the offset is read here
  float scale, softcap;
};

// The query rows' offset: the launch's, or the one in device memory.
template <typename A>
__device__ __forceinline__ int query_offset(const A& a) {
  return a.q_offset_ptr != nullptr ? *a.q_offset_ptr : a.q_offset;
}

// Copy rows [row0, row0 + rows) of a strided [S, D] matrix into shared
// memory as f32 with row stride ld, zeros past row nvalid.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long ss, int row0,
                                      int rows, int nvalid, int d, float* dst, int ld) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = d / V;
  for (int t = threadIdx.x; t < rows * per_row; t += kThreads) {
    const int r = t / per_row;
    const int c = (t - r * per_row) * V;
    float* out = dst + r * ld + c;
    if (row0 + r < nvalid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = to_f32(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = 0.0f;
    }
  }
}

__device__ __forceinline__ float row_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int RI, int NCH>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(Args a) {
  constexpr int BQ = RI * kTY;
  extern __shared__ float smem[];
  const int d = a.d;
  const int ldq = d + 1, ldk = d + 1, ldv = d;
  float* qs = smem;
  float* ks = qs + BQ * ldq;
  float* vs = ks + kBK * ldk;
  float* ps = vs + kBK * ldv;

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // Keys [k_lo, k_hi) are the only ones any real row of this tile sees.
  const int q_offset = query_offset(a);
  const int q_first = q0 + q_offset;
  const int q_last = min(q0 + BQ, a.sq) - 1 + q_offset;
  int k_hi = a.skv;
  if (a.causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (a.has_window) k_lo = max(0, q_first - a.window + 1);
  const int t_lo = k_lo / kBK;
  const int t_hi = k_hi > 0 ? (k_hi + kBK - 1) / kBK : 0;

  stage<T>(qp, a.q_ss, q0, BQ, a.sq, d, qs, ldq);

  float m[RI], l[RI], acc[RI][NCH];
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int n = 0; n < NCH; ++n) acc[r][n] = 0.0f;
  }

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the previous tile's K and V are no longer read
    stage<T>(kp, a.k_ss, k0, kBK, a.skv, d, ks, ldk);
    stage<T>(vp, a.v_ss, k0, kBK, a.skv, d, vs, ldv);
    __syncthreads();

    float s[RI][kRJ];
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < kRJ; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int e = 0; e < d; ++e) {
      float qv[RI], kv[kRJ];
#pragma unroll
      for (int r = 0; r < RI; ++r) qv[r] = qs[(ty + kTY * r) * ldq + e];
#pragma unroll
      for (int c = 0; c < kRJ; ++c) kv[c] = ks[(tx + kTX * c) * ldk + e];
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < kRJ; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < RI; ++r) {
      const int qi = q0 + ty + kTY * r;
      const int pos = q_offset + qi;
      bool live[kRJ];
      float tile_max = kNegInf;
#pragma unroll
      for (int c = 0; c < kRJ; ++c) {
        const int kj = k0 + tx + kTX * c;
        bool ok = kj < a.skv && qi < a.sq;
        if (a.causal) ok = ok && kj <= pos;
        if (a.has_window) ok = ok && kj > pos - a.window;
        float x = s[r][c] * a.scale;
        if (a.softcap > 0.0f) x = a.softcap * tanhf(x / a.softcap);
        live[c] = ok;
        s[r][c] = ok ? x : kNegInf;
        tile_max = fmaxf(tile_max, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(tile_max));
      const float corr = expf(m[r] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < kRJ; ++c) {
        const float p = live[c] ? expf(s[r][c] - m_new) : 0.0f;
        ps[(ty + kTY * r) * kLdp + tx + kTX * c] = p;
        psum += p;
      }
      l[r] = l[r] * corr + row_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NCH; ++n) acc[r][n] *= corr;
    }
    __syncwarp();  // a row's probabilities come from the lanes that read them

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[RI];
#pragma unroll
      for (int r = 0; r < RI; ++r) pv[r] = ps[(ty + kTY * r) * kLdp + kk];
#pragma unroll
      for (int n = 0; n < NCH; ++n) {
        const int e = tx + kTX * n;
        if (e < d) {
          const float vv = vs[kk * ldv + e];
#pragma unroll
          for (int r = 0; r < RI; ++r) acc[r][n] = fmaf(pv[r], vv, acc[r][n]);
        }
      }
    }
  }

  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    const int qi = q0 + ty + kTY * r;
    if (qi >= a.sq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < NCH; ++n) {
      const int e = tx + kTX * n;
      if (e < d) op[qi * a.o_ss + e] = from_f32<T>(acc[r][n] * inv);
    }
  }
}

size_t smem_bytes(int rows, int d) {
  return sizeof(float) * (size_t(rows) * (d + 1) + size_t(kBK) * (d + 1) +
                          size_t(kBK) * d + size_t(rows) * kLdp);
}

template <typename T, int RI, int NCH>
int launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int BQ = RI * kTY;
  const size_t bytes = smem_bytes(BQ, a.d);
  // Above 48 KB a launch must opt in, per function and device.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, RI, NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.sq + BQ - 1) / BQ, a.hq, batch);
  flash_kernel<T, RI, NCH><<<grid, kThreads, bytes, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T, int RI>
int launch_d(const Args& a, int batch, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, RI, 2>(a, batch, stream);
  if (a.d <= 64) return launch<T, RI, 4>(a, batch, stream);
  if (a.d <= 128) return launch<T, RI, 8>(a, batch, stream);
  return launch<T, RI, 16>(a, batch, stream);
}

template <typename T>
int launch_t(const Args& a, int batch, cudaStream_t stream) {
  return a.sq <= kTY ? launch_d<T, 1>(a, batch, stream) : launch_d<T, 4>(a, batch, stream);
}


// ---------------------------------------------------------------------------
// bf16 forms on the tensor cores.
//
// Both take K/V tiles of 64 keys through a two-stage cp.async ring (16-byte
// copies, zero-filled past Skv), so tile t + 1 loads while tile t computes;
// tiles stay bf16, D is padded with zeros to DP.  A CTA is 4 warps.  Both
// run the online softmax in f32 on the accumulator fragments of S (a row on
// the 4 lanes of a quad), in base 2: logits scaled by log2 e, p = 2^(s − m)
// by ex2.approx (relative error below 2^-22, far inside the logits' own
// rounding), with the TPU kernel's -1e30 masking.  p is rounded to bf16 as
// the A operand of P·V, while l sums the f32 p.
//
// Prefill form (flash_prefill_kernel, Hq/Hkv · Sq > 16): one warpgroup on
// 64 query rows packed by GQA group (row r: query head hg·G + r / P of kv
// head hk's group, position q0 + r % P, G = min(Hq/Hkv, 4) heads × P = 64 /
// G positions), so each K/V tile a CTA loads serves G heads.  S = Q·Kᵀ is a
// wgmma chain (m64n64k16, Q and K read by descriptor from shared memory);
// P·V is a wgmma chain with P from registers (S's fragments are already
// wgmma's A layout) and V read transposed.  Tiles use the 128-byte swizzle
// (DP a multiple of 64).  Only tiles that cross the causal diagonal, a
// window's edge or Skv are masked; the softcap and the mask are branches
// around whole loops, not selects inside them (a select would evaluate
// tanhf for every logit).
//
// Decode form (flash_decode_kernel + flash_combine_kernel, Hq/Hkv · Sq <=
// 16): the 16-row tile holds every query row of a kv head; one CTA per
// (split, kv-head, b).  A split is a run of key tiles; warp w takes keys
// 16w..16w+15 of each with mma.sync.m16n8k16 on ldmatrix fragments (padded
// rows, read ahead of the products), keeps its own (m, l, acc) and writes
// them unnormalised as one partial of an f32 workspace.  The combine kernel
// merges a row's partials by their m (an empty partial has m = -1e30, l = 0
// and weighs 0) and writes q's dtype.  The split count comes from the
// wrapper (decode_splits), so that B·Hkv·splits CTAs fill the card.
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 64;       // keys per tile
constexpr int kStages = 2;    // K/V ring depth
constexpr int kPrefillRows = 16 * kWarps;
constexpr int kDecodeRows = 16;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int hkv, sq, skv, d;
  int causal, has_window, window, q_offset;
  const int* q_offset_ptr;  // when set, the offset is read here
  float scale, softcap;
  int rep;              // Hq / Hkv
  int heads, pos;       // prefill: G heads × P positions in a CTA's tile
  int groups;           // prefill: CTAs along a kv head's query heads, ceil(rep / G)
  int tiles_per_split;  // decode
  float* ws_ml;         // decode partials: (m, l) per row
  float* ws_acc;        // decode partials: acc[d] per row
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// wgmma (sm_90a), for the prefill form.  Tiles are bf16 [rows × DP] in the
// 128-byte-swizzled layout: DP / 64 column blocks of rows × 128 bytes, 8-row
// atoms of 1024 bytes, 16-byte chunk c of row r at chunk (c ^ r) % 8 of its
// row.  As a K-major operand (Q, K) a k step of 16 moves 32 bytes along a
// row (a new block every 4); as the transposed B of P·V (V, keys × d) a k
// step of 16 keys moves two atoms.
__device__ __forceinline__ int sw128(int rows, int r, int c) {
  return (c >> 3) * rows * 128 + r * 128 + (((c ^ r) & 7) << 4);
}

// Descriptor: start address, leading byte offset (V: the next 64 columns),
// stride byte offset 1024 (the next 8-row atom), 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, int lbo_bytes) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define WGMMA_D32                                                                    \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),         \
      "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),     \
      "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),     \
      "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),     \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),     \
      "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),     \
      "+f"(d[7][2]), "+f"(d[7][3])
#define WGMMA_REGS32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 × 64] += A[64 × 16] · B[16 × 64]: A and B K-major in shared memory.
// Warp w of the warpgroup holds rows 16w..16w+15 of d in mma.sync's C layout.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_REGS32
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : WGMMA_D32
               : "l"(da), "l"(db), "r"(1));
}

// d[64 × 64] += A[64 × 16] · B[16 × 64]: A in registers (mma.sync's A layout
// per warp), B transposed (N-major) in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_REGS32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : WGMMA_D32
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef WGMMA_D32
#undef WGMMA_REGS32

// Orders every later use of these registers after wgmma_wait (the compiler
// sees each written here), and keeps wgmma's register inputs live until then.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[n][e])::"memory");
}

// 2^x (MUFU.EX2: relative error below 2^-22; 0 for x below -126).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// fn(r, c) for every 16-byte chunk (row r, column chunk c) of a [rows,
// per_row · 8] tile that this thread copies: thread i takes chunks i, i +
// 128, ..., chunks along a row running fastest (consecutive lanes read
// consecutive 16 bytes).  Stepping by 128 chunks moves the row and the column
// by fixed amounts, so the loop divides once.
template <typename F>
__device__ __forceinline__ void for_chunks(int rows, int per_row, F&& fn) {
  const int dr = kThreads / per_row, dc = kThreads % per_row;
  for (int i = threadIdx.x, r = i / per_row, c = i % per_row; i < rows * per_row;
       i += kThreads) {
    fn(r, c);
    r += dr;
    c += dc;
    if (c >= per_row) c -= per_row, ++r;
  }
}

// Dynamic shared memory of both forms.  Decode: Q and a two-stage K/V ring
// in padded rows (DP + 8 elements).  Prefill: Q and the ring in the
// 128-byte-swizzled layout (DP elements a row; atoms 1024-byte aligned).
extern __shared__ __align__(1024) unsigned char smem_raw[];

template <int DP, bool DECODE>
constexpr size_t smem_bytes() {
  return DECODE ? sizeof(bf16) * size_t(kDecodeRows + 2 * kStages * kBK) * (DP + 8)
                : sizeof(bf16) * size_t(kPrefillRows + 2 * kStages * kBK) * DP;
}

// The decode form: the (Hq / Hkv)·Sq <= 16 query rows of a kv head in one
// 16-row tile (row r: head r / Sq of the group, position r % Sq), the CTA's
// split of key tiles through a two-stage cp.async ring in padded rows, and
// warp w on keys 16w..16w+15 of every tile with mma.sync.m16n8k16.  Each
// warp keeps its own (m, l, acc) and writes them, unnormalised, as partial
// blockIdx.x · 4 + w of its rows.
template <int DP>
__device__ __forceinline__ void attend_decode(const Args& a) {
  constexpr int BQ = kDecodeRows;
  constexpr int LD = DP + 8;  // padded row stride, elements
  constexpr int ND = DP / 8;  // 8-wide blocks of a row of acc
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BQ * LD;
  bf16* vs = ks + kStages * kBK * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int d = a.d;
  const bf16* kp = a.k + b * a.k_sb + hk * a.k_sh;
  const bf16* vp = a.v + b * a.v_sb + hk * a.v_sh;

  // This split's key tiles: tiles_per_split of the tiles [k_lo, k_hi) that
  // some row sees (the wrapper's key_tiles).  With the offset in device
  // memory the wrapper sizes the grid for the most tiles any offset can
  // leave live, and each split takes ceil(live tiles / splits) of the tiles
  // this offset leaves live, so the work stays spread over the grid however
  // short the live range is; a split past them walks no tile and writes the
  // empty partial (m = -1e30, l = 0), which the combine weighs 0.
  const int q_offset = query_offset(a);
  int k_hi = a.skv;
  if (a.causal) k_hi = min(k_hi, a.sq + q_offset);
  int k_lo = 0;
  if (a.has_window) k_lo = max(0, q_offset - a.window + 1);
  const int t_lo = k_lo / kBK, t_hi = k_hi > 0 ? (k_hi + kBK - 1) / kBK : 0;
  const int per = a.q_offset_ptr != nullptr
                      ? max(1, (t_hi - t_lo + (int)gridDim.x - 1) / (int)gridDim.x)
                      : a.tiles_per_split;
  const int t0 = t_lo + blockIdx.x * per;
  const int t1 = min(t_hi, t0 + per);

  // Zero the pad columns [d, DP) of Q and of the K/V ring; the copies below
  // never write them.
  if (DP > d) {
    const int pad = (DP - d) / 8;
    for (int c = tid; c < (BQ + 2 * kStages * kBK) * pad; c += kThreads) {
      const int r = c / pad;
      *reinterpret_cast<uint4*>(qs + r * LD + d + (c - r * pad) * 8) = make_uint4(0, 0, 0, 0);
    }
  }
  const int per_row = d / 8;
  for_chunks(BQ, per_row, [&](int r, int c) {
    const int g = r / a.sq, pi = r % a.sq;
    const bool ok = g < a.rep;
    const bf16* src = ok ? a.q + b * a.q_sb + (hk * a.rep + g) * a.q_sh + pi * a.q_ss + c * 8 : a.q;
    cp_async16(qs + r * LD + c * 8, src, ok ? 16 : 0);
  });
  auto load_tile = [&](int t, int stage) {
    bf16* kd = ks + stage * kBK * LD;
    bf16* vd = vs + stage * kBK * LD;
    for_chunks(kBK, per_row, [&](int r, int c) {
      const int key = t * kBK + r;
      const bool ok = key < a.skv;
      const long long row = ok ? key : 0;
      cp_async16(kd + r * LD + c * 8, kp + row * a.k_ss + c * 8, ok ? 16 : 0);
      cp_async16(vd + r * LD + c * 8, vp + row * a.v_ss + c * 8, ok ? 16 : 0);
    });
  };
  if (t0 < t1) load_tile(t0, 0);
  cp_async_commit();

  // This thread's rows lane / 4 and 8 below it; the warp's keys in a tile.
  const int kb = 16 * warp;
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = (lane / 4 + 8 * h) % a.sq + q_offset;
  // Logits in log2 units (s·log2 e), so p = 2^(s − m).
  const bool capped = a.softcap > 0.0f;
  const float to_log2 = capped ? a.softcap * kLog2e : a.scale * kLog2e;
  const float cap_in = capped ? a.scale / a.softcap : 0.0f;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int t = t0; t < t1; ++t) {
    const int stage = (t - t0) & 1;
    if (t + 1 < t1) {
      load_tile(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + stage * kBK * LD;
    const bf16* vt = vs + stage * kBK * LD;

    // S = Q·Kᵀ over the warp's 16 keys; the fragments of step kk + 1 are
    // read before step kk's products are issued.
    float s[2][4] = {};
    uint32_t qa[2][4], kf[2][4];
    auto load_qk = [&](int kk, int buf) {
      ldsm_x4(qa[buf], qs + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(kf[buf], kt + (kb + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                           ((lane >> 3) & 1) * 8);
    };
    load_qk(0, 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      if (kk + 1 < DP / 16) load_qk(kk + 1, (kk + 1) & 1);
      mma(s[0], qa[kk & 1], kf[kk & 1][0], kf[kk & 1][1]);
      mma(s[1], qa[kk & 1], kf[kk & 1][2], kf[kk & 1][3]);
    }

    // Scale, softcap (a uniform branch around the loop, so tanhf runs only
    // when asked), mask; entry (n, e) is row e / 2, key k0 + 8n +
    // 2·(lane % 4) + e % 2.
    const int k0 = t * kBK + kb;
    if (capped) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = to_log2 * tanhf(s[n][e] * cap_in);
    } else {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= to_log2;
    }
    uint32_t live = 0;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
        const int p = pos[e >> 1];
        bool ok = key < a.skv;
        if (a.causal) ok = ok && key <= p;
        if (a.has_window) ok = ok && key > p - a.window;
        if (ok) live |= 1u << (n * 4 + e);
        else s[n][e] = kNegInf;
      }

    // Online softmax per row, in f32 (the TPU kernel's rules, base 2).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]), fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      const float m_new = fmaxf(m[h], quad_max(mx));
      const float corr = exp2_approx(m[h] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * h + j;
          const float p = exp2_approx(s[n][e] - m_new);
          s[n][e] = (live >> (n * 4 + e)) & 1u ? p : 0.0f;
          psum += s[n][e];
        }
      l[h] = l[h] * corr + quad_sum(psum);
      m[h] = m_new;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * h] *= corr;
        acc[n][2 * h + 1] *= corr;
      }
    }

    // acc += P·V over the warp's 16 keys, P rounded to bf16 (S's fragments
    // are the A fragment of that k step); V's fragments come through a ring,
    // three ahead of the products that use them.
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
    constexpr int NV = ND / 2;  // V fragments a warp reads per tile
    constexpr int kAhead = 3;
    uint32_t vf[kAhead + 1][4];
    auto load_v = [&](int i) {
      ldsm_x4_t(vf[i % (kAhead + 1)],
                vt + (kb + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + 2 * i * 8 + (lane >> 4) * 8);
    };
#pragma unroll
    for (int i = 0; i < kAhead && i < NV; ++i) load_v(i);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i + kAhead < NV) load_v(i + kAhead);
      mma(acc[2 * i], pa, vf[i % (kAhead + 1)][0], vf[i % (kAhead + 1)][1]);
      mma(acc[2 * i + 1], pa, vf[i % (kAhead + 1)][2], vf[i % (kAhead + 1)][3]);
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();

  // Partial (blockIdx.x · 4 + warp) of (b, hk): rows r < (Hq / Hkv)·Sq.
  const int rows = a.rep * a.sq;
  const long long base =
      ((long long)(b * a.hkv + hk) * gridDim.x * kWarps + blockIdx.x * kWarps + warp) * rows;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane / 4 + 8 * h;
    if (r >= rows) continue;
    if ((lane & 3) == 0) {
      a.ws_ml[(base + r) * 2] = m[h];
      a.ws_ml[(base + r) * 2 + 1] = l[h];
    }
    float* out = a.ws_acc + (base + r) * d;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = n * 8 + 2 * (lane & 3);
      if (col < d) *reinterpret_cast<float2*>(out + col) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
  }
}

// The prefill form: one warpgroup, 64 packed query rows, S = Q·Kᵀ and
// acc += P·V as wgmma over 128-byte-swizzled tiles (Q once, K and V in a
// ring of kStages cp.async slots, loads issued kStages − 1 tiles ahead),
// softmax in registers between them.  DP is a multiple of 64.
template <int DP>
__device__ __forceinline__ void attend_wgmma(const Args& a) {
  constexpr int BQ = kPrefillRows;
  constexpr int NJ = DP / 64;              // 64-column blocks of a row of acc
  constexpr int kRing = kStages;
  constexpr int kTile = kBK * DP * 2;      // bytes of a K or V tile
  const uint32_t qs = smem_u32(smem_raw);
  const uint32_t ks = qs + BQ * DP * 2;    // kRing K tiles, then kRing V tiles
  const uint32_t vs = ks + kRing * kTile;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z;
  const int hk = blockIdx.y / a.groups, hg = blockIdx.y % a.groups;
  const int q0 = blockIdx.x * a.pos;
  const int d = a.d;
  const bf16* kp = a.k + b * a.k_sb + hk * a.k_sh;
  const bf16* vp = a.v + b * a.v_sb + hk * a.v_sh;

  // Key tiles [t0, t1) hold every key a live row of this tile sees.
  const int q_offset = query_offset(a);
  const int pos_lo = q0 + q_offset;
  const int pos_hi = min(q0 + a.pos, a.sq) - 1 + q_offset;
  int k_hi = a.skv;
  if (a.causal) k_hi = min(k_hi, pos_hi + 1);
  int k_lo = 0;
  if (a.has_window) k_lo = max(0, pos_lo - a.window + 1);
  const int t0 = k_lo / kBK;
  const int t1 = k_hi > 0 ? (k_hi + kBK - 1) / kBK : 0;

  // Zero the chunks past d of every row (Q and every ring tile); the copies
  // never write them.
  const int per_row = d / 8;
  if (DP > d) {
    const int pad = DP / 8 - per_row;
    for (int c = tid; c < (BQ + 2 * kRing * kBK) * pad; c += kThreads) {
      const int r = c / pad, col = per_row + c - r * pad;
      const uint32_t at = r < BQ ? qs + sw128(BQ, r, col)
                                 : ks + (r - BQ) / kBK * kTile + sw128(kBK, (r - BQ) % kBK, col);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(0), "r"(0),
                   "r"(0), "r"(0));
    }
  }
  for_chunks(BQ, per_row, [&](int r, int c) {
    const int g = r / a.pos, pi = r % a.pos, head = hg * a.heads + g;
    const bool ok = g < a.heads && head < a.rep && q0 + pi < a.sq;
    const bf16* src = ok ? a.q + b * a.q_sb + (hk * a.rep + head) * a.q_sh +
                               (q0 + pi) * a.q_ss + c * 8
                         : a.q;
    cp_async16(qs + sw128(BQ, r, c), src, ok ? 16 : 0);
  });
  // Tile t goes to slot (t − t0) % kRing, one commit group per tile (empty
  // past t1), so "tile t has landed" is cp.async.wait_group kRing − 2 once
  // the loads of tiles up to t + kRing − 2 are issued.
  auto load_tile = [&](int t) {
    if (t < t1) {
      const uint32_t slot = (t - t0) % kRing * kTile;
      for_chunks(kBK, per_row, [&](int r, int c) {
        const int key = t * kBK + r;
        const int n = key < a.skv ? 16 : 0;
        const long long row = key < a.skv ? key : 0;
        const uint32_t off = slot + sw128(kBK, r, c);
        cp_async16(ks + off, kp + row * a.k_ss + c * 8, n);
        cp_async16(vs + off, vp + row * a.v_ss + c * 8, n);
      });
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) load_tile(t0 + i);  // tile t0 with Q

  // This thread's rows of S and acc: 16·warp + lane / 4 and 8 below it.
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) pos[h] = q0 + (16 * warp + lane / 4 + 8 * h) % a.pos + q_offset;
  // p = 2^(x·c − m·c) for x the logit before scaling (q·k, or with a softcap
  // softcap·tanh(scale·q·k / softcap)) and m the row's running max of x.
  const bool capped = a.softcap > 0.0f;
  const float c2 = capped ? kLog2e : a.scale * kLog2e;
  const float cap_in = capped ? a.scale / a.softcap : 0.0f;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[NJ][8][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][n][e] = 0.0f;

  for (int t = t0; t < t1; ++t) {
    load_tile(t + kRing - 1);
    cp_async_wait<kRing - 1>();  // tile t
    fence_proxy_async();  // this thread's copies, seen by wgmma's reads
    __syncthreads();
    const uint32_t kt = ks + (t - t0) % kRing * kTile, vt = vs + (t - t0) % kRing * kTile;

    // S[64 × 64] = Q·K(t)ᵀ; warp w holds rows 16w..16w+15, entry (n, e) at
    // row e / 2, key 8n + 2·(lane % 4) + e % 2 of the tile.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk / 4) * kBK * 128 + (kk % 4) * 32;  // Q and K: 64 rows a block
      wgmma_ss(s, sw128_desc(qs + off, 0), sw128_desc(kt + off, 0));
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(s);

    // Softcap and mask: uniform branches around whole loops (a select inside
    // one would evaluate tanhf for every logit).
    if (capped) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = a.softcap * tanhf(s[n][e] * cap_in);
    }
    const int k0 = t * kBK;
    bool edge = k0 + kBK > a.skv;
    if (a.causal) edge = edge || k0 + kBK - 1 > pos_lo;
    if (a.has_window) edge = edge || k0 <= pos_hi - a.window;
    uint32_t live = 0xffffffffu;
    if (edge) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
          const int p = pos[e >> 1];
          bool ok = key < a.skv;
          if (a.causal) ok = ok && key <= p;
          if (a.has_window) ok = ok && key > p - a.window;
          if (!ok) {
            live &= ~(1u << (n * 4 + e));
            s[n][e] = kNegInf;
          }
        }
    }
    // Online softmax per row, in f32 (the TPU kernel's rules, base 2), with
    // tree reductions over the thread's 16 entries of a row.
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) v[n] = fmaxf(s[n][2 * h], s[n][2 * h + 1]);
#pragma unroll
      for (int w = 4; w > 0; w /= 2)
#pragma unroll
        for (int n = 0; n < w; ++n) v[n] = fmaxf(v[n], v[n + w]);
      const float m_new = fmaxf(m[h], quad_max(v[0]));
      const float mc = m_new * c2;
      // The difference first: with both maxima at -1e30 it is exactly 0,
      // where m·c2 − mc (contracted to an FMA) leaves the product's rounding.
      corr[h] = exp2_approx((m[h] - m_new) * c2);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * h + j;
          const float p = exp2_approx(fmaf(s[n][e], c2, -mc));  // masked: dropped below
          s[n][e] = (live >> (n * 4 + e)) & 1u ? p : 0.0f;
        }
        v[n] = s[n][2 * h] + s[n][2 * h + 1];
      }
#pragma unroll
      for (int w = 4; w > 0; w /= 2)
#pragma unroll
        for (int n = 0; n < w; ++n) v[n] += v[n + w];
      l[h] = l[h] * corr[h] + quad_sum(v[0]);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][n][e] *= corr[e >> 1];

    // acc += P·V(t): P rounded to bf16 (keys 16kk..16kk+15 of S's fragments
    // are the A fragment of k step kk), V transposed by descriptor.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        wgmma_rs(acc[j], pa[kk], sw128_desc(vt + j * kBK * 128 + kk * 2048, kBK * 128));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NJ; ++j) pin(acc[j]);
    pin(pa);
    __syncthreads();  // slot (t − t0) % kRing is refilled next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
    const int g = r / a.pos, pi = r % a.pos, head = hg * a.heads + g;
    if (g >= a.heads || head >= a.rep || q0 + pi >= a.sq) continue;
    const float inv = 1.0f / fmaxf(l[h], 1e-30f);
    bf16* out = a.o + b * a.o_sb + (hk * a.rep + head) * a.o_sh + (q0 + pi) * a.o_ss;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = j * 64 + n * 8 + 2 * (lane & 3);
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(acc[j][n][2 * h] * inv, acc[j][n][2 * h + 1] * inv);
      }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(Args a) {
  attend_wgmma<DP>(a);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(Args a) {
  attend_decode<DP>(a);
}

// One CTA per (b, kv-head, row): out = Σ_p 2^{m_p − M} acc_p /
// max(Σ_p 2^{m_p − M} l_p, 1e-30), M = max_p m_p, over the row's nparts
// partials (m in log2 units).
__global__ void __launch_bounds__(kThreads) flash_combine_kernel(Args a, int nparts) {
  const int b = blockIdx.x / a.hkv, hk = blockIdx.x % a.hkv, r = blockIdx.y;
  const int rows = a.rep * a.sq, d = a.d;
  const float* ml = a.ws_ml + ((long long)blockIdx.x * nparts * rows + r) * 2;
  const float* acc = a.ws_acc + ((long long)blockIdx.x * nparts * rows + r) * d;
  float mx = kNegInf;
  for (int p = 0; p < nparts; ++p) mx = fmaxf(mx, ml[p * rows * 2]);
  const int g = r / a.sq, pi = r % a.sq;
  bf16* out = a.o + b * a.o_sb + (hk * a.rep + g) * a.o_sh + pi * a.o_ss;
  for (int col = threadIdx.x; col < d; col += kThreads) {
    float lsum = 0.0f, sum = 0.0f;
#pragma unroll 4
    for (int p = 0; p < nparts; ++p) {
      const float w = exp2_approx(ml[p * rows * 2] - mx);
      lsum += w * ml[p * rows * 2 + 1];
      sum += w * acc[(long long)p * rows * d + col];
    }
    out[col] = __float2bfloat16(sum / fmaxf(lsum, 1e-30f));
  }
}

template <int DP, bool DECODE>
int launch(const Args& a, dim3 grid, cudaStream_t stream) {
  const size_t bytes = smem_bytes<DP, DECODE>();
  void (*kernel)(Args);
  if constexpr (DECODE) kernel = flash_decode_kernel<DP>;
  else kernel = flash_prefill_kernel<DP>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return int(cudaGetLastError());
}

// DP: D rounded up to a multiple of 64 (prefill) or to the next of 16, 32,
// 64, 96, 112, 128, 256 (decode).
template <bool DECODE>
int launch_dp(const Args& a, dim3 grid, cudaStream_t stream) {
  if constexpr (!DECODE) {
    if (a.d <= 64) return launch<64, false>(a, grid, stream);
    if (a.d <= 128) return launch<128, false>(a, grid, stream);
    if (a.d <= 192) return launch<192, false>(a, grid, stream);
    return launch<256, false>(a, grid, stream);
  } else {
    if (a.d <= 16) return launch<16, true>(a, grid, stream);
    if (a.d <= 32) return launch<32, true>(a, grid, stream);
    if (a.d <= 64) return launch<64, true>(a, grid, stream);
    if (a.d <= 96) return launch<96, true>(a, grid, stream);
    if (a.d <= 112) return launch<112, true>(a, grid, stream);
    if (a.d <= 128) return launch<128, true>(a, grid, stream);
    return launch<256, true>(a, grid, stream);
  }
}

}  // namespace tc

}  // namespace

// Strides are in elements, for [B, H, S, D] (the last dimension contiguous);
// the wrapper checks shapes, dtypes, D (a multiple of 8, at most 256) and
// 16-byte alignment, and never launches an empty grid.  form: 0 = f32,
// 1 = bf16 prefill, 2 = bf16 decode over `splits` CTAs of `tiles_per_split`
// key tiles each, with ws an f32 workspace of B·Hkv·4·splits·R·(D + 2)
// floats (R = Hq / Hkv · Sq <= 16); the decode form launches the combine
// kernel after the split kernel.  q_offset_ptr, when not null, points to an
// int32 on the device that every form reads in place of q_offset; the
// wrapper then sizes the decode form's splits from the cache, not the offset.
extern "C" int blaze_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int batch, int hq, int hkv, int sq, int skv, int d,
    int causal, int has_window, int window, int q_offset, const void* q_offset_ptr,
    float scale, float softcap, int form, int splits, int tiles_per_split,
    void* ws, void* stream) {
  const int* off_ptr = static_cast<const int*>(q_offset_ptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    Args a{q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, hq, hkv, sq, skv, d, causal, has_window, window,
           q_offset, off_ptr, scale, softcap};
    return launch_t<float>(a, batch, s);
  }
  const int rep = hq / hkv;
  tc::Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
             static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
             q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
             hkv, sq, skv, d, causal, has_window, window, q_offset, off_ptr, scale,
             softcap, rep, 0, 0, 1, tiles_per_split, nullptr, nullptr};
  if (form == 1) {
    a.heads = rep < 4 ? rep : 4;
    a.pos = tc::kPrefillRows / a.heads;
    a.groups = (rep + a.heads - 1) / a.heads;
    const dim3 grid((sq + a.pos - 1) / a.pos, hkv * a.groups, batch);
    return tc::launch_dp<false>(a, grid, s);
  }
  if (form != 2 || rep * sq > tc::kDecodeRows || splits < 1)
    return int(cudaErrorInvalidValue);
  const int nparts = splits * tc::kWarps;
  a.ws_ml = static_cast<float*>(ws);
  a.ws_acc = a.ws_ml + size_t(batch) * hkv * nparts * rep * sq * 2;
  const int err = tc::launch_dp<true>(a, dim3(splits, hkv, batch), s);
  if (err != 0) return err;
  tc::flash_combine_kernel<<<dim3(batch * hkv, rep * sq), tc::kThreads, 0, s>>>(a, nparts);
  return int(cudaGetLastError());
}
