// Flash attention (online softmax) on Hopper.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel), which walked a (b, h, q-tile, kv-tile) grid in order
// on one core and carried the running (m, l, acc) of a q-tile across the
// kv-tile axis in VMEM scratch.  Here one CTA owns one (b, h, q-tile) and
// walks its kv-tiles in a loop, so the running state lives in registers for
// the CTA's whole life and nothing crosses CTAs.
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
// Tiles: 256 threads as 16 (keys / head dims) × 16 (rows).  A thread holds
// RI query rows (ty + 16·r) × 4 keys (tx + 16·c) of the logits tile and RI
// rows × NCH head dims (tx + 16·n) of the accumulator; RI = 4 (64-row
// q-tiles) for prefill, RI = 1 (16 rows) when Sq <= 16, for decode.  Each
// kv-tile is 64 keys.  Q, K and V tiles are staged in shared memory as f32
// (16-byte loads from device memory; rows of Q and K padded to D + 1 floats
// so the dot products read without bank conflicts), the probabilities go
// through shared memory from the 16 lanes that own a row to the same lanes.
// The products run on the CUDA cores in f32 (no tensor cores yet): at
// Sq = Skv = 512, D = 128 the function does ~250 flops per byte moved, so a
// fast version is bound by the tensor-core rate, and this one by shared-memory
// reads and f32 FMAs.  wgmma, TMA and split-KV decode are later work.
//
// Tiles the mask rules out are never read: a causal q-tile stops at the last
// key its last row sees (so a decode step over a [B, S_max, Hkv, D] cache
// costs O(position), not O(S_max)), and a window starts at the first key
// its first row sees.  The inputs are read through their strides, so the
// KV cache's [B, S, H, D] layout is read in place; q_offset is a run-time
// argument.  D is any multiple of 8 up to 256; shared memory is sized from
// D at launch (217,600 bytes at D = 256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;
constexpr int kBK = 64;           // keys per kv-tile
constexpr int kRJ = kBK / kTX;    // keys per thread in a tile
constexpr int kLdp = kBK + 16;    // row stride of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int hq, hkv, sq, skv, d;
  int causal, has_window, window, q_offset;
  float scale, softcap;
};

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
  const int q_first = q0 + a.q_offset;
  const int q_last = min(q0 + BQ, a.sq) - 1 + a.q_offset;
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
      const int pos = a.q_offset + qi;
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

}  // namespace

// Strides are in elements, for [B, H, S, D] (the last dimension contiguous);
// the wrapper checks shapes, dtypes, D (a multiple of 8, at most 256) and
// 16-byte alignment, and never launches an empty grid.
extern "C" int blaze_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int batch, int hq, int hkv, int sq, int skv, int d,
    int causal, int has_window, int window, int q_offset,
    float scale, float softcap, int is_bf16, void* stream) {
  Args a{q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
         o_sb, o_sh, o_ss, hq, hkv, sq, skv, d, causal, has_window, window,
         q_offset, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_t<__nv_bfloat16>(a, batch, s) : launch_t<float>(a, batch, s);
}
