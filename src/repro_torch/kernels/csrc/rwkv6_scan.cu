// RWKV-6 wkv scan (rwkv6's time-mix recurrence) on Hopper.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_scan (body
// _rwkv6_kernel), which walked a (b·h, chunk) grid in order on one core and
// carried the [K, V] state across the chunk axis in VMEM scratch.  Here one
// CTA owns one (b, h) and walks its chunks in a loop, so the f32 state stays
// in shared memory for the CTA's whole life and nothing crosses CTAs.
//
// What it computes, per chunk of up to 64 steps, with the decay floored as
// the reference floors it (log w ≥ floor = −88 / min(chunk, S), passed by
// the wrapper) and λ_l = Σ_{r≤l} log w_r inside the chunk, per channel k:
//   out_l = (r_l ∘ e^{λ_{l−1}})·S + Σ_{s<l} ((r_l ∘ e^{λ_{l−1}})·(k_s ∘ e^{−λ_s}))·v_s
//           + (Σ_k r_l u k_l)·v_l;
//   S'    = e^{λ_last} ∘ S + Σ_s (k_s ∘ e^{λ_last − λ_s}) ⊗ v_s,
// all in f32, the decomposition of the reference's ops.rwkv6_chunked.  The
// intra-chunk scores use the factored e^{λ_{l−1}}·e^{−λ_s}; the floor keeps
// them finite: the wrapper's tile, min(64, L) with the reference's L =
// min(chunk, S), keeps |λ| ≤ 88 inside a chunk, and e^{88} < 3.4e38.
// Steps past the end are zeros with w = 1.
//
// Unlike the TPU kernel it takes an initial state (read at chunk 0) and
// writes the final one to a buffer that may be the same, so a serving cache
// is updated in place (each CTA reads its whole state before it writes it).
// Decode is S = 1: the loops over rows stop at the one live row.
//
// What bounds it on this card: at rwkv6's prefill (r, k, v [8, 512, 32, 64]
// bf16, w f32) the four 64 × 64 × 64 products of a chunk do ~1 MFLOP per
// (b, h, chunk) against ~105 MB of inputs and outputs a layer (0.031 ms at
// 3.35 TB/s); this first form runs them on the CUDA cores in f32, bound by
// shared-memory reads and FMAs.  Design: 256 threads as 16 × 16, each owning
// a 4 × 4 tile of every 64 × 64 product; r, k (raw and twice decayed), v, λ
// (reused for the scores) and the state sit in shared memory as f32 with
// rows padded to 65 floats (no bank conflicts).  100,864 bytes of shared
// memory (opted in above 48 KB), two CTAs an SM.  Only 8 × 32 = 256 CTAs at
// rwkv6's shapes; splitting V across CTAs, tensor cores and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 16;
constexpr int kThreads = kT * kT;
constexpr int kL = 64;        // steps per chunk
constexpr int kD = 64;        // largest K and V
constexpr int kLd = kD + 1;   // padded row stride
constexpr int kR = kD / kT;   // rows (and columns) of a thread's tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
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
};

constexpr size_t kSmemBytes = sizeof(float) * (6 * kL * kLd + 4 * kD);

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) rwkv6_kernel(Args a) {
  extern __shared__ float smem[];
  float* rs = smem;              // [kL][kLd]  r, then r ∘ e^{λ_{l−1}}
  float* kd = rs + kL * kLd;     // [kL][kLd]  k ∘ e^{−λ}
  float* ku = kd + kL * kLd;     // [kL][kLd]  k, then k ∘ e^{λ_last − λ}
  float* lm = ku + kL * kLd;     // [kL][kLd]  log w, then λ, then the scores [l][s]
  float* vs = lm + kL * kLd;     // [kL][kLd]  v
  float* st = vs + kL * kLd;     // [kD][kLd]  state [K][V]
  float* diag = st + kD * kLd;   // [kL]  Σ_k r u k
  float* lamt = diag + kL;       // [kD]  λ_last
  float* dect = lamt + kD;       // [kD]  e^{λ_last}
  float* us = dect + kD;         // [kD]  u

  const int bi = blockIdx.x / a.h;
  const int hi = blockIdx.x % a.h;
  const int tid = threadIdx.x;
  const int tx = tid % kT, ty = tid / kT;
  const T* rp = static_cast<const T*>(a.r) + bi * a.r_sb + hi * a.r_sh;
  const T* kp = static_cast<const T*>(a.k) + bi * a.k_sb + hi * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + bi * a.v_sb + hi * a.v_sh;
  const float* wp = a.w + bi * a.w_sb + hi * a.w_sh;
  T* yp = static_cast<T*>(a.y) + bi * a.y_sb + hi * a.y_sh;
  const size_t state_off = size_t(blockIdx.x) * a.kd * a.vd;

  for (int t = tid; t < kD * kD; t += kThreads) {
    const int row = t / kD, col = t % kD;
    st[row * kLd + col] = (a.s0 != nullptr && row < a.kd && col < a.vd)
                              ? a.s0[state_off + row * a.vd + col] : 0.0f;
  }
  for (int i = tid; i < kD; i += kThreads) us[i] = i < a.kd ? a.u[hi * a.kd + i] : 0.0f;

  for (int c0 = 0; c0 < a.s; c0 += a.tile) {
    const int lc = min(a.tile, a.s - c0);  // live rows of this chunk
    __syncthreads();  // the last chunk's readers are done
    for (int t = tid; t < kL * kD; t += kThreads) {
      const int l = t / kD, col = t % kD;
      const long long step = c0 + l;
      const bool live = l < lc;
      const bool kc = live && col < a.kd;
      rs[l * kLd + col] = kc ? to_f32(rp[step * a.r_ss + col]) : 0.0f;
      ku[l * kLd + col] = kc ? to_f32(kp[step * a.k_ss + col]) : 0.0f;
      vs[l * kLd + col] = live && col < a.vd ? to_f32(vp[step * a.v_ss + col]) : 0.0f;
      lm[l * kLd + col] =
          kc ? fmaxf(logf(fmaxf(wp[step * a.w_ss + col], 1e-30f)), a.floor) : 0.0f;
    }
    __syncthreads();
    if (tid < kD) {  // λ: a running sum down each channel's column
      float run = 0.0f;
      for (int l = 0; l < kL; ++l) {
        run += lm[l * kLd + tid];
        lm[l * kLd + tid] = run;
      }
      lamt[tid] = run;
      dect[tid] = expf(run);
    } else if (tid < kD + kL) {  // the bonus u of each row's own token
      const int l = tid - kD;
      float acc = 0.0f;
      for (int k = 0; k < kD; ++k) acc = fmaf(rs[l * kLd + k] * us[k], ku[l * kLd + k], acc);
      diag[l] = acc;
    }
    __syncthreads();
    for (int t = tid; t < kL * kD; t += kThreads) {
      const int l = t / kD, col = t % kD;
      const float lam = lm[l * kLd + col];
      const float lam_prev = l > 0 ? lm[(l - 1) * kLd + col] : 0.0f;
      const float kraw = ku[l * kLd + col];
      rs[l * kLd + col] *= expf(lam_prev);
      kd[l * kLd + col] = kraw * expf(-lam);
      ku[l * kLd + col] = kraw * expf(lamt[col] - lam);
    }
    __syncthreads();

    // Scores [l][s] = (r_l ∘ e^{λ_{l−1}})·(k_s ∘ e^{−λ_s}) for s < l, into lm.
    if (ty < lc) {
      float acc[kR][kR] = {};
      for (int k = 0; k < kD; ++k) {
        float rv[kR], kv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) rv[i] = rs[(ty + kT * i) * kLd + k];
#pragma unroll
        for (int j = 0; j < kR; ++j) kv[j] = kd[(tx + kT * j) * kLd + k];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(rv[i], kv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int l = ty + kT * i;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int s = tx + kT * j;
          lm[l * kLd + s] = s < l ? acc[i][j] : 0.0f;
        }
      }
    }
    __syncthreads();

    // out = (r ∘ e^{λ_{l−1}})·S + scores·v + diag ∘ v  (rows l, columns v).
    if (ty < lc) {
      float acc[kR][kR] = {};
      for (int k = 0; k < kD; ++k) {
        float rv[kR], sv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) rv[i] = rs[(ty + kT * i) * kLd + k];
#pragma unroll
        for (int j = 0; j < kR; ++j) sv[j] = st[k * kLd + tx + kT * j];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(rv[i], sv[j], acc[i][j]);
      }
      for (int s = 0; s < lc; ++s) {
        float pv[kR], vv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) pv[i] = lm[(ty + kT * i) * kLd + s];
#pragma unroll
        for (int j = 0; j < kR; ++j) vv[j] = vs[s * kLd + tx + kT * j];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int l = ty + kT * i;
        if (l >= lc) continue;
        const float dg = diag[l];
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int col = tx + kT * j;
          if (col < a.vd)
            yp[(c0 + l) * a.y_ss + col] = from_f32<T>(fmaf(dg, vs[l * kLd + col], acc[i][j]));
        }
      }
    }

    // S' = e^{λ_last} ∘ S + Σ_s (k_s ∘ e^{λ_last − λ_s}) ⊗ v_s  (rows k, columns v).
    float sn[kR][kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float e = dect[ty + kT * i];
#pragma unroll
      for (int j = 0; j < kR; ++j) sn[i][j] = st[(ty + kT * i) * kLd + tx + kT * j] * e;
    }
    for (int s = 0; s < lc; ++s) {
      float kv[kR], vv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) kv[i] = ku[s * kLd + ty + kT * i];
#pragma unroll
      for (int j = 0; j < kR; ++j) vv[j] = vs[s * kLd + tx + kT * j];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) sn[i][j] = fmaf(kv[i], vv[j], sn[i][j]);
    }
    __syncthreads();  // every reader of the old state is done
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) st[(ty + kT * i) * kLd + tx + kT * j] = sn[i][j];
  }
  __syncthreads();
  for (int t = tid; t < a.kd * a.vd; t += kThreads) {
    const int row = t / a.vd, col = t % a.vd;
    a.sT[state_off + t] = st[row * kLd + col];
  }
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  // Above 48 KB a launch must opt in, per function and device.
  const cudaError_t err = cudaFuncSetAttribute(
      rwkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
  if (err != cudaSuccess) return int(err);
  rwkv6_kernel<T><<<batch * a.h, kThreads, kSmemBytes, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// Strides are in elements, by (batch, seq, head), for r, k, w [B, S, H, K],
// v and y [B, S, H, V], the last dimension contiguous; u is contiguous
// [H, K] f32; s0 (or null) and sT are contiguous [B, H, K, V] f32 and may be
// the same buffer.  The wrapper checks shapes, dtypes and K, V <= 64, and
// never launches an empty grid or S = 0.  tile (1 to 64) is the chunk length,
// at most the L of the floor −88 / L.
extern "C" int blaze_rwkv6_scan(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* s0, void* y, void* sT,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh,
    long long y_sb, long long y_ss, long long y_sh,
    int batch, int s, int h, int kdim, int vdim, int tile, float floor, int is_bf16,
    void* stream) {
  Args args{r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),
            static_cast<const float*>(s0), y, static_cast<float*>(sT),
            r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh,
            y_sb, y_ss, y_sh, s, h, kdim, vdim, tile, floor};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(args, batch, st) : launch<float>(args, batch, st);
}
