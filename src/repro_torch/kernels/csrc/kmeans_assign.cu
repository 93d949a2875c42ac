// Fused k-means assignment + per-centre statistics on Hopper.
//
// Replaces the TPU kernel repro/kernels/kmeans_assign.py::kmeans_assign
// (body _kmeans_kernel), which multiplied a tile of points by the centres on
// the MXU and accumulated [Σx | count] with a one-hot matmul into a VMEM
// tile carried across its sequential grid.  At the paper's shape (D = 3,
// K = 5) the function does 2·N·K·D flops on N·D·4 bytes, 2.5 flops a byte,
// far under the card's f32 ridge, so it is bound by reading the points; the
// tensor cores have nothing to do and the one-hot product has no reason to
// exist.  One thread takes one point at a time, striding over the grid:
//
// * distance: d² = ‖c‖² − 2·Σ_j x_j c_j, ‖x‖² dropped (it does not move the
//   argmin), FMAs in f32 in the order j = 0..D−1, the same in every form.
//   The running minimum keeps a strict <, so the first index wins ties, and
//   a NaN distance wins over any number, so the first NaN wins as in
//   jnp.argmin and torch.argmin.
// * register form, for K <= kRegK and D <= kRegD (the paper's shape): each
//   thread keeps its own [K, D+1] sums in registers across all its points,
//   the way the TPU kernel carried its tile across the grid, so the loop
//   does no atomics at all.  At the end a warp sums each cell with
//   shuffles, one lane folds it into the CTA's shared copy, and the CTA
//   merges that into the output with one atomic per non-zero cell.
// * shared form, for larger K·D that fits the 48 KiB a launch takes without
//   opting in: centres, their norms and a [K, D+1] accumulator live in
//   shared memory; each point folds [x | 1] into it with D+1 atomics, and the
//   CTA merges as above (K1's shared form).
// * global form, when that does not fit either: centres are read through the
//   cache, each norm is recomputed per point in the same order, and each
//   point folds straight into the output (K1's global form; with many
//   centres the atomics spread over many cells).
// Partial sums stay small in every form, so f32 keeps the sums of 10^8
// points accurate.  The wrapper zeroes the output and never launches an
// empty grid.
#include "blaze_fold.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRegK = 8;  // the wrapper's REG_K
constexpr int kRegD = 4;  // the wrapper's REG_D

enum Form { FORM_REGISTERS = 0, FORM_SHARED = 1, FORM_GLOBAL = 2 };

__device__ __forceinline__ float norm2(const float* c, int d) {
  float s = 0.0f;
  for (int j = 0; j < d; ++j) s = fmaf(c[j], c[j], s);
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Copy the centres into shared memory, zero the accumulator, then fill the
// norms.
__device__ __forceinline__ void stage_centres(const float* ctr, float* sc, float* scn,
                                              float* sacc, int d, int k) {
  for (int t = threadIdx.x; t < k * d; t += blockDim.x) sc[t] = ctr[t];
  for (int t = threadIdx.x; t < k * (d + 1); t += blockDim.x) sacc[t] = 0.0f;
  __syncthreads();
  for (int t = threadIdx.x; t < k; t += blockDim.x) scn[t] = norm2(sc + t * d, d);
  __syncthreads();
}

// Merge the CTA's shared accumulator into the output.
__device__ __forceinline__ void merge_cta(const float* sacc, float* stats, int cells) {
  __syncthreads();
  for (int t = threadIdx.x; t < cells; t += blockDim.x) {
    const float v = sacc[t];
    // Adding zero changes nothing: skip the atomic.
    if (v != 0.0f) atomic_fold<OP_SUM>(stats + t, v);
  }
}

__device__ __forceinline__ void keep_nearest(float d2, int m, int& best, float& best_d2) {
  if (m == 0 || d2 < best_d2 || (isnan(d2) && !isnan(best_d2))) {
    best = m;
    best_d2 = d2;
  }
}

__global__ void __launch_bounds__(256, 3)
kmeans_assign_registers(const float* __restrict__ pts, const float* __restrict__ ctr,
                        int* __restrict__ assign, float* __restrict__ stats,
                        long long n, int d, int k) {
  __shared__ float sc[kRegK * kRegD];
  __shared__ float scn[kRegK];
  __shared__ float sacc[kRegK * (kRegD + 1)];
  stage_centres(ctr, sc, scn, sacc, d, k);
  float acc[kRegK][kRegD + 1];
#pragma unroll
  for (int m = 0; m < kRegK; ++m) {
#pragma unroll
    for (int j = 0; j <= kRegD; ++j) acc[m][j] = 0.0f;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float x[kRegD];
#pragma unroll
    for (int j = 0; j < kRegD; ++j) x[j] = j < d ? pts[i * d + j] : 0.0f;
    int best = 0;
    float best_d2 = 0.0f;
#pragma unroll
    for (int m = 0; m < kRegK; ++m) {
      if (m < k) {
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < kRegD; ++j) {
          if (j < d) dot = fmaf(x[j], sc[m * d + j], dot);
        }
        keep_nearest(scn[m] - 2.0f * dot, m, best, best_d2);
      }
    }
    assign[i] = best;
#pragma unroll
    for (int m = 0; m < kRegK; ++m) {
      if (m == best) {
#pragma unroll
        for (int j = 0; j < kRegD; ++j) acc[m][j] += x[j];  // x[j] = 0 past d
        acc[m][kRegD] += 1.0f;
      }
    }
  }
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < kRegK; ++m) {
    if (m >= k) continue;  // k is the same for every lane
#pragma unroll
    for (int j = 0; j <= kRegD; ++j) {
      if (j >= d && j < kRegD) continue;
      const float v = warp_sum(acc[m][j]);
      if (lane == 0) atomic_fold<OP_SUM>(sacc + m * (d + 1) + (j == kRegD ? d : j), v);
    }
  }
  merge_cta(sacc, stats, k * (d + 1));
}

template <bool SHARED>
__global__ void kmeans_assign_atomics(const float* __restrict__ pts,
                                      const float* __restrict__ ctr,
                                      int* __restrict__ assign,
                                      float* __restrict__ stats, long long n,
                                      int d, int k) {
  extern __shared__ float smem[];
  const int w = d + 1;
  const float* c = ctr;
  const float* cn = nullptr;
  float* acc = stats;
  if (SHARED) {
    float* sc = smem;
    float* scn = sc + k * d;
    acc = scn + k;
    stage_centres(ctr, sc, scn, acc, d, k);
    c = sc;
    cn = scn;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float* x = pts + i * d;
    int best = 0;
    float best_d2 = 0.0f;
    for (int m = 0; m < k; ++m) {
      const float* cm = c + (long long)m * d;
      float dot = 0.0f;
      for (int j = 0; j < d; ++j) dot = fmaf(x[j], cm[j], dot);
      keep_nearest((SHARED ? cn[m] : norm2(cm, d)) - 2.0f * dot, m, best, best_d2);
    }
    assign[i] = best;
    float* row = acc + (long long)best * w;
    for (int j = 0; j < d; ++j) atomic_fold<OP_SUM>(row + j, x[j]);
    atomic_fold<OP_SUM>(row + d, 1.0f);
  }
  if (SHARED) merge_cta(acc, stats, k * w);
}

}  // namespace

extern "C" int blaze_kmeans_assign(const void* pts, const void* ctr, void* assign,
                                   void* stats, long long n, int d, int k, int form,
                                   int blocks, int threads, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pts);
  const float* c = static_cast<const float*>(ctr);
  int* a = static_cast<int*>(assign);
  float* out = static_cast<float*>(stats);
  if (form == FORM_REGISTERS) {
    if (k > kRegK || d > kRegD || threads > 256) return (int)cudaErrorInvalidValue;
    kmeans_assign_registers<<<blocks, threads, 0, s>>>(p, c, a, out, n, d, k);
  } else if (form == FORM_SHARED) {
    const size_t smem = (size_t)k * (2 * d + 2) * sizeof(float);
    kmeans_assign_atomics<true><<<blocks, threads, smem, s>>>(p, c, a, out, n, d, k);
  } else if (form == FORM_GLOBAL) {
    kmeans_assign_atomics<false><<<blocks, threads, 0, s>>>(p, c, a, out, n, d, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
