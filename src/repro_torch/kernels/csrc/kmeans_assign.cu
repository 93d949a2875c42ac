// Fused k-means assignment + per-centre statistics on Hopper.
//
// Replaces the TPU kernel repro/kernels/kmeans_assign.py::kmeans_assign
// (body _kmeans_kernel), which multiplied a tile of points by the centres on
// the MXU and accumulated [Σx | count] with a one-hot matmul into a VMEM
// tile carried across its sequential grid.  At the paper's shape (D = 3,
// K = 5) the function does 2·N·K·D flops on N·D·4 bytes, 2.5 flops a byte,
// far under the card's f32 ridge, so it is bound by reading the points and
// writing the assignments; the tensor cores have nothing to do and the
// one-hot product has no reason to exist.
//
// * distance: d² = ‖c‖² − 2·Σ_j x_j c_j, ‖x‖² dropped (it does not move the
//   argmin), FMAs in f32 in the order j = 0..D−1, the same in every form.
//   The running minimum keeps a strict <, so the first index wins ties, and
//   a NaN distance wins over any number, so the first NaN wins as in
//   jnp.argmin and torch.argmin.
// * stream form, for K <= 8 and D <= 4 (the paper's shape), K and D fixed at
//   compile time (one instance each, picked by the C entry):
//   - One persistent CTA an SM (the wrapper's STREAM_CTAS_PER_SM) of 8
//     consumer warps and one producer warp, launched cooperatively.  The
//     points, cut into tiles of kTile = 1024 points after a head of at most
//     3 points, go to the CTAs round robin (tile j to CTA j mod G).  The
//     producer's lane 0 streams a CTA's tiles through a ring of stages in
//     shared memory (~96 KB) with 1-D bulk copies (tma_bulk.cuh): 8 stages
//     of 12 KB at D = 3, so ~12 MB of reads are in flight on the card
//     where one synchronous load per thread kept ~1.2 MB.
//   - A bulk copy needs a 16-byte-aligned source.  The head (the wrapper's
//     stream_layout) is the fewest points after which a point starts on 16
//     bytes; where none does (D = 2 or 4 and an odd start) each tile is
//     copied from the 16 bytes below its first point, 16 bytes longer, and
//     read `shift` floats in.  The head and the tail shorter than a tile
//     (or, shifted, than a tile and 16 bytes) are read with plain loads by
//     the CTA that the next tile would go to, after its tiles.
//   - Consumer thread t takes points 4t..4t+3 of a tile: D 16-byte shared
//     loads at a 16·D-byte stride (conflict-free for odd D), four
//     assignments stored as one int4 where their address is 16-byte
//     aligned, else one by one.  Centres and norms sit in registers, and
//     each thread's [K, D+1] sums in K·(D+1) registers, with every loop
//     unrolled and no guard.
//   - The sums merge in a fixed order: a shuffle tree in each warp (lane 0's
//     5 levels), the 8 warps in warp order, each CTA's partial to a scratch
//     row, and after a grid barrier CTA 0 adds the rows in CTA order and
//     writes the output.  No atomics: two calls on one input give the same
//     bits, and nothing needs zeroing first.
// * shared form, for larger K·D that fits the 48 KiB a launch takes without
//   opting in: centres, their norms and a [K, D+1] accumulator live in
//   shared memory; each point folds [x | 1] into it with D+1 atomics, and the
//   CTA merges its copy into the output with one atomic per non-zero cell
//   (K1's shared form).
// * global form, when that does not fit either: centres are read through the
//   cache, each norm is recomputed per point in the same order, and each
//   point folds straight into the output (K1's global form; with many
//   centres the atomics spread over many cells).
// Partial sums stay small in every form, so f32 keeps the sums of 10^8
// points accurate.  The wrapper zeroes the output of the two atomic forms
// and never launches an empty grid.
#include <cooperative_groups.h>

#include "blaze_fold.cuh"
#include "coop_launch.cuh"
#include "tma_bulk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

enum Form { FORM_STREAM = 0, FORM_SHARED = 1, FORM_GLOBAL = 2 };

__device__ __forceinline__ float norm2(const float* c, int d) {
  float s = 0.0f;
  for (int j = 0; j < d; ++j) s = fmaf(c[j], c[j], s);
  return s;
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

// --- stream form -------------------------------------------------------------

constexpr int kStreamWarps = 8;                          // the wrapper's STREAM_WARPS
constexpr int kConsumers = 32 * kStreamWarps;            // consumer threads a CTA
constexpr int kStreamThreads = kConsumers + 32;          // and one producer warp
constexpr int kTile = 4 * kConsumers;                    // points a tile: the wrapper's TILE
constexpr int kRingBytes = 96 * 1024;

template <int D>
struct Ring {
  static constexpr int kTileBytes = kTile * D * 4;
  static constexpr int kStride = kTile * D + 4;  // floats a stage: a tile and a shift's 16 bytes
  static constexpr int kStages = kRingBytes / kTileBytes < 8 ? kRingBytes / kTileBytes : 8;
  static constexpr int kBytes = kStages * kStride * 4;
};

struct StreamArgs {
  const float* pts;     // [n, D]
  const char* tiles;    // the first tile's first copied byte, 16-byte aligned
  const float* ctr;     // [K, D]
  int* assign;          // [n]
  float* stats;         // [K, D+1], written by CTA 0
  float* partial;       // [gridDim.x, K·(D+1)] scratch, each row written by its CTA
  long long n;
  long long tiles_n;    // full tiles
  int head;             // points before the first tile
  int shift;            // floats between a tile's copied start and its first point
  int vec_store;        // 1: a thread's four assignments start 16-byte aligned
};

template <int D, int K>
__device__ __forceinline__ int nearest(const float (&x)[D], const float (&c)[K][D],
                                       const float (&cn)[K]) {
  int best = 0;
  float best_d2 = 0.0f;
#pragma unroll
  for (int m = 0; m < K; ++m) {
    float dot = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) dot = fmaf(x[j], c[m][j], dot);
    keep_nearest(cn[m] - 2.0f * dot, m, best, best_d2);
  }
  return best;
}

template <int D, int K>
__device__ __forceinline__ void fold_point(float (&acc)[K][D + 1], const float (&x)[D], int best) {
#pragma unroll
  for (int m = 0; m < K; ++m) {
    if (m == best) {
#pragma unroll
      for (int j = 0; j < D; ++j) acc[m][j] += x[j];
      acc[m][D] += 1.0f;
    }
  }
}

__device__ __forceinline__ void store4(const StreamArgs& a, long long i0, const int (&b)[4]) {
  if (a.vec_store) {
    *reinterpret_cast<int4*>(a.assign + i0) = make_int4(b[0], b[1], b[2], b[3]);
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) a.assign[i0 + p] = b[p];
  }
}

template <int D, int K>
__global__ void __launch_bounds__(kStreamThreads, 1) kmeans_assign_stream(const StreamArgs a) {
  using R = Ring<D>;
  constexpr int kCells = K * (D + 1);
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[R::kStages];
  __shared__ __align__(8) uint64_t empty[R::kStages];
  __shared__ float red[kStreamWarps][kCells];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long grid = gridDim.x;
  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kStreamWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  float acc[K][D + 1];
#pragma unroll
  for (int m = 0; m < K; ++m) {
#pragma unroll
    for (int j = 0; j <= D; ++j) acc[m][j] = 0.0f;
  }
  if (warp == kStreamWarps) {
    // Producer: lane 0 keeps the ring full.
    if (lane == 0) {
      const uint32_t bytes = R::kTileBytes + (a.shift ? 16 : 0);
      int s = 0;
      uint32_t phase = 0;
      long long it = 0;
      for (long long tile = blockIdx.x; tile < a.tiles_n; tile += grid, ++it) {
        if (it >= R::kStages) mbar_wait(&empty[s], phase ^ 1);
        mbar_arrive_expect_tx(&full[s], bytes);
        bulk_copy_g2s(ring + s * R::kStride, a.tiles + tile * R::kTileBytes, bytes, &full[s]);
        if (++s == R::kStages) s = 0, phase ^= 1;
      }
    }
  } else {
    float c[K][D], cn[K];
#pragma unroll
    for (int m = 0; m < K; ++m) {
      cn[m] = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        c[m][j] = __ldg(a.ctr + m * D + j);
        cn[m] = fmaf(c[m][j], c[m][j], cn[m]);
      }
    }
    int s = 0;
    uint32_t phase = 0;
    for (long long tile = blockIdx.x; tile < a.tiles_n; tile += grid) {
      mbar_wait(&full[s], phase);
      const float* st = ring + s * R::kStride + a.shift + 4 * D * tid;
      float x[4][D];
      if (a.shift == 0) {
        float f[4 * D];
#pragma unroll
        for (int q = 0; q < D; ++q) {
          const float4 v = reinterpret_cast<const float4*>(st)[q];
          f[4 * q] = v.x, f[4 * q + 1] = v.y, f[4 * q + 2] = v.z, f[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
#pragma unroll
          for (int j = 0; j < D; ++j) x[p][j] = f[p * D + j];
        }
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
#pragma unroll
          for (int j = 0; j < D; ++j) x[p][j] = st[p * D + j];
        }
      }
      int b[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        b[p] = nearest<D, K>(x[p], c, cn);
        fold_point<D, K>(acc, x[p], b[p]);
      }
      store4(a, a.head + tile * kTile + 4 * tid, b);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // the warp is done with the stage
      if (++s == R::kStages) s = 0, phase ^= 1;
    }
    // The head and the tail, by the CTA the next tile would go to.
    if (blockIdx.x == a.tiles_n % grid) {
      const long long extra = a.n - a.tiles_n * kTile;
      for (long long q = tid; q < extra; q += kConsumers) {
        const long long i = q < a.head ? q : q + a.tiles_n * kTile;
        float x[D];
#pragma unroll
        for (int j = 0; j < D; ++j) x[j] = a.pts[i * D + j];
        const int best = nearest<D, K>(x, c, cn);
        fold_point<D, K>(acc, x, best);
        a.assign[i] = best;
      }
    }
  }

  // Fixed-order merge: lane 0's shuffle tree, the warps in order, the CTAs
  // in order.
  if (warp < kStreamWarps) {
#pragma unroll
    for (int m = 0; m < K; ++m) {
#pragma unroll
      for (int j = 0; j <= D; ++j) {
        float v = acc[m][j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
        if (lane == 0) red[warp][m * (D + 1) + j] = v;
      }
    }
  }
  __syncthreads();
  if (tid < kCells) {
    float v = red[0][tid];
#pragma unroll
    for (int w = 1; w < kStreamWarps; ++w) v += red[w][tid];
    a.partial[blockIdx.x * kCells + tid] = v;
  }
  cg::this_grid().sync();
  if (blockIdx.x == 0) {
    // Every copy has landed (the consumers waited on each), so the ring is
    // free: stage the partials there, then add them in CTA order.
    for (long long e = tid; e < grid * kCells; e += kStreamThreads) ring[e] = __ldcg(a.partial + e);
    __syncthreads();
    if (tid < kCells) {
      float v = ring[tid];
      for (long long g = 1; g < grid; ++g) v += ring[g * kCells + tid];
      a.stats[tid] = v;
    }
  }
}

#define BLAZE_STREAM_ROW(D)                                                                  \
  {                                                                                          \
    (const void*)kmeans_assign_stream<D, 1>, (const void*)kmeans_assign_stream<D, 2>,        \
        (const void*)kmeans_assign_stream<D, 3>, (const void*)kmeans_assign_stream<D, 4>,    \
        (const void*)kmeans_assign_stream<D, 5>, (const void*)kmeans_assign_stream<D, 6>,    \
        (const void*)kmeans_assign_stream<D, 7>, (const void*)kmeans_assign_stream<D, 8>     \
  }

int launch_stream(StreamArgs& a, int d, int k, int blocks, cudaStream_t stream) {
  static const void* const kernels[4][8] = {BLAZE_STREAM_ROW(1), BLAZE_STREAM_ROW(2),
                                            BLAZE_STREAM_ROW(3), BLAZE_STREAM_ROW(4)};
  static const int ring_bytes[4] = {Ring<1>::kBytes, Ring<2>::kBytes, Ring<3>::kBytes,
                                    Ring<4>::kBytes};
  if (d < 1 || d > 4 || k < 1 || k > 8 || blocks < 1) return (int)cudaErrorInvalidValue;
  const int smem = ring_bytes[d - 1];
  // CTA 0 stages every CTA's partial in its ring.
  if ((long long)blocks * k * (d + 1) * 4 > smem) return (int)cudaErrorInvalidValue;
  if (a.tiles_n > 0) {
    // The copies: 16-byte aligned, and inside the points.
    const long long first = a.tiles - reinterpret_cast<const char*>(a.pts);
    const long long end = first + a.tiles_n * kTile * d * 4 + (a.shift ? 16 : 0);
    if (reinterpret_cast<uintptr_t>(a.tiles) % 16 != 0 || first < 0 || end > a.n * d * 4 ||
        a.head < 0 || a.head > 3 || a.shift < 0 || a.shift > 3)
      return (int)cudaErrorInvalidValue;
  }
  a.vec_store = reinterpret_cast<uintptr_t>(a.assign + a.head) % 16 == 0;
  const void* kernel = kernels[d - 1][k - 1];
  // Past 48 KB of shared memory a launch has to opt in, once per instance
  // and device.
  static bool opted[64][4][8] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev][d - 1][k - 1]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted[dev][d - 1][k - 1] = true;
  }
  void* args[] = {&a};
  return (int)launch_cooperative(kernel, dim3((unsigned)blocks), dim3(kStreamThreads),
                                 args, (size_t)smem, stream);
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

// pts [n, d] and ctr [k, d] f32, contiguous; assign [n] int32 and stats
// [k, d+1] f32 are written.  The stream form also takes its scratch
// ([blocks, k·(d+1)] f32) and its layout from the wrapper's stream_layout:
// `head` points before the first of `tiles` full tiles, copied from
// `head·d − shift` floats past pts; `threads` is then ignored (8 consumer
// warps and a producer warp).  The atomic forms add into a zeroed stats.
extern "C" int blaze_kmeans_assign(const void* pts, const void* ctr, void* assign,
                                   void* stats, void* scratch, long long n, int d, int k,
                                   int form, int blocks, int threads, int head, int shift,
                                   long long tiles, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pts);
  const float* c = static_cast<const float*>(ctr);
  int* a = static_cast<int*>(assign);
  float* out = static_cast<float*>(stats);
  if (form == FORM_STREAM) {
    StreamArgs args{p,
                    reinterpret_cast<const char*>(p) + ((long long)head * d - shift) * 4,
                    c,
                    a,
                    out,
                    static_cast<float*>(scratch),
                    n,
                    tiles,
                    head,
                    shift,
                    0};
    const int err = launch_stream(args, d, k, blocks, s);
    return err != 0 ? err : (int)cudaGetLastError();
  }
  if (form == FORM_SHARED) {
    const size_t smem = (size_t)k * (2 * d + 2) * sizeof(float);
    kmeans_assign_atomics<true><<<blocks, threads, smem, s>>>(p, c, a, out, n, d, k);
  } else if (form == FORM_GLOBAL) {
    kmeans_assign_atomics<false><<<blocks, threads, 0, s>>>(p, c, a, out, n, d, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
