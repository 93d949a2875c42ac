// Dense reduce-by-key on Hopper: (id, value-row) pairs -> [K, V] accumulator.
//
// Replaces the TPU kernel repro/kernels/segment_reduce.py::segment_reduce
// (body _segment_reduce_kernel), which kept the [K, V] accumulator in VMEM
// and fed it with a one-hot matmul on the MXU.  Here there is no matrix work
// at all: the function reads N ids and N*V values once and writes K*V cells,
// so it is bound by memory bytes, and past that by how many updates land on
// one cell at a time (atomics on few addresses serialise).
//
// Three forms, picked by the wrapper (launch_shape) from K and K*V:
// * registers, for K <= kRegK (k-means' [5, 4], GMM's [5, 9]): the values
//   are read as one flat stream, four consecutive elements a thread a step
//   (one 16-byte load), and the grid's 4*threads elements a step are a
//   multiple of V, so each of a thread's four slots always meets the same
//   column.  A slot keeps one partial per key in registers and folds every
//   element into it with a predicated fold per key: no atomics in the loop.
//   At the end, when every lane of a warp meets the same columns (V divides
//   4) a shuffle tree folds each partial across the warp and lane 0 folds it
//   into the CTA's [K, V] copy in shared memory; otherwise every slot folds
//   its partials there.  The CTA then merges its copy into the output with
//   one atomic per cell.  The earlier form (below) folded 4*10^8 values into
//   20 shared cells with one shared atomic each, which every SM serialised.
// * shared: each CTA grid-strides over the pairs and folds them into its own
//   [K, V] copy in shared memory (initialised to the identity), then merges
//   that copy into the global output with one atomic per non-identity cell;
//   for K*V that fits shared memory but not the registers.
// * global: when [K, V] does not fit the shared-memory budget (PageRank's
//   K = 2^20), pairs fold into the global output with atomics.  R-MAT's
//   in-links are heavy-tailed (page 0 takes ~0.4% of PageRank's edges, ~69 K
//   atomics on one address), and on this card its pairs took 2.2 times as
//   long as as many uniform ids: each CTA keeps a small table of the keys
//   that first claim its slots (1,024 at V = 1) in shared memory, folds
//   those keys there and flushes each once; a hub claims its slot early in
//   every CTA, and the other keys pay one shared read.  A row too wide for
//   one slot in the table's 16 KiB (V > 4095 in f32) gets no table.
// The wrapper pre-fills the output with the identity.  A dropped lane (id
// outside [0, K)) never folds its value anywhere, so a NaN on a masked lane
// cannot leak into any key.
#include <type_traits>

#include "blaze_fold.cuh"

template <typename InT, typename AccT, int OP>
__global__ void segment_reduce_global(const int* __restrict__ ids,
                                      const InT* __restrict__ vals,
                                      AccT* __restrict__ out, long long n,
                                      int v, int k, int slot_bits) {
  // The CTA's table of hot keys: 2^slot_bits slots of (key, [v] partials),
  // a key's slot fixed by a multiplicative hash.  The first key that reaches
  // a free slot claims it for the CTA's life; a key that finds its own slot
  // folds there, any other folds straight into the output.  slot_bits < 0:
  // no table (one slot of a row this wide would not fit), every pair folds
  // straight into the output.
  extern __shared__ unsigned char smem_raw[];
  const int slots = slot_bits < 0 ? 0 : 1 << slot_bits;
  int* tags = reinterpret_cast<int*>(smem_raw);
  AccT* part = reinterpret_cast<AccT*>(tags + slots);
  const AccT ident = identity<AccT, OP>();
  for (int t = threadIdx.x; t < slots; t += blockDim.x) tags[t] = -1;
  for (int t = threadIdx.x; t < slots * v; t += blockDim.x) part[t] = ident;
  __syncthreads();
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int id = ids[i];
    if (id < 0 || id >= k) continue;
    AccT* dst = out + (long long)id * v;
    if (slots) {
      const int slot = slot_bits ? int((unsigned(id) * 2654435761u) >> (32 - slot_bits)) : 0;
      int tag = tags[slot];
      if (tag == -1) {
        const int old = atomicCAS(tags + slot, -1, id);
        tag = old == -1 ? id : old;
      }
      if (tag == id) dst = part + (long long)slot * v;
    }
    for (int c = 0; c < v; ++c) atomic_fold<OP>(dst + c, load_acc(vals, i * v + c));
  }
  __syncthreads();
  for (int t = threadIdx.x; t < slots * v; t += blockDim.x) {
    const int tag = tags[t / v];
    const AccT x = part[t];
    if (tag != -1 && !same_bits(x, ident)) atomic_fold<OP>(out + (long long)tag * v + t % v, x);
  }
}

template <typename InT, typename AccT, int OP>
__global__ void segment_reduce_shared(const int* __restrict__ ids,
                                      const InT* __restrict__ vals,
                                      AccT* __restrict__ out, long long n,
                                      int v, int k) {
  extern __shared__ unsigned char smem_raw[];
  AccT* acc = reinterpret_cast<AccT*>(smem_raw);
  const int cells = k * v;
  const AccT ident = identity<AccT, OP>();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) acc[c] = ident;
  __syncthreads();
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int id = ids[i];
    if (id < 0 || id >= k) continue;
    for (int c = 0; c < v; ++c) {
      atomic_fold<OP>(acc + id * v + c, load_acc(vals, i * v + c));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    AccT x = acc[c];
    // Folding the identity changes nothing: skip the atomic.
    if (same_bits(x, ident)) continue;
    atomic_fold<OP>(out + c, x);
  }
}

namespace {

constexpr int kRegK = 8;    // the wrapper's REG_K: keys a slot keeps in registers
constexpr int kSteps = 4;   // register form: steps whose loads are in flight together
constexpr int kHotBits = 10;          // global form: at most 1024 hot-key slots a CTA
constexpr size_t kHotBytes = 16384;   // and at most 16 KiB of table
constexpr int kSlots = 4;   // consecutive elements a thread takes a step

// Elements e .. e + 3 of the flat value stream (past total: unread).
template <typename InT, typename AccT>
__device__ __forceinline__ void load4(const InT* p, long long e, long long total,
                                      bool aligned, AccT (&v)[kSlots]) {
  if (aligned && e + kSlots <= total) {
    if constexpr (std::is_same<InT, float>::value) {
      const float4 u = *reinterpret_cast<const float4*>(p + e);
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    } else if constexpr (std::is_same<InT, int>::value) {
      const int4 u = *reinterpret_cast<const int4*>(p + e);
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p + e);
      const InT* x = reinterpret_cast<const InT*>(&u);
#pragma unroll
      for (int q = 0; q < kSlots; ++q) v[q] = load_acc(x, q);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kSlots; ++q) v[q] = e + q < total ? load_acc(p, e + q) : AccT(0);
  }
}

template <int OP, typename AccT>
__device__ __forceinline__ AccT warp_fold(AccT x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fold<OP>(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The ids of a step's four elements, rows row[q] (-1 past the last row).
// v is the same for every thread, so the branch is uniform: four slots of
// one row (v a multiple of 4) load one id, otherwise each slot loads its own.
__device__ __forceinline__ void load_ids(const int* __restrict__ ids, long long n, int v,
                                         const long long (&row)[kSlots], int (&id)[kSlots]) {
  if (v % kSlots == 0) {
    const int i0 = row[0] < n ? ids[row[0]] : -1;
#pragma unroll
    for (int q = 0; q < kSlots; ++q) id[q] = i0;
  } else {
#pragma unroll
    for (int q = 0; q < kSlots; ++q) id[q] = row[q] < n ? ids[row[q]] : -1;
  }
}

// A predicated fold of each slot's element into its partial of every key.
template <typename AccT, int OP>
__device__ __forceinline__ void fold_step(const AccT (&v)[kSlots], const int (&id)[kSlots],
                                          int k, AccT (&acc)[kSlots][kRegK]) {
  const AccT ident = identity<AccT, OP>();
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
#pragma unroll
    for (int m = 0; m < kRegK; ++m) {
      if (m < k) acc[q][m] = fold<OP>(acc[q][m], id[q] == m ? v[q] : ident);
    }
  }
}

}  // namespace

template <typename InT, typename AccT, int OP>
__global__ void __launch_bounds__(256, 2)
segment_reduce_registers(const int* __restrict__ ids, const InT* __restrict__ vals,
                         AccT* __restrict__ out, long long n, int v, int k, int aligned) {
  extern __shared__ unsigned char smem_raw[];
  AccT* sacc = reinterpret_cast<AccT*>(smem_raw);
  const int cells = k * v;
  const AccT ident = identity<AccT, OP>();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) sacc[c] = ident;
  AccT acc[kSlots][kRegK];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
#pragma unroll
    for (int m = 0; m < kRegK; ++m) acc[q][m] = ident;
  }
  const long long total = n * v;
  const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  const long long step = kSlots * threads;  // a multiple of v (the wrapper's grid)
  const long long rows_step = step / v;
  long long row[kSlots];
#pragma unroll
  for (int q = 0; q < kSlots; ++q) row[q] = (kSlots * gt + q) / v;
  // kSteps steps in flight: every step's loads are issued before any fold.
  const bool vec = aligned != 0;
  long long e0 = kSlots * gt;
  for (; e0 + (kSteps - 1) * step < total; e0 += kSteps * step) {
    AccT vs[kSteps][kSlots];
    int id[kSteps][kSlots];
#pragma unroll
    for (int t = 0; t < kSteps; ++t) load4(vals, e0 + t * step, total, vec, vs[t]);
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      long long rt[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) rt[q] = row[q] + t * rows_step;
      load_ids(ids, n, v, rt, id[t]);
    }
#pragma unroll
    for (int t = 0; t < kSteps; ++t) fold_step<AccT, OP>(vs[t], id[t], k, acc);
#pragma unroll
    for (int q = 0; q < kSlots; ++q) row[q] += kSteps * rows_step;
  }
  for (; e0 < total; e0 += step) {
    AccT vs[kSlots];
    int id[kSlots];
    load4(vals, e0, total, vec, vs);
    load_ids(ids, n, v, row, id);
    fold_step<AccT, OP>(vs, id, k, acc);
#pragma unroll
    for (int q = 0; q < kSlots; ++q) row[q] += rows_step;
  }
  __syncthreads();  // sacc is initialised
  if (kSlots % v == 0) {
    // Every lane's slot q meets column q % v: fold across the warp first.
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
#pragma unroll
      for (int m = 0; m < kRegK; ++m) {
        if (m >= k) continue;  // k is the same for every lane
        const AccT x = warp_fold<OP>(acc[q][m]);
        if ((threadIdx.x & 31) == 0 && !same_bits(x, ident))
          atomic_fold<OP>(sacc + m * v + q % v, x);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int col = int((kSlots * gt + q) % v);
#pragma unroll
      for (int m = 0; m < kRegK; ++m) {
        if (m < k && !same_bits(acc[q][m], ident)) atomic_fold<OP>(sacc + m * v + col, acc[q][m]);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const AccT x = sacc[c];
    if (!same_bits(x, ident)) atomic_fold<OP>(out + c, x);
  }
}

enum Form { FORM_REGISTERS = 0, FORM_SHARED = 1, FORM_GLOBAL = 2 };

// form: FORM_*; aligned: vals is 16-byte aligned (the register form's vector
// loads).  The register form needs 4 * blocks * threads to be a multiple of
// v, and threads <= 256; the wrapper's launch_shape keeps both.
extern "C" int blaze_segment_reduce(const void* ids, const void* vals, void* out,
                                    long long n, int v, int k, int dtype, int op,
                                    int form, int aligned, int blocks, int threads,
                                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (form == FORM_REGISTERS &&
      (k > kRegK || threads > 256 || (4LL * blocks * threads) % v != 0))
    return (int)cudaErrorInvalidValue;
  BLAZE_DISPATCH(dtype, op, {
    const int* i = static_cast<const int*>(ids);
    const InT* x = static_cast<const InT*>(vals);
    AccT* o = static_cast<AccT*>(out);
    const size_t smem = (size_t)k * v * sizeof(AccT);
    if (form == FORM_REGISTERS) {
      segment_reduce_registers<InT, AccT, OP><<<blocks, threads, smem, s>>>(i, x, o, n, v, k,
                                                                              aligned);
    } else if (form == FORM_SHARED) {
      segment_reduce_shared<InT, AccT, OP><<<blocks, threads, smem, s>>>(i, x, o, n, v, k);
    } else if (form == FORM_GLOBAL) {
      // The most slots whose table fits kHotBytes; -1 (no table) when one
      // slot of a [v] row does not.
      const size_t slot_bytes = sizeof(int) + (size_t)v * sizeof(AccT);
      int bits = kHotBits;
      while (bits >= 0 && slot_bytes << bits > kHotBytes) --bits;
      const size_t table = bits < 0 ? 0 : slot_bytes << bits;
      segment_reduce_global<InT, AccT, OP><<<blocks, threads, table, s>>>(i, x, o, n, v, k,
                                                                          bits);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  });
  return (int)cudaGetLastError();
}
