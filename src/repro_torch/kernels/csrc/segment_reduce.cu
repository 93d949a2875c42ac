// Dense reduce-by-key on Hopper: (id, value-row) pairs -> [K, V] accumulator.
//
// Replaces the TPU kernel repro/kernels/segment_reduce.py::segment_reduce
// (body _segment_reduce_kernel), which kept the [K, V] accumulator in VMEM
// and fed it with a one-hot matmul on the MXU.  Here there is no matrix work
// at all: the function reads N ids and N*V values once and writes K*V cells,
// so it is bound by memory bytes, and past that by atomic throughput when
// many pairs land on the same few cells.
//
// Two forms, picked by the wrapper from K*V:
// * shared: each CTA grid-strides over the pairs and folds them into its own
//   [K, V] copy in shared memory (initialised to the identity), then merges
//   that copy into the global output with one atomic per non-identity cell.
//   Small key ranges (k-means' [5, 4]) would otherwise serialise ~10^8
//   global atomics on 20 addresses; shared atomics keep that contention
//   inside each SM.
// * global: when [K, V] does not fit the shared-memory budget (PageRank's
//   K = 2^20), pairs fold straight into the global output with atomics; the
//   keys are spread, so contention is low and the atomics resolve in L2.
// The wrapper pre-fills the output with the identity.  A dropped lane (id
// outside [0, K)) never has its value read, so a NaN on a masked lane cannot
// leak into any key.
#include "blaze_fold.cuh"

template <typename InT, typename AccT, int OP>
__global__ void segment_reduce_global(const int* __restrict__ ids,
                                      const InT* __restrict__ vals,
                                      AccT* __restrict__ out, long long n,
                                      int v, int k) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int id = ids[i];
    if (id < 0 || id >= k) continue;
    for (int c = 0; c < v; ++c) {
      atomic_fold<OP>(out + (long long)id * v + c, load_acc(vals, i * v + c));
    }
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

extern "C" int blaze_segment_reduce(const void* ids, const void* vals, void* out,
                                    long long n, int v, int k, int dtype, int op,
                                    int use_shared, int blocks, int threads,
                                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  BLAZE_DISPATCH(dtype, op, {
    if (use_shared) {
      size_t smem = (size_t)k * v * sizeof(AccT);
      segment_reduce_shared<InT, AccT, OP><<<blocks, threads, smem, s>>>(
          static_cast<const int*>(ids), static_cast<const InT*>(vals),
          static_cast<AccT*>(out), n, v, k);
    } else {
      segment_reduce_global<InT, AccT, OP><<<blocks, threads, 0, s>>>(
          static_cast<const int*>(ids), static_cast<const InT*>(vals),
          static_cast<AccT*>(out), n, v, k);
    }
  });
  return (int)cudaGetLastError();
}
