// Open-addressing hash aggregation on Hopper: (key, value-row) pairs with
// duplicates -> a linear-probing table keys[C] + vals[C, V] in device memory.
//
// Replaces the TPU kernel repro/kernels/hash_combine.py::hash_aggregate (body
// _hash_kernel), which kept the table in VMEM and walked pair blocks in
// order.  Here every live lane takes part in one round-synchronous probe
// sequence, each round three launches over the lanes or the slots:
//   1. claim:   a lane whose probe slot (splitmix32(key) + r) % C is free does
//               atomicMax of its key into claim[slot] (claim starts at
//               EMPTY_KEY), so the largest claimant wins: the tie-break of
//               containers.hashmap_insert, not a first-come atomicCAS;
//   2. commit:  every slot with a claim takes the winning key, and the claim
//               resets to EMPTY_KEY for the next round;
//   3. deposit: a lane whose key now sits at its slot folds its row in with
//               the reducer's atomic and goes inactive; lanes still active
//               are counted, one atomic per warp.
// Duplicates of a key follow the same probe sequence and deposit together, so
// the table equals hashmap_insert of the unique keys slot for slot.  The
// wrapper runs at most max_probes rounds and stops as soon as a round leaves
// no lane active; what is still active then is the overflow.
//
// Bound: the pairs are read once per round (keys and flags every round, the
// values in the round they deposit), the table once per round; the hot keys
// of a skewed stream then serialise on their slot's atomics.  The read of
// claim[slot] before the atomicMax skips the atomic once a larger or equal
// key has claimed, so the claim step sends few atomics to a hot slot; the
// deposit keeps one atomic per lane.
#include "blaze_fold.cuh"

#define EMPTY_KEY ((int)0x80000000)

__device__ __forceinline__ unsigned hash32(unsigned x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ int probe_slot(int key, int cap, int round) {
  unsigned home = hash32((unsigned)key) % (unsigned)cap;
  return (int)((home + (unsigned)round) % (unsigned)cap);
}

__global__ void hash_claim(const int* __restrict__ keys,
                           const unsigned char* __restrict__ active,
                           const int* __restrict__ tkeys, int* claim,
                           long long n, int cap, int round) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!active[i]) continue;
    int key = keys[i];
    int slot = probe_slot(key, cap, round);
    if (tkeys[slot] == EMPTY_KEY && claim[slot] < key) atomicMax(claim + slot, key);
  }
}

__global__ void hash_commit(int* __restrict__ tkeys, int* __restrict__ claim,
                            int cap) {
  int stride = gridDim.x * blockDim.x;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < cap; s += stride) {
    int c = claim[s];
    if (c != EMPTY_KEY) {
      tkeys[s] = c;
      claim[s] = EMPTY_KEY;
    }
  }
}

template <typename InT, typename AccT, int OP>
__global__ void hash_deposit(const int* __restrict__ keys,
                             const InT* __restrict__ vals,
                             unsigned char* __restrict__ active,
                             const int* __restrict__ tkeys,
                             AccT* __restrict__ tvals, int* remaining,
                             long long n, int v, int cap, int round) {
  int left = 0;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!active[i]) continue;
    int key = keys[i];
    int slot = probe_slot(key, cap, round);
    if (tkeys[slot] == key) {
      for (int c = 0; c < v; ++c) {
        atomic_fold<OP>(tvals + (long long)slot * v + c, load_acc(vals, i * v + c));
      }
      active[i] = 0;
    } else {
      ++left;
    }
  }
  // Every thread leaves the loop, so the whole warp takes part here.
  for (int off = 16; off > 0; off >>= 1) left += __shfl_down_sync(0xffffffffu, left, off);
  if ((threadIdx.x & 31) == 0 && left) atomicAdd(remaining, left);
}

extern "C" int blaze_hash_claim(const void* keys, const void* active,
                                const void* tkeys, void* claim, long long n,
                                int cap, int round, int blocks, int threads,
                                void* stream) {
  hash_claim<<<blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const unsigned char*>(active),
      static_cast<const int*>(tkeys), static_cast<int*>(claim), n, cap, round);
  return (int)cudaGetLastError();
}

extern "C" int blaze_hash_commit(void* tkeys, void* claim, int cap, int blocks,
                                 int threads, void* stream) {
  hash_commit<<<blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(tkeys), static_cast<int*>(claim), cap);
  return (int)cudaGetLastError();
}

extern "C" int blaze_hash_deposit(const void* keys, const void* vals,
                                  void* active, const void* tkeys, void* tvals,
                                  void* remaining, long long n, int v, int cap,
                                  int round, int dtype, int op, int blocks,
                                  int threads, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  BLAZE_DISPATCH(dtype, op, {
    hash_deposit<InT, AccT, OP><<<blocks, threads, 0, s>>>(
        static_cast<const int*>(keys), static_cast<const InT*>(vals),
        static_cast<unsigned char*>(active), static_cast<const int*>(tkeys),
        static_cast<AccT*>(tvals), static_cast<int*>(remaining), n, v, cap,
        round);
  });
  return (int)cudaGetLastError();
}
