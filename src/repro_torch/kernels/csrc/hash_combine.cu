// Open-addressing hash aggregation on Hopper: (key, value-row) pairs with
// duplicates -> a linear-probing table keys[C] + vals[C, V] in device memory.
//
// Replaces the TPU kernel repro/kernels/hash_combine.py::hash_aggregate (body
// _hash_kernel), which kept the table in VMEM, walked pair blocks in order and
// folded the duplicates of a block on the MXU before it touched the table.
//
// One cooperative launch (every CTA resident at once, grid.sync() between
// phases), so no round waits on the host:
//
// 0. Pre-combine.  CTA b owns the lanes [lo_b, hi_b) and walks them a warp
//    step at a time.  The lanes of a warp that hold the same key find each
//    other with __match_any_sync and fold their rows by pointer jumping (five
//    shuffles at most); the group's first lane then folds the group's partial
//    into the CTA's table of hot keys in shared memory (first-come slots, up
//    to kCtaProbes linear probes, sized by V by the wrapper), adding the
//    group's size to the slot's multiplicity.  A group whose key finds no room
//    passes through: it becomes one compacted lane (key, partial [V],
//    multiplicity) in the CTA's own part of the scratch.  Each warp keeps
//    one hot key (that of the largest group of its first step with a
//    repeat) with its partial and lane count in registers, for rows of up
//    to kHotV values, so Zipf's hottest word, in nearly every warp step,
//    stays out of the table's atomics.  The next step's keys and values load
//    while a step folds.  At the end the warps' hot partials join the table,
//    and its slots follow as compacted lanes.  A CTA never writes more lanes
//    than it read, so its part of the scratch is its own lane range, and no
//    counter is shared between CTAs.
// 1. Probe rounds over the compacted lanes:
//    claim:  a lane whose probe slot (splitmix32(key) + r) % C is free does
//            atomicMax of its key into claim[slot], so the largest claimant
//            wins (containers.hashmap_insert's tie-break);
//    commit: after a grid.sync, a lane whose key won writes it into
//            keys[slot]; a lane whose key sits at its slot folds its partial
//            in with the reducer's atomic and leaves; the others claim their
//            next slot and are compacted in order within the CTA's part, and
//            the CTA adds their count to live[r + 1].
//    After the round every CTA reads live[r + 1]; at 0 all stop.  A claimed
//    slot is never free again, so the claims need no reset between rounds.
//    A round claims into claim[r % 2], so its survivors claim their next
//    slot in the same phase: one grid.sync a round.  Once at most
//    kSoloLanes lanes are left, CTA 0 gathers them and runs the last rounds
//    alone with block barriers (a grid barrier costs more than such a
//    round); the other CTAs leave.
// 2. Overflow.  After max_probes rounds the multiplicities of the lanes still
//    live add to `overflow`: it counts raw lanes, as the reference does.
//
// Pre-combining changes neither the set of keys nor their probe sequences,
// and every lane of a key deposits in the same round, so the table equals
// hashmap_insert of the unique keys slot for slot.  The partials only
// regroup the additions of a key's sum.
//
// Bound: the pairs are read once (0.28 ms at wordcount's 2^27 lanes); the
// earlier form read every lane's key and flag every round and sent one
// atomic per lane to its slot, so Zipf's hot words (the hottest about a
// quarter of the tokens) serialised on one address.  Here a hot key reaches
// the table once per CTA, and the rounds start from ~6% of the lanes.  What
// bounds it now is the walk's instructions a warp step (the match, the
// shuffles of the fold, the table's probes), about 60% of the combine
// (profiling/k2_k6_probe.py --phases).  live[0] is the number of compacted
// lanes; live[r + 1] what is left after round r (the wrapper keeps it for
// inspection).
#include <cooperative_groups.h>

#include "blaze_fold.cuh"
#include "coop_launch.cuh"

namespace cg = cooperative_groups;

#define EMPTY_KEY ((int)0x80000000)

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCtaProbes = 4;  // the wrapper's CTA_PROBES
constexpr int kHotV = 4;       // widest row a warp keeps its hot key's partial of
constexpr int kSoloLanes = 256;  // the wrapper's SOLO_LANES: lanes CTA 0 takes on alone
constexpr size_t kMaxTableBytes = 48 * 1024;  // the wrapper's TABLE_BYTES

__device__ __forceinline__ unsigned hash32(unsigned x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ int probe_slot(int key, int cap, int round) {
  unsigned home = hash32((unsigned)key) % (unsigned)cap;
  return (int)((home + (unsigned)round) % (unsigned)cap);
}

struct Args {
  const int* keys;
  const void* vals;
  const int* ikeys;  // the table merged into, copied into tkeys/tvals/overflow
  const void* ivals;  // (accumulator type), or null: a fresh table
  const int* iovf;
  int* tkeys;
  void* tvals;
  int* overflow;
  unsigned long long* rounds;  // rounds run, added to
  int* skey;                   // [n + kSoloLanes] compacted lanes: key,
  int* smult;                  //     multiplicity,
  int* sidx;                   //     and the row of svals holding the partial
  void* svals;                 // [n, v]
  int* claim;                  // [2, cap]: the claims of even and odd rounds
  int* live;                   // [max_probes + 1]
  int* gathered;               // lanes gathered for CTA 0's rounds
  long long n;
  int v, cap, max_probes, bits;
};

// Fold of the lanes of `group` (lanes after me, by pointer jumping along
// succ[]): afterwards the group's first lane holds the whole group's fold.
template <typename AccT, int OP>
__device__ __forceinline__ AccT group_fold(AccT x, const int (&succ)[5], int steps) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 5; ++j) {  // unrolled, so succ[] stays in registers
    if (j >= steps) break;
    const int s = succ[j];
    const AccT y = __shfl_sync(0xffffffffu, x, s >= 0 ? s : lane);
    if (s >= 0) x = fold<OP>(x, y);
  }
  return x;
}

// Order-keeping compaction within the CTA: the position among this step's
// kept lanes of the CTA, and the step's total.  Two barriers.
__device__ __forceinline__ int block_rank(bool keep, int* warp_n, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ball = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) warp_n[warp] = __popc(ball);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_n[w];
    before += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();  // warp_n is free again
  return before + __popc(ball & ((1u << lane) - 1u));
}

// key's slot in the CTA's table of 2^bits slots (first come, up to
// kCtaProbes linear probes), or -1 when it finds no room.
__device__ __forceinline__ int cta_slot(int key, int* tags, int slots, int bits) {
  if (!slots) return -1;
  const unsigned h0 = bits ? hash32((unsigned)key) >> (32 - bits) : 0u;
#pragma unroll
  for (int p = 0; p < kCtaProbes; ++p) {
    const int s = (int)((h0 + p) & (unsigned)(slots - 1));
    int t = tags[s];
    if (t == EMPTY_KEY) {
      const int old = atomicCAS(tags + s, EMPTY_KEY, key);
      t = old == EMPTY_KEY ? key : old;
    }
    if (t == key) return s;
  }
  return -1;
}

template <typename InT, typename AccT, int OP>
__global__ void __launch_bounds__(kThreads) hash_aggregate_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_n[kWarps];
  __shared__ int cursor;
  const int slots = a.bits < 0 ? 0 : 1 << a.bits;
  int* tags = reinterpret_cast<int*>(smem_raw);
  int* mult = tags + slots;
  AccT* part = reinterpret_cast<AccT*>(mult + slots);
  const AccT ident = identity<AccT, OP>();
  const int tid = threadIdx.x, lane = tid & 31;
  const int* __restrict__ keys = a.keys;
  const InT* __restrict__ vals = static_cast<const InT*>(a.vals);
  AccT* svals = static_cast<AccT*>(a.svals);
  AccT* tvals = static_cast<AccT*>(a.tvals);
  const int v = a.v;

  // The table starts as init's copy or empty, claim[], live[] and gathered
  // at 0.  The first grid.sync below orders this before any CTA adds to
  // them, so a CTA counts its compacted lanes into live[0] only after it.
  const long long gtid = (long long)blockIdx.x * blockDim.x + tid;
  const long long gthreads = (long long)gridDim.x * blockDim.x;
  const AccT* ivals = static_cast<const AccT*>(a.ivals);
  for (long long s = gtid; s < a.cap; s += gthreads)
    a.tkeys[s] = a.ikeys ? a.ikeys[s] : EMPTY_KEY;
  for (long long s = gtid; s < (long long)a.cap * a.v; s += gthreads)
    tvals[s] = ivals ? ivals[s] : ident;
  if (gtid == 0) *a.overflow = a.iovf ? *a.iovf : 0;
  for (long long s = gtid; s < 2LL * a.cap; s += gthreads) a.claim[s] = EMPTY_KEY;
  for (long long s = gtid; s <= a.max_probes; s += gthreads) a.live[s] = 0;
  if (gtid == 0) *a.gathered = 0;
  for (int t = tid; t < slots; t += kThreads) {
    tags[t] = EMPTY_KEY;
    mult[t] = 0;
  }
  for (int t = tid; t < slots * v; t += kThreads) part[t] = ident;
  if (tid == 0) cursor = 0;
  __syncthreads();

  // --- 0. pre-combine ------------------------------------------------------
  const long long tile = (a.n + gridDim.x - 1) / gridDim.x;
  const long long lo = min((long long)blockIdx.x * tile, a.n);
  const long long hi = min(lo + tile, a.n);
  // The warp's hot key: the key of the first group of two or more lanes it
  // meets, whose partial and lane count stay in registers (every lane holds
  // them) for rows of at most kHotV values, so the hottest word does not
  // send every warp step's fold to one shared address.
  const int hv = v <= kHotV ? v : 0;
  int hot_key = EMPTY_KEY;
  unsigned hot_size = 0;
  AccT hot[kHotV];
#pragma unroll
  for (int c = 0; c < kHotV; ++c) hot[c] = ident;
  // The next step's key and first values load while this step folds.
  AccT nval[kHotV];
  int nkey = lo + tid < hi ? keys[lo + tid] : EMPTY_KEY;
#pragma unroll
  for (int c = 0; c < kHotV; ++c)
    nval[c] = c < v && nkey != EMPTY_KEY ? load_acc(vals, (lo + tid) * v + c) : ident;
  for (long long base = lo; base < hi; base += kThreads) {
    const long long i = base + tid;
    const int key = nkey;
    AccT val[kHotV];
#pragma unroll
    for (int c = 0; c < kHotV; ++c) val[c] = nval[c];
    const long long inext = i + kThreads;
    nkey = inext < hi ? keys[inext] : EMPTY_KEY;
#pragma unroll
    for (int c = 0; c < kHotV; ++c)
      nval[c] = c < v && nkey != EMPTY_KEY ? load_acc(vals, inext * v + c) : ident;
    const bool live = key != EMPTY_KEY;
    const unsigned group = __match_any_sync(0xffffffffu, key);
    const bool leader = live && (__ffs(group) - 1) == lane;
    const unsigned size = __popc(group);
    // Successors in the group for the pointer-jumping fold.
    const unsigned above = lane == 31 ? 0u : group & (0xffffffffu << (lane + 1));
    int succ[5];
    succ[0] = above ? __ffs(above) - 1 : -1;
#pragma unroll
    for (int j = 1; j < 5; ++j) {
      const int s = succ[j - 1];
      const int t = __shfl_sync(0xffffffffu, s, s >= 0 ? s : lane);
      succ[j] = s >= 0 ? t : -1;
    }
    const unsigned biggest = __reduce_max_sync(0xffffffffu, live ? size : 1u);
    const int steps = biggest > 1 ? 32 - __clz(biggest - 1) : 0;
    if (hv && hot_key == EMPTY_KEY && biggest > 1) {
      const unsigned cand = __ballot_sync(0xffffffffu, leader && size == biggest);
      hot_key = __shfl_sync(0xffffffffu, key, __ffs(cand) - 1);
    }
    const unsigned hball = __ballot_sync(0xffffffffu, leader && key == hot_key);
    const int hlead = __ffs(hball) - 1;  // the hot group's leader, or -1
    const bool hot_here = hball != 0;
    if (hot_here) hot_size += __shfl_sync(0xffffffffu, size, hlead);
    // The leader's slot in the CTA table, or -1: it passes through.
    const bool place = leader && !(hot_here && lane == hlead);
    const int slot = place ? cta_slot(key, tags, slots, a.bits) : -1;
    const bool pass = place && slot < 0;
    const unsigned pball = __ballot_sync(0xffffffffu, pass);
    int first = 0;
    if (lane == 0 && pball) first = atomicAdd(&cursor, __popc(pball));
    first = __shfl_sync(0xffffffffu, first, 0);
    const long long pos = lo + first + __popc(pball & ((1u << lane) - 1u));
    for (int c = 0; c < v; ++c) {
      const AccT raw = c < kHotV ? val[c] : (live ? load_acc(vals, i * v + c) : ident);
      const AccT x = group_fold<AccT, OP>(raw, succ, steps);
      if (hot_here && c < hv) {
        const AccT y = __shfl_sync(0xffffffffu, x, hlead);
#pragma unroll
        for (int q = 0; q < kHotV; ++q)
          if (q == c) hot[q] = fold<OP>(hot[q], y);
      }
      if (slot >= 0) {
        atomic_fold<OP>(part + slot * v + c, x);
      } else if (pass) {
        svals[pos * v + c] = x;
      }
    }
    if (slot >= 0) atomicAdd(mult + slot, (int)size);
    if (pass) {
      a.skey[pos] = key;
      a.smult[pos] = (int)size;
      a.sidx[pos] = (int)pos;
    }
  }
  // Each warp's hot partial joins the table, or passes through.
  if (lane == 0 && hot_key != EMPTY_KEY) {
    const int slot = cta_slot(hot_key, tags, slots, a.bits);
    if (slot >= 0) {
      for (int c = 0; c < hv; ++c) atomic_fold<OP>(part + slot * v + c, hot[c]);
      atomicAdd(mult + slot, (int)hot_size);
    } else {
      const long long pos = lo + atomicAdd(&cursor, 1);
      for (int c = 0; c < hv; ++c) svals[pos * v + c] = hot[c];
      a.skey[pos] = hot_key;
      a.smult[pos] = (int)hot_size;
      a.sidx[pos] = (int)pos;
    }
  }
  __syncthreads();
  // The table's slots follow the pass-through lanes.
  for (int t0 = 0; t0 < slots; t0 += kThreads) {
    const int t = t0 + tid;
    const bool used = t < slots && tags[t] != EMPTY_KEY;
    int total;
    const int rank = block_rank(used, warp_n, total);
    if (used) {
      const long long pos = lo + cursor + rank;
      a.skey[pos] = tags[t];
      a.smult[pos] = mult[t];
      a.sidx[pos] = (int)pos;
      for (int c = 0; c < v; ++c) svals[pos * v + c] = part[t * v + c];
    }
    __syncthreads();  // every thread has read cursor
    if (tid == 0) cursor += total;
    __syncthreads();
  }
  int count = cursor;  // this CTA's compacted lanes
  grid.sync();

  // --- 1. probe rounds -----------------------------------------------------
  // Round r claims into claim[r % 2]: a lane that survives round r claims
  // its slot of round r + 1 in the same phase, so a round takes one
  // grid.sync.  A slot free at round r + 1 was never claimed (every claim
  // has a winner, who commits it), so claim[(r + 1) % 2] holds nothing
  // stale there; a claim made while its slot was being committed in round r
  // lands on a slot no later round finds free.
  int* claims[2] = {a.claim, a.claim + a.cap};
  auto claim_slot = [&](int key, int round) {
    const int s = probe_slot(key, a.cap, round);
    int* c = claims[round & 1] + s;
    if (__ldcg(a.tkeys + s) == EMPTY_KEY && __ldcg(c) < key) atomicMax(c, key);
  };
  if (tid == 0 && count) atomicAdd(a.live, count);
  for (int i = tid; i < count; i += kThreads) claim_slot(a.skey[lo + i], 0);
  grid.sync();
  // Once few lanes are left, CTA 0 gathers them past the lanes' scratch and
  // runs the remaining rounds alone, with block barriers in place of grid
  // ones; the other CTAs leave.
  long long part_lo = lo;  // this CTA's lanes: [part_lo, part_lo + count)
  bool solo = false;
  int round = 0;
  for (; round < a.max_probes; ++round) {
    const int left = __ldcg(a.live + round);  // every CTA reads the same count
    if (left == 0) break;
    if (!solo && left <= kSoloLanes) {
      if (tid == 0) cursor = count ? atomicAdd(a.gathered, count) : 0;
      __syncthreads();
      for (int i = tid; i < count; i += kThreads) {
        const long long to = a.n + cursor + i;
        a.skey[to] = a.skey[part_lo + i];
        a.smult[to] = a.smult[part_lo + i];
        a.sidx[to] = a.sidx[part_lo + i];
      }
      grid.sync();
      if (blockIdx.x != 0) return;
      solo = true;
      part_lo = a.n;
      count = left;
    }
    const int* claim = claims[round & 1];
    const bool next = round + 1 < a.max_probes;
    int kept = 0;
    for (int b = 0; b < count; b += kThreads) {
      const int i = b + tid;
      const bool have = i < count;
      int key = 0, m = 0, idx = 0;
      bool placed = false;
      if (have) {
        key = a.skey[part_lo + i];
        m = a.smult[part_lo + i];
        idx = a.sidx[part_lo + i];
        const int s = probe_slot(key, a.cap, round);
        const int t = __ldcg(a.tkeys + s);
        if (t == EMPTY_KEY && __ldcg(claim + s) == key) {
          a.tkeys[s] = key;  // every lane of the winning key writes the same
          placed = true;
        } else {
          placed = t == key;
        }
        if (placed) {
          for (int c = 0; c < v; ++c)
            atomic_fold<OP>(tvals + (long long)s * v + c, __ldcg(svals + (long long)idx * v + c));
        } else if (next) {
          claim_slot(key, round + 1);
        }
      }
      int total;
      const int rank = block_rank(have && !placed, warp_n, total);
      if (have && !placed) {  // in place: every lane of this step was read above
        a.skey[part_lo + kept + rank] = key;
        a.smult[part_lo + kept + rank] = m;
        a.sidx[part_lo + kept + rank] = idx;
      }
      kept += total;
    }
    count = kept;
    if (solo) {
      if (tid == 0) a.live[round + 1] = count;
      __syncthreads();
    } else {
      if (tid == 0 && count) atomicAdd(a.live + round + 1, count);
      grid.sync();
    }
  }
  if (blockIdx.x == 0 && tid == 0) atomicAdd(a.rounds, (unsigned long long)round);

  // --- 2. overflow: the raw lanes still unplaced ---------------------------
  if (round == a.max_probes && __ldcg(a.live + round) != 0) {
    int left = 0;
    for (int i = tid; i < count; i += kThreads) left += a.smult[part_lo + i];
    for (int off = 16; off > 0; off >>= 1) left += __shfl_down_sync(0xffffffffu, left, off);
    if (lane == 0 && left) atomicAdd(a.overflow, left);
  }
}

template <typename InT, typename AccT, int OP>
int launch(Args& a, size_t smem, cudaStream_t stream) {
  auto kernel = hash_aggregate_kernel<InT, AccT, OP>;
  // The table and the static shared memory may pass 48 KB together: opt in
  // once per function and device.
  static bool opted[64] = {};
  int dev = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < 64 && !opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(kMaxTableBytes));
    opted[dev] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return (int)err;
  // The resident CTAs, asked once per device and table size.
  static int known_smem[64], known_blocks[64];
  if (dev < 64 && known_blocks[dev] > 0 && known_smem[dev] == (int)smem) {
    resident = known_blocks[dev];
  } else {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    resident *= sms;  // CTAs an SM, times the SMs
    if (dev < 64) known_smem[dev] = (int)smem, known_blocks[dev] = resident;
  }
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (a.n + kThreads - 1) / kThreads;
  blocks = min(blocks, (long long)resident);
  void* args[] = {&a};
  return (int)launch_cooperative((const void*)kernel, dim3((unsigned)max(1LL, blocks)),
                                 dim3(kThreads), args, smem, stream);
}

}  // namespace

// keys [n] int32 (EMPTY_KEY: a dead lane), vals [n, v] (dtype); the table
// tkeys [cap], tvals [cap, v] (accumulator type) and the int32 overflow are
// written: first as a copy of ikeys, ivals (accumulator type, contiguous)
// and iovf, or, when they are null, as a fresh table; rounds (u64) is
// added the rounds run.  Scratch: skey,
// smult, sidx [n + kSoloLanes] int32, svals [n, v] accumulator type, claim
// [2, cap] int32, live [max_probes + 1] int32 and gathered [1] int32, all
// written by the kernel before it reads them.  bits: the CTA table holds
// 2^bits slots (-1: no table).
// The grid is as many CTAs as can be resident at once, at most one per 256
// lanes.
// The wrapper never launches n = 0.
extern "C" int blaze_hash_aggregate(const void* keys, const void* vals, const void* ikeys,
                                    const void* ivals, const void* iovf, void* tkeys,
                                    void* tvals, void* overflow, void* rounds, void* skey,
                                    void* smult, void* sidx, void* svals, void* claim,
                                    void* live, void* gathered, long long n, int v, int cap, int max_probes,
                                    int bits, int dtype, int op, void* stream) {
  Args a{static_cast<const int*>(keys), vals, static_cast<const int*>(ikeys), ivals,
         static_cast<const int*>(iovf), static_cast<int*>(tkeys), tvals,
         static_cast<int*>(overflow), static_cast<unsigned long long*>(rounds),
         static_cast<int*>(skey), static_cast<int*>(smult), static_cast<int*>(sidx), svals,
         static_cast<int*>(claim), static_cast<int*>(live), static_cast<int*>(gathered), n, v,
         cap, max_probes, bits};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t slot_bytes = 2 * sizeof(int) + (size_t)v * 4;  // both accumulators are 4 bytes
  const size_t smem = bits < 0 ? 0 : slot_bytes << bits;
  if (smem > kMaxTableBytes) return (int)cudaErrorInvalidValue;
  BLAZE_DISPATCH(dtype, op, { return launch<InT, AccT, OP>(a, smem, s); });
  return (int)cudaErrorInvalidValue;
}
