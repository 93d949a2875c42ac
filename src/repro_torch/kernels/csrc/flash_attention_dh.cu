// K4's "dh" form on Hopper: decode attention with d_head sharded over the
// model axis, as two kernels on each rank's slice of d_head, one on each side
// of the all-reduce of the partial logits.
//
// Replaces the "dh" route of the reference's repro/kernels/ops.py::attention
// and attention_chunked (shard_hint="dh": the logits contracted over each
// device's slice of d_head and psummed over "model", then the softmax and
// the product with the device's slice of v), which on a TPU resolves to the
// Pallas kernel of repro/kernels/flash_attention.py::flash_attention
// (pallas_call at :135).  K4's own forms normalise inside the kernel, so they
// cannot sum partial logits across ranks; the all-reduce stays outside both
// kernels here (kernels/ops.py, a DTensor redistribute from Partial to
// Replicate).
//
// What they compute, for q [B, Hq, Sq, Dl], k, v [B, Hkv, Skv, Dl] (query
// head h reads kv head h / (Hq / Hkv)), Dl = d_head / model:
//   dh_logits:      out[b, h, i, j] = scale · Σ_{d < Dl} q[b, h, i, d]·k[b, h/rep, j, d]
//                   in f32 (kernels/ref.py::attention_logits);
//   dh_softmax_pv:  from the summed logits s, s ← softcap·tanh(s / softcap),
//                   masked (causal j > pos, window j <= pos − window, pos =
//                   q_offset + i) → dropped, p = softmax_j(s) in f32,
//                   out[b, h, i, :] = Σ_j p_j·v[b, h/rep, j, :] in the output
//                   dtype (kernels/ref.py::attention_from_logits).  A row with
//                   no live key gives zeros, as attention_ref does.
//
// What bounds them: both do about one flop a byte moved (a logit is Dl
// products of one key row of Dl elements; a key's weight is Dl products
// against its row of v), far under the ~295 the H100 needs before its
// tensor cores limit, so both are bound by the bytes of k or v (67.1 MB a
// call at gemma2-9b's decode_32k shard: [8, 8, 32768, 16] bf16) and of the
// f32 logits (16.8 MB), and run on the CUDA cores in exact f32.
//
// What the design does about it: every byte is read once, with copies in
// flight while the CTA computes, and one launch a call.
//  * A CTA is 8 consumer warps and, in the ring form, one producer warp.
//    The producer fills a ring of up to 4 stages in shared memory with
//    Hopper's bulk copy (tma_bulk.cuh): a stage holds a tile of 64 keys of a
//    group of kv heads in the operand's own dtype (converted as it is read).
//    In the cache's [B, S, Hkv, Dl] layout (read in place, through the
//    strides of its transposed view or of a local window's view) a key's
//    Dl elements of consecutive heads are one run, and a whole-Hkv group's
//    64 keys one run of 64 such rows (16 KB at gemma2's slice): one copy a
//    tile, else one a key, with an L2 evict-first hint (k and v are read
//    once; the logits, written and read again, keep the L2).  Other layouts,
//    or runs not 16-byte aligned, take the element form: the consumers load
//    each tile an element a load.
//  * dh_logits: two resident CTAs an SM, each walking a contiguous run of
//    (batch row, head group, key tile) items.  The group's query rows are
//    staged once as f32 (again only when the run crosses into the next
//    group); a thread keeps its columns' queries in registers: E elements
//    of one head's Dl (16, 8 or 4; Dl / E lanes a head add their sums by
//    shuffles), for 2 or 4 consecutive keys at a time, so that a warp reads
//    consecutive 16-byte chunks of the stage.  Other widths, or more than 2
//    rows a head, take a thread a (key, head), an element a load.  The
//    tile's logits go to a shared [rows][64] tile, then out along the keys
//    in 16-byte stores (double-buffered: one consumer barrier a tile).
//  * dh_softmax_pv: a grid of (splits, B, head groups), each split a
//    contiguous run of the live key tiles (tiles no row sees are never
//    read), sized so that the grid fills the SMs once with full rings.  A
//    stage also holds the tile's logits rows (the copy of a row starts at
//    the 16-byte boundary at or before its first key; keys the copy does
//    not reach are read from global memory).  A round of two tiles at a
//    time (one barrier a round): a half-warp a row takes the softcap, the
//    masks and the online softmax (running max, sum, rescale factor; weights
//    in f32 into a double-buffered shared tile), then the weights times v:
//    a thread two of a head's Dl for its rows (up to 2) over a block of the
//    round's keys, its sums kept in registers across rounds and the blocks
//    added in order at the end (more rows a head: a thread an output (row,
//    d), its sum in shared memory).  Each CTA writes its f32 partial (m, l,
//    acc[Dl]) and takes a
//    ticket (an acquire-release atomic) on its (batch row, head group)'s
//    counter; the CTA that draws the last ticket stages the group's
//    partials in its ring and merges them in split order, so the bits do
//    not depend on which CTA ends last:
//      out = Σ_s e^{m_s−M} acc_s / max(Σ_s e^{m_s−M} l_s, 1e-30), M = max m_s,
//    writes the output and sets the counter back to 0.  One split writes
//    acc / max(l, 1e-30), the same bits.  The counters are the wrapper's, a
//    buffer per (device, stream) zeroed once at first use: calls on one
//    stream run in order, and two calls in flight at once on two streams
//    use two buffers; no call adds a memset, and a captured call replays as
//    it is.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tma_bulk.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;                         // keys a tile
constexpr int kConsumers = 256;                   // 8 consumer warps
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;         // and one producer warp
constexpr int kMaxStages = 4;
constexpr int kLdp = kTile + 4;                   // floats a row of a logits or output tile
constexpr int kLdr = 2 * kTile + 4;               // floats a row of a round's weights
constexpr float kNegInf = -1e30f;                 // the running max before any live key
constexpr int kMaxWidth = 128;                    // elements of a staged key row, at most
constexpr long long kSmemMax = 232448 - 1024;     // dynamic shared memory a CTA may take
// The resident CTAs an SM each kernel is built for (register budget;
// flash_attention.py's DH_CTAS_PER_SM plans the grid and the ring with it):
// dh_logits' columns form at 8 or 4 elements a thread 3, its other forms 2
// (16 elements a thread hold 32 queries in registers); dh_softmax_pv 2.
template <int E>
constexpr int logits_ctas() { return E == 8 || E == 4 ? 3 : 2; }
constexpr int kPvCtas = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ long long a4(long long n) { return (n + 3) & ~3LL; }

// Dynamic shared memory of the two kernels in 4-byte words, for head groups
// of `hg` kv heads with `rpk` query rows each, elements of `es` bytes and
// `stages` stages (kernels/flash_attention.py::dh_smem_bytes mirrors these).
// A stage is 64 keys × hg·dl elements (a multiple of 16 words), in
// dh_softmax_pv followed by the tile's logits rows [rows][kLdp].
__host__ __device__ __forceinline__ long long logits_words(int hg, int rpk, int dl, int es,
                                                           int stages) {
  const long long rows = (long long)hg * rpk, w = (long long)hg * dl;
  return stages * 16 * w * es + a4(hg * (((long long)dl * rpk) | 1)) + 2 * rows * kLdp;
}
__host__ __device__ __forceinline__ long long pv_words(int hg, int rpk, int dl, int es,
                                                       int stages) {
  const long long rows = (long long)hg * rpk, w = (long long)hg * dl;
  // the ring, the weights [2][rows][kLdr], acc [rows·dl], rescale [2][rows],
  // running max, sum, the logits rows' offsets (8 bytes) and 4 ints a row
  return stages * (16 * w * es + kLdp * rows) + 2 * rows * kLdr + a4(rows * dl) +
         a4(2 * rows) + 2 * a4(rows) + 2 * a4(rows) + 4 * a4(rows);
}

// The most splits whose partials dh_softmax_pv's merge stages in its ring:
// splits·rows·(dl + 3) words at most (a partial row is dl + 2).
__host__ __device__ __forceinline__ long long merge_splits(int hg, int rpk, int dl, int es,
                                                           int stages) {
  const long long rows = (long long)hg * rpk, w = (long long)hg * dl;
  const long long ring = stages * (16 * w * es + kLdp * rows);
  const long long cap = (ring - 4) / (rows * (dl + 3));
  return cap > 1 ? cap : 1;
}

struct Src {  // a [B, H, S, Dl] operand read through its strides (elements)
  const void* p;
  long long sb, sh, ss, sd;
};

// atomicAdd(p, 1) with acquire and release semantics at the device's scope.
__device__ __forceinline__ int ticket_acq_rel(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// N elements of T from shared memory as f32, in one load of N·sizeof(T)
// bytes (the caller keeps the address aligned to it).
template <typename T, int N>
__device__ __forceinline__ void load_chunk(const T* p, float (&x)[N]) {
  constexpr int kBytes = N * int(sizeof(T));
  if constexpr (kBytes == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_f32(e[i]);
  } else if constexpr (kBytes == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_f32(e[i]);
  } else if constexpr (kBytes == 4 && N == 2) {
    const uint32_t r = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_f32(p[i]);
  }
}

// ---------------------------------------------------------------------------
// dh_logits.  Query row r of a head group is (hl·rep + g)·Sq + i: query head
// (h0 + hl)·rep + g at position i, so a group's rows are consecutive rows of
// the [B, Hq, Sq, Skv] output, and head hl's rpk = rep·Sq rows are
// hl·rpk .. hl·rpk + rpk − 1.
// ---------------------------------------------------------------------------
struct LogitsArgs {
  Src q, k;
  float* out;  // [B, Hq, Sq, Skv], contiguous
  int hq, hkv, sq, skv, dl, rep, hg, groups, n_tiles, stages;
  int elems;  // elements of a head a thread takes a key (columns form), 0: heads form
  long long items, per;
  float scale;
};

// E elements of T from shared memory as f32, 16 bytes a load at most.
template <typename T, int E>
__device__ __forceinline__ void load_elems(const T* p, float (&x)[E]) {
  constexpr int N = E * int(sizeof(T)) >= 16 ? 16 / int(sizeof(T)) : E;
#pragma unroll
  for (int c = 0; c < E / N; ++c) {
    float y[N];
    load_chunk<T, N>(p + c * N, y);
#pragma unroll
    for (int i = 0; i < N; ++i) x[c * N + i] = y[i];
  }
}

// The heads form, for any slice width and rows a head: a thread a (key,
// head) of the tile, an element a load, the queries from shared memory.
template <typename T>
__device__ __forceinline__ void logits_heads(const T* st, const float* qs, int qhs, float* o,
                                             int nh, int dl, int rpk, int nk, float scale) {
  const int w = nh * dl;
  for (int u = threadIdx.x; u < nh * nk; u += kConsumers) {
    const int hl = u % nh, kk = u / nh;
    const T* kr = st + kk * w + hl * dl;
    const float* qh = qs + hl * qhs;
    for (int i = 0; i < rpk; ++i) {
      float acc = 0.0f;
      for (int d = 0; d < dl; ++d) acc = fmaf(qh[d * rpk + i], to_f32(kr[d]), acc);
      o[(hl * rpk + i) * kLdp + kk] = acc * scale;
    }
  }
}

// The consumers' walk over a CTA's items.  The columns form (E > 0, at most
// RB rows a head): a thread a column, E elements of a head's dl (gpr = dl /
// E columns a head, a power of two, on consecutive lanes), with its rows'
// queries in registers, loaded once a head group; it takes KPT consecutive
// keys of a tile at a time (blocks kl, kl + kl_n, ...), the head's lanes add
// their sums by shuffles and its first lane stores the KPT logits of each
// row into the output tile (every lane runs every iteration: the shuffles
// take the whole warp).  Then a barrier and
// the tile's logits out along the keys, 16 bytes a store where rows are
// aligned; the output tile is double-buffered, so one barrier a tile.
template <typename T, bool RING, int E, int RB>
__device__ __forceinline__ void logits_consume(const LogitsArgs& a, float* smem, uint64_t* full,
                                               uint64_t* empty, long long i_begin, int n,
                                               int stage_words, float* qs, int qhs, float* ot) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int dl = a.dl, rpk = a.rep * a.sq, rows_max = a.hg * rpk;
  const T* qp = static_cast<const T*>(a.q.p);
  const T* kp = static_cast<const T*>(a.k.p);
  float qr[RB > 0 ? RB : 1][E > 0 ? E : 1];
  int gpr = 1, kl_n = 1, kl = 0, hl = 0, cg = 0;
  bool on = false;
  long long cur = -1;
  for (int i = 0; i < n; ++i) {
    const long long item = i_begin + i, bg = item / a.n_tiles;
    const int t = int(item - bg * a.n_tiles), g = int(bg % a.groups), b = int(bg / a.groups);
    const int h0 = g * a.hg, nh = min(a.hg, a.hkv - h0), j0 = t * kTile;
    const int nk = min(kTile, a.skv - j0), w = nh * dl, s = RING ? i % a.stages : 0;
    const int q_first = h0 * a.rep;
    const T* st = reinterpret_cast<const T*>(smem + (long long)s * stage_words);
    bool sync = false;
    if (bg != cur) {  // the group's query rows as f32 [hl][d][row] (the last tile's readers
                      // are past the barrier before its stores)
      for (int e = tid; e < nh * rpk * dl; e += kConsumers) {
        const int r = e / dl, d = e - r * dl, h = r / rpk;
        qs[h * qhs + d * rpk + (r - h * rpk)] =
            to_f32(qp[b * a.q.sb + (q_first + r / a.sq) * a.q.sh + (r % a.sq) * a.q.ss +
                      d * a.q.sd]);
      }
      sync = true;
    }
    if constexpr (!RING) {  // the element form: the tile an element a load
      T* dst = reinterpret_cast<T*>(smem);
      const T* base = kp + b * a.k.sb + (long long)j0 * a.k.ss;
#pragma unroll 4
      for (int e = tid; e < nk * w; e += kConsumers) {
        const int kk = e / w, c = e - kk * w, h = c / dl;
        dst[e] = base[kk * a.k.ss + (h0 + h) * a.k.sh + (c - h * dl) * a.k.sd];
      }
      sync = true;
    }
    if (sync) consumers_sync();
    if constexpr (E > 0) {
      if (bg != cur) {  // this thread's column and its queries
        gpr = dl / E;
        const int ncol = nh * gpr, col = tid % ncol;
        kl_n = kConsumers / ncol;
        kl = tid / ncol;
        on = kl < kl_n;
        hl = col / gpr;
        cg = col - hl * gpr;
#pragma unroll
        for (int j = 0; j < RB; ++j) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            qr[j][e] = j < rpk ? qs[hl * qhs + (cg * E + e) * rpk + j] : 0.0f;
        }
      }
    }
    cur = bg;
    if constexpr (RING) mbar_wait(&full[s], (i / a.stages) & 1);
    float* o = ot + (i & 1) * rows_max * kLdp;
    if constexpr (E > 0) {
      // KPT consecutive keys a thread at a time: their logits go out in one
      // shared-memory store a row
      constexpr int KPT = E == 4 ? 4 : 2;
      for (int kb = 0; kb < nk; kb += kl_n * KPT) {
        const int kk = kb + kl * KPT;
        float x[KPT][E];
#pragma unroll
        for (int u = 0; u < KPT; ++u) {
          if (on && kk + u < nk) {
            load_elems<T, E>(st + (kk + u) * w + hl * dl + cg * E, x[u]);
          } else {
#pragma unroll
            for (int e = 0; e < E; ++e) x[u][e] = 0.0f;
          }
        }
        float acc[RB][KPT];
#pragma unroll
        for (int j = 0; j < RB; ++j) {
#pragma unroll
          for (int u = 0; u < KPT; ++u) {
            acc[j][u] = 0.0f;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[j][u] = fmaf(qr[j][e], x[u][e], acc[j][u]);
          }
        }
        for (int off = 1; off < gpr; off <<= 1) {
#pragma unroll
          for (int j = 0; j < RB; ++j) {
#pragma unroll
            for (int u = 0; u < KPT; ++u)
              acc[j][u] += __shfl_xor_sync(0xffffffffu, acc[j][u], off);
          }
        }
        if (on && cg == 0 && kk < nk) {
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            if (j >= rpk) break;
            float* orow = o + (hl * rpk + j) * kLdp + kk;
            if (kk + KPT <= nk) {
              if constexpr (KPT == 4)
                *reinterpret_cast<float4*>(orow) = make_float4(
                    acc[j][0] * a.scale, acc[j][1] * a.scale, acc[j][2] * a.scale,
                    acc[j][3] * a.scale);
              else
                *reinterpret_cast<float2*>(orow) =
                    make_float2(acc[j][0] * a.scale, acc[j][1] * a.scale);
            } else {
#pragma unroll
              for (int u = 0; u < KPT; ++u)
                if (kk + u < nk) orow[u] = acc[j][u] * a.scale;
            }
          }
        }
      }
    } else {
      logits_heads<T>(st, qs, qhs, o, nh, dl, rpk, nk, a.scale);
    }
    if constexpr (RING) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // the warp is done with the stage
    }
    consumers_sync();
    const int rows = nh * rpk;
    float* out = a.out + (((long long)b * a.hq + q_first) * a.sq) * a.skv + j0;
    const bool vec = (a.skv & 3) == 0;
    for (int e = tid; e < rows * (kTile / 4); e += kConsumers) {
      const int r = e >> 4, c = (e & 15) * 4;
      if (c >= nk) continue;
      const float* src = o + r * kLdp + c;
      float* dst = out + (long long)r * a.skv + c;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else {
        for (int x = 0; x < 4 && c + x < nk; ++x) dst[x] = src[x];
      }
    }
  }
}

// One kernel a form: T, RING, and E and RB of the columns form (0, 0: the
// heads form), so that each keeps only its own registers.
template <typename T, bool RING, int E, int RB>
__global__ void __launch_bounds__(kThreads, logits_ctas<E>())
    dh_logits_kernel(const LogitsArgs a) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  constexpr int es = int(sizeof(T));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rpk = a.rep * a.sq;
  const int stage_words = 16 * a.hg * a.dl * es;
  const int qhs = (a.dl * rpk) | 1;  // an odd stride between heads' staged queries
  float* qs = smem + (long long)a.stages * stage_words;       // [hg][dl][rpk]
  float* ot = qs + a4((long long)a.hg * qhs);                  // [2][rows_max][kLdp]
  const long long i_begin = blockIdx.x * a.per;
  const int n = int(min(a.items, i_begin + a.per) - i_begin);
  if constexpr (RING) {
    if (tid == 0) {
      for (int s = 0; s < a.stages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kConsumerWarps);
      }
      mbar_fence_init();
    }
    __syncthreads();
    if (warp == kConsumerWarps) {  // the producer keeps the ring full
      for (int i = 0; i < n; ++i) {
        const long long item = i_begin + i, bg = item / a.n_tiles;
        const int t = int(item - bg * a.n_tiles), g = int(bg % a.groups), b = int(bg / a.groups);
        const int h0 = g * a.hg, nh = min(a.hg, a.hkv - h0), j0 = t * kTile;
        const int nk = min(kTile, a.skv - j0), s = i % a.stages;
        const uint32_t key_bytes = uint32_t(nh * a.dl * es);
        if (lane == 0) {
          if (i >= a.stages) mbar_wait(&empty[s], ((i / a.stages) - 1) & 1);
          mbar_arrive_expect_tx(&full[s], uint32_t(nk) * key_bytes);
        }
        __syncwarp();
        const char* src = static_cast<const char*>(a.k.p) +
                          (b * a.k.sb + h0 * a.k.sh + (long long)j0 * a.k.ss) * es;
        char* dst = reinterpret_cast<char*>(smem + (long long)s * stage_words);
        if (a.k.ss == (long long)nh * a.dl) {  // the tile's keys are one run
          if (lane == 0) bulk_copy_g2s_evict_first(dst, src, uint32_t(nk) * key_bytes, &full[s]);
        } else {
          for (int kk = lane; kk < nk; kk += 32)
            bulk_copy_g2s_evict_first(dst + kk * key_bytes, src + kk * a.k.ss * es, key_bytes,
                                      &full[s]);
        }
      }
      return;
    }
  }
  if (warp == kConsumerWarps) return;  // the element form has no producer
  logits_consume<T, RING, E, RB>(a, smem, full, empty, i_begin, n, stage_words, qs, qhs, ot);
}

// ---------------------------------------------------------------------------
// dh_softmax_pv: grid (splits, B, head groups).  Split s walks key tiles
// [t_lo + s·per, min(t_hi, t_lo + (s + 1)·per)); warp w owns rows w, w + 8,
// ... for the running max and sum.  Partials: ws[(b·groups + g)·splits +
// s][row][m, l, acc[Dl]], rows spaced for a full group.
// ---------------------------------------------------------------------------
struct PvArgs {
  const float* lg;  // summed logits [B, Hq, Sq, Skv] f32, through its strides
  long long l_sb, l_sh, l_ss, l_sk, l_extent;  // l_extent: floats from lg the view spans
  Src v;
  void* out;
  float* ws;
  int* tickets;
  int hq, hkv, sq, skv, dl, rep, hg, groups, stages;
  int causal, has_window, window, q_offset;
  float softcap;
  int t_lo, t_hi, splits, per;
};

// n elements from global memory (L2) into shared memory by the consumers,
// each thread's loads all issued before its stores (12 a thread at a time).
template <typename V>
__device__ __forceinline__ void stage_l2(V* dst, const V* src, int n) {
  constexpr int kBatch = 12;
  for (int base = threadIdx.x; base < n; base += kBatch * kConsumers) {
    V r[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (base + u * kConsumers < n) r[u] = __ldcg(src + base + u * kConsumers);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (base + u * kConsumers < n) dst[base + u * kConsumers] = r[u];
  }
}

// The floats [a0, a1) of a logits row a ring stage holds for keys j0 .. j0 +
// nk − 1 of the row at element offset `roff` (l_sk = 1): from the 16-byte
// boundary at or before the first key to the one at or after the last,
// within the view; at most kLdp floats.
__device__ __forceinline__ void row_copy(long long roff, int j0, int nk, long long extent,
                                         long long& a0, long long& a1) {
  const long long e0 = roff + j0;
  a0 = e0 & ~3LL;
  a1 = min((e0 + nk + 3) & ~3LL, extent & ~3LL);
}

struct PvShared {  // a CTA's shared-memory state (dh_softmax_pv_kernel lays it out)
  float* ring;      // the stages: v tile [64][hg·dl] in v's dtype, then logits rows
  float* P;         // weights [2][rows_max][kLdr]
  float* acc;       // [rows·dl]
  float* C;         // rescale factors [2][rows_max]
  float* M;         // running max
  float* L;         // running sum
  long long* roff;  // a row's logits offset
  int* live;        // a row's [lo, hi, lim, d0]
  int stage_words, v_words, rows, rows_max, rpk, w, h0, b;
};

// Softcap, masks and the online softmax of one round of NT tiles (1 or 2,
// the second absent where lt[1] is null): a half-warp a row, a lane 4 keys
// of each tile.  Keys outside the row's live range [lo, hi) get -inf (weight
// 0); a tile wholly live and staged takes no per-key test.  The round's
// weights go to the row's kLdr floats of Pi, its rescale factor to Ci.
template <bool RING>
__device__ __forceinline__ void pv_softmax(const PvArgs& a, const PvShared& c,
                                           const float* const (&lt)[2], float* Pi, float* Ci,
                                           int j0, float inv_cap) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, l16 = lane & 15;
  const int kk = 4 * l16;
  for (int r0 = 2 * warp; r0 < c.rows; r0 += 2 * kConsumerWarps) {
    const int r = r0 + (lane >> 4);
    const bool on = r < c.rows;
    float x[8];
    bool lv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      x[u] = -CUDART_INF_F;
      lv[u] = false;
    }
    if (on) {
      const int lo = c.live[4 * r], hi = c.live[4 * r + 1], lim = c.live[4 * r + 2];
      const int d0 = c.live[4 * r + 3];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (lt[t] == nullptr) break;
        const int jt = j0 + t * kTile, j = jt + kk;
        const float* lr = lt[t] + r * kLdp + d0 + kk;
        if (jt >= lo && jt + kTile <= min(hi, lim)) {
          if (d0 == 0) {  // the row's copy starts at its first key: 16-byte loads
            const float4 v4 = *reinterpret_cast<const float4*>(lr);
            x[4 * t] = v4.x, x[4 * t + 1] = v4.y, x[4 * t + 2] = v4.z, x[4 * t + 3] = v4.w;
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) x[4 * t + u] = lr[u];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) lv[4 * t + u] = true;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            lv[4 * t + u] = j + u >= lo && j + u < hi;
            if (lv[4 * t + u])
              x[4 * t + u] =
                  j + u < lim ? lr[u] : __ldg(a.lg + c.roff[r] + (long long)(j + u) * a.l_sk);
          }
        }
      }
    }
    if (a.softcap > 0.0f) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (lv[u]) x[u] = a.softcap * tanhf(x[u] * inv_cap);
    }
    float mx = x[0];
#pragma unroll
    for (int u = 1; u < 8; ++u) mx = fmaxf(mx, x[u]);
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_old = on ? c.M[r] : kNegInf, m_new = fmaxf(m_old, mx);
    float p[8], sum = 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      p[u] = expf(x[u] - m_new);
      sum += p[u];
    }
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (on) {
      float* pr = Pi + r * kLdr + kk;
      *reinterpret_cast<float4*>(pr) = make_float4(p[0], p[1], p[2], p[3]);
      if (lt[1] != nullptr)
        *reinterpret_cast<float4*>(pr + kTile) = make_float4(p[4], p[5], p[6], p[7]);
      if (l16 == 0) {
        const float cr = expf(m_old - m_new);
        Ci[r] = cr;
        c.L[r] = c.L[r] * cr + sum;
        c.M[r] = m_new;
      }
    }
  }
}

// DV consecutive elements of v as f32 (a bf16 pair is one 4-byte load).
template <typename T, int DV>
__device__ __forceinline__ void load_v(const T* p, float (&x)[DV]) {
  if constexpr (DV == 2 && sizeof(T) == 2) {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    x[0] = __uint_as_float(u << 16);
    x[1] = __uint_as_float(u & 0xffff0000u);
  } else if constexpr (DV == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = to_f32(p[0]);
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// The consumers' walk over a CTA's tiles, a round of two tiles at a time in
// the ring form (one in the element form, or at an odd end): wait for the
// round's stages (or load the tile), the softmax, a barrier, the weights
// times v, release.  The columns form (RB > 0, at most RB rows a head): a
// thread a column, DV elements of a head's dl, over a block of kb keys of
// the round (kb dividing the tile, so that a block lies in one stage; a
// warp's lanes on one block read one key row), keeping its head's rows'
// sums in registers across rounds (rescaled a round at a time); at the end
// the blocks are added into acc in block order.  RB = 0: a thread an output
// (row, d) over all the round's keys, its sum in acc.
template <typename T, bool RING, int DV, int RB>
__device__ __forceinline__ void pv_consume(const PvArgs& a, const PvShared& c, uint64_t* full,
                                           uint64_t* empty, int n, int t_begin) {
  constexpr int kRound = RING ? 2 : 1;  // tiles a round
  const int tid = threadIdx.x, lane = tid & 31, dl = a.dl, rpk = c.rpk, w = c.w;
  const T* vp = static_cast<const T*>(a.v.p);
  const float inv_cap = a.softcap > 0.0f ? 1.0f / a.softcap : 0.0f;
  const int ngrp = dl / DV, ncols = (c.rows / rpk) * ngrp;
  const int nq0 = min(8, kConsumers / ncols);
  int kb = 4;  // the fewest keys a block, a power of two, that nq0 blocks cover a round with
  while (kb < kTile && kb * nq0 < kRound * kTile) kb *= 2;
  const int nq = kRound * kTile / kb;
  const int q = tid / ncols, col = tid - q * ncols, hl = col / ngrp, d = (col - hl * ngrp) * DV;
  const bool act = RB > 0 && q < nq;
  float sums[RB > 0 ? RB : 1][DV];
#pragma unroll
  for (int jj = 0; jj < (RB > 0 ? RB : 1); ++jj) {
#pragma unroll
    for (int e = 0; e < DV; ++e) sums[jj][e] = 0.0f;
  }
  for (int i = 0, round = 0; i < n; i += kRound, ++round) {
    const int nt = min(kRound, n - i), j0 = (t_begin + i) * kTile;
    int s[2] = {0, 0};
    const T* vt[2] = {nullptr, nullptr};
    const float* lt[2] = {nullptr, nullptr};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t < nt) {
        s[t] = RING ? (i + t) % a.stages : 0;
        vt[t] = reinterpret_cast<const T*>(c.ring + (long long)s[t] * c.stage_words);
        lt[t] = c.ring + (long long)s[t] * c.stage_words + c.v_words;
        if constexpr (RING) mbar_wait(&full[s[t]], ((i + t) / a.stages) & 1);
      }
    }
    if constexpr (!RING) {  // the element form: the tile's v and logits an element a load
      const int nk = min(kTile, a.skv - j0);
      T* vdst = reinterpret_cast<T*>(c.ring);
      float* ldst = c.ring + c.v_words;
      const T* base = vp + c.b * a.v.sb + (long long)j0 * a.v.ss;
#pragma unroll 4
      for (int e = tid; e < nk * w; e += kConsumers) {
        const int kk = e / w, cc = e - kk * w, h = cc / dl;
        vdst[e] = base[kk * a.v.ss + (c.h0 + h) * a.v.sh + (cc - h * dl) * a.v.sd];
      }
#pragma unroll 4
      for (int e = tid; e < c.rows * nk; e += kConsumers) {
        const int r = e / nk, kk = e - r * nk;
        ldst[r * kLdp + kk] = a.lg[c.roff[r] + (long long)(j0 + kk) * a.l_sk];
      }
      consumers_sync();
    }
    float* Pi = c.P + (round & 1) * c.rows_max * kLdr;
    float* Ci = c.C + (round & 1) * c.rows_max;
    pv_softmax<RING>(a, c, lt, Pi, Ci, j0, inv_cap);
    consumers_sync();
    if constexpr (RB > 0) {
      if (act) {
        const int t = q * kb / kTile, k0 = q * kb - t * kTile;
        float tsum[RB][DV];
#pragma unroll
        for (int jj = 0; jj < RB; ++jj) {
#pragma unroll
          for (int e = 0; e < DV; ++e) tsum[jj][e] = 0.0f;
        }
        if (t < nt) {
          const int nk = min(kTile, a.skv - (j0 + t * kTile)), k1 = min(k0 + kb, nk);
          const T* vc = (t == 0 ? vt[0] : vt[1]) + hl * dl + d;
          const float* pr = Pi + hl * rpk * kLdr + t * kTile;
          if (k1 - k0 == kb) {
            for (int kk = k0; kk < k1; kk += 4) {
              float4 pp[RB];
#pragma unroll
              for (int jj = 0; jj < RB; ++jj)
                pp[jj] = jj < rpk ? *reinterpret_cast<const float4*>(pr + jj * kLdr + kk)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                float vv[DV];
                load_v<T, DV>(vc + (kk + u) * w, vv);
#pragma unroll
                for (int jj = 0; jj < RB; ++jj) {
#pragma unroll
                  for (int e = 0; e < DV; ++e)
                    tsum[jj][e] = fmaf(lane_of(pp[jj], u), vv[e], tsum[jj][e]);
                }
              }
            }
          } else {
            for (int kk = k0; kk < k1; ++kk) {
              float vv[DV];
              load_v<T, DV>(vc + kk * w, vv);
#pragma unroll
              for (int jj = 0; jj < RB; ++jj) {
                const float pj = jj < rpk ? pr[jj * kLdr + kk] : 0.0f;
#pragma unroll
                for (int e = 0; e < DV; ++e) tsum[jj][e] = fmaf(pj, vv[e], tsum[jj][e]);
              }
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < RB; ++jj) {
          const float cr = jj < rpk ? Ci[hl * rpk + jj] : 0.0f;
#pragma unroll
          for (int e = 0; e < DV; ++e) sums[jj][e] = fmaf(sums[jj][e], cr, tsum[jj][e]);
        }
      }
    } else {
      for (int e = tid; e < c.rows * dl; e += kConsumers) {
        const int r = e / dl, dd = e - r * dl;
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t >= nt) break;
          const int nk = min(kTile, a.skv - (j0 + t * kTile));
          const float* pr = Pi + r * kLdr + t * kTile;
          const T* vc = vt[t] + (r / rpk) * dl + dd;
          if (nk == kTile) {
#pragma unroll 4
            for (int kk = 0; kk < kTile; kk += 4) {
              const float4 pp = *reinterpret_cast<const float4*>(pr + kk);
              s0 = fmaf(pp.x, to_f32(vc[kk * w]), s0);
              s1 = fmaf(pp.y, to_f32(vc[(kk + 1) * w]), s1);
              s2 = fmaf(pp.z, to_f32(vc[(kk + 2) * w]), s2);
              s3 = fmaf(pp.w, to_f32(vc[(kk + 3) * w]), s3);
            }
          } else {
            for (int kk = 0; kk < nk; ++kk) s0 = fmaf(pr[kk], to_f32(vc[kk * w]), s0);
          }
        }
        c.acc[e] = c.acc[e] * Ci[r] + ((s0 + s1) + (s2 + s3));
      }
    }
    if constexpr (RING) {
      __syncwarp();
      if (lane == 0) {  // the warp is done with the round's stages
        mbar_arrive(&empty[s[0]]);
        if (nt == 2) mbar_arrive(&empty[s[1]]);
      }
    } else {
      consumers_sync();  // the next tile is loaded over this one
    }
  }
  if constexpr (RB > 0) {  // the blocks into acc, in block order
    for (int qq = 0; qq < nq; ++qq) {
      consumers_sync();
      if (act && q == qq) {
#pragma unroll
        for (int jj = 0; jj < RB; ++jj) {
#pragma unroll
          for (int e = 0; e < DV; ++e)
            if (jj < rpk) c.acc[(hl * rpk + jj) * dl + d + e] += sums[jj][e];
        }
      }
    }
  }
}

// One kernel a form: T, RING, and DV and RB of the columns form (1, 0: a
// thread an output).
template <typename T, bool RING, int DV, int RB>
__global__ void __launch_bounds__(kThreads, kPvCtas) dh_softmax_pv_kernel(const PvArgs a) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ int last;
  constexpr int es = int(sizeof(T));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int h0 = g * a.hg, nh = min(a.hg, a.hkv - h0), rpk = a.rep * a.sq;
  const int rows = nh * rpk, rows_max = a.hg * rpk, w = nh * a.dl, dl = a.dl;
  const int v_words = 16 * a.hg * dl * es, stage_words = v_words + kLdp * rows_max;
  float* P = smem + (long long)a.stages * stage_words;  // weights [2][rows_max][kLdr]
  float* acc = P + 2 * rows_max * kLdr;                  // [rows_max·dl]
  float* C = acc + a4((long long)rows_max * dl);         // rescale factors [2][rows_max]
  float* M = C + a4(2 * rows_max);
  float* L = M + a4(rows_max);
  long long* roff = reinterpret_cast<long long*>(L + a4(rows_max));
  int* live = reinterpret_cast<int*>(roff + a4(rows_max));  // [rows_max][lo, hi, lim, d0]
  const int q_first = h0 * a.rep;
  const int t_begin = a.t_lo + split * a.per, n = max(0, min(a.t_hi, t_begin + a.per) - t_begin);
  if constexpr (RING) {
    if (tid == 0) {
      for (int s = 0; s < a.stages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kConsumerWarps);
      }
      mbar_fence_init();
    }
  }
  // Per row: its logits' offset; its live keys [lo, hi); in the ring form
  // the keys below lim in its stage rows, from float d0 of a row on (the
  // copy starts at the 16-byte boundary at or before the row's first key).
  for (int r = tid; r < rows; r += kThreads) {
    const int i = r % a.sq, p = a.q_offset + i;
    const long long off = b * a.l_sb + (q_first + r / a.sq) * a.l_sh + i * a.l_ss;
    roff[r] = off;
    live[4 * r] = a.has_window ? max(0, p - a.window + 1) : 0;
    live[4 * r + 1] = a.causal ? min(a.skv, max(p + 1, 0)) : a.skv;
    live[4 * r + 2] = RING ? int(min(max((a.l_extent & ~3LL) - off, 0LL), (long long)a.skv))
                           : a.skv;
    live[4 * r + 3] = RING ? int(off & 3) : 0;
    M[r] = kNegInf;
    L[r] = 0.0f;
  }
  for (int e = tid; e < rows * dl; e += kThreads) acc[e] = 0.0f;
  __syncthreads();
  if constexpr (RING) {
    if (warp == kConsumerWarps) {  // the producer keeps the ring full
      for (int i = 0; i < n; ++i) {
        const int s = i % a.stages, j0 = (t_begin + i) * kTile, nk = min(kTile, a.skv - j0);
        float* stage = smem + (long long)s * stage_words;
        uint32_t bytes = 0;
        for (int r = lane; r < rows; r += 32) {
          long long a0, a1;
          row_copy(roff[r], j0, nk, a.l_extent, a0, a1);
          if (a1 > a0) bytes += uint32_t(a1 - a0) * 4;
        }
        bytes = __reduce_add_sync(0xffffffffu, bytes);
        const uint32_t key_bytes = uint32_t(w * es);
        if (lane == 0) {
          if (i >= a.stages) mbar_wait(&empty[s], ((i / a.stages) - 1) & 1);
          mbar_arrive_expect_tx(&full[s], bytes + uint32_t(nk) * key_bytes);
        }
        __syncwarp();
        const char* src = static_cast<const char*>(a.v.p) +
                          (b * a.v.sb + h0 * a.v.sh + (long long)j0 * a.v.ss) * es;
        char* dst = reinterpret_cast<char*>(stage);
        if (a.v.ss == (long long)w) {  // the tile's keys are one run
          if (lane == 0) bulk_copy_g2s_evict_first(dst, src, uint32_t(nk) * key_bytes, &full[s]);
        } else {
          for (int kk = lane; kk < nk; kk += 32)
            bulk_copy_g2s_evict_first(dst + kk * key_bytes, src + kk * a.v.ss * es, key_bytes,
                                      &full[s]);
        }
        for (int r = lane; r < rows; r += 32) {
          long long a0, a1;
          row_copy(roff[r], j0, nk, a.l_extent, a0, a1);
          if (a1 > a0)
            bulk_copy_g2s(stage + v_words + r * kLdp, a.lg + a0, uint32_t(a1 - a0) * 4, &full[s]);
        }
      }
      return;
    }
  }
  if (warp == kConsumerWarps) return;  // the element form has no producer
  const PvShared c{smem, P, acc, C, M, L, roff, live, stage_words, v_words, rows, rows_max,
                   rpk, w, h0, b};
  pv_consume<T, RING, DV, RB>(a, c, full, empty, n, t_begin);
  consumers_sync();
  const long long row0 = ((long long)b * a.hq + q_first) * a.sq;
  T* out = static_cast<T*>(a.out) + row0 * dl;
  if (a.splits == 1) {  // the merge of one partial, the same bits
    for (int e = tid; e < rows * dl; e += kConsumers)
      out[e] = from_f32<T>(acc[e] / fmaxf(L[e / dl], 1e-30f));
    return;
  }
  const int pw = rows_max * (dl + 2);  // floats a split's partial
  const long long slot = (long long)b * a.groups + g;
  float* part = a.ws + (slot * a.splits + split) * pw;
  for (int r = tid; r < rows; r += kConsumers) {
    part[r * (dl + 2)] = M[r];
    part[r * (dl + 2) + 1] = L[r];
  }
  for (int e = tid; e < rows * dl; e += kConsumers) {
    const int r = e / dl;
    part[r * (dl + 2) + 2 + (e - r * dl)] = acc[e];
  }
  // The barrier orders every thread's partial before thread 0's ticket, a
  // release; the ticket's acquire, then the barrier, order the last CTA's
  // reads after every other CTA's partial.
  consumers_sync();
  if (tid == 0) last = ticket_acq_rel(a.tickets + slot) == a.splits - 1;
  consumers_sync();
  if (!last) return;
  // The last CTA of the group: every partial is written.  They are staged
  // in the ring (free now: every copy has landed; dh_plan keeps the splits
  // within it); a thread an output takes M over the splits, then sums l and
  // acc in split order.
  const float* src = a.ws + slot * a.splits * pw;
  const int words = a.splits * pw;
  if (pw % 4 == 0)
    stage_l2(reinterpret_cast<float4*>(smem), reinterpret_cast<const float4*>(src), words / 4);
  else
    stage_l2(smem, src, words);
  consumers_sync();
  for (int e = tid; e < rows * dl; e += kConsumers) {
    const int r = e / dl, d = e - r * dl;
    const float* pr = smem + r * (dl + 2);  // split s's m, l, acc at pr[s·pw]
    float mx = kNegInf;
#pragma unroll 4
    for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, pr[s * pw]);
    float l = 0.0f, num = 0.0f;
#pragma unroll 4
    for (int s = 0; s < a.splits; ++s) {
      const float wv = expf(pr[s * pw] - mx);
      l = fmaf(wv, pr[s * pw + 1], l);
      num = fmaf(wv, pr[s * pw + 2 + d], num);
    }
    out[e] = from_f32<T>(num / fmaxf(l, 1e-30f));
  }
  if (tid == 0) a.tickets[slot] = 0;  // ready for the next call on this stream
}

// Past 48 KB of dynamic shared memory a kernel must opt in: once per kernel
// and device, for the most any launch takes.
template <typename Args, void (*K)(Args)>
int launch(dim3 grid, long long words, const Args& a, cudaStream_t s) {
  static bool opted[64] = {};
  const long long bytes = words * 4;
  if (bytes > kSmemMax) return int(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev < 0 || dev >= 64) return int(cudaErrorInvalidDevice);
  if (bytes > 48 * 1024 && !opted[dev]) {
    err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemMax));
    if (err != cudaSuccess) return int(err);
    opted[dev] = true;
  }
  K<<<grid, kThreads, size_t(bytes), s>>>(a);
  return int(cudaGetLastError());
}

// The logits kernel of a form: E elements a thread and RB rows a head where
// the columns form takes the shape (Dl by E into a power of two of columns,
// at most 2 rows a head), else the heads form.
template <typename T, bool RING>
int launch_logits(int e, int rpk, dim3 grid, long long words, const LogitsArgs& a,
                  cudaStream_t s) {
#define BLAZE_LOGITS(E, RB) \
  if (e == E && rpk == RB)  \
    return launch<LogitsArgs, dh_logits_kernel<T, RING, E, RB>>(grid, words, a, s);
  BLAZE_LOGITS(16, 1) BLAZE_LOGITS(16, 2) BLAZE_LOGITS(8, 1) BLAZE_LOGITS(8, 2)
  BLAZE_LOGITS(4, 1) BLAZE_LOGITS(4, 2)
#undef BLAZE_LOGITS
  return launch<LogitsArgs, dh_logits_kernel<T, RING, 0, 0>>(grid, words, a, s);
}

// The softmax_pv kernel of a form: DV = 2 where Dl is even, RB = the rows a
// head where at most 2, else a thread an output.
template <typename T, bool RING>
int launch_pv(int dl, int rpk, dim3 grid, long long words, const PvArgs& a, cudaStream_t s) {
  if (rpk == 1)
    return dl % 2 ? launch<PvArgs, dh_softmax_pv_kernel<T, RING, 1, 1>>(grid, words, a, s)
                  : launch<PvArgs, dh_softmax_pv_kernel<T, RING, 2, 1>>(grid, words, a, s);
  if (rpk == 2)
    return dl % 2 ? launch<PvArgs, dh_softmax_pv_kernel<T, RING, 1, 2>>(grid, words, a, s)
                  : launch<PvArgs, dh_softmax_pv_kernel<T, RING, 2, 2>>(grid, words, a, s);
  return launch<PvArgs, dh_softmax_pv_kernel<T, RING, 1, 0>>(grid, words, a, s);
}

bool bad_shape(int batch, int hq, int hkv, int sq, int skv, int dl, int hg, int stages) {
  return batch < 1 || batch > 65535 || hkv < 1 || hq % hkv || sq < 1 || skv < 1 || dl < 1 ||
         hg < 1 || hg > hkv || (long long)hg * dl > kMaxWidth || (hkv + hg - 1) / hg > 65535 ||
         stages < 1 || stages > kMaxStages;
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

// What a bulk copy of a group's key rows needs (the wrapper's
// flash_attention._dh_ring): the heads of a key adjacent, d contiguous, and
// every run 16-byte aligned.
bool ring_refuses(const Src& x, int hkv, int hg, int dl, int es) {
  return misaligned(x.p) || (hkv > 1 && x.sh != dl) || (dl > 1 && x.sd != 1) ||
         (x.sb * es) % 16 || (x.ss * es) % 16 || ((long long)hg * dl * es) % 16 ||
         ((long long)hkv * dl * es) % 16;
}

}  // namespace

// The dynamic shared memory in bytes a CTA of dh_logits (kernel 0) or
// dh_softmax_pv (kernel 1) takes (kernels/flash_attention.py::dh_smem_bytes
// plans with the same formula; a card test holds the two equal).
extern "C" long long blaze_dh_smem_bytes(int kernel, int hg, int rpk, int dl, int es,
                                         int stages) {
  return 4 * (kernel ? pv_words(hg, rpk, dl, es, stages) : logits_words(hg, rpk, dl, es, stages));
}

// Strides are in elements, 0 along a dimension of size 1.  The wrapper
// (kernels/flash_attention.py) checks shapes, dtypes and devices, takes the
// plan (head group `hg`, `stages`, `grid` CTAs of `per` items) from
// dh_plan, `ring` from the strides and `elems` (a thread's elements of a
// head a key, 0 for the heads form) from Dl, and allocates the contiguous
// f32 output.
extern "C" int blaze_dh_logits(
    const void* q, const void* k, void* out,
    long long q_sb, long long q_sh, long long q_ss, long long q_sd,
    long long k_sb, long long k_sh, long long k_ss, long long k_sd,
    int batch, int hq, int hkv, int sq, int skv, int dl, int hg, int ring, int stages,
    int elems, int grid, long long per, int is_bf16, float scale, void* stream) {
  if (bad_shape(batch, hq, hkv, sq, skv, dl, hg, stages) || grid < 1 || per < 1 ||
      (elems && (elems < 4 || elems > 16 || elems & (elems - 1) || dl % elems ||
                 (dl / elems) & (dl / elems - 1))))
    return int(cudaErrorInvalidValue);
  const int groups = (hkv + hg - 1) / hg, n_tiles = (skv + kTile - 1) / kTile, es = is_bf16 ? 2 : 4;
  const long long items = (long long)batch * groups * n_tiles;
  if ((long long)grid * per < items || (long long)(grid - 1) * per >= items)
    return int(cudaErrorInvalidValue);
  const Src qs{q, q_sb, q_sh, q_ss, q_sd}, ks{k, k_sb, k_sh, k_ss, k_sd};
  if (ring && (stages < 2 || ring_refuses(ks, hkv, hg, dl, es))) return int(cudaErrorInvalidValue);
  const LogitsArgs a{qs, ks, static_cast<float*>(out), hq, hkv, sq, skv, dl, hq / hkv, hg, groups,
                     n_tiles, stages, elems, items, per, scale};
  const long long words = logits_words(hg, a.rep * sq, dl, es, stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rpk = a.rep * sq;
  if (is_bf16)
    return ring ? launch_logits<bf16, true>(elems, rpk, dim3(grid), words, a, s)
                : launch_logits<bf16, false>(elems, rpk, dim3(grid), words, a, s);
  return ring ? launch_logits<float, true>(elems, rpk, dim3(grid), words, a, s)
              : launch_logits<float, false>(elems, rpk, dim3(grid), words, a, s);
}

// `splits` CTAs a (batch row, head group), each over `per` of the live key
// tiles [t_lo, t_hi); with more than one split, ws holds splits·B·groups·
// hg·(Hq/Hkv)·Sq·(Dl + 2) floats and tickets B·groups zeroed ints (each
// call leaves them zero); out is the contiguous [B, Hq, Sq, Dl] output in
// v's dtype.  One launch.
extern "C" int blaze_dh_softmax_pv(
    const void* logits, const void* v, void* out, void* ws, void* tickets,
    long long l_sb, long long l_sh, long long l_ss, long long l_sk, long long l_extent,
    long long v_sb, long long v_sh, long long v_ss, long long v_sd,
    int batch, int hq, int hkv, int sq, int skv, int dl, int hg, int ring, int stages,
    int is_bf16, int causal, int has_window, int window, int q_offset, float softcap,
    int t_lo, int t_hi, int splits, int per, void* stream) {
  if (bad_shape(batch, hq, hkv, sq, skv, dl, hg, stages) || splits < 1 || splits > 65535 ||
      per < 1 || (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return int(cudaErrorInvalidValue);
  const int groups = (hkv + hg - 1) / hg, es = is_bf16 ? 2 : 4;
  const Src vs{v, v_sb, v_sh, v_ss, v_sd};
  if (splits > merge_splits(hg, hq / hkv * sq, dl, es, stages)) return int(cudaErrorInvalidValue);
  if (ring && (stages < 2 || ring_refuses(vs, hkv, hg, dl, es) || misaligned(logits) ||
               (skv > 1 && l_sk != 1)))
    return int(cudaErrorInvalidValue);
  const PvArgs a{static_cast<const float*>(logits), l_sb, l_sh, l_ss, l_sk, l_extent, vs, out,
                 static_cast<float*>(ws), static_cast<int*>(tickets), hq, hkv, sq, skv, dl,
                 hq / hkv, hg, groups, stages, causal, has_window, window, q_offset, softcap,
                 t_lo, t_hi, splits, per};
  const dim3 grid(splits, batch, groups);
  const long long words = pv_words(hg, a.rep * sq, dl, es, stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rpk = a.rep * sq;
  if (is_bf16)
    return ring ? launch_pv<bf16, true>(dl, rpk, grid, words, a, s)
                : launch_pv<bf16, false>(dl, rpk, grid, words, a, s);
  return ring ? launch_pv<float, true>(dl, rpk, grid, words, a, s)
              : launch_pv<float, false>(dl, rpk, grid, words, a, s);
}
