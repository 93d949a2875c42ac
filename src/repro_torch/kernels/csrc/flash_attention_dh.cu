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
// What the design does about it: every byte is read once, coalesced, with
// enough CTAs and loads in flight to fill the card.
//  * A CTA stages a tile of 64 keys for a group of kv heads as f32 in shared
//    memory.  In the cache's own [B, S, Hkv, Dl] layout (read in place,
//    through the strides of its transposed view or of a local window's view)
//    those heads' Dl elements of a key are one contiguous run (256 B a key
//    for gemma2), so a thread moves 16 bytes a load, four loads in flight;
//    other layouts are read an element a load, lanes along (head, d).
//  * dh_logits: grid (key tiles, B, head groups).  The CTA holds batch row
//    b's query rows of its heads in shared memory; a thread owns one key of
//    the tile and a stripe of rows, so the logits are written coalesced
//    along the keys.
//  * dh_softmax_pv: split over the keys as K4's decode form is.  Each CTA
//    walks its run of live key tiles (tiles no row sees are never read)
//    keeping, per query row, the running max, sum and Dl accumulators in
//    shared memory; the weights stay in f32.  It writes f32 partials (m, l,
//    acc[Dl]); a combine kernel merges a row's partials:
//    out = Σ e^{m−M} acc / max(Σ e^{m−M} l, 1e-30), M = max m.
// Shared-memory rows of the staged tiles are padded to an odd width, so
// lanes on consecutive keys read distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // keys a tile
constexpr int kLdp = kTile + 1;    // row stride of the weights tile
constexpr int kInFlight = 4;       // loads a thread issues before storing any
constexpr float kNegInf = -1e30f;  // the running max before any live key
constexpr int kMaxWidth = 128;     // floats of a staged tile's key row, at most
constexpr size_t kSmemBytes = 96 * 1024;  // shared memory a CTA may take

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// The row stride of a staged tile `w` floats wide: made odd.
__host__ __device__ __forceinline__ int tile_ld(int w) { return w | 1; }

// Shared memory of the two split kernels in 4-byte words, for head groups of
// `hg` kv heads with `rpk` query rows each (blaze_dh_head_group sizes the
// groups by this count).
__host__ __device__ __forceinline__ size_t logits_words(int hg, int rpk, int dl) {
  return size_t(kTile) * tile_ld(hg * dl) + size_t(hg) * rpk * dl;
}
__host__ __device__ __forceinline__ size_t pv_words(int hg, int rpk, int dl) {
  // per row: its logits offset (2 words), position, weights, accumulators,
  // running max, sum and rescale factor
  return size_t(kTile) * tile_ld(hg * dl) + size_t(hg) * rpk * (2 + 1 + kLdp + dl + 3);
}

struct Src {  // a [B, H, S, Dl] operand read through its strides (elements)
  const void* p;
  long long sb, sh, ss, sd;
};

// Stage keys j0 .. j0 + 63 of heads h0 .. h0 + nh − 1 of batch row b as f32
// in dst[kk·ld + hl·dl + d], zeros from key `jend` on.  VEC: those heads'
// dl elements of a key are contiguous and every 16-byte chunk aligned (the
// wrapper checks), so a thread moves 16 bytes a load.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_tile(float* dst, int ld, const Src& s, int b, int h0,
                                           int nh, int dl, int j0, int jend) {
  const T* base = static_cast<const T*>(s.p) + b * s.sb + h0 * s.sh + j0 * s.ss;
  const int w = nh * dl;
  if constexpr (VEC) {
    constexpr int N = 16 / sizeof(T);
    const int vw = w / N;  // 16-byte chunks a key
    const int per = kThreads / vw;  // keys a pass (w <= 128, so at least 2)
    const int c = threadIdx.x % vw, kk0 = threadIdx.x / vw;
    if (kk0 >= per) return;
    for (int k0 = kk0; k0 < kTile; k0 += kInFlight * per) {
      uint4 r[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int kk = k0 + u * per;
        r[u] = make_uint4(0u, 0u, 0u, 0u);
        if (kk < kTile && j0 + kk < jend)
          r[u] = __ldg(reinterpret_cast<const uint4*>(base + kk * s.ss) + c);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int kk = k0 + u * per;
        if (kk >= kTile) break;
        const T* e = reinterpret_cast<const T*>(&r[u]);
        float* out = dst + kk * ld + c * N;
#pragma unroll
        for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
      }
    }
  } else {
    const int per = kThreads / w;
    const int c = threadIdx.x % w, kk0 = threadIdx.x / w;
    if (kk0 >= per) return;
    const T* col = base + (c / dl) * s.sh + (c % dl) * s.sd;
    for (int k0 = kk0; k0 < kTile; k0 += kInFlight * per) {
      float r[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int kk = k0 + u * per;
        r[u] = (kk < kTile && j0 + kk < jend) ? to_f32(col[kk * s.ss]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int kk = k0 + u * per;
        if (kk < kTile) dst[kk * ld + c] = r[u];
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// dh_logits: grid (key tiles, B, head groups).  Query row r of a CTA is
// (hl·rep + g)·Sq + i: query head (h0 + hl)·rep + g at position i, so a
// group's rows are consecutive rows of the [B, Hq, Sq, Skv] output.
// ---------------------------------------------------------------------------
struct LogitsArgs {
  Src q, k;
  float* out;  // [B, Hq, Sq, Skv], contiguous
  int hq, hkv, sq, skv, dl, rep, hg;
  float scale;
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) dh_logits_kernel(LogitsArgs a) {
  extern __shared__ float smem[];
  const int j0 = blockIdx.x * kTile, b = blockIdx.y, h0 = blockIdx.z * a.hg;
  const int nh = min(a.hg, a.hkv - h0), rpk = a.rep * a.sq, rows = nh * rpk;
  const int ld = tile_ld(nh * a.dl);
  float* kt = smem;                                   // [kTile][ld]
  float* qs = kt + kTile * tile_ld(a.hg * a.dl);      // [rows][dl]
  const int q_first = h0 * a.rep;
  const T* qp = static_cast<const T*>(a.q.p) + b * a.q.sb;
  for (int e = threadIdx.x; e < rows * a.dl; e += kThreads) {
    const int r = e / a.dl, d = e - r * a.dl;
    qs[e] = to_f32(qp[(q_first + r / a.sq) * a.q.sh + (r % a.sq) * a.q.ss + d * a.q.sd]);
  }
  stage_tile<T, VEC>(kt, ld, a.k, b, h0, nh, a.dl, j0, a.skv);
  __syncthreads();
  const int kk = threadIdx.x % kTile, j = j0 + kk;
  if (j >= a.skv) return;
  float* out = a.out + ((long long)b * a.hq + q_first) * a.sq * a.skv + j;
  for (int r = threadIdx.x / kTile; r < rows; r += kThreads / kTile) {
    const float* qr = qs + r * a.dl;
    const float* kr = kt + kk * ld + (r / rpk) * a.dl;
    float s = 0.0f;
    for (int d = 0; d < a.dl; ++d) s = fmaf(qr[d], kr[d], s);
    out[(long long)r * a.skv] = s * a.scale;
  }
}

// ---------------------------------------------------------------------------
// dh_softmax_pv: grid (splits, B, head groups).  Split s walks key tiles
// [t_lo + s·per, min(t_hi, t_lo + (s + 1)·per)); warp w owns rows w, w + 8,
// ... for the running max and sum; the partials go to
// ws[split][row][(m, l)] and, after all splits' (m, l), ws[split][row][dl].
// ---------------------------------------------------------------------------
struct PvArgs {
  const float* lg;  // summed logits [B, Hq, Sq, Skv] f32, through its strides
  long long l_sb, l_sh, l_ss, l_sk;
  Src v;
  float* ws;
  int batch, hq, hkv, sq, skv, dl, rep, hg;
  int causal, has_window, window, q_offset;
  float softcap;
  int t_lo, t_hi, per;
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) dh_pv_split_kernel(PvArgs a) {
  extern __shared__ float smem[];
  const int split = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * a.hg;
  const int nh = min(a.hg, a.hkv - h0), rpk = a.rep * a.sq, rows = nh * rpk;
  const int max_rows = a.hg * rpk, ld = tile_ld(nh * a.dl);
  long long* roff = reinterpret_cast<long long*>(smem);                  // [max_rows]
  int* pos = reinterpret_cast<int*>(smem + 2 * max_rows);                // [max_rows]
  float* vt = smem + 3 * max_rows;                                       // [kTile][ld]
  float* pt = vt + kTile * tile_ld(a.hg * a.dl);                         // [max_rows][kLdp]
  float* acc = pt + max_rows * kLdp;                                     // [max_rows][dl]
  float* mrow = acc + max_rows * a.dl;
  float* lrow = mrow + max_rows;
  float* crow = lrow + max_rows;
  const int q_first = h0 * a.rep;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int i = r % a.sq;
    roff[r] = b * a.l_sb + (q_first + r / a.sq) * a.l_sh + i * a.l_ss;
    pos[r] = a.q_offset + i;
    mrow[r] = kNegInf;
    lrow[r] = 0.0f;
  }
  for (int e = threadIdx.x; e < rows * a.dl; e += kThreads) acc[e] = 0.0f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t_begin = a.t_lo + split * a.per, t_end = min(a.t_hi, t_begin + a.per);
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * kTile;
    __syncthreads();  // the set-up, or the last tile's readers, are done
    stage_tile<T, VEC>(vt, ld, a.v, b, h0, nh, a.dl, j0, a.skv);
    // Softcap and masks; a masked key's logit is -inf, so its weight is 0.
    for (int e = threadIdx.x; e < rows * kTile; e += kThreads) {
      const int r = e / kTile, kk = e % kTile, j = j0 + kk, p = pos[r];
      float s = -CUDART_INF_F;
      if (j < a.skv && (!a.causal || j <= p) && (!a.has_window || j > p - a.window)) {
        s = a.lg[roff[r] + j * a.l_sk];
        if (a.softcap > 0.0f) s = a.softcap * tanhf(s / a.softcap);
      }
      pt[r * kLdp + kk] = s;
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      float* p = pt + r * kLdp;
      const float s0 = p[lane], s1 = p[lane + 32];
      const float m_old = mrow[r], m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      p[lane] = p0;
      p[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        crow[r] = c;
        lrow[r] = lrow[r] * c + sum;
        mrow[r] = m_new;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * a.dl; e += kThreads) {
      const int r = e / a.dl, d = e - r * a.dl;
      const float* p = pt + r * kLdp;
      const float* vc = vt + (r / rpk) * a.dl + d;
      float s = 0.0f;
#pragma unroll 8
      for (int kk = 0; kk < kTile; ++kk) s = fmaf(p[kk], vc[kk * ld], s);
      acc[e] = acc[e] * crow[r] + s;
    }
  }
  __syncthreads();
  const long long nrows = (long long)a.batch * a.hq * a.sq;
  const long long row0 = ((long long)b * a.hq + q_first) * a.sq;
  float* ml = a.ws + ((long long)split * nrows + row0) * 2;
  float* wacc = a.ws + (long long)gridDim.x * nrows * 2 + ((long long)split * nrows + row0) * a.dl;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    ml[2 * r] = mrow[r];
    ml[2 * r + 1] = lrow[r];
  }
  for (int e = threadIdx.x; e < rows * a.dl; e += kThreads) wacc[e] = acc[e];
}

// A warp a row of the contiguous [B, Hq, Sq, Dl] output: out = Σ_s e^{m_s − M}
// acc_s / max(Σ_s e^{m_s − M} l_s, 1e-30), M = max_s m_s.  A row no split
// saw a live key of has every m_s = -1e30 and l_s = 0, and gives zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads) dh_pv_combine_kernel(const float* ws, T* out,
                                                                 long long nrows, int dl,
                                                                 int splits) {
  const long long r = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= nrows) return;
  const float* ml = ws + r * 2;
  const float* acc = ws + (long long)splits * nrows * 2 + r * dl;
  float mx = kNegInf;
  for (int s = lane; s < splits; s += 32) mx = fmaxf(mx, ml[s * nrows * 2]);
  mx = warp_max(mx);
  float l = 0.0f;
  for (int s = lane; s < splits; s += 32)
    l += expf(ml[s * nrows * 2] - mx) * ml[s * nrows * 2 + 1];
  l = fmaxf(warp_sum(l), 1e-30f);
  for (int d = lane; d < dl; d += 32) {
    float sum = 0.0f;
    for (int s = 0; s < splits; ++s)
      sum += expf(ml[s * nrows * 2] - mx) * acc[s * nrows * dl + d];
    out[r * dl + d] = from_f32<T>(sum / l);
  }
}

template <typename Args>
int launch(void (*kernel)(Args), dim3 grid, size_t words, const Args& a, cudaStream_t s) {
  const size_t bytes = words * 4;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<grid, kThreads, bytes, s>>>(a);
  return int(cudaGetLastError());
}

bool bad_shape(int batch, int hq, int hkv, int sq, int dl, int hg, int groups) {
  return batch < 1 || batch > 65535 || hkv < 1 || hq % hkv || sq < 1 || dl < 1 ||
         hg < 1 || hg * dl > kMaxWidth || groups > 65535;
}

}  // namespace

// The kv heads a CTA of dh_logits (pv = 0) or dh_softmax_pv's split kernel
// (pv = 1) stages together, for `rpk` query rows a kv head at slice width
// `dl`: the most, up to `hkv`, whose staged tile is at most kMaxWidth floats
// wide (so 256 threads cover a key twice over) and whose shared memory fits
// kSmemBytes; 0 where a single kv head does not fit.
extern "C" int blaze_dh_head_group(int pv, int hkv, int rpk, int dl) {
  if (hkv < 1 || rpk < 1 || dl < 1 || dl > kMaxWidth) return 0;
  for (int hg = hkv < kMaxWidth / dl ? hkv : kMaxWidth / dl; hg > 0; --hg)
    if (4 * (pv ? pv_words(hg, rpk, dl) : logits_words(hg, rpk, dl)) <= kSmemBytes) return hg;
  return 0;
}

// Strides are in elements.  The wrapper (kernels/flash_attention.py) checks
// shapes, dtypes and devices, takes the head group `hg` from
// blaze_dh_head_group and `vec` (16-byte loads of k) from the strides,
// allocates the contiguous f32 output and never launches an empty grid.
extern "C" int blaze_dh_logits(
    const void* q, const void* k, void* out,
    long long q_sb, long long q_sh, long long q_ss, long long q_sd,
    long long k_sb, long long k_sh, long long k_ss, long long k_sd,
    int batch, int hq, int hkv, int sq, int skv, int dl, int hg, int vec, int is_bf16,
    float scale, void* stream) {
  const int groups = hkv > 0 && hg > 0 ? (hkv + hg - 1) / hg : 0;
  if (bad_shape(batch, hq, hkv, sq, dl, hg, groups) || skv < 1)
    return int(cudaErrorInvalidValue);
  const LogitsArgs a{{q, q_sb, q_sh, q_ss, q_sd}, {k, k_sb, k_sh, k_ss, k_sd},
                     static_cast<float*>(out), hq, hkv, sq, skv, dl, hq / hkv, hg, scale};
  const dim3 grid((skv + kTile - 1) / kTile, batch, groups);
  const size_t words = logits_words(hg, a.rep * sq, dl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return vec ? launch(dh_logits_kernel<bf16, true>, grid, words, a, s)
               : launch(dh_logits_kernel<bf16, false>, grid, words, a, s);
  return vec ? launch(dh_logits_kernel<float, true>, grid, words, a, s)
             : launch(dh_logits_kernel<float, false>, grid, words, a, s);
}

// `splits` CTAs a (batch row, head group), each over `per` of the live key
// tiles [t_lo, t_hi); ws holds splits·B·Hq·Sq·(Dl + 2) floats; out is the
// contiguous [B, Hq, Sq, Dl] output in v's dtype.  Launches the split kernel,
// then the combine kernel.
extern "C" int blaze_dh_softmax_pv(
    const void* logits, const void* v, void* out, void* ws,
    long long l_sb, long long l_sh, long long l_ss, long long l_sk,
    long long v_sb, long long v_sh, long long v_ss, long long v_sd,
    int batch, int hq, int hkv, int sq, int skv, int dl, int hg, int vec, int is_bf16,
    int causal, int has_window, int window, int q_offset, float softcap,
    int t_lo, int t_hi, int splits, int per, void* stream) {
  const int groups = hkv > 0 && hg > 0 ? (hkv + hg - 1) / hg : 0;
  if (bad_shape(batch, hq, hkv, sq, dl, hg, groups) || splits < 1 || splits > 65535 ||
      per < 1)
    return int(cudaErrorInvalidValue);
  const PvArgs a{static_cast<const float*>(logits), l_sb, l_sh, l_ss, l_sk,
                 {v, v_sb, v_sh, v_ss, v_sd}, static_cast<float*>(ws),
                 batch, hq, hkv, sq, skv, dl, hq / hkv, hg,
                 causal, has_window, window, q_offset, softcap, t_lo, t_hi, per};
  const dim3 grid(splits, batch, groups);
  const size_t words = pv_words(hg, a.rep * sq, dl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (is_bf16)
    err = vec ? launch(dh_pv_split_kernel<bf16, true>, grid, words, a, s)
              : launch(dh_pv_split_kernel<bf16, false>, grid, words, a, s);
  else
    err = vec ? launch(dh_pv_split_kernel<float, true>, grid, words, a, s)
              : launch(dh_pv_split_kernel<float, false>, grid, words, a, s);
  if (err != 0) return err;
  const long long nrows = (long long)batch * hq * sq;
  const unsigned blocks = unsigned((nrows + kWarps - 1) / kWarps);
  if (is_bf16)
    dh_pv_combine_kernel<bf16><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(ws), static_cast<bf16*>(out), nrows, dl, splits);
  else
    dh_pv_combine_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(ws), static_cast<float*>(out), nrows, dl, splits);
  return int(cudaGetLastError());
}
