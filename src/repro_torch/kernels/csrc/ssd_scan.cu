// Mamba-2 SSD scan (zamba2's Mamba-2 blocks) on Hopper.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel), which walked a (b·h, chunk) grid in order on one core and
// carried the [P, N] state across the chunk axis in VMEM scratch.  Here one
// CTA owns one (b, h) and walks its chunks in a loop, so the f32 state stays
// in shared memory for the CTA's whole life and nothing crosses CTAs.
//
// What it computes, per chunk of up to 64 steps (Δ_l = Σ_{r≤l} a·dt_r inside
// the chunk, T = Δ of its last step, dx_s = dt_s·x_s):
//   M[l,s] = (C_l·B_s)·exp(min(Δ_l − Δ_s, 0)) for s ≤ l, else 0;
//   y_l    = Σ_s M[l,s]·dx_s + exp(Δ_l)·(h·C_l);
//   h'     = exp(T)·h + Σ_s exp(T − Δ_s)·dx_s ⊗ B_s,
// all in f32, as the reference's ops.ssd_chunked does.  The decay is taken
// pairwise, exp(min(Δ_l − Δ_s, 0)), never as exp(Δ_l)·exp(−Δ_s): a ∈ [−16, −1]
// times a large dt overflows exp(−Δ), and inf·0 is NaN.  Steps past the end
// of the sequence are zeros with dt = 0, so they leave the state unchanged.
//
// Unlike the TPU kernel it takes an initial state (read at chunk 0) and
// writes the final one to a buffer that may be the same: every CTA reads its
// whole [P, N] state before any CTA-local write, and CTAs own disjoint
// states, so a serving cache is updated in place.  Decode is S = 1: one chunk
// of one live row, and the loops over rows stop at the live ones, so a step
// costs about the state's read and write.
//
// What bounds it on this card: at zamba2's prefill (x [8, 512, 112, 64] bf16,
// P = N = 64) the four 64 × 64 × 64 products of a chunk do ~1 MFLOP per
// (b, h, chunk), ~15 GFLOP a layer, against ~136 MB of inputs and outputs
// (0.041 ms at 3.35 TB/s): the tensor cores would make it byte-bound, this
// first form is bound by shared-memory reads and f32 FMAs on the CUDA cores.
// Design: 256 threads as 16 × 16, each owning a 4 × 4 tile of every 64 × 64
// product (rows ty + 16·i, columns tx + 16·j); the chunk's dt·x, B, C, the
// state and M sit in shared memory as f32 with rows padded to 65 floats, so
// every product reads its operands without bank conflicts.  84,224 bytes of
// shared memory (opted in above 48 KB), two CTAs an SM.  Tensor cores, TMA,
// and computing C·Bᵀ once per group (here 56 heads share each group's B and
// C) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 16;             // threads along each side of the 16 x 16 block
constexpr int kThreads = kT * kT;
constexpr int kL = 64;             // steps per chunk
constexpr int kD = 64;             // largest P and N
constexpr int kLd = kD + 1;        // padded row stride of every tile
constexpr int kR = kD / kT;        // rows (and columns) of a thread's tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Args {
  const void* x;
  const float* dt;
  const float* a;
  const void* b;
  const void* c;
  const float* h0;  // may be null (zeros), may alias hT
  void* y;
  float* hT;
  long long x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
      y_sb, y_ss, y_sh;
  int s, h, g, p, n;
};

constexpr size_t kSmemBytes = sizeof(float) * (5 * kL * kLd + 4 * kL);

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_kernel(Args a) {
  extern __shared__ float smem[];
  float* xs = smem;              // [kL][kLd]  dt·x
  float* bs = xs + kL * kLd;     // [kL][kLd]  B
  float* cs = bs + kL * kLd;     // [kL][kLd]  C
  float* hs = cs + kL * kLd;     // [kD][kLd]  state [P][N]
  float* ms = hs + kD * kLd;     // [kL][kLd]  M
  float* dts = ms + kL * kLd;    // [kL]  dt
  float* cum = dts + kL;         // [kL]  Δ
  float* ecum = cum + kL;        // [kL]  exp(Δ)
  float* sdec = ecum + kL;       // [kL]  exp(T − Δ)

  const int bi = blockIdx.x / a.h;
  const int hi = blockIdx.x % a.h;
  const int gi = hi / (a.h / a.g);
  const int tid = threadIdx.x;
  const int tx = tid % kT, ty = tid / kT;
  const float av = a.a[hi];
  const T* xp = static_cast<const T*>(a.x) + bi * a.x_sb + hi * a.x_sh;
  const float* dp = a.dt + bi * a.dt_sb + hi * a.dt_sh;
  const T* bp = static_cast<const T*>(a.b) + bi * a.b_sb + gi * a.b_sg;
  const T* cp = static_cast<const T*>(a.c) + bi * a.c_sb + gi * a.c_sg;
  T* yp = static_cast<T*>(a.y) + bi * a.y_sb + hi * a.y_sh;
  const size_t state_off = size_t(blockIdx.x) * a.p * a.n;

  for (int t = tid; t < kD * kD; t += kThreads) {
    const int r = t / kD, col = t % kD;
    hs[r * kLd + col] =
        (a.h0 != nullptr && r < a.p && col < a.n) ? a.h0[state_off + r * a.n + col] : 0.0f;
  }

  for (int c0 = 0; c0 < a.s; c0 += kL) {
    const int lc = min(kL, a.s - c0);  // live rows of this chunk
    __syncthreads();                   // the last chunk's readers are done
    for (int l = tid; l < kL; l += kThreads) dts[l] = l < lc ? dp[(c0 + l) * a.dt_ss] : 0.0f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int l = 0; l < kL; ++l) {
        run += av * dts[l];
        cum[l] = run;
      }
    }
    for (int t = tid; t < kL * kD; t += kThreads) {
      const int r = t / kD, col = t % kD;
      const bool row = r < lc;
      const long long step = c0 + r;
      xs[r * kLd + col] =
          row && col < a.p ? dts[r] * to_f32(xp[step * a.x_ss + col]) : 0.0f;
      bs[r * kLd + col] = row && col < a.n ? to_f32(bp[step * a.b_ss + col]) : 0.0f;
      cs[r * kLd + col] = row && col < a.n ? to_f32(cp[step * a.c_ss + col]) : 0.0f;
    }
    __syncthreads();
    const float total = cum[kL - 1];
    for (int l = tid; l < kL; l += kThreads) {
      ecum[l] = expf(cum[l]);
      sdec[l] = expf(total - cum[l]);
    }

    // M = (C·Bᵀ) ∘ exp(min(Δ_l − Δ_s, 0)), lower triangle (rows l, columns s).
    if (ty < lc) {
      float acc[kR][kR] = {};
      for (int k = 0; k < a.n; ++k) {
        float cv[kR], bv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) cv[i] = cs[(ty + kT * i) * kLd + k];
#pragma unroll
        for (int j = 0; j < kR; ++j) bv[j] = bs[(tx + kT * j) * kLd + k];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int l = ty + kT * i;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int s = tx + kT * j;
          ms[l * kLd + s] = s <= l ? acc[i][j] * expf(fminf(cum[l] - cum[s], 0.0f)) : 0.0f;
        }
      }
    }
    __syncthreads();

    // y = exp(Δ_l)·(C·hᵀ) + M·dx  (rows l, columns p).
    if (ty < lc) {
      float acc[kR][kR] = {};
      for (int k = 0; k < a.n; ++k) {
        float cv[kR], hv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) cv[i] = cs[(ty + kT * i) * kLd + k];
#pragma unroll
        for (int j = 0; j < kR; ++j) hv[j] = hs[(tx + kT * j) * kLd + k];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const float e = ecum[ty + kT * i];
#pragma unroll
        for (int j = 0; j < kR; ++j) acc[i][j] *= e;
      }
      for (int s = 0; s < lc; ++s) {
        float mv[kR], xv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) mv[i] = ms[(ty + kT * i) * kLd + s];
#pragma unroll
        for (int j = 0; j < kR; ++j) xv[j] = xs[s * kLd + tx + kT * j];
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int l = ty + kT * i;
        if (l >= lc) continue;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int col = tx + kT * j;
          if (col < a.p) yp[(c0 + l) * a.y_ss + col] = from_f32<T>(acc[i][j]);
        }
      }
    }

    // h' = exp(T)·h + Σ_s exp(T − Δ_s)·dx_s ⊗ B_s  (rows p, columns n).
    float hn[kR][kR];
    const float et = expf(total);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) hn[i][j] = hs[(ty + kT * i) * kLd + tx + kT * j] * et;
    for (int s = 0; s < lc; ++s) {
      const float f = sdec[s];
      float xv[kR], bv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) xv[i] = xs[s * kLd + ty + kT * i] * f;
#pragma unroll
      for (int j = 0; j < kR; ++j) bv[j] = bs[s * kLd + tx + kT * j];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) hn[i][j] = fmaf(xv[i], bv[j], hn[i][j]);
    }
    __syncthreads();  // every reader of the old state is done
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) hs[(ty + kT * i) * kLd + tx + kT * j] = hn[i][j];
  }
  __syncthreads();
  for (int t = tid; t < a.p * a.n; t += kThreads) {
    const int r = t / a.n, col = t % a.n;
    a.hT[state_off + t] = hs[r * kLd + col];
  }
}

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  // Above 48 KB a launch must opt in, per function and device.
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
  if (err != cudaSuccess) return int(err);
  ssd_kernel<T><<<batch * a.h, kThreads, kSmemBytes, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// Strides are in elements: x and y [B, S, H, P] and b, c [B, S, G, N] by
// (batch, seq, head or group), dt [B, S, H] likewise, the last dimension
// contiguous; h0 (or null) and hT are contiguous [B, H, P, N] f32 and may be
// the same buffer.  The wrapper checks shapes, dtypes, P, N <= 64 and H a
// multiple of G, and never launches an empty grid or S = 0.
extern "C" int blaze_ssd_scan(
    const void* x, const void* dt, const void* a, const void* b, const void* c,
    const void* h0, void* y, void* hT,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    long long y_sb, long long y_ss, long long y_sh,
    int batch, int s, int h, int g, int p, int n, int is_bf16, void* stream) {
  Args args{x, static_cast<const float*>(dt), static_cast<const float*>(a), b, c,
            static_cast<const float*>(h0), y, static_cast<float*>(hT),
            x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
            y_sb, y_ss, y_sh, s, h, g, p, n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(args, batch, st) : launch<float>(args, batch, st);
}
