// Reducer monoid on the device: identities, the elementwise fold and its
// atomic form, shared by the segment-reduce and hash-aggregate kernels.
//
// Accumulators are f32 (float and bf16 inputs) or i32 (int inputs), as in the
// TPU kernels.  i32 sum/prod wrap modulo 2^32 like XLA's int32 arithmetic.
// f32 min/max propagate NaN from either operand (jnp.minimum/maximum do;
// fminf/fmaxf and the int-reinterpret atomicMin trick do not), so they and
// every prod go through a compare-and-swap loop on the 32-bit pattern.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum BlazeOp { OP_SUM = 0, OP_PROD = 1, OP_MIN = 2, OP_MAX = 3 };
enum BlazeDtype { DT_F32 = 0, DT_BF16 = 1, DT_I32 = 2 };

__device__ __forceinline__ float load_acc(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_acc(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ int load_acc(const int* p, long long i) { return p[i]; }

template <int OP>
__device__ __forceinline__ float fold(float a, float b) {
  if (OP == OP_SUM) return a + b;
  if (OP == OP_PROD) return a * b;
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return OP == OP_MIN ? fminf(a, b) : fmaxf(a, b);
}

template <int OP>
__device__ __forceinline__ int fold(int a, int b) {
  if (OP == OP_SUM) return (int)((unsigned)a + (unsigned)b);
  if (OP == OP_PROD) return (int)((unsigned)a * (unsigned)b);
  return OP == OP_MIN ? min(a, b) : max(a, b);
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_int(a) == __float_as_int(b);
}
__device__ __forceinline__ bool same_bits(int a, int b) { return a == b; }

template <typename AccT, int OP>
__device__ __forceinline__ AccT identity();
template <> __device__ __forceinline__ float identity<float, OP_SUM>() { return 0.0f; }
template <> __device__ __forceinline__ float identity<float, OP_PROD>() { return 1.0f; }
template <> __device__ __forceinline__ float identity<float, OP_MIN>() { return __int_as_float(0x7f800000); }
template <> __device__ __forceinline__ float identity<float, OP_MAX>() { return __int_as_float(0xff800000); }
template <> __device__ __forceinline__ int identity<int, OP_SUM>() { return 0; }
template <> __device__ __forceinline__ int identity<int, OP_PROD>() { return 1; }
template <> __device__ __forceinline__ int identity<int, OP_MIN>() { return 0x7fffffff; }
template <> __device__ __forceinline__ int identity<int, OP_MAX>() { return (int)0x80000000; }

// Fold v into *addr atomically (global or shared memory).
template <int OP>
__device__ __forceinline__ void atomic_fold(float* addr, float v) {
  if (OP == OP_SUM) {
    atomicAdd(addr, v);
    return;
  }
  int* bits = reinterpret_cast<int*>(addr);
  int old = *bits;
  while (true) {
    int next = __float_as_int(fold<OP>(__int_as_float(old), v));
    if (next == old) return;
    int seen = atomicCAS(bits, old, next);
    if (seen == old) return;
    old = seen;
  }
}

template <int OP>
__device__ __forceinline__ void atomic_fold(int* addr, int v) {
  if (OP == OP_SUM) {
    atomicAdd(addr, v);
    return;
  }
  if (OP == OP_MIN) {
    atomicMin(addr, v);
    return;
  }
  if (OP == OP_MAX) {
    atomicMax(addr, v);
    return;
  }
  int old = *addr;
  while (true) {
    int next = fold<OP>(old, v);
    if (next == old) return;
    int seen = atomicCAS(addr, old, next);
    if (seen == old) return;
    old = seen;
  }
}

// Instantiate the body (the variadic argument) for every (input dtype,
// reducer) pair the wrappers accept; it sees the types InT/AccT and the
// constant OP.  Unknown pairs make the entry point return
// cudaErrorInvalidValue.
#define BLAZE_DISPATCH(dtype, op, ...)                                    \
  switch ((dtype) * 4 + (op)) {                                            \
    case DT_F32 * 4 + OP_SUM: { typedef float InT; typedef float AccT; const int OP = OP_SUM; __VA_ARGS__; break; } \
    case DT_F32 * 4 + OP_PROD: { typedef float InT; typedef float AccT; const int OP = OP_PROD; __VA_ARGS__; break; } \
    case DT_F32 * 4 + OP_MIN: { typedef float InT; typedef float AccT; const int OP = OP_MIN; __VA_ARGS__; break; } \
    case DT_F32 * 4 + OP_MAX: { typedef float InT; typedef float AccT; const int OP = OP_MAX; __VA_ARGS__; break; } \
    case DT_BF16 * 4 + OP_SUM: { typedef __nv_bfloat16 InT; typedef float AccT; const int OP = OP_SUM; __VA_ARGS__; break; } \
    case DT_BF16 * 4 + OP_PROD: { typedef __nv_bfloat16 InT; typedef float AccT; const int OP = OP_PROD; __VA_ARGS__; break; } \
    case DT_BF16 * 4 + OP_MIN: { typedef __nv_bfloat16 InT; typedef float AccT; const int OP = OP_MIN; __VA_ARGS__; break; } \
    case DT_BF16 * 4 + OP_MAX: { typedef __nv_bfloat16 InT; typedef float AccT; const int OP = OP_MAX; __VA_ARGS__; break; } \
    case DT_I32 * 4 + OP_SUM: { typedef int InT; typedef int AccT; const int OP = OP_SUM; __VA_ARGS__; break; } \
    case DT_I32 * 4 + OP_PROD: { typedef int InT; typedef int AccT; const int OP = OP_PROD; __VA_ARGS__; break; } \
    case DT_I32 * 4 + OP_MIN: { typedef int InT; typedef int AccT; const int OP = OP_MIN; __VA_ARGS__; break; } \
    case DT_I32 * 4 + OP_MAX: { typedef int InT; typedef int AccT; const int OP = OP_MAX; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;                            \
  }
