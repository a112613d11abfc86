// Shared helpers of the port's CUDA kernels.
//
// The kernels take int32 and float32 lanes; the zeta kernels take
// float64 too.  int32 goes through uint32_t: signed overflow is undefined
// in C++, unsigned arithmetic wraps, and the bits are those of
// two's-complement int32 — what XLA and PyTorch give on int32.  float32
// and float64 use the _rn intrinsics, which the compiler never contracts
// into an FMA, so each add and multiply rounds exactly as PyTorch's
// separate elementwise ops do.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

enum Dtype : int { kInt32 = 0, kFloat32 = 1, kFloat64 = 2 };

// Make `device` current unless it already is (the common case: one card).
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

struct U32Arith {
  using T = uint32_t;
  __device__ __forceinline__ static T add(T a, T b) { return a + b; }
  __device__ __forceinline__ static T sub(T a, T b) { return a - b; }
  __device__ __forceinline__ static T mul(T a, T b) { return a * b; }
};

struct F32Arith {
  using T = float;
  __device__ __forceinline__ static T add(T a, T b) { return __fadd_rn(a, b); }
  __device__ __forceinline__ static T sub(T a, T b) { return __fsub_rn(a, b); }
  __device__ __forceinline__ static T mul(T a, T b) { return __fmul_rn(a, b); }
};

struct F64Arith {
  using T = double;
  __device__ __forceinline__ static T add(T a, T b) { return __dadd_rn(a, b); }
  __device__ __forceinline__ static T sub(T a, T b) { return __dsub_rn(a, b); }
  __device__ __forceinline__ static T mul(T a, T b) { return __dmul_rn(a, b); }
};

}  // namespace repro
