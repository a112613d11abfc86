// Layer-k ranked convolution of a ranked zeta table, for Hopper.
//
// Replaces repro/kernels/ranked_conv.py::_ranked_conv_kernel (pallas_call
// at :65, launched by ranked_conv_pallas).
//
// What it computes, elementwise over the lattice (batch axes folded):
//   acc = 2 * sum_{d=1}^{floor((k-1)/2)} Z[d] * Z[k-d]  (+ Z[k/2]^2, k even)
// from Z of shape (nranks, rest), into out of shape (rest,).
//
// Design.  Bound by memory: it reads rank slices 1..k-1 once
// (4 (k-1) bytes per position) and writes 4 bytes, for about k/2
// multiply-adds.  One thread owns four consecutive positions (16-byte
// vector loads when the pointers and `rest` allow, scalar otherwise),
// walks d at the rank stride with the sum in registers, and stores the
// result once — the TPU kernel's "read the ranked table once" in VMEM
// becomes "read it once into registers".  k is a runtime argument, so one
// compiled kernel serves every layer.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <class A>
__device__ __forceinline__ typename A::T conv_at(const typename A::T* Z,
                                                 long long rest,
                                                 long long p, int k) {
  using T = typename A::T;
  T acc = 0;
  for (int d = 1; d <= (k - 1) / 2; ++d)
    acc = A::add(acc, A::mul(Z[d * rest + p], Z[(k - d) * rest + p]));
  acc = A::add(acc, acc);
  if ((k & 1) == 0) {
    const T h = Z[(k / 2) * rest + p];
    acc = A::add(acc, A::mul(h, h));
  }
  return acc;
}

template <class A>
__global__ void ranked_conv_kernel(const typename A::T* __restrict__ Z,
                                   typename A::T* __restrict__ out,
                                   long long rest, int k) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p < rest) out[p] = conv_at<A>(Z, rest, p, k);
}

// Four positions per thread through 16-byte loads; V is uint4 or float4.
template <class A, class V>
__global__ void ranked_conv_vec4_kernel(const typename A::T* __restrict__ Z,
                                        typename A::T* __restrict__ out,
                                        long long rest, int k) {
  using T = typename A::T;
  const long long q =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long rest4 = rest >> 2;
  if (q >= rest4) return;
  const V* Zv = reinterpret_cast<const V*>(Z);
  T acc[4] = {0, 0, 0, 0};
  for (int d = 1; d <= (k - 1) / 2; ++d) {
    const V a = Zv[d * rest4 + q];
    const V b = Zv[(k - d) * rest4 + q];
    acc[0] = A::add(acc[0], A::mul(a.x, b.x));
    acc[1] = A::add(acc[1], A::mul(a.y, b.y));
    acc[2] = A::add(acc[2], A::mul(a.z, b.z));
    acc[3] = A::add(acc[3], A::mul(a.w, b.w));
  }
  for (int e = 0; e < 4; ++e) acc[e] = A::add(acc[e], acc[e]);
  if ((k & 1) == 0) {
    const V h = Zv[(k / 2) * rest4 + q];
    acc[0] = A::add(acc[0], A::mul(h.x, h.x));
    acc[1] = A::add(acc[1], A::mul(h.y, h.y));
    acc[2] = A::add(acc[2], A::mul(h.z, h.z));
    acc[3] = A::add(acc[3], A::mul(h.w, h.w));
  }
  V o;
  o.x = acc[0];
  o.y = acc[1];
  o.z = acc[2];
  o.w = acc[3];
  reinterpret_cast<V*>(out)[q] = o;
}

template <class A, class V>
void launch(const void* Z, void* out, long long rest, int k,
            cudaStream_t s) {
  using T = typename A::T;
  const bool vec =
      (rest % 4) == 0 &&
      ((reinterpret_cast<uintptr_t>(Z) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  const long long work = vec ? rest / 4 : rest;
  const dim3 grid(static_cast<unsigned>((work + kThreads - 1) / kThreads));
  if (vec)
    ranked_conv_vec4_kernel<A, V><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(Z), static_cast<T*>(out), rest, k);
  else
    ranked_conv_kernel<A><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(Z), static_cast<T*>(out), rest, k);
}

}  // namespace

// Z: (nranks, rest) contiguous; out: (rest,).  Needs 1 <= k < nranks.
extern "C" int repro_ranked_conv(const void* Z, void* out, long long rest,
                                 int nranks, int k, int dtype, int device,
                                 void* stream) {
  if (rest <= 0 || k < 1 || k >= nranks) return cudaErrorInvalidValue;
  cudaError_t err = repro::use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kInt32)
    launch<repro::U32Arith, uint4>(Z, out, rest, k, s);
  else if (dtype == repro::kFloat32)
    launch<repro::F32Arith, float4>(Z, out, rest, k, s);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
