// Subset-lattice zeta (sign +1) and Moebius (sign -1) transform over the
// last axis of a (..., 2^n) table of int32 or float32, for Hopper.
//
// Replaces repro/kernels/zeta_pallas.py: _local_kernel (pallas_call at
// :85, launched by _local_pass) and _pair_kernel (pallas_call at :122,
// launched by _pair_pass), and the zeta_pallas host contract.
//
// What it computes: Yates' butterfly.  For every bit j < n and every
// index i with bit j set, x[i] += sign * x[i ^ (1 << j)], bits in
// increasing order.  Leading batch axes fold into the index: a tile or a
// partner never crosses a 2^n element, because tiles are 2^b-aligned with
// b <= n and partners differ only in bits below n.
//
// Design.  The transform is bound by memory on this card: 2^n n / 2 adds
// on 8 bytes per element moved (read once, written once).  So
//   * zeta_local_kernel does the low b = min(n, 12) bits in shared
//     memory: one block loads a 2^b tile (16 KB), runs b stages with a
//     __syncthreads() between them, and writes the tile once.  One
//     launch replaces the TPU's 256-lane subset-matrix product plus its
//     sublane butterflies;
//   * zeta_pair_kernel does one bit j >= b per launch, in place: within
//     one stage no element that is read is also written (readers have
//     bit j clear, writers bit j set), so the in-place pass is bitwise
//     the same as the TPU's read-twice / write-once pair pass.
// At n = 15 a transform is one local launch and three pair launches.
// f32 runs the same butterflies in f32 (no tensor cores, no TF32): exact
// for integer values below 2^24.  The TPU kernel's n < 11 fallback to the
// reference is gone: any n >= 0 launches.
#include "common.cuh"

namespace {

constexpr int kMaxTileBits = 12;  // 4096 x 4 B = 16 KB of shared memory
constexpr int kLocalThreads = 512;
constexpr int kPairThreads = 256;

template <class A>
__device__ __forceinline__ typename A::T step(typename A::T own,
                                              typename A::T partner,
                                              int sign) {
  return sign > 0 ? A::add(own, partner) : A::sub(own, partner);
}

template <class A>
__global__ void zeta_local_kernel(const typename A::T* in,
                                  typename A::T* out, int tile_bits,
                                  int sign) {
  using T = typename A::T;
  __shared__ T buf[1 << kMaxTileBits];
  const int tile = 1 << tile_bits;
  const long long base = static_cast<long long>(blockIdx.x) << tile_bits;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) buf[i] = in[base + i];
  __syncthreads();
  const int half = tile >> 1;
  for (int j = 0; j < tile_bits; ++j) {
    const int low = (1 << j) - 1;
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const int i = ((p & ~low) << 1) | (1 << j) | (p & low);
      buf[i] = step<A>(buf[i], buf[i ^ (1 << j)], sign);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) out[base + i] = buf[i];
}

template <class A>
__global__ void zeta_pair_kernel(typename A::T* x, long long half, int bit,
                                 int sign) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= half) return;
  const long long low = (1LL << bit) - 1;
  const long long i = ((t & ~low) << 1) | (1LL << bit) | (t & low);
  x[i] = step<A>(x[i], x[i ^ (1LL << bit)], sign);
}

}  // namespace

// Low tile_bits bits of every 2^tile_bits tile of `in` (total elements)
// into `out`.  Returns a cudaError_t.
extern "C" int repro_zeta_local(const void* in, void* out, long long total,
                                int tile_bits, int sign, int dtype,
                                int device, void* stream) {
  if (tile_bits < 0 || tile_bits > kMaxTileBits || total <= 0 ||
      (total & ((1LL << tile_bits) - 1)) != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long blocks = total >> tile_bits;
  const int half = (1 << tile_bits) >> 1;
  const int threads =
      half < 32 ? 32 : (half > kLocalThreads ? kLocalThreads : half);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kInt32) {
    zeta_local_kernel<repro::U32Arith><<<grid, threads, 0, s>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
        tile_bits, sign);
  } else if (dtype == repro::kFloat32) {
    zeta_local_kernel<repro::F32Arith><<<grid, threads, 0, s>>>(
        static_cast<const float*>(in), static_cast<float*>(out), tile_bits,
        sign);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// One butterfly stage over index bit `bit`, in place on `x`.
extern "C" int repro_zeta_pair(void* x, long long total, int bit, int sign,
                               int dtype, int device, void* stream) {
  if (bit < 0 || bit > 62 || total <= 0 ||
      (total & ((2LL << bit) - 1)) != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const long long half = total >> 1;
  const long long blocks = (half + kPairThreads - 1) / kPairThreads;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kInt32) {
    zeta_pair_kernel<repro::U32Arith><<<grid, kPairThreads, 0, s>>>(
        static_cast<uint32_t*>(x), half, bit, sign);
  } else if (dtype == repro::kFloat32) {
    zeta_pair_kernel<repro::F32Arith><<<grid, kPairThreads, 0, s>>>(
        static_cast<float*>(x), half, bit, sign);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
