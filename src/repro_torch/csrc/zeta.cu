// Subset-lattice zeta (sign +1) and Moebius (sign -1) transform over the
// last axis of a (..., 2^n) table of int32, float32 or float64, for
// Hopper.
//
// Replaces repro/kernels/zeta_pallas.py: _local_kernel (:53, pallas_call
// at :85, launched by _local_pass) and _pair_kernel (:101, pallas_call at
// :122, launched by _pair_pass), and the zeta_pallas host contract.
//
// What it computes: Yates' butterfly.  For every bit j < n and every
// index i with bit j set, x[i] += sign * x[i ^ (1 << j)], bits in
// increasing order.  Leading batch axes fold into the index: a tile or a
// partner never crosses a 2^n element, because tiles are 2^b-aligned with
// b <= n and partners differ only in bits below n.
//
// Bound.  2^n n / 2 adds on 2 E bytes per element of device memory
// (E = 4 or 8 bytes an element, read once, written once): at 3.35 TB/s
// and well under one add per byte the transform is bound by bytes, 2.4
// ns per 1024 elements at 4 bytes and 4.9 ns at 8 (34 TFLOP/s of float64
// would take 0.3 ns per 1024 elements and bit).  It only gets there with
// one pass over the table and enough bytes in flight.
//
// Design.  zeta_cluster_kernel does the low b = min(n, t + 3) bits in
// ONE launch, reading and writing every element of device memory once;
// a tile is 2^t elements, 16 KB of shared memory: t = 12 (4096
// elements, 128 threads) at 4 bytes, t = 11 (2048, 64 threads) at 8, so
// b <= 15 at 4 bytes and b <= 14 at 8.  Each thread holds 32 elements:
//   * a block owns a tile and does its low min(b, t) bits in registers,
//     5 bits at a time: loads of 4 consecutive elements (one 16-byte
//     vector at 4 bytes, two at 8) put bits 0-1 in registers, then two
//     passes through shared memory (a __syncthreads each) put bits 2-6
//     and then bits 7..t-1 in registers.  A swizzle keeps every access
//     free of bank conflicts (swz: at 4 bytes bits 2-4 XOR bits 7-9; at
//     8 bytes, where a warp's 8-byte accesses run as two half-warps and
//     its 16-byte ones as four quarter-warps, bit 1 XOR bit 4 and bits
//     2-3 XOR bits 7-8);
//   * for b > t a row of 2^b elements is one thread block cluster of
//     2^(b-t) blocks (at most 8, the portable size).  Each block stores
//     column slice s of its tile into block s's receive buffer (16 KB
//     more; at 8 bytes it takes the swizzle too) through distributed
//     shared memory; after one release/acquire cluster barrier block r
//     holds slice r of every tile of the row, runs bits t..b-1 in
//     registers and writes the slice straight to device memory.  The
//     barrier that guards the first remote store is arrived at before
//     the loads, so its wait costs nothing;
//   * for n < t one block takes 2^t / 2^n whole rows.
// Every block loads its whole tile before its first barrier (the
// cluster barrier, or its own __syncthreads when n <= t) and stores
// only after it, so `out` may be `in` (an in-place transform).  Bits are
// applied in increasing order, each add rounded alone, as the plain
// version applies them: f32 and f64 results are bitwise those of the
// plain version.
// The tile is 16 KB at either size because a block's time is nearly all
// latency and bytes through its SM: at 8 bytes a 4096-element tile (64
// KB with its receive buffer, dynamic shared memory) took twice the
// 4-byte kernel's time on the same shapes, 0.00714 ms against 0.00354 at
// (1, 2^16) and 0.00988 against 0.00432 at (1, 2^19), warm; 2048
// elements halve each block's bytes and double the blocks: 0.00444 and
// 0.00833 ms (14 bits), and whole float64 transforms of (1, 2^16), (1,
// 2^19) and (16, 2^13) took 0.00573, 0.01140 and 0.00420 ms against
// 0.00860, 0.01352 and 0.00610 (H100 SXM, 700 W, scripts/bench_zeta.py).
//
// zeta_high_kernel does bits lo..hi-1 (at most kHighMaxBits of them) in
// one launch: the bits past the cluster launch's of an n > 15 table (n
// > 14 at 8 bytes: the float64 tier's large cliques, n = 16..19; no
// caller of the int32 tier has one), in chunks of kHighMaxBits.  Seen as a (2^(n-lo), 2^lo) matrix, a row of the table
// takes the chunk's bits as a zeta over the matrix's row index,
// independently for every column.  A thread owns one 16-byte column
// vector (4 elements at 4 bytes, 2 at 8; one element on the scalar
// path) and one setting of the bits outside the chunk: it issues all
// 2^b loads, 2^lo elements apart, before any add, applies the b bits in
// increasing order in registers (each add rounded alone: bitwise the
// plain version, as above) and stores the 2^b - 1 vectors whose chunk
// index is not 0 (that one never changes; it is stored too when `out`
// is not `in`).  Neighbouring threads take neighbouring columns, so
// every access of a warp is 512 contiguous bytes.
// Bound: a launch over b bits of T elements reads E T bytes and writes
// E T (1 - 2^-b) bytes; at b = 1 that is the per-bit pass of
// _pair_kernel, and at (8, 2^20) int32, bits 15..19 in one launch, 66 MB
// (0.0197 ms at 3.35 TB/s) against 252 MB for five one-bit passes.
// kHighMaxBits = 5 from the register budget: 2^5 vectors of 16 bytes are
// 128 registers of data at either element size (164-172 in all at 4
// bytes, 162 at 8, no spill, by ptxas), under the 255 a thread may hold; 6 bits
// would need 256 and spill.  kHighThreads = 256 at 4 bytes: one such
// block fits an SM, and (8, 2^20) int32 at 5 bits then runs in 1.94
// waves of blocks; 128 threads (3 blocks an SM, 1.29 waves) took 0.0306
// ms L2 cold there, 256 took 0.0276 ms (H100 SXM, 700 W,
// scripts/bench_zeta.py on both builds).  At 8 bytes the float64 tier's
// tables are one row, (1, 2^n) at n = 16..19, and every chunk there
// (bits 14..n-1) has 8192 threads: 64 a block make 128 blocks, about one
// an SM, where 256 made 32: bits 14..18 of (1, 2^19) took 0.00270 ms
// warm against 0.00692.  Each thread reads everything it writes and no
// two threads share an element, so `out` may be `in`.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPerThread = 32;      // elements of data a thread holds
constexpr int kMaxClusterBits = 3;  // 8 blocks: the portable size
constexpr int kHighMaxBits = 5;             // bits per zeta_high launch
// zeta_high threads a block, by element size (see the header)
template <class T>
constexpr int kHighThreads = sizeof(T) == 4 ? 256 : 64;

template <class A>
__device__ __forceinline__ typename A::T step(typename A::T own,
                                              typename A::T partner,
                                              int sign) {
  return sign > 0 ? A::add(own, partner) : A::sub(own, partner);
}

// One butterfly stage over register bit RB: v[r | RB] op= v[r].
template <class A, int RB>
__device__ __forceinline__ void reg_stage(typename A::T (&v)[kPerThread],
                                          int sign) {
#pragma unroll
  for (int r = 0; r < kPerThread; ++r)
    if (r & RB) v[r] = step<A>(v[r], v[r ^ RB], sign);
}

// Elements of T in the 16-byte vector V (uint4, float4: 4; double2: 2),
// its log2, and the vectors of a group of 4 consecutive elements.
template <class T, class V>
constexpr int kLanes = static_cast<int>(sizeof(V) / sizeof(T));
template <class T, class V>
constexpr int kLaneBits = kLanes<T, V> == 4 ? 2 : 1;
template <class T, class V>
constexpr int kGroupVecs = 4 / kLanes<T, V>;

template <class T, class V>
__device__ __forceinline__ void unpack(const V& w, T* d) {
  d[0] = w.x;
  d[1] = w.y;
  if constexpr (kLanes<T, V> == 4) {
    d[2] = w.z;
    d[3] = w.w;
  }
}

template <class T, class V>
__device__ __forceinline__ V pack(const T* d) {
  V w;
  w.x = d[0];
  w.y = d[1];
  if constexpr (kLanes<T, V> == 4) {
    w.z = d[2];
    w.w = d[3];
  }
  return w;
}

// Four consecutive elements at idx; zeros past `total`.  kVec: 16-byte
// accesses (pointer 16-byte aligned, total a multiple of 4).
template <class T, class V, bool kVec>
__device__ __forceinline__ void load4(const T* p, long long idx,
                                      long long total, T* d) {
  if (kVec) {
    if (idx < total) {
      constexpr int kL = kLanes<T, V>;
#pragma unroll
      for (int h = 0; h < kGroupVecs<T, V>; ++h)
        unpack<T, V>(*reinterpret_cast<const V*>(p + idx + kL * h),
                     d + kL * h);
    } else {
      d[0] = d[1] = d[2] = d[3] = 0;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) d[c] = idx + c < total ? p[idx + c] : 0;
  }
}

template <class T, class V, bool kVec>
__device__ __forceinline__ void store4(T* p, long long idx, long long total,
                                       const T* d) {
  if (kVec) {
    if (idx < total) {
      constexpr int kL = kLanes<T, V>;
#pragma unroll
      for (int h = 0; h < kGroupVecs<T, V>; ++h)
        *reinterpret_cast<V*>(p + idx + kL * h) = pack<T, V>(d + kL * h);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (idx + c < total) p[idx + c] = d[c];
  }
}

// Shared-memory word of tile element i, so that each of the kernel's
// access patterns (16-byte accesses of consecutive groups, 32 lanes 4
// words apart, 32 consecutive lanes) meets every bank once.  At 4 bytes
// bits 2-4 XOR bits 7-9: groups of 4 consecutive elements stay together
// and 16-byte aligned.  At 8 bytes a group is two 16-byte halves 32
// bytes apart in a thread: bit 1 XOR bit 4 spreads a quarter-warp's
// halves over 8 different 16-byte bank quads, bits 2-3 XOR bits 7-8 a
// half-warp's lanes 4 words apart over 16 different 8-byte bank pairs;
// each half stays together and 16-byte aligned.
template <class T>
__device__ __forceinline__ int swz(int i) {
  if constexpr (sizeof(T) == 4)
    return i ^ (((i >> 7) & 7) << 2);
  else
    return i ^ (((i >> 4) & 1) << 1) ^ (((i >> 7) & 3) << 2);
}

// Receive-buffer word of element i: 4-byte groups of consecutive threads
// are conflict-free as they are; 8-byte groups take swz, as in the tile.
template <class T>
__device__ __forceinline__ int rswz(int i) {
  if constexpr (sizeof(T) == 4)
    return i;
  else
    return swz<T>(i);
}

// A zeta_cluster block's tile of T: 2^kBits elements, 16 KB, over
// kThreads threads of kPerThread elements each.
template <class T>
struct Tile {
  static constexpr int kBits = sizeof(T) == 4 ? 12 : 11;
  static constexpr int kSize = 1 << kBits;
  static constexpr int kThreadBits = kBits - 5;
  static constexpr int kThreads = 1 << kThreadBits;
};

// Low tile_bits (<= Tile<T>::kBits) bits of every tile, then, for
// kClusterBits > 0, the kClusterBits bits above the tile's across the
// cluster.
template <class A, class V, int kClusterBits, bool kVec>
__global__ void __launch_bounds__(Tile<typename A::T>::kThreads)
    zeta_cluster_kernel(const typename A::T* in, typename A::T* out,
                        long long total, int tile_bits, int sign) {
  using T = typename A::T;
  constexpr int kL = kLanes<T, V>;
  constexpr int kLB = kLaneBits<T, V>;
  constexpr int kTileBits = Tile<T>::kBits;
  constexpr int kTile = Tile<T>::kSize;
  constexpr int kThreads = Tile<T>::kThreads;
  __shared__ __align__(16) T buf[kTile];
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) << kTileBits;
  T v[kPerThread];
  // Arrive now, wait before the first remote store: every block of the
  // cluster has then started, and the wait overlaps the loads.
  if constexpr (kClusterBits > 0)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // Layout 1 (16-byte loads): v[4q + c] is element 4 kThreads q + 4 t +
  // c, so register bits 0-1 are index bits 0-1.
#pragma unroll
  for (int q = 0; q < 8; ++q)
    load4<T, V, kVec>(in, base + 4 * kThreads * q + 4 * t, total, v + 4 * q);
  if (tile_bits > 0) reg_stage<A, 1>(v, sign);
  if (tile_bits > 1) reg_stage<A, 2>(v, sign);
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int h = 0; h < kGroupVecs<T, V>; ++h)
      reinterpret_cast<V*>(buf)[
          swz<T>(4 * kThreads * q + 4 * t + kL * h) >> kLB] =
          pack<T, V>(v + 4 * q + kL * h);
  __syncthreads();
  // Layout 2: v[r] is element (t & 3) + 4 r + 128 (t >> 2): register
  // bits are index bits 2-6.  Each thread rewrites the words it read.
  const int lo = (t & 3) + 128 * (t >> 2);
  if (tile_bits > 2) {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) v[r] = buf[swz<T>(lo + 4 * r)];
    reg_stage<A, 1>(v, sign);
    if (tile_bits > 3) reg_stage<A, 2>(v, sign);
    if (tile_bits > 4) reg_stage<A, 4>(v, sign);
    if (tile_bits > 5) reg_stage<A, 8>(v, sign);
    if (tile_bits > 6) reg_stage<A, 16>(v, sign);
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) buf[swz<T>(lo + 4 * r)] = v[r];
    __syncthreads();
  }
  // Layout 3: v[r] is element t + kThreads r: register bits are index
  // bits kThreadBits.. (7-11 at 4 bytes; 6-10 at 8, whose bit 6 layout 2
  // applied).  Again each thread rewrites only the words it read.
  constexpr int kJ = Tile<T>::kThreadBits;  // index bit of register bit 0
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) v[r] = buf[swz<T>(t + kThreads * r)];
  if (kJ == 7 && tile_bits > 7) reg_stage<A, 1>(v, sign);
  if (tile_bits > kJ + 1) reg_stage<A, 2>(v, sign);
  if (tile_bits > kJ + 2) reg_stage<A, 4>(v, sign);
  if (tile_bits > kJ + 3) reg_stage<A, 8>(v, sign);
  if (tile_bits > kJ + 4) reg_stage<A, 16>(v, sign);

  if constexpr (kClusterBits == 0) {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const long long idx = base + t + kThreads * r;
      if (idx < total) out[idx] = v[r];
    }
  } else {
    constexpr int kC = 1 << kClusterBits;        // tiles per row
    constexpr int kGroups = kPerThread / 4 / kC;  // 4-element columns
    __shared__ __align__(16) T recv[kTile];   // slice `rank` of each tile
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
#pragma unroll
    for (int r = 0; r < kPerThread; ++r)
      buf[swz<T>(t + kThreads * r)] = v[r];
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    // Push: slice s of this tile goes to block s, as its part `rank`.
#pragma unroll
    for (int s = 0; s < kC; ++s) {
      V* peer = reinterpret_cast<V*>(cluster.map_shared_rank(recv, s));
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int p = 4 * (t + kThreads * g);
#pragma unroll
        for (int h = 0; h < kGroupVecs<T, V>; ++h)
          peer[rswz<T>(rank * (kTile / kC) + p + kL * h) >> kLB] =
              reinterpret_cast<const V*>(buf)[
                  swz<T>(s * (kTile / kC) + p + kL * h) >> kLB];
      }
    }
    // Every push into recv is complete and visible after this barrier;
    // no block touches another's shared memory later, so blocks may exit.
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    const int slice = rank * (kTile / kC);
    // v[4 (g kC + s) + c]: element slice + 4 (t + kThreads g) + c of tile
    // s, so register bits 2..2+kClusterBits-1 are index bits kTileBits.. .
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int s = 0; s < kC; ++s)
#pragma unroll
        for (int h = 0; h < kGroupVecs<T, V>; ++h)
          unpack<T, V>(reinterpret_cast<const V*>(recv)[
                           rswz<T>(s * (kTile / kC) +
                                   4 * (t + kThreads * g) + kL * h) >> kLB],
                       v + 4 * (g * kC + s) + kL * h);
    reg_stage<A, 4>(v, sign);
    if constexpr (kClusterBits > 1) reg_stage<A, 8>(v, sign);
    if constexpr (kClusterBits > 2) reg_stage<A, 16>(v, sign);
    const long long row = base - (static_cast<long long>(rank) << kTileBits);
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int s = 0; s < kC; ++s)
        store4<T, V, kVec>(
            out, row + (s << kTileBits) + slice + 4 * (t + kThreads * g),
            total, v + 4 * (g * kC + s));
  }
}

// Bits lo..lo+kBits-1 of `in` into `out`: thread c owns column vector c
// of the (2^kBits, 2^lo) block it lies in.  kVec: 16-byte columns (2^lo
// a multiple of the vector's lanes, pointers 16-byte aligned), else one
// element each.
template <class A, class V, int kBits, bool kVec>
__global__ void __launch_bounds__(kHighThreads<typename A::T>)
    zeta_high_kernel(const typename A::T* in, typename A::T* out,
                     long long columns, int lo, int sign) {
  using T = typename A::T;
  constexpr int kW = kVec ? kLanes<T, V> : 1;  // elements per column vector
  constexpr int kR = 1 << kBits;               // vectors per thread
  const long long c =
      static_cast<long long>(blockIdx.x) * kHighThreads<T> + threadIdx.x;
  if (c >= columns) return;
  // 2^col_bits columns a block
  const int col_bits = kVec ? lo - kLaneBits<T, V> : lo;
  const long long base = ((c >> col_bits) << (lo + kBits)) +
                         (c & ((1LL << col_bits) - 1)) * kW;
  T v[kR][kW];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const long long idx = base + (static_cast<long long>(r) << lo);
    if constexpr (kVec)
      unpack<T, V>(*reinterpret_cast<const V*>(in + idx), v[r]);
    else
      v[r][0] = in[idx];
  }
#pragma unroll
  for (int b = 0; b < kBits; ++b)
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (r & (1 << b))
#pragma unroll
        for (int w = 0; w < kW; ++w)
          v[r][w] = step<A>(v[r][w], v[r ^ (1 << b)][w], sign);
  const bool in_place = in == out;  // then v[0], unchanged, is not stored
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r == 0 && in_place) continue;
    const long long idx = base + (static_cast<long long>(r) << lo);
    if constexpr (kVec)
      *reinterpret_cast<V*>(out + idx) = pack<T, V>(v[r]);
    else
      out[idx] = v[r][0];
  }
}

template <class A, class V, int kClusterBits, bool kVec>
cudaError_t launch_cluster(const void* in, void* out, long long total,
                           int tile_bits, int sign, cudaStream_t s) {
  using T = typename A::T;
  constexpr int kTile = Tile<T>::kSize;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((total + kTile - 1) / kTile));
  cfg.blockDim = dim3(Tile<T>::kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << kClusterBits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kClusterBits > 0 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, zeta_cluster_kernel<A, V, kClusterBits, kVec>,
                            static_cast<const T*>(in), static_cast<T*>(out),
                            total, tile_bits, sign);
}

template <class A, class V, bool kVec>
cudaError_t dispatch_cluster(const void* in, void* out, long long total,
                             int bits, int sign, cudaStream_t s) {
  constexpr int kTileBits = Tile<typename A::T>::kBits;
  const int tile_bits = bits < kTileBits ? bits : kTileBits;
  switch (bits - tile_bits) {
    case 0:
      return launch_cluster<A, V, 0, kVec>(in, out, total, tile_bits, sign, s);
    case 1:
      return launch_cluster<A, V, 1, kVec>(in, out, total, tile_bits, sign, s);
    case 2:
      return launch_cluster<A, V, 2, kVec>(in, out, total, tile_bits, sign, s);
    default:
      return launch_cluster<A, V, 3, kVec>(in, out, total, tile_bits, sign, s);
  }
}

template <class A, class V>
cudaError_t dispatch_vec(const void* in, void* out, long long total,
                         int bits, int sign, cudaStream_t s) {
  using G = Tile<typename A::T>;
  if (bits > G::kBits + kMaxClusterBits ||
      (total + G::kSize - 1) / G::kSize > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool vec =
      (total % 4) == 0 &&
      ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  return vec ? dispatch_cluster<A, V, true>(in, out, total, bits, sign, s)
             : dispatch_cluster<A, V, false>(in, out, total, bits, sign, s);
}

template <class A, class V, int kBits, bool kVec>
cudaError_t launch_high(const void* in, void* out, long long total, int lo,
                        int sign, cudaStream_t s) {
  using T = typename A::T;
  const long long columns = total >> (kBits + (kVec ? kLaneBits<T, V> : 0));
  const dim3 grid(
      static_cast<unsigned>((columns + kHighThreads<T> - 1) /
                            kHighThreads<T>));
  zeta_high_kernel<A, V, kBits, kVec><<<grid, kHighThreads<T>, 0, s>>>(
      static_cast<const T*>(in), static_cast<T*>(out), columns, lo, sign);
  return cudaSuccess;
}

template <class A, class V, bool kVec>
cudaError_t dispatch_high_bits(const void* in, void* out, long long total,
                               int lo, int bits, int sign, cudaStream_t s) {
  switch (bits) {
    case 1:
      return launch_high<A, V, 1, kVec>(in, out, total, lo, sign, s);
    case 2:
      return launch_high<A, V, 2, kVec>(in, out, total, lo, sign, s);
    case 3:
      return launch_high<A, V, 3, kVec>(in, out, total, lo, sign, s);
    case 4:
      return launch_high<A, V, 4, kVec>(in, out, total, lo, sign, s);
    default:
      return launch_high<A, V, kHighMaxBits, kVec>(in, out, total, lo, sign,
                                                   s);
  }
}

template <class A, class V>
cudaError_t dispatch_high(const void* in, void* out, long long total, int lo,
                          int bits, int sign, cudaStream_t s) {
  using T = typename A::T;
  if (((total >> bits) + kHighThreads<T> - 1) / kHighThreads<T> >
      0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool vec =
      lo >= kLaneBits<T, V> && (total % kLanes<T, V>) == 0 &&
      ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  return vec ? dispatch_high_bits<A, V, true>(in, out, total, lo, bits, sign,
                                              s)
             : dispatch_high_bits<A, V, false>(in, out, total, lo, bits,
                                               sign, s);
}

}  // namespace

// Low `bits` (<= 15 at 4 bytes, <= 14 at 8) bits of every 2^bits row of
// `in` (total elements) into `out`, in one launch; `out` may be `in`.
// Returns a cudaError_t.
extern "C" int repro_zeta_cluster(const void* in, void* out, long long total,
                                  int bits, int sign, int dtype, int device,
                                  void* stream) {
  if (bits < 0 || total <= 0 || (total & ((1LL << bits) - 1)) != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = repro::use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kInt32)
    err = dispatch_vec<repro::U32Arith, uint4>(in, out, total, bits, sign, s);
  else if (dtype == repro::kFloat32)
    err = dispatch_vec<repro::F32Arith, float4>(in, out, total, bits, sign, s);
  else if (dtype == repro::kFloat64)
    err = dispatch_vec<repro::F64Arith, double2>(in, out, total, bits, sign,
                                                 s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Bits lo..hi-1 (1 <= hi - lo <= kHighMaxBits) of every 2^hi block of
// `in` (total elements) into `out`, in one launch; `out` may be `in`.
// Returns a cudaError_t.
extern "C" int repro_zeta_high(const void* in, void* out, long long total,
                               int lo, int hi, int sign, int dtype,
                               int device, void* stream) {
  const int bits = hi - lo;
  if (lo < 0 || bits < 1 || bits > kHighMaxBits || hi > 62 || total <= 0 ||
      (total & ((1LL << hi) - 1)) != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = repro::use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kInt32)
    err = dispatch_high<repro::U32Arith, uint4>(in, out, total, lo, bits,
                                                sign, s);
  else if (dtype == repro::kFloat32)
    err = dispatch_high<repro::F32Arith, float4>(in, out, total, lo, bits,
                                                 sign, s);
  else if (dtype == repro::kFloat64)
    err = dispatch_high<repro::F64Arith, double2>(in, out, total, lo, bits,
                                                  sign, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
