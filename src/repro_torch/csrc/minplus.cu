// One layer of the (min,+) subset sweep in float64, for Hopper: the
// recursion of DPsub[out] (C_cap's pass 2) and of DPccp (connected C_out)
// over a (rows, 2^n) value table, without split tables.
//
// What it computes.  For every row and every set S of one layer k >= 2
// (a list of masks), with dp holding the final values of every smaller
// set:
//
//   seed_ok[S]            dp[S] = seed_vals[S]                (seeded)
//   else !ok[S]           dp[S] = +inf                        (the gate)
//   else                  dp[S] = (min_T dp[T] + dp[S^T]) + card[S]
//
// T ranging over the proper subsets of S that hold S's lowest relation
// (2^(k-1) - 1 of them: each unordered split once), and, for a
// connected sweep, only over those with conn[T] && conn[S^T].  The gate
// `ok` is c(S) <= slack * gamma* for C_cap, conn[S] for C_out, their
// conjunction for the connected cap.  Each add rounds alone (_rn: no
// contraction) and min does not depend on the order of its operands, so
// the values are bitwise those of the gather sweep of core/lattice.py,
// which takes every ordered split (T, S^T) and its mirror: a + b == b + a.
//
// Design.  A group of g = min(32, 2^(k-1)) lanes takes one (row, S); a
// warp takes 32 / g of them, a block 256 lanes.  A group whose set is
// seeded or gated off stores and does no split at all, so pruned sets
// cost one load of the gate.  Otherwise lane l takes the splits
// j = l, l + g, l + 2g, ... < 2^(k-1) - 1, where split j is T = low |
// deposit(j, M), M = S less its lowest bit `low`: the lane deposits its
// first j bit by bit (g <= 32, so at most 5 bits), and steps by g with
// the masked add ((sub | ~M) + deposit(g, M)) & M, deposit(g, M) being
// one bit of M since g is a power of two.  No table of splits exists:
// the sets of a layer come from one int32 list per n (2^n masks ordered
// by layer).  Neighbouring lanes take neighbouring j, so their T (and
// S^T) differ in the low bits of M and often share a sector.  The
// group's minimum is a shuffle reduction; its first lane adds card[S]
// and stores.  A layer reads only smaller sets and writes only its own,
// so one launch per layer, in order, needs no other synchronisation.
//
// Split count.  Given `pairs` (a connected sweep), each lane also counts
// the splits it found valid, both halves connected, in the sets it
// evaluated: summed over a sweep's layers, DPccp's csg/cmp pairs (#ccp)
// of each row's graph, whatever enumerates them.  A lane's count is
// summed over its warp by shuffles and over the block in shared memory,
// and one thread adds the block's total to *pairs (one global atomic a
// block, none for a block with no valid split).  The count reads
// nothing the values are made of and writes nothing they read, so it
// changes no result bit.
//
// Bound.  2 operations per split (add, min) over (2^(k-1) - 1) C(n,k)
// splits a row, at the float64 rate; per row the table read and written
// once and card, the gate and conn read once: at n = 19, ~5.8e8 splits
// (34 us at 34 TFLOP/s) against 13 MB (4 us at 3.35 TB/s), so the
// arithmetic bounds it.  In practice the two dp loads of a split, L2
// hits at random addresses, are what it waits on.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kMaxGroupBits = 5;

template <bool kConn, bool kSeed>
__global__ void __launch_bounds__(kThreads) minplus_layer_kernel(
    double* __restrict__ dp, const double* __restrict__ card,
    const uint8_t* __restrict__ ok, const uint8_t* __restrict__ conn,
    const double* __restrict__ seed_vals,
    const uint8_t* __restrict__ seed_ok, const int32_t* __restrict__ sets,
    unsigned long long* __restrict__ pairs, long long m, long long items,
    int n, int k, int group_bits) {
  const int g = 1 << group_bits;
  const int lane = threadIdx.x & (g - 1);
  const long long item =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >>
      group_bits;
  double best = CUDART_INF;
  unsigned int valid = 0;
  bool eval = false;
  size_t base = 0;
  uint32_t S = 0;
  if (item < items) {
    const long long row = item / m;
    S = static_cast<uint32_t>(sets[item - row * m]);
    base = static_cast<size_t>(row) << n;
    const size_t at = base + S;
    if (kSeed && seed_ok[at]) {
      if (lane == 0) dp[at] = seed_vals[at];
    } else if (ok[at]) {
      eval = true;
    } else if (lane == 0) {
      dp[at] = CUDART_INF;
    }
  }
  if (eval) {
    const uint32_t low = S & (0u - S);
    const uint32_t M = S ^ low;
    // sub = deposit(lane, M); step = deposit(g, M), bit group_bits of M
    uint32_t sub = 0, step = 0, rest = M;
#pragma unroll
    for (int b = 0; b <= kMaxGroupBits; ++b) {
      const uint32_t lb = rest & (0u - rest);
      if ((lane >> b) & 1) sub |= lb;
      if (b == group_bits) step = lb;
      rest ^= lb;
    }
    const uint32_t splits = (1u << (k - 1)) - 1u;
    const double* row_dp = dp + base;
    const uint8_t* row_conn = kConn ? conn + base : nullptr;
#pragma unroll 4
    for (uint32_t j = lane; j < splits; j += g) {
      const uint32_t T = low | sub;
      const uint32_t C = M ^ sub;
      if (!kConn || (row_conn[T] && row_conn[C])) {
        best = fmin(best, __dadd_rn(row_dp[T], row_dp[C]));
        ++valid;
      }
      sub = ((sub | ~M) + step) & M;
    }
  }
  // every lane of the warp reaches the reduction; xor offsets below g
  // stay inside the group
  for (int off = g >> 1; off > 0; off >>= 1)
    best = fmin(best, __shfl_xor_sync(0xffffffffu, best, off, kWarp));
  if (eval && lane == 0) dp[base + S] = __dadd_rn(best, card[base + S]);
  if (kConn && pairs != nullptr) {   // uniform: every thread of the block
    __shared__ unsigned long long block_valid;
    if (threadIdx.x == 0) block_valid = 0;
    __syncthreads();
    for (int off = kWarp >> 1; off > 0; off >>= 1)
      valid += __shfl_xor_sync(0xffffffffu, valid, off, kWarp);
    if ((threadIdx.x & (kWarp - 1)) == 0 && valid != 0)
      atomicAdd(&block_valid, static_cast<unsigned long long>(valid));
    __syncthreads();
    if (threadIdx.x == 0 && block_valid != 0) atomicAdd(pairs, block_valid);
  }
}

template <bool kConn, bool kSeed>
void launch(double* dp, const double* card, const uint8_t* ok,
            const uint8_t* conn, const double* seed_vals,
            const uint8_t* seed_ok, const int32_t* sets,
            unsigned long long* pairs, long long m, long long items, int n,
            int k, int group_bits, long long blocks, cudaStream_t s) {
  minplus_layer_kernel<kConn, kSeed>
      <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
          dp, card, ok, conn, seed_vals, seed_ok, sets, pairs, m, items, n,
          k, group_bits);
}

}  // namespace

// Layer k of the (min,+) sweep over `rows` tables of 2^n float64 values
// (dp, card, ok, conn, seed_vals, seed_ok: (rows, 2^n) contiguous; bools
// one byte each), for the m sets listed at `sets` (int32 masks of
// popcount k).  `conn` null: no split check (the value sweep); `seed_ok`
// null: no seeds (then seed_vals is not read); `pairs` (one uint64, read
// only with `conn`) gains the layer's valid splits, null: no count.
// Returns a cudaError_t.
extern "C" int repro_minplus_layer(void* dp, const void* card,
                                   const void* ok, const void* conn,
                                   const void* seed_vals,
                                   const void* seed_ok, const void* sets,
                                   void* pairs, long long rows, long long m,
                                   int n, int k, int device, void* stream) {
  if (n < 2 || n > 30 || k < 2 || k > n || rows <= 0 || m <= 0 ||
      (seed_ok != nullptr && seed_vals == nullptr))
    return cudaErrorInvalidValue;
  const int group_bits = k - 1 < kMaxGroupBits ? k - 1 : kMaxGroupBits;
  const long long items = rows * m;
  const long long per_block = kThreads >> group_bits;
  const long long blocks = (items + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = repro::use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* d = static_cast<double*>(dp);
  auto* c = static_cast<const double*>(card);
  auto* o = static_cast<const uint8_t*>(ok);
  auto* cn = static_cast<const uint8_t*>(conn);
  auto* sv = static_cast<const double*>(seed_vals);
  auto* so = static_cast<const uint8_t*>(seed_ok);
  auto* st = static_cast<const int32_t*>(sets);
  auto* pr = static_cast<unsigned long long*>(pairs);
  if (cn != nullptr && so != nullptr)
    launch<true, true>(d, c, o, cn, sv, so, st, pr, m, items, n, k,
                       group_bits, blocks, s);
  else if (cn != nullptr)
    launch<true, false>(d, c, o, cn, sv, so, st, pr, m, items, n, k,
                        group_bits, blocks, s);
  else if (so != nullptr)
    launch<false, true>(d, c, o, cn, sv, so, st, pr, m, items, n, k,
                        group_bits, blocks, s);
  else
    launch<false, false>(d, c, o, cn, sv, so, st, pr, m, items, n, k,
                         group_bits, blocks, s);
  return cudaGetLastError();
}
