// Connected-subset masks of simple-edge query graphs, for Hopper: the
// (rows, 2^n) table conn[S] = "S induces a connected subgraph" that the
// connected (min,+) sweep of csrc/minplus.cu reads (DPccp's search space
// as a dense bitset table), built on the card from n adjacency bitmasks
// a row.
//
// What it computes.  For each row and each set S: the component of S's
// lowest relation inside S, by the fixpoint
//
//   reach = lowbit(S);  reach = (reach | adj(reach)) & S  until stable
//
// (adj(R) the OR of the neighbour masks of R's relations), and
// conn[S] = (reach == S), conn[0] false: bitwise QueryGraph.connected_mask
// of the graph.
//
// Design.  One thread a (row, S): a block takes 256 consecutive sets of
// one row (blockIdx.y is the row), after reading the row's n neighbour
// masks once into shared memory (n <= 30 words, each in its own bank, so
// the threads' scattered reads never conflict).  A thread reaches the
// fixpoint breadth first: each round expands only the relations that
// the last round added (frontier = adj(frontier) & S & ~reach), so every
// relation of S is expanded at most once: at most popcount(S) shared
// loads a thread, where expanding the whole of reach each round would
// take up to popcount(S)^2.  The result is the same fixpoint.  The write
// is one byte a thread, consecutive threads consecutive bytes.
//
// Bound.  rows * 2^n bytes written and rows * n * 4 read: at (1, 2^19)
// 0.5 MB, 0.16 us at 3.35 TB/s, so a launch at that size is latency,
// not bytes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 30;

__global__ void __launch_bounds__(kThreads) connmask_kernel(
    uint8_t* __restrict__ conn, const int32_t* __restrict__ adj, int n) {
  __shared__ uint32_t nbr[kMaxN];
  const long long row = blockIdx.y;
  if (threadIdx.x < n)
    nbr[threadIdx.x] = static_cast<uint32_t>(adj[row * n + threadIdx.x]);
  __syncthreads();
  const uint32_t S = blockIdx.x * kThreads + threadIdx.x;
  if (S >= (1u << n)) return;
  uint32_t reach = S & (0u - S);
  uint32_t frontier = reach;
  while (frontier != 0u) {
    uint32_t grow = 0u;
    for (uint32_t f = frontier; f != 0u; f &= f - 1u)
      grow |= nbr[__ffs(static_cast<int>(f)) - 1];
    frontier = grow & S & ~reach;
    reach |= frontier;
  }
  conn[(static_cast<size_t>(row) << n) + S] =
      static_cast<uint8_t>(S != 0u && reach == S);
}

}  // namespace

// The connected-subset masks of `rows` graphs over n relations: `adj`
// (rows, n) int32, adj[r][i] the neighbour bits of relation i in row r's
// graph; `conn` (rows, 2^n) one byte each (0 or 1), contiguous.
// Returns a cudaError_t.
extern "C" int repro_connmask(void* conn, const void* adj, long long rows,
                              int n, int device, void* stream) {
  if (n < 1 || n > kMaxN || rows <= 0 || rows > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = repro::use_device(device);
  if (err != cudaSuccess) return err;
  const long long size = 1LL << n;
  const dim3 grid(static_cast<unsigned>((size + kThreads - 1) / kThreads),
                  static_cast<unsigned>(rows));
  connmask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(conn), static_cast<const int32_t*>(adj), n);
  return cudaGetLastError();
}
