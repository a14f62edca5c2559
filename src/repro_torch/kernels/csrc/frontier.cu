// K1: one IDX-DFS hop over a chunk of partial paths (the frontier masks).
//
// Replaces the TPU kernel src/repro/kernels/frontier_expand.py
// `_frontier_kernel` (entry `frontier_expand_masks`).  For each row of the
// (C, k+1) int32 path matrix, all at one depth: read the last vertex v,
// gather begin[v] and end[v, b] with b = k - depth - 1, read up to max_deg
// candidates from dst, drop those already on the row's prefix, and split
// the rest into emit (== t) and continue.  Outputs the (C, max_deg)
// candidate / emit / continue matrices and adds the Fig.-6 counters
// [edges, edges, invalid, 0] into `counters` (zeroed by the caller).
//
// What bounds it on the H100: bytes.  Per candidate slot it reads one dst
// entry (4 B) and compares it with at most k+1 prefix entries that sit in
// L1, and it writes three int32 outputs (12 B); there are a handful of
// integer operations per byte, far below the card's compute rate.  The
// gathers into begin/end/dst are irregular, so the sustained rate is the
// rate of scattered 32-byte sectors, not the streaming rate.
//
// Design: one warp per row (the per-row logic is in frontier.cuh, shared
// with the resident deque round K2).  Lanes walk the row's candidate slots in
// steps of 32, so the dst reads of one warp are contiguous (one index
// segment per row) and the output writes are coalesced.  The row prefix
// is read by every lane from the same addresses (a broadcast through L1).
// The dead-row test and the duplicate count are warp votes; the block
// sums its warps' counters in shared memory and issues one atomicAdd per
// counter.  Integer sums are exact in any order, so the counters equal
// the plain version's.  Compaction into rows (which must keep row-major
// order) is left to the wrapper, as on the TPU.

#include <cuda_runtime.h>

#include "frontier.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void frontier_masks_kernel(
    const int* __restrict__ paths, const int* __restrict__ begin,
    const int* __restrict__ end, const int* __restrict__ dst,
    const int* __restrict__ meta, int* __restrict__ vnew,
    int* __restrict__ emit, int* __restrict__ cont,
    int* __restrict__ counters, int rows, int k1, int max_deg, int mf) {
  __shared__ int blk_edges;
  __shared__ int blk_invalid;
  if (threadIdx.x == 0) {
    blk_edges = 0;
    blk_invalid = 0;
  }
  __syncthreads();

  const int depth = meta[0];
  const int t = meta[1];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);

  if (row < rows) {  // uniform across the warp
    const frontier::Row r = frontier::row_window(
        paths + static_cast<long long>(row) * k1, begin, end, k1, depth, k1);
    bool alive = false;
    int dups = 0;
    for (int j0 = 0; j0 < max_deg; j0 += 32) {
      const int j = j0 + lane;
      const frontier::Slot s = frontier::row_slot(
          r, dst, mf, t, j, max_deg, frontier::PrefixInMemory{r.prow, depth});
      if (j < max_deg) {
        const long long o = static_cast<long long>(row) * max_deg + j;
        vnew[o] = (s.emit || s.cont) ? s.v : frontier::kPad;
        emit[o] = s.emit ? 1 : 0;
        cont[o] = s.cont ? 1 : 0;
      }
      alive |= __any_sync(0xffffffffu, s.emit || s.cont);
      dups += __popc(__ballot_sync(0xffffffffu, s.in_range && s.dup));
    }
    if (lane == 0) {
      atomicAdd(&blk_edges, frontier::row_edges(r));
      atomicAdd(&blk_invalid, frontier::row_invalid(r, dups, alive));
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(&counters[0], blk_edges);
    atomicAdd(&counters[1], blk_edges);
    atomicAdd(&counters[2], blk_invalid);
  }
}

}  // namespace

extern "C" int frontier_masks_launch(
    const int* paths, const int* begin, const int* end, const int* dst,
    const int* meta, int* vnew, int* emit, int* cont, int* counters,
    int rows, int k1, int max_deg, int mf, cudaStream_t stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  frontier_masks_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      paths, begin, end, dst, meta, vnew, emit, cont, counters, rows, k1,
      max_deg, mf);
  return static_cast<int>(cudaGetLastError());
}
