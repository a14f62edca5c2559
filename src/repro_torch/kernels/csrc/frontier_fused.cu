// K5: one fused IDX-DFS hop over the chunks of many queries (the fused
// frontier masks).
//
// Replaces the TPU kernel src/repro/kernels/frontier_expand.py
// `_frontier_fused_kernel` (entry `frontier_fused_masks`).  It is K1 for m
// queries in one launch.  The (C, k1max) int32 path matrix packs one chunk
// per member, rows in ascending member rank; `rank` (C,) tags each row with
// its member and `tvec` / `depthv` (m,) give each member's target and the
// depth of its chunk.  For each row: read the last vertex v at the member's
// depth, gather begin[v] and end[v, b] with b = k_member - depth - 1 from
// the member's own index, read up to max_deg candidates from the member's
// own dst (positions clipped inside that member's array, so no row reads
// another member's edges), drop those already on the row's prefix, and
// split the rest into emit (== t) and continue.  Outputs the (C, max_deg)
// candidate / emit / continue matrices and the per-member Fig.-6 counters
// [edges, edges, invalid, 0] in the (m, 4) `counters`, which the launch
// function zeroes on the stream (`cudaMemsetAsync`) before the kernel.
// PAD rows carry rank 0 and contribute nothing.  The per-row logic is
// frontier.cuh's, shared with K1 and K2.
//
// The member table.  The TPU wrapper concatenates every member's begin,
// budget column of end and padded dst into (m*n,) / (m*mfm,) arrays on
// every round.  Here the kernel reads a small (m, 5) int64 table of
// per-member [begin pointer, end pointer, dst pointer, mf, k+1] on the
// device and reads the budget column of end itself.  The caller puts the
// table into the one host-to-device copy it makes anyway (the packed rows
// and per-member scalars, `ops.frontier_expand_fused`), from pinned memory
// without a stream sync, so a launch waits on nothing.  Every offset is
// 64-bit (rows * k1, v * (k+1)).
//
// What bounds it on the H100: bytes, as for K1.  Per candidate slot it
// reads one dst entry (4 B) and writes three int32 outputs (12 B); the
// gathers are irregular, so the sustained rate is that of scattered
// 32-byte sectors.
//
// Design:
//  * A row gets a group of W lanes, W = max_deg rounded up to a power of
//    two and at most 32, so where the batch's fan-out is small a warp
//    serves 32 / W rows instead of leaving most lanes idle.  Lanes walk the
//    row's candidate slots in steps of W (contiguous dst reads, coalesced
//    output writes); the dead-row test and the duplicate count are ballots
//    masked to the group.
//  * The row's prefix is read once into lane registers (lane c of the
//    group holds entry c, W at a time) and each candidate is tested
//    against it by shuffles, instead of every candidate re-reading the
//    prefix from memory.
//  * Counters: lanes with equal ranks in a warp add their rows' sums
//    together (`__match_any_sync`, `__reduce_add_sync`), the warps of a
//    block in shared memory, and one thread per member the block touched
//    issues the global atomicAdds.  Integer sums are exact in any order, so
//    the counters equal the plain version's.  Compaction into rows is left
//    to the wrapper.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "frontier.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kTableCols = 5;  // begin, end, dst pointers; mf; k+1
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) frontier_fused_kernel(
    const int* __restrict__ paths, const int* __restrict__ rank,
    const int* __restrict__ tvec, const int* __restrict__ depthv,
    const long long* __restrict__ table, int* __restrict__ vnew,
    int* __restrict__ emit, int* __restrict__ cont,
    int* __restrict__ counters, int rows, int k1max, int max_deg, int m,
    int width) {
  __shared__ int s_base;
  __shared__ int s_edges[kThreads];
  __shared__ int s_invalid[kThreads];

  const int lane = threadIdx.x & 31;
  const int sub = lane & (width - 1);
  const int grp = lane / width;
  const int per_block = kThreads / width;
  const int row = blockIdx.x * per_block + (threadIdx.x >> 5) * (32 / width)
                  + grp;
  const unsigned gmask =
      width == 32 ? kFull : ((1u << width) - 1u) << (grp * width);
  s_edges[threadIdx.x] = 0;
  s_invalid[threadIdx.x] = 0;
  if (threadIdx.x == 0) s_base = INT_MAX;

  int r = -1;
  frontier::Row fr{paths, -1, 0, 0, false};
  const int* dst = nullptr;
  int mf = 1;
  int t = frontier::kPad;
  if (row < rows) {
    r = rank[row];
    const int* prow = paths + static_cast<long long>(row) * k1max;
    fr.prow = prow;
    if (r >= 0 && r < m) {
      const long long* mt = table + static_cast<long long>(r) * kTableCols;
      const int* begin =
          reinterpret_cast<const int*>(static_cast<uintptr_t>(mt[0]));
      const int* end =
          reinterpret_cast<const int*>(static_cast<uintptr_t>(mt[1]));
      dst = reinterpret_cast<const int*>(static_cast<uintptr_t>(mt[2]));
      mf = static_cast<int>(mt[3]);
      t = tvec[r];
      fr = frontier::row_window(prow, begin, end, static_cast<int>(mt[4]),
                                depthv[r], k1max);
    } else {
      r = -1;
    }
  }
  const int depth = fr.valid ? fr.depth : -1;  // no prefix test otherwise
  const frontier::PrefixInLanes on_prefix{
      fr.prow, sub <= depth && sub < k1max ? fr.prow[sub] : frontier::kPad,
      depth, sub, width, k1max};

  bool alive = false;
  int dups = 0;
  for (int j0 = 0; j0 < max_deg; j0 += width) {
    const int j = j0 + sub;
    const frontier::Slot s =
        frontier::row_slot(fr, dst, mf, t, j, max_deg, on_prefix);
    if (row < rows && j < max_deg) {
      const long long o = static_cast<long long>(row) * max_deg + j;
      vnew[o] = (s.emit || s.cont) ? s.v : frontier::kPad;
      emit[o] = s.emit ? 1 : 0;
      cont[o] = s.cont ? 1 : 0;
    }
    alive |= (__ballot_sync(kFull, s.emit || s.cont) & gmask) != 0;
    dups += __popc(__ballot_sync(kFull, s.in_range && s.dup) & gmask);
  }

  // this row's counters, on its group's first lane
  int edges = 0, invalid = 0;
  if (sub == 0 && r >= 0) {
    edges = frontier::row_edges(fr);
    invalid = frontier::row_invalid(fr, dups, alive);
  }
  const int key = (edges != 0 || invalid != 0) ? r : -1;
  const unsigned peers = __match_any_sync(kFull, key);
  edges = __reduce_add_sync(peers, edges);
  invalid = __reduce_add_sync(peers, invalid);
  const bool leader = key >= 0 && lane == __ffs(peers) - 1;
  __syncthreads();
  if (leader) atomicMin(&s_base, key);
  __syncthreads();
  // ranks ascend with the rows, so the block's members are s_base + i for
  // small i; a rank out of that window (unsorted input) adds straight away
  if (leader) {
    const int i = key - s_base;
    if (i < kThreads) {
      atomicAdd(&s_edges[i], edges);
      atomicAdd(&s_invalid[i], invalid);
    } else {
      int* c = counters + static_cast<long long>(key) * 4;
      atomicAdd(&c[0], edges);
      atomicAdd(&c[1], edges);
      atomicAdd(&c[2], invalid);
    }
  }
  __syncthreads();
  const int e = s_edges[threadIdx.x];
  const int iv = s_invalid[threadIdx.x];
  if (e != 0 || iv != 0) {
    int* c = counters + static_cast<long long>(s_base + threadIdx.x) * 4;
    if (e != 0) {
      atomicAdd(&c[0], e);
      atomicAdd(&c[1], e);
    }
    if (iv != 0) atomicAdd(&c[2], iv);
  }
}

}  // namespace

// `counters` (m, 4) is zeroed here, on the stream, before the kernel.
extern "C" int frontier_fused_masks_launch(
    const int* paths, const int* rank, const int* tvec, const int* depthv,
    const long long* table, int* vnew, int* emit, int* cont, int* counters,
    int rows, int k1max, int max_deg, int m, cudaStream_t stream) {
  if (m > 0) {
    const cudaError_t err = cudaMemsetAsync(
        counters, 0, static_cast<size_t>(m) * 4 * sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (rows <= 0) return 0;
  int width = 1;
  while (width < max_deg && width < 32) width *= 2;
  const int per_block = kThreads / width;
  const int blocks = (rows + per_block - 1) / per_block;
  frontier_fused_kernel<<<blocks, kThreads, 0, stream>>>(
      paths, rank, tvec, depthv, table, vnew, emit, cont, counters, rows,
      k1max, max_deg, m, width);
  return static_cast<int>(cudaGetLastError());
}
