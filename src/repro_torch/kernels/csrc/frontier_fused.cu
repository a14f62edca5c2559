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
// candidate / emit / continue matrices and adds the per-member Fig.-6
// counters [edges, edges, invalid, 0] into the (m, 4) `counters` (zeroed by
// the caller).  PAD rows carry rank 0 and contribute nothing.
//
// No concatenated tables: the TPU wrapper concatenates every member's
// begin, budget column of end and padded dst into (m*n,) / (m*mfm,) arrays
// on every round.  Here the kernel reads a small (m, 5) int64 table of
// per-member [begin pointer, end pointer, dst pointer, mf, k+1] and reads
// the budget column of end itself, so a round copies nothing but that
// table.  Every offset is 64-bit (rows * k1, v * (k+1)).
//
// What bounds it on the H100: bytes, as for K1.  Per candidate slot it
// reads one dst entry (4 B) and compares it with at most k+1 prefix entries
// that sit in L1, and it writes three int32 outputs (12 B); the gathers are
// irregular, so the sustained rate is that of scattered 32-byte sectors.
//
// Design: one warp per row, as in frontier.cu.  Lanes walk the row's
// candidate slots in steps of 32 (contiguous dst reads, coalesced output
// writes); the dead-row test and the duplicate count are warp votes.  Each
// warp leaves its row's (rank, edges, invalid) in shared memory; then one
// thread per run of equal ranks in the block sums the run and issues one
// atomicAdd per counter, so a block adds once per member it touches.
// Integer sums are exact in any order, so the counters equal the plain
// version's.  Compaction into rows is left to the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = -1;
constexpr int kWarpsPerBlock = 8;
constexpr int kTableCols = 5;  // begin, end, dst pointers; mf; k+1

__global__ void frontier_fused_kernel(
    const int* __restrict__ paths, const int* __restrict__ rank,
    const int* __restrict__ tvec, const int* __restrict__ depthv,
    const long long* __restrict__ table, int* __restrict__ vnew,
    int* __restrict__ emit, int* __restrict__ cont,
    int* __restrict__ counters, int rows, int k1max, int max_deg, int m) {
  __shared__ int s_rank[kWarpsPerBlock];
  __shared__ int s_edges[kWarpsPerBlock];
  __shared__ int s_invalid[kWarpsPerBlock];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  int r = -1;
  int edges = 0;
  int invalid = 0;

  if (row < rows) {  // uniform across the warp
    r = rank[row];
    const bool member_ok = r >= 0 && r < m;
    const int* prow = paths + static_cast<long long>(row) * k1max;
    const int* begin = nullptr;
    const int* end = nullptr;
    const int* dst = nullptr;
    int mf = 1;
    int k1m = 1;
    int depth = -1;
    int t = kPad;
    if (member_ok) {
      const long long* mt = table + static_cast<long long>(r) * kTableCols;
      begin = reinterpret_cast<const int*>(static_cast<uintptr_t>(mt[0]));
      end = reinterpret_cast<const int*>(static_cast<uintptr_t>(mt[1]));
      dst = reinterpret_cast<const int*>(static_cast<uintptr_t>(mt[2]));
      mf = static_cast<int>(mt[3]);
      k1m = static_cast<int>(mt[4]);
      depth = depthv[r];
      t = tvec[r];
    } else {
      r = -1;
    }
    // budget k - depth - 1 of this member, clipped like the TPU code
    int b = k1m - 2 - depth;
    b = b < 0 ? 0 : (b > k1m - 1 ? k1m - 1 : b);
    const bool depth_ok = depth >= 0 && depth < k1max;
    const int last = (member_ok && depth_ok) ? prow[depth] : kPad;
    const bool valid = last != kPad;
    int bg = 0;
    int cnt = 0;
    if (valid) {
      bg = begin[last];
      cnt = end[static_cast<long long>(last) * k1m + b] - bg;
    }
    bool alive = false;
    int dups = 0;
    for (int j0 = 0; j0 < max_deg; j0 += 32) {
      const int j = j0 + lane;
      const bool in_range = j < max_deg && j < cnt;
      int v = kPad;
      bool dup = false;
      if (in_range) {
        long long pos = static_cast<long long>(bg) + j;
        pos = pos < 0 ? 0 : (pos > mf - 1 ? mf - 1 : pos);
        v = dst[pos];
        for (int c = 0; c <= depth; ++c) dup |= (prow[c] == v);
      }
      const bool e = in_range && !dup && v == t;
      const bool co = in_range && !dup && v != t;
      if (j < max_deg) {
        const long long o = static_cast<long long>(row) * max_deg + j;
        vnew[o] = (e || co) ? v : kPad;
        emit[o] = e ? 1 : 0;
        cont[o] = co ? 1 : 0;
      }
      alive |= __any_sync(0xffffffffu, e || co);
      dups += __popc(__ballot_sync(0xffffffffu, in_range && dup));
    }
    edges = valid ? cnt : 0;
    invalid = dups + ((valid && !alive) ? 1 : 0);
  }
  if (lane == 0) {
    s_rank[warp] = r;
    s_edges[warp] = edges;
    s_invalid[warp] = invalid;
  }
  __syncthreads();
  // one thread per run of equal ranks: sum the run, one atomicAdd each
  const int w = threadIdx.x;
  if (w < kWarpsPerBlock && s_rank[w] >= 0
      && (w == 0 || s_rank[w] != s_rank[w - 1])) {
    const int mr = s_rank[w];
    int e = 0;
    int iv = 0;
    for (int x = w; x < kWarpsPerBlock && s_rank[x] == mr; ++x) {
      e += s_edges[x];
      iv += s_invalid[x];
    }
    int* c = counters + static_cast<long long>(mr) * 4;
    if (e != 0) {
      atomicAdd(&c[0], e);
      atomicAdd(&c[1], e);
    }
    if (iv != 0) atomicAdd(&c[2], iv);
  }
}

}  // namespace

extern "C" int frontier_fused_masks_launch(
    const int* paths, const int* rank, const int* tvec, const int* depthv,
    const long long* table, int* vnew, int* emit, int* cont, int* counters,
    int rows, int k1max, int max_deg, int m, cudaStream_t stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  frontier_fused_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      paths, rank, tvec, depthv, table, vnew, emit, cont, counters, rows,
      k1max, max_deg, m);
  return static_cast<int>(cudaGetLastError());
}
