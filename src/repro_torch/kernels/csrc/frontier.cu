// K1: one IDX-DFS hop over a chunk of partial paths of one query.
//
// Replaces the TPU kernel src/repro/kernels/frontier_expand.py
// `_frontier_kernel` (entry `frontier_expand_masks`) and, for the hop
// entry, the compaction that `repro`'s `ops._frontier_expand_jit` fuses
// after it.  For each row of the (rows, k+1) int32 path matrix, all at one
// depth: read the last vertex v, gather begin[v] and end[v, b] with
// b = k - depth - 1, read up to max_deg candidates from dst, drop those
// already on the row's prefix, and split the rest into emit (== t) and
// continue.  The Fig.-6 counters are [edges, edges, invalid, 0].
//
// One per-row phase (frontier.cuh, shared with K2 and K5), two entries:
//  * masks (`frontier_masks_launch`): the (rows, max_deg) candidate /
//    emit / continue matrices and the counters, which the launch function
//    zeroes on the stream before the kernel;
//  * hop (`frontier_hop_launch`, two launches): the children themselves,
//    in the flat row-major (row, slot) order of a prefix-sum compaction
//    (`frontier_expand.compact` + `children`), so emission order is the host
//    driver's.  The count launch sums each block's emit and continue
//    children and counters; the write launch gives each block the
//    exclusive prefix of the block totals before it, ranks its rows by a
//    block scan and each row's children by ballots, and writes every child
//    row once, a group's children as one run of consecutive ints.  The
//    masks never reach device memory.  Block 0 of the write launch writes
//    `head` = [edges, edges, invalid, 0, n_emit, n_cont, 0, 0], which the
//    host reads in one small copy; no counter needs zeroing.  The lane
//    groups, row ranges, child writes and grid are frontier.cuh's, shared
//    with K5's hop (frontier_fused.cu).
//
// What bounds it on the H100: bytes.  Per candidate slot it reads one dst
// entry (4 B); the masks write three int32 outputs a slot (12 B), the hop
// one (k+1)-int row a child.  The gathers into begin/end/dst are
// irregular, so the sustained rate is that of scattered 32-byte sectors.
//
// Design:
//  * A row gets a group of W lanes, W = max_deg rounded up to a power of
//    two and at most 32 (a warp serves 32 / W rows); the group walks the
//    row's slots W at a time (contiguous dst reads, coalesced mask
//    writes).  The row's prefix is held in the group's lane registers and
//    tested by shuffles (frontier::PrefixInLanes), not read by every lane.
//  * The grid is at most kBlocksPerSm blocks an SM; each block owns a
//    contiguous range of rows and walks it kThreads / W rows a step, so a
//    block's children are contiguous in the output.
//  * Counters are summed per group, per block, then added once a block
//    (masks) or stored as the block's total (hop).  Integer sums are exact
//    in any order, so the counters equal the plain version's.

#include <cuda_runtime.h>

#include "frontier.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxGrid = 1024;  // block totals the hop's scratch holds
constexpr int kHead = 8;        // ints of the hop's head
using frontier::Group;
using frontier::RowCounts;
using frontier::kFull;
using frontier::kPad;

struct Hop {
  const int* paths;
  const int* begin;
  const int* end;
  const int* dst;
  const int* meta;  // [depth, t]
  int rows;
  int k1;
  int max_deg;
  int mf;
  int width;  // W
};

// Prefix entries a row at `depth` has, 0..depth, within the row's width:
// the one depth of a chunk bounds the prefix test of all its rows.
__device__ __forceinline__ int depth_span(int depth, int k1) {
  return depth < 0 ? 0 : (depth + 1 < k1 ? depth + 1 : k1);
}

// The per-row phase: the row's candidate window and its prefix in the
// group's registers.  A row past `live` is inert (no candidates).
struct RowPass {
  frontier::Row row;
  frontier::PrefixInLanes prefix;
  int depth;
  int t;
  int sub;

  __device__ __forceinline__ RowPass(const Hop& h, int r, bool live,
                                     const Group& g)
      : row{h.paths, -1, 0, 0, false},
        prefix{h.paths, kPad, -1, g.sub, h.width,
               depth_span(h.meta[0], h.k1)},
        depth(h.meta[0]),
        t(h.meta[1]),
        sub(g.sub) {
    if (live)
      row = frontier::row_window(h.paths + static_cast<long long>(r) * h.k1,
                                 h.begin, h.end, h.k1, depth, h.k1);
    const int d = row.valid ? depth : -1;  // no prefix test otherwise
    prefix.prow = row.prow;
    prefix.depth = d;
    prefix.first = g.sub <= d && g.sub < h.k1 ? row.prow[g.sub] : kPad;
  }

  // the group's slot j0 + sub
  __device__ __forceinline__ frontier::Slot slot(const Hop& h, int j0) const {
    return frontier::row_slot(row, h.dst, h.mf, t, j0 + sub, h.max_deg,
                              prefix);
  }
};

__global__ void __launch_bounds__(kThreads) frontier_masks_kernel(
    Hop h, int* __restrict__ vnew, int* __restrict__ emit,
    int* __restrict__ cont, int* __restrict__ counters) {
  __shared__ int4 red[kWarps];
  const Group g = frontier::group_of(h.width);
  const int2 rg = frontier::block_rows(h.rows, g.per_step);
  int edges = 0, invalid = 0;  // on each group's first lane
  for (int base = rg.x; base < rg.y; base += g.per_step) {
    const int r = base + g.slot;
    const bool live = r < rg.y;
    const RowPass rp(h, r, live, g);
    RowCounts rc;
    for (int j0 = 0; j0 < h.max_deg; j0 += h.width) {
      const frontier::Slot s = rp.slot(h, j0);
      const int j = j0 + g.sub;
      if (live && j < h.max_deg) {
        const long long o = static_cast<long long>(r) * h.max_deg + j;
        vnew[o] = (s.emit || s.cont) ? s.v : kPad;
        emit[o] = s.emit ? 1 : 0;
        cont[o] = s.cont ? 1 : 0;
      }
      rc.add(s, g, true);
    }
    if (g.sub == 0 && live) {
      edges += frontier::row_edges(rp.row);
      invalid += frontier::row_invalid(rp.row, rc.dups, rc.alive);
    }
  }
  const int4 tot =
      frontier::block_sum<kWarps>(make_int4(edges, invalid, 0, 0), red);
  if (threadIdx.x == 0 && (tot.x != 0 || tot.y != 0)) {
    atomicAdd(&counters[0], tot.x);
    atomicAdd(&counters[1], tot.x);
    atomicAdd(&counters[2], tot.y);
  }
}

// Hop, count launch: blk[block] = (emit, cont, edges, invalid) of the
// block's rows.
__global__ void __launch_bounds__(kThreads) frontier_hop_count_kernel(
    Hop h, int want_cont, int4* __restrict__ blk) {
  __shared__ int4 red[kWarps];
  const Group g = frontier::group_of(h.width);
  const int2 rg = frontier::block_rows(h.rows, g.per_step);
  int4 mine = make_int4(0, 0, 0, 0);
  for (int base = rg.x; base < rg.y; base += g.per_step) {
    const int r = base + g.slot;
    const bool live = r < rg.y;
    const RowPass rp(h, r, live, g);
    RowCounts rc;
    for (int j0 = 0; j0 < h.max_deg; j0 += h.width)
      rc.add(rp.slot(h, j0), g, want_cont != 0);
    if (g.sub == 0 && live) {
      mine.x += rc.emit;
      mine.y += rc.cont;
      mine.z += frontier::row_edges(rp.row);
      mine.w += frontier::row_invalid(rp.row, rc.dups, rc.alive);
    }
  }
  const int4 tot = frontier::block_sum<kWarps>(mine, red);
  if (threadIdx.x == 0) blk[blockIdx.x] = tot;
}

// Hop, write launch: every child row at its flat row-major rank.
__global__ void __launch_bounds__(kThreads) frontier_hop_write_kernel(
    Hop h, int want_cont, const int4* __restrict__ blk,
    int* __restrict__ head, int* __restrict__ emit_rows,
    int* __restrict__ cont_rows) {
  __shared__ int4 red4[kWarps];
  __shared__ int2 red2[kWarps];
  __shared__ int sv[kThreads];
  const Group g = frontier::group_of(h.width);
  const int2 rg = frontier::block_rows(h.rows, g.per_step);
  int* const gsv = sv + (threadIdx.x - g.sub);  // this group's W slots

  // the children of the blocks before this one, and of all blocks
  int4 before = make_int4(0, 0, 0, 0);
  int4 all = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < gridDim.x; i += kThreads) {
    const int4 v = blk[i];
    if (i < static_cast<int>(blockIdx.x)) {
      before.x += v.x;
      before.y += v.y;
    }
    all.x += v.x;
    all.y += v.y;
    all.z += v.z;
    all.w += v.w;
  }
  before = frontier::block_sum<kWarps>(before, red4);
  all = frontier::block_sum<kWarps>(all, red4);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    head[0] = all.z;
    head[1] = all.z;
    head[2] = all.w;
    head[3] = 0;
    head[4] = all.x;
    head[5] = all.y;
    head[6] = 0;
    head[7] = 0;
  }

  const int col = h.meta[0] + 1;
  long long run_e = before.x;  // children of the rows before this step
  long long run_c = before.y;
  for (int base = rg.x; base < rg.y; base += g.per_step) {
    const int r = base + g.slot;
    const bool live = r < rg.y;
    const RowPass rp(h, r, live, g);
    RowCounts rc;
    frontier::Slot first{};
    for (int j0 = 0; j0 < h.max_deg; j0 += h.width) {
      const frontier::Slot s = rp.slot(h, j0);
      if (j0 == 0) first = s;
      rc.add(s, g, want_cont != 0);
    }
    // rank the step's rows: each group's count on its first lane
    int2 step_tot;
    const int2 ex = frontier::block_scan<kWarps>(
        g.sub == 0 ? make_int2(rc.emit, rc.cont) : make_int2(0, 0), red2,
        &step_tot);
    long long eo = run_e + __shfl_sync(kFull, ex.x, g.leader);
    long long co = run_c + __shfl_sync(kFull, ex.y, g.leader);
    for (int j0 = 0; j0 < h.max_deg; j0 += h.width) {
      const frontier::Slot s = j0 == 0 ? first : rp.slot(h, j0);
      const bool c = s.cont && want_cont;
      const unsigned em = __ballot_sync(kFull, s.emit) & g.mask;
      const unsigned cm = __ballot_sync(kFull, c) & g.mask;
      eo = frontier::write_children(emit_rows, eo, em, s.emit, s.v,
                                    rp.row.prow, h.k1, col, g, h.width, gsv);
      co = frontier::write_children(cont_rows, co, cm, c, s.v, rp.row.prow,
                                    h.k1, col, g, h.width, gsv);
    }
    run_e += step_tot.x;
    run_c += step_tot.y;
  }
}

// Blocks for `rows` rows: frontier::hop_grid at this file's block shape.
int grid_for(int rows, int width) {
  return frontier::hop_grid(rows, width, kThreads, kBlocksPerSm, kMaxGrid);
}

}  // namespace

// The masks: `counters` (4,) is zeroed here, on the stream, before the
// kernel.
extern "C" int frontier_masks_launch(
    const int* paths, const int* begin, const int* end, const int* dst,
    const int* meta, int* vnew, int* emit, int* cont, int* counters,
    int rows, int k1, int max_deg, int mf, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(counters, 0, 4 * sizeof(int), stream);
  if (err != cudaSuccess || rows <= 0) return static_cast<int>(err);
  const Hop h{paths, begin, end, dst, meta, rows, k1, max_deg, mf,
              frontier::group_width(max_deg)};
  frontier_masks_kernel<<<grid_for(rows, h.width), kThreads, 0, stream>>>(
      h, vnew, emit, cont, counters);
  return static_cast<int>(cudaGetLastError());
}

// The hop: `head` (8,) gets [edges, edges, invalid, 0, n_emit, n_cont, 0,
// 0]; the first n_emit rows of `emit_rows` and the first n_cont rows of
// `cont_rows` (each (., k1) int32) the children in flat row-major order.
// `blk` is scratch for kMaxGrid int4 block totals.  want_cont = 0 writes
// no continue child and n_cont = 0; the counters are unaffected.
extern "C" int frontier_hop_launch(
    const int* paths, const int* begin, const int* end, const int* dst,
    const int* meta, int* head, int* blk, int* emit_rows, int* cont_rows,
    int rows, int k1, int max_deg, int mf, int want_cont,
    cudaStream_t stream) {
  if (rows <= 0)
    return static_cast<int>(
        cudaMemsetAsync(head, 0, kHead * sizeof(int), stream));
  const Hop h{paths, begin, end, dst, meta, rows, k1, max_deg, mf,
              frontier::group_width(max_deg)};
  const int grid = grid_for(rows, h.width);
  int4* totals = reinterpret_cast<int4*>(blk);
  frontier_hop_count_kernel<<<grid, kThreads, 0, stream>>>(h, want_cont,
                                                           totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  frontier_hop_write_kernel<<<grid, kThreads, 0, stream>>>(
      h, want_cont, totals, head, emit_rows, cont_rows);
  return static_cast<int>(cudaGetLastError());
}
