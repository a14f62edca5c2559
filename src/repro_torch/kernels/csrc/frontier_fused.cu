// K5: one fused IDX-DFS hop over the chunks of many queries.
//
// Replaces the TPU kernel src/repro/kernels/frontier_expand.py
// `_frontier_fused_kernel` (entry `frontier_fused_masks`) and, for the hop
// entry, the compaction, child rows and per-member counts that `repro`'s
// `ops.frontier_expand_fused` runs after it.  It is K1 for m queries in one
// launch.  The (rows, k1max) int32 path matrix packs one chunk per member,
// rows in ascending member rank; `rank` (rows,) tags each row with its
// member and `tvec` / `depthv` (m,) give each member's target and the
// depth of its chunk.  For each row: read the last vertex v at the
// member's depth, gather begin[v] and end[v, b] with b = k_member - depth
// - 1 from the member's own index, read up to max_deg candidates from the
// member's own dst (positions clipped inside that member's array, so no
// row reads another member's edges), drop those already on the row's
// prefix, and split the rest into emit (== t) and continue.  The
// per-member Fig.-6 counters are [edges, edges, invalid, 0].  Rows whose
// rank is no member's, and PAD rows, contribute nothing.  The per-row
// logic is frontier.cuh's, shared with K1 and K2.
//
// Two entries over one per-row phase (MemberRow):
//  * masks (`frontier_fused_masks_launch`): the (rows, max_deg) candidate
//    / emit / continue matrices and the (m, 4) counters, which the launch
//    function zeroes on the stream (`cudaMemsetAsync`) before the kernel;
//  * hop (`frontier_fused_hop_launch`, two launches, K1's hop for many
//    queries): the children themselves, in the flat row-major (row, slot)
//    order of a prefix-sum compaction, so each member's emit and continue
//    children form one segment in its solo emission order.  The count
//    launch sums each block's emit and continue children and adds the
//    per-member sums into `head` = [n_emit (m) | n_cont (m) | counters
//    (m x 4)], which the launch function zeroes; the write launch gives
//    each block the exclusive prefix of the block totals before it, ranks
//    its rows by a block scan and each row's children by ballots, and
//    writes every child row once.  A member whose `wantc` is 0 (its last
//    hop) gets no continue child and n_cont 0; its counters still come
//    from the full continue mask.  The masks never reach device memory.
//
// The member table.  The TPU wrapper concatenates every member's begin,
// budget column of end and padded dst into (m*n,) / (m*mfm,) arrays on
// every round.  Here the kernels read a small (m, 5) int64 table of
// per-member [begin pointer, end pointer, dst pointer, mf, k+1] on the
// device and read the budget column of end themselves.  The caller puts
// the table into the one host-to-device copy it makes anyway (the packed
// rows and per-member scalars, `ops.frontier_expand_fused`), from pinned
// memory without a stream sync, so a launch waits on nothing.  Every
// offset is 64-bit (rows * k1, v * (k+1)).
//
// What bounds it on the H100: bytes, as for K1.  Per candidate slot it
// reads one dst entry (4 B); the masks write three int32 outputs a slot
// (12 B), the hop one (k1max)-int row a child.  The gathers are
// irregular, so the sustained rate is that of scattered 32-byte sectors.
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
//  * The hop's grid and row ranges are K1's hop's (frontier.cuh): at most
//    kBlocksPerSm blocks an SM, each owning a contiguous range of rows, so
//    a block's children are contiguous in the output.
//  * Per-member sums (MemberSums): lanes with equal ranks in a warp add
//    their rows' sums together (`__match_any_sync`, `__reduce_add_sync`),
//    the warps of a block in shared memory, and one thread per member the
//    block touched makes the global atomicAdds.  Integer sums are exact
//    in any order, so the counts equal the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "frontier.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxGrid = 1024;  // block totals the hop's scratch holds
constexpr int kTableCols = 5;   // begin, end, dst pointers; mf; k+1
using frontier::Group;
using frontier::RowCounts;
using frontier::kFull;
using frontier::kPad;

struct Fused {
  const int* paths;
  const int* rank;
  const int* tvec;
  const int* depthv;
  const int* wantc;  // (m,) or nullptr: every member continues
  const long long* table;
  int rows;
  int k1max;
  int max_deg;
  int m;
  int width;  // W
};

// The per-row phase: the row's member, its candidate window in that
// member's index and its prefix in the group's registers.  A row past
// `live`, or whose rank is no member's, is inert (no candidates).
struct MemberRow {
  frontier::Row row;
  frontier::PrefixInLanes prefix;
  const int* dst = nullptr;
  int mf = 1;
  int t = kPad;
  int rank = -1;  // the member, -1 for an inert row
  bool want_cont = false;
  int sub;

  __device__ __forceinline__ MemberRow(const Fused& f, int r, bool live,
                                       const Group& g)
      : row{f.paths, -1, 0, 0, false},
        prefix{f.paths, kPad, -1, g.sub, f.width, f.k1max},
        sub(g.sub) {
    if (live) {
      const int* prow = f.paths + static_cast<long long>(r) * f.k1max;
      row.prow = prow;
      const int k = f.rank[r];
      if (k >= 0 && k < f.m) {
        const long long* mt = f.table + static_cast<long long>(k) * kTableCols;
        const int* begin =
            reinterpret_cast<const int*>(static_cast<uintptr_t>(mt[0]));
        const int* end =
            reinterpret_cast<const int*>(static_cast<uintptr_t>(mt[1]));
        dst = reinterpret_cast<const int*>(static_cast<uintptr_t>(mt[2]));
        mf = static_cast<int>(mt[3]);
        t = f.tvec[k];
        rank = k;
        want_cont = f.wantc == nullptr || f.wantc[k] != 0;
        row = frontier::row_window(prow, begin, end, static_cast<int>(mt[4]),
                                   f.depthv[k], f.k1max);
      }
    }
    const int d = row.valid ? row.depth : -1;  // no prefix test otherwise
    prefix.prow = row.prow;
    prefix.depth = d;
    prefix.first = g.sub <= d && g.sub < f.k1max ? row.prow[g.sub] : kPad;
  }

  // the group's slot j0 + sub
  __device__ __forceinline__ frontier::Slot slot(const Fused& f,
                                                 int j0) const {
    return frontier::row_slot(row, dst, mf, t, j0 + sub, f.max_deg, prefix);
  }
};

// Per-member sums of one block, [emit, cont, edges, invalid]: members
// base .. base + kThreads - 1 in shared memory, added to global memory
// once a block (`flush`); a member outside that window (ranks that do not
// ascend with the rows) adds straight to global memory.  `n_emit` and
// `n_cont` (m,) may be nullptr (the masks entry); `counters` is (m, 4).
struct MemberSums {
  int* s;  // 4 * kThreads ints of shared memory
  int base;
  int* n_emit;
  int* n_cont;
  int* counters;
  int m;

  // zeroes this thread's entries; the caller syncs the block before add
  __device__ __forceinline__ MemberSums(int* shared, int first_rank,
                                        int* ne, int* nc, int* ctr, int mm)
      : s(shared), base(first_rank), n_emit(ne), n_cont(nc), counters(ctr),
        m(mm) {
    for (int c = 0; c < 4; ++c) s[c * kThreads + threadIdx.x] = 0;
  }

  __device__ __forceinline__ void to_global(int key, int4 v) const {
    if (v.x != 0 && n_emit != nullptr) atomicAdd(&n_emit[key], v.x);
    if (v.y != 0 && n_cont != nullptr) atomicAdd(&n_cont[key], v.y);
    int* c = counters + static_cast<long long>(key) * 4;
    if (v.z != 0) {
      atomicAdd(&c[0], v.z);
      atomicAdd(&c[1], v.z);
    }
    if (v.w != 0) atomicAdd(&c[2], v.w);
  }

  // `v` of member `key` (-1: nothing); every lane of the warp calls it
  __device__ __forceinline__ void add(int key, int4 v) {
    if (v.x == 0 && v.y == 0 && v.z == 0 && v.w == 0) key = -1;
    const unsigned peers = __match_any_sync(kFull, key);
    v.x = __reduce_add_sync(peers, v.x);
    v.y = __reduce_add_sync(peers, v.y);
    v.z = __reduce_add_sync(peers, v.z);
    v.w = __reduce_add_sync(peers, v.w);
    if (key < 0 || (threadIdx.x & 31) != __ffs(peers) - 1) return;
    const int i = key - base;
    if (i >= 0 && i < kThreads) {
      atomicAdd(&s[i], v.x);
      atomicAdd(&s[kThreads + i], v.y);
      atomicAdd(&s[2 * kThreads + i], v.z);
      atomicAdd(&s[3 * kThreads + i], v.w);
    } else {
      to_global(key, v);
    }
  }

  // after a block sync that follows every add
  __device__ __forceinline__ void flush() const {
    const int key = base + static_cast<int>(threadIdx.x);
    if (key < m)
      to_global(key, make_int4(s[threadIdx.x], s[kThreads + threadIdx.x],
                               s[2 * kThreads + threadIdx.x],
                               s[3 * kThreads + threadIdx.x]));
  }
};

// The rank of the block's first row (where its members' window starts),
// clipped to the members.
__device__ __forceinline__ int first_rank(const Fused& f, int r) {
  const int k = r < f.rows ? f.rank[r] : 0;
  return k >= 0 && k < f.m ? k : 0;
}

// A row's [emit, cont, edges, invalid] on its group's first lane.
__device__ __forceinline__ int4 row_sums(const MemberRow& mr,
                                         const RowCounts& rc,
                                         const Group& g) {
  if (g.sub != 0 || mr.rank < 0) return make_int4(0, 0, 0, 0);
  return make_int4(rc.emit, rc.cont, frontier::row_edges(mr.row),
                   frontier::row_invalid(mr.row, rc.dups, rc.alive));
}

// Masks: one row a group, one step a block.
__global__ void __launch_bounds__(kThreads) frontier_fused_kernel(
    Fused f, int* __restrict__ vnew, int* __restrict__ emit,
    int* __restrict__ cont, int* __restrict__ counters) {
  __shared__ int sums[4 * kThreads];
  const Group g = frontier::group_of(f.width);
  const int first = blockIdx.x * g.per_step;
  const int row = first + g.slot;
  MemberSums ms(sums, first_rank(f, first), nullptr, nullptr, counters,
                f.m);
  __syncthreads();
  const MemberRow mr(f, row, row < f.rows, g);
  RowCounts rc;
  for (int j0 = 0; j0 < f.max_deg; j0 += f.width) {
    const frontier::Slot s = mr.slot(f, j0);
    const int j = j0 + g.sub;
    if (row < f.rows && j < f.max_deg) {
      const long long o = static_cast<long long>(row) * f.max_deg + j;
      vnew[o] = (s.emit || s.cont) ? s.v : kPad;
      emit[o] = s.emit ? 1 : 0;
      cont[o] = s.cont ? 1 : 0;
    }
    rc.add(s, g, true);
  }
  ms.add(mr.rank, row_sums(mr, rc, g));
  __syncthreads();
  ms.flush();
}

// Hop, count launch: blk[block] = (emit, cont) children of the block's
// rows; the per-member sums into the head.
__global__ void __launch_bounds__(kThreads) frontier_fused_hop_count_kernel(
    Fused f, int4* __restrict__ blk, int* __restrict__ head) {
  __shared__ int4 red[kWarpsPerBlock];
  __shared__ int sums[4 * kThreads];
  const Group g = frontier::group_of(f.width);
  const int2 rg = frontier::block_rows(f.rows, g.per_step);
  MemberSums ms(sums, first_rank(f, rg.x), head, head + f.m, head + 2 * f.m,
                f.m);
  __syncthreads();
  int2 mine = make_int2(0, 0);
  for (int base = rg.x; base < rg.y; base += g.per_step) {
    const int r = base + g.slot;
    const MemberRow mr(f, r, r < rg.y, g);
    RowCounts rc;
    for (int j0 = 0; j0 < f.max_deg; j0 += f.width)
      rc.add(mr.slot(f, j0), g, mr.want_cont);
    const int4 v = row_sums(mr, rc, g);
    mine.x += v.x;
    mine.y += v.y;
    ms.add(mr.rank, v);
  }
  // block_sum syncs the block before it returns, after every add
  const int4 tot =
      frontier::block_sum<kWarpsPerBlock>(make_int4(mine.x, mine.y, 0, 0),
                                          red);
  if (threadIdx.x == 0) blk[blockIdx.x] = tot;
  ms.flush();
}

// Hop, write launch: every child row at its flat row-major rank.
__global__ void __launch_bounds__(kThreads) frontier_fused_hop_write_kernel(
    Fused f, const int4* __restrict__ blk, int* __restrict__ emit_rows,
    int* __restrict__ cont_rows) {
  __shared__ int4 red4[kWarpsPerBlock];
  __shared__ int2 red2[kWarpsPerBlock];
  __shared__ int sv[kThreads];
  const Group g = frontier::group_of(f.width);
  const int2 rg = frontier::block_rows(f.rows, g.per_step);
  int* const gsv = sv + (threadIdx.x - g.sub);  // this group's W slots

  // the children of the blocks before this one
  int4 before = make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < static_cast<int>(blockIdx.x); i += kThreads) {
    const int4 v = blk[i];
    before.x += v.x;
    before.y += v.y;
  }
  before = frontier::block_sum<kWarpsPerBlock>(before, red4);

  long long run_e = before.x;  // children of the rows before this step
  long long run_c = before.y;
  for (int base = rg.x; base < rg.y; base += g.per_step) {
    const int r = base + g.slot;
    const MemberRow mr(f, r, r < rg.y, g);
    RowCounts rc;
    frontier::Slot first{};
    for (int j0 = 0; j0 < f.max_deg; j0 += f.width) {
      const frontier::Slot s = mr.slot(f, j0);
      if (j0 == 0) first = s;
      rc.add(s, g, mr.want_cont);
    }
    // rank the step's rows: each group's count on its first lane
    int2 step_tot;
    const int2 ex = frontier::block_scan<kWarpsPerBlock>(
        g.sub == 0 ? make_int2(rc.emit, rc.cont) : make_int2(0, 0), red2,
        &step_tot);
    long long eo = run_e + __shfl_sync(kFull, ex.x, g.leader);
    long long co = run_c + __shfl_sync(kFull, ex.y, g.leader);
    const int col = mr.row.depth + 1;
    for (int j0 = 0; j0 < f.max_deg; j0 += f.width) {
      const frontier::Slot s = j0 == 0 ? first : mr.slot(f, j0);
      const bool c = s.cont && mr.want_cont;
      const unsigned em = __ballot_sync(kFull, s.emit) & g.mask;
      const unsigned cm = __ballot_sync(kFull, c) & g.mask;
      eo = frontier::write_children(emit_rows, eo, em, s.emit, s.v,
                                    mr.row.prow, f.k1max, col, g, f.width,
                                    gsv);
      co = frontier::write_children(cont_rows, co, cm, c, s.v, mr.row.prow,
                                    f.k1max, col, g, f.width, gsv);
    }
    run_e += step_tot.x;
    run_c += step_tot.y;
  }
}

}  // namespace

// The masks: `counters` (m, 4) is zeroed here, on the stream, before the
// kernel.
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
  const Fused f{paths, rank, tvec, depthv, nullptr, table, rows, k1max,
                max_deg, m, frontier::group_width(max_deg)};
  const int per_block = kThreads / f.width;
  const int blocks = (rows + per_block - 1) / per_block;
  frontier_fused_kernel<<<blocks, kThreads, 0, stream>>>(f, vnew, emit, cont,
                                                         counters);
  return static_cast<int>(cudaGetLastError());
}

// The hop: `head` (6m,) gets [n_emit (m) | n_cont (m) | counters (m, 4)],
// zeroed here, on the stream, before the kernels; the first n_emit rows of
// `emit_rows` and the first n_cont rows of `cont_rows` (each (., k1max)
// int32, summed over the members) the children in flat row-major order,
// member by member.  `blk` is scratch for kMaxGrid int4 block totals
// (16-byte aligned); `wantc` (m,) int32, 0 on a member's last hop.
extern "C" int frontier_fused_hop_launch(
    const int* paths, const int* rank, const int* tvec, const int* depthv,
    const int* wantc, const long long* table, int* head, int* blk,
    int* emit_rows, int* cont_rows, int rows, int k1max, int max_deg, int m,
    cudaStream_t stream) {
  if (m > 0) {
    const cudaError_t err = cudaMemsetAsync(
        head, 0, static_cast<size_t>(m) * 6 * sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (rows <= 0) return 0;
  const Fused f{paths, rank, tvec, depthv, wantc, table, rows, k1max,
                max_deg, m, frontier::group_width(max_deg)};
  const int grid =
      frontier::hop_grid(rows, f.width, kThreads, kBlocksPerSm, kMaxGrid);
  int4* totals = reinterpret_cast<int4*>(blk);
  frontier_fused_hop_count_kernel<<<grid, kThreads, 0, stream>>>(f, totals,
                                                                 head);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  frontier_fused_hop_write_kernel<<<grid, kThreads, 0, stream>>>(
      f, totals, emit_rows, cont_rows);
  return static_cast<int>(cudaGetLastError());
}
