// K2: one round of the device-resident work deque, as one persistent
// kernel: the whole loop of pop -> frontier masks -> compact -> push runs
// on the card, and the host reads the state once when the launch ends.
//
// Replaces the TPU kernel src/repro/kernels/ops.py `_deque_round_jit`, the
// `lax.while_loop` that drives K1 (`_frontier_pallas`) over a device
// arena.  State: the arena of chunk rows (live rows [0, top)), the chunks'
// meta slots (depth and length, bottom to top, n_chunks of them), the
// round's emit buffer.  Before every pop the loop evaluates repro's `cond`
// (chunks left, pops below round_pops, and one worst-case push of room in
// the arena, the emit buffer and the meta slots) and leaves as soon as it
// fails; there are no masked iterations.  Each pop:
//  1. reads the top chunk's length and depth, so its rows are
//     [top - clen, top);
//  2. runs K1's per-row logic (frontier.cuh) on those clen rows only;
//  3. ranks the emit and continue flags by exclusive prefix sums in
//     row-major (row, slot) order -- no atomics choose a position -- so
//     emission order and the pieces' order equal the plain version's;
//  4. appends the emit children at n_emit, scatters the continue children
//     back into the arena as chunk_size pieces with piece 0 on top (the
//     host loop pushes pieces reversed), and writes the pieces' meta
//     slots;
//  5. adds the Fig.-6 counters (integer atomics, exact in any order).
// Only the contract's regions are written: arena[:arena_cap], meta slots
// below max_chunks, emitbuf/emitlen[:n_emit], and the scalars.  The
// scratch tails that repro's masked scatters hit are not touched.
//
// What bounds it on the H100: latency.  The bytes of a round are a few
// megabytes (rows in, candidate edges, child rows out: microseconds at
// 3.35 TB/s), but pop i + 1 reads the state that pop i wrote, so a round
// is a chain of dependent pops, each two grid-wide barriers and a few
// dependent global reads (meta, row, begin/end, dst) deep.
//
// Design: a cooperative launch of one block per SM that stays resident for
// the whole round (cudaLaunchCooperativeKernel; grid.sync() between
// phases).  Every block keeps the scalar state (top, n_chunks, n_emit,
// pops) in registers and updates it identically, so all blocks leave the
// loop together.  A pop's rows are cut into one contiguous range per
// block, one warp per row:
//  * phase 1: each warp counts its row's emit and continue candidates
//    (warp votes), copies the row to a workspace (the continue children
//    overwrite the popped rows in the arena), and the block publishes its
//    totals;  -- grid.sync --
//  * phase 2: each block sums the totals of the blocks before it (its
//    base) and of all blocks, scans its rows' counts in tiles of 256
//    (warp shuffles), and each warp writes its row's children at base +
//    row offset + the lane's rank in the warp's vote; the grid writes the
//    pieces' meta slots;  -- grid.sync --
// so a pop costs two barriers whatever its size, and its work is
// proportional to the popped chunk, clen rows by the rows' own fan-out.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "frontier.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// scal: the scalars the host reads back, one int32 each
constexpr int kTop = 0;
constexpr int kChunks = 1;
constexpr int kEmit = 2;
constexpr int kPops = 3;
constexpr int kCounters = 4;  // four Fig.-6 counters
constexpr int kIters = 8;     // loop condition evaluations

struct Geometry {
  int k1;          // path width k + 1
  int cs;          // chunk size of the pushed pieces
  int block_rows;  // rows one pop reads at most
  int max_deg;     // pow2 fan-out bound of the index
  int cap;         // block_rows * max_deg
  int arena_cap;
  int emit_cap;
  int max_chunks;
  int max_pieces;
  int round_pops;
};

__global__ void __launch_bounds__(kThreads, 1) deque_round_kernel(
    int* arena, int* meta_depth, int* meta_len, const int* top_in,
    const int* nc_in, const int* __restrict__ begin,
    const int* __restrict__ end, const int* __restrict__ dst, int mf, int t,
    int* __restrict__ emitbuf, int* __restrict__ emitlen, int* scal,
    int2* row_cnt, int2* blk_cnt, int* rows_ws, Geometry g) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int4 red4[kWarps];
  __shared__ int2 red2[kWarps];
  __shared__ int2 row_off[kThreads];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = gridDim.x;
  const int b = blockIdx.x;
  const int k1 = g.k1;
  const unsigned lt = (1u << lane) - 1u;
  if (b == 0 && threadIdx.x < 4) scal[kCounters + threadIdx.x] = 0;

  long long top = *top_in;
  long long nc = *nc_in;
  long long ne = 0;
  int pops = 0;
  int iters = 0;
  int edges = 0;    // this warp's Fig.-6 sums over the round (lane 0)
  int invalid = 0;

  while (true) {
    ++iters;
    if (!(nc > 0 && pops < g.round_pops
          && top + g.cap <= g.arena_cap && ne + g.cap <= g.emit_cap
          && nc + g.max_pieces <= g.max_chunks))
      break;
    const long long cidx = nc - 1;
    const int clen = meta_len[cidx];
    const int cdepth = meta_depth[cidx];
    const long long cstart = top - clen;
    const int rows = clen < g.block_rows ? clen : g.block_rows;
    const bool wantc = cdepth + 1 < k1 - 1;
    const int r0 = static_cast<int>(static_cast<long long>(rows) * b / nb);
    const int r1 =
        static_cast<int>(static_cast<long long>(rows) * (b + 1) / nb);

    // phase 1: count each row's candidates, copy the rows aside
    int2 mine = make_int2(0, 0);
    for (int r = r0 + warp; r < r1; r += kWarps) {
      const int* src = arena + (cstart + r) * k1;
      int* copy = rows_ws + static_cast<long long>(r) * k1;
      for (int c = lane; c < k1; c += 32) copy[c] = src[c];
      const frontier::Row row =
          frontier::row_window(src, begin, end, k1, cdepth, k1);
      const int span = row.cnt < g.max_deg ? row.cnt : g.max_deg;
      int ec = 0, cc = 0, dups = 0;
      bool alive = false;
      for (int j0 = 0; j0 < span; j0 += 32) {
        const frontier::Slot s =
            frontier::row_slot(row, dst, mf, t, j0 + lane, g.max_deg,
                               frontier::PrefixInMemory{src, cdepth});
        ec += __popc(__ballot_sync(kFull, s.emit));
        cc += __popc(__ballot_sync(kFull, s.cont && wantc));
        alive |= __any_sync(kFull, s.emit || s.cont);
        dups += __popc(__ballot_sync(kFull, s.in_range && s.dup));
      }
      if (lane == 0) {
        row_cnt[r] = make_int2(ec, cc);
        mine.x += ec;
        mine.y += cc;
        edges += frontier::row_edges(row);
        invalid += frontier::row_invalid(row, dups, alive);
      }
    }
    const int4 bsum =
        frontier::block_sum<kWarps>(make_int4(mine.x, mine.y, 0, 0), red4);
    if (threadIdx.x == 0) blk_cnt[b] = make_int2(bsum.x, bsum.y);
    grid.sync();

    // phase 2: positions from prefix sums, then the writes
    int4 acc = make_int4(0, 0, 0, 0);  // (base e, base c, total e, total c)
    for (int i = threadIdx.x; i < nb; i += kThreads) {
      const int2 v = blk_cnt[i];
      if (i < b) {
        acc.x += v.x;
        acc.y += v.y;
      }
      acc.z += v.x;
      acc.w += v.y;
    }
    acc = frontier::block_sum<kWarps>(acc, red4);
    const long long n_emit = acc.z;
    const long long n_cont = acc.w;
    const long long n_pieces = (n_cont + g.cs - 1) / g.cs;
    for (long long pj = static_cast<long long>(b) * kThreads + threadIdx.x;
         pj < n_pieces; pj += static_cast<long long>(nb) * kThreads) {
      const long long slot = cidx + n_pieces - 1 - pj;
      const long long left = n_cont - pj * g.cs;
      meta_depth[slot] = cdepth + 1;
      meta_len[slot] = static_cast<int>(left < g.cs ? left : g.cs);
    }
    int2 run = make_int2(acc.x, acc.y);
    for (int tile = r0; tile < r1; tile += kThreads) {
      const int r = tile + threadIdx.x;
      int2 tile_tot;
      const int2 ex =
          frontier::block_scan<kWarps>(r < r1 ? row_cnt[r] : make_int2(0, 0),
                                       red2, &tile_tot);
      row_off[threadIdx.x] = make_int2(run.x + ex.x, run.y + ex.y);
      __syncthreads();
      const int in_tile = r1 - tile < kThreads ? r1 - tile : kThreads;
      for (int i = warp; i < in_tile; i += kWarps) {
        const int* prow = rows_ws + static_cast<long long>(tile + i) * k1;
        const frontier::Row row =
            frontier::row_window(prow, begin, end, k1, cdepth, k1);
        const int span = row.cnt < g.max_deg ? row.cnt : g.max_deg;
        long long eo = row_off[i].x;
        long long co = row_off[i].y;
        for (int j0 = 0; j0 < span; j0 += 32) {
          const frontier::Slot s =
              frontier::row_slot(row, dst, mf, t, j0 + lane, g.max_deg,
                                 frontier::PrefixInMemory{prow, cdepth});
          const bool c = s.cont && wantc;
          const unsigned em = __ballot_sync(kFull, s.emit);
          const unsigned cm = __ballot_sync(kFull, c);
          if (s.emit) {
            const long long pos = ne + eo + __popc(em & lt);
            frontier::write_child(emitbuf + pos * k1, prow, k1, cdepth + 1,
                                  s.v);
            emitlen[pos] = cdepth + 1;
          }
          if (c) {
            const long long crank = co + __popc(cm & lt);
            const long long piece = crank / g.cs;
            const long long hi = (piece + 1) * g.cs;
            const long long dest = cstart + n_cont
                                   - (hi < n_cont ? hi : n_cont)
                                   + (crank - piece * g.cs);
            frontier::write_child(arena + dest * k1, prow, k1, cdepth + 1,
                                  s.v);
          }
          eo += __popc(em);
          co += __popc(cm);
        }
      }
      run.x += tile_tot.x;
      run.y += tile_tot.y;
      __syncthreads();  // row_off is reused
    }

    top = cstart + n_cont;
    nc = cidx + n_pieces;
    ne += n_emit;
    ++pops;
    grid.sync();
  }

  // the counters were zeroed before the first barrier; one more barrier
  // orders that before the adds when the round made no pop
  grid.sync();
  const int4 ctr =
      frontier::block_sum<kWarps>(make_int4(edges, invalid, 0, 0), red4);
  if (threadIdx.x == 0) {
    atomicAdd(&scal[kCounters + 0], ctr.x);
    atomicAdd(&scal[kCounters + 1], ctr.x);
    atomicAdd(&scal[kCounters + 2], ctr.y);
  }
  if (b == 0 && threadIdx.x == 0) {
    scal[kTop] = static_cast<int>(top);
    scal[kChunks] = static_cast<int>(nc);
    scal[kEmit] = static_cast<int>(ne);
    scal[kPops] = pops;
    scal[kIters] = iters;
  }
}

}  // namespace

// One round on `blocks` blocks (the wrapper passes the SM count; a
// cooperative launch fails rather than run blocks that are not all
// resident).  `scal` receives [top, n_chunks, n_emit, pops, counters x4,
// iterations]; `ws` is the workspace: 2 * block_rows ints of row counts,
// 2 * blocks of block totals, then block_rows * k1 ints of row copies.
extern "C" int deque_round_launch(
    int* arena, int* meta_depth, int* meta_len, const int* top_in,
    const int* nc_in, const int* begin, const int* end, const int* dst,
    int mf, int t, int* emitbuf, int* emitlen, int* scal, int* ws,
    int blocks, int k1, int cs, int block_rows, int max_deg, int cap,
    int arena_cap, int emit_cap, int max_chunks, int max_pieces,
    int round_pops, cudaStream_t stream) {
  Geometry g{k1,       cs,       block_rows, max_deg,    cap,
             arena_cap, emit_cap, max_chunks, max_pieces, round_pops};
  int2* row_cnt = reinterpret_cast<int2*>(ws);
  int2* blk_cnt = row_cnt + block_rows;
  int* rows_ws = reinterpret_cast<int*>(blk_cnt + blocks);
  void* args[] = {&arena,   &meta_depth, &meta_len, &top_in,  &nc_in,
                  &begin,   &end,        &dst,      &mf,      &t,
                  &emitbuf, &emitlen,    &scal,     &row_cnt, &blk_cnt,
                  &rows_ws, &g};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(deque_round_kernel), dim3(blocks),
      dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
