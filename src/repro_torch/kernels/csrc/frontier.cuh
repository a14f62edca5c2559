// The per-row logic of one IDX-DFS hop (the frontier masks), shared by K1
// (frontier.cu), the resident deque round K2 (deque_round.cu) and the fused
// multi-query hop K5 (frontier_fused.cu), so the three cannot drift apart.
// K2 gives one warp to a row, whose lanes walk the row's candidate slots in
// steps of 32 and read the prefix from memory; K1 and K5 give a row a
// group of lanes and test the prefix held in lane registers
// (PrefixInLanes).  The block-wide sum and scan that the hops (K1's and
// K5's) and K2 rank their children with are here too, and the pieces the
// two hops share: the lane group, a block's contiguous rows, a row's
// counts over its slot groups, the group's child writes and the grid.
//
// For a row at `depth` of the (., k+1) int32 path matrix: read the last
// vertex v, gather begin[v] and end[v, b] with b = k - depth - 1 (clipped
// like the TPU code), read up to max_deg candidates from dst, drop those
// already on the row's prefix, and split the rest into emit (== t) and
// continue.  The Fig.-6 counters of the row are [cnt, cnt, invalid]: cnt
// candidate edges of a valid row, and invalid = the duplicates plus one
// if a valid row keeps no candidate.

#pragma once

namespace frontier {

constexpr int kPad = -1;
constexpr unsigned kFull = 0xffffffffu;

// One row's candidate window in dst.
struct Row {
  const int* prow;  // the row's k+1 entries
  int depth;
  int bg;           // begin[last]
  int cnt;          // end[last, b] - begin[last]; 0 for a PAD row
  bool valid;       // the row holds a vertex at `depth`
};

// `k1` is the query's k + 1 (the width of end), `width` the row's length
// in the path matrix (k1, or more where rows of several queries share one
// matrix)
__device__ __forceinline__ Row row_window(const int* prow,
                                          const int* __restrict__ begin,
                                          const int* __restrict__ end,
                                          int k1, int depth, int width) {
  int b = k1 - 2 - depth;  // budget k - depth - 1, clipped like the TPU code
  b = b < 0 ? 0 : (b > k1 - 1 ? k1 - 1 : b);
  const bool depth_ok = depth >= 0 && depth < width;
  const int last = depth_ok ? prow[depth] : kPad;
  Row r{prow, depth, 0, 0, last != kPad};
  if (r.valid) {
    r.bg = begin[last];
    r.cnt = end[static_cast<long long>(last) * k1 + b] - r.bg;
  }
  return r;
}

// One candidate slot j of a row: its vertex (PAD out of range), and
// whether it is in range, a duplicate of the prefix, an emit or a
// continue.
struct Slot {
  int v;
  bool in_range;
  bool dup;
  bool emit;
  bool cont;
};

// `on_prefix(v, in_range)` says whether v is one of the row's entries
// 0..depth; every lane calls it, in range or not, so a test that
// exchanges values between lanes may.
template <typename PrefixTest>
__device__ __forceinline__ Slot row_slot(const Row& r,
                                         const int* __restrict__ dst, int mf,
                                         int t, int j, int max_deg,
                                         const PrefixTest& on_prefix) {
  Slot s{kPad, j < max_deg && j < r.cnt, false, false, false};
  if (s.in_range) {
    int pos = r.bg + j;
    pos = pos < 0 ? 0 : (pos > mf - 1 ? mf - 1 : pos);
    s.v = dst[pos];
  }
  s.dup = on_prefix(s.v, s.in_range) && s.in_range;
  s.emit = s.in_range && !s.dup && s.v == t;
  s.cont = s.in_range && !s.dup && s.v != t;
  return s;
}

// The prefix test that reads the row's entries from memory (they sit in L1)
struct PrefixInMemory {
  const int* prow;
  int depth;
  __device__ __forceinline__ bool operator()(int v, bool in_range) const {
    bool dup = false;
    if (in_range)
      for (int c = 0; c <= depth; ++c) dup |= (prow[c] == v);
    return dup;
  }
};

// The prefix test of a row whose group of W lanes holds entries
// 0..W-1 of the prefix in `first` (PAD past depth); entries from W on, if
// the rows are wider than W, are read a group-width at a time.  `span`
// entries are tested, at least depth + 1 of every row of the warp and the
// same on every lane, so every lane runs the same shuffles.
struct PrefixInLanes {
  const int* prow;
  int first;
  int depth;
  int sub;
  int width;  // W
  int span;
  __device__ __forceinline__ bool operator()(int v, bool in_range) const {
    bool dup = false;
    for (int c0 = 0; c0 < span; c0 += width) {
      const int own = c0 == 0 ? first
                      : (c0 + sub <= depth ? prow[c0 + sub] : kPad);
      const int n = span - c0 < width ? span - c0 : width;
      for (int s = 0; s < n; ++s) {
        const int x = __shfl_sync(kFull, own, s, width);
        dup |= c0 + s <= depth && x == v;
      }
    }
    return dup && in_range;
  }
};

// The row's Fig.-6 contributions from the warp's votes over all its slot
// groups: edges (= partials) and invalid.
__device__ __forceinline__ int row_edges(const Row& r) {
  return r.valid ? r.cnt : 0;
}

__device__ __forceinline__ int row_invalid(const Row& r, int dups,
                                           bool alive) {
  return dups + ((r.valid && !alive) ? 1 : 0);
}

// Sum of an int4 over a block of kWarps warps; every thread gets the
// total.  `red` holds kWarps entries.
template <int kWarps>
__device__ int4 block_sum(int4 v, int4* red) {
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_down_sync(kFull, v.x, off);
    v.y += __shfl_down_sync(kFull, v.y, off);
    v.z += __shfl_down_sync(kFull, v.z, off);
    v.w += __shfl_down_sync(kFull, v.w, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int4 s = make_int4(0, 0, 0, 0);
  for (int w = 0; w < kWarps; ++w) {
    s.x += red[w].x;
    s.y += red[w].y;
    s.z += red[w].z;
    s.w += red[w].w;
  }
  __syncthreads();  // red is reused
  return s;
}

// Exclusive prefix of (emit, cont) counts over the block's threads in
// thread order; `total` gets the block's sum.
template <int kWarps>
__device__ int2 block_scan(int2 v, int2* red, int2* total) {
  const int lane = threadIdx.x & 31;
  int2 inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(kFull, inc.x, off);
    const int y = __shfl_up_sync(kFull, inc.y, off);
    if (lane >= off) {
      inc.x += x;
      inc.y += y;
    }
  }
  if (lane == 31) red[threadIdx.x >> 5] = inc;
  __syncthreads();
  int2 base = make_int2(0, 0);
  int2 tot = make_int2(0, 0);
  for (int w = 0; w < kWarps; ++w) {
    const int2 s = red[w];
    if (w < static_cast<int>(threadIdx.x >> 5)) {
      base.x += s.x;
      base.y += s.y;
    }
    tot.x += s.x;
    tot.y += s.y;
  }
  __syncthreads();  // red is reused
  *total = tot;
  return make_int2(base.x + inc.x - v.x, base.y + inc.y - v.y);
}

// The child of a parent row: the row with `v` at column `col`.
__device__ __forceinline__ void write_child(int* __restrict__ out,
                                            const int* prow, int k1,
                                            int col, int v) {
  for (int c = 0; c < k1; ++c) out[c] = c == col ? v : prow[c];
}

// ---------------------------------------------------------------------------
// The hops' shared pieces (K1's hop in frontier.cu, K5's in
// frontier_fused.cu): a count launch and a write launch over the same
// grid, each block owning a contiguous range of rows.
// ---------------------------------------------------------------------------

// This thread's lane group: W lanes that serve one row.
struct Group {
  int sub;         // lane within the group
  int leader;      // the group's first lane in the warp
  unsigned mask;   // the group's lanes
  unsigned below;  // the group's lanes below this one
  int per_step;    // rows a block walks at once
  int slot;        // this group's row within a step
};

__device__ __forceinline__ Group group_of(int width) {
  const int lane = threadIdx.x & 31;
  Group g;
  g.sub = lane & (width - 1);
  g.leader = lane - g.sub;
  g.mask = width == 32 ? kFull : ((1u << width) - 1u) << g.leader;
  g.below = ((1u << lane) - 1u) & g.mask;
  g.per_step = blockDim.x / width;
  g.slot = threadIdx.x / width;
  return g;
}

// The contiguous rows [r0, r1) of this block: whole steps of per_step
// rows, cut evenly across the grid.
__device__ __forceinline__ int2 block_rows(int rows, int per_step) {
  const long long steps = (rows + per_step - 1) / per_step;
  const long long s0 = steps * blockIdx.x / gridDim.x;
  const long long s1 = steps * (blockIdx.x + 1) / gridDim.x;
  const long long r1 = s1 * per_step;
  return make_int2(static_cast<int>(s0 * per_step),
                   static_cast<int>(r1 < rows ? r1 : rows));
}

// One row's counts over all its slot groups: emit and continue children,
// and whether any candidate survived and how many were duplicates.
// `want_cont` false counts no continue child; `alive` is unaffected.
struct RowCounts {
  int emit = 0;
  int cont = 0;
  int dups = 0;
  bool alive = false;

  __device__ __forceinline__ void add(const Slot& s, const Group& g,
                                      bool want_cont) {
    emit += __popc(__ballot_sync(kFull, s.emit) & g.mask);
    cont += __popc(__ballot_sync(kFull, s.cont && want_cont) & g.mask);
    alive |= (__ballot_sync(kFull, s.emit || s.cont) & g.mask) != 0;
    dups += __popc(__ballot_sync(kFull, s.in_range && s.dup) & g.mask);
  }
};

// The children of one kind that a group's slot batch makes (`mine` on the
// lanes of `mask`) at rows [o, o + popc(mask)) of `out`: the lanes stage
// the children's vertices in `sv` (the group's W slots of shared memory)
// and write the rows' k1 ints together, consecutive lanes on consecutive
// ints.  Every lane of the warp calls it.
__device__ __forceinline__ long long write_children(
    int* __restrict__ out, long long o, unsigned mask, bool mine, int v,
    const int* prow, int k1, int col, const Group& g, int width, int* sv) {
  __syncwarp();  // the previous batch's readers are done with sv
  if (mine) sv[__popc(mask & g.below)] = v;
  __syncwarp();
  const int total = __popc(mask) * k1;
  int* dst = out + o * k1;
  for (int e = g.sub; e < total; e += width) {
    const int q = e / k1;
    const int c = e - q * k1;
    dst[e] = c == col ? sv[q] : prow[c];
  }
  return o + __popc(mask);
}

// W for a fan-out bound: max_deg rounded up to a power of two, at most 32.
inline int group_width(int max_deg) {
  int width = 1;
  while (width < max_deg && width < 32) width *= 2;
  return width;
}

// Blocks of `threads` for `rows` rows: no more than the steps of rows,
// `per_sm` an SM, and `max_grid` (the block totals a hop's scratch holds).
inline int hop_grid(int rows, int width, int threads, int per_sm,
                    int max_grid) {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) dev = 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    sms[dev] = 1;
  const int per_step = threads / width;
  const long long steps = (static_cast<long long>(rows) + per_step - 1)
                          / per_step;
  long long g = static_cast<long long>(per_sm) * sms[dev];
  if (g > max_grid) g = max_grid;
  return static_cast<int>(steps < g ? steps : g);
}

}  // namespace frontier
