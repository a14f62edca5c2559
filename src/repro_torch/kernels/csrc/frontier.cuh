// The per-row logic of one IDX-DFS hop (the frontier masks), shared by K1
// (frontier.cu), the resident deque round K2 (deque_round.cu) and the fused
// multi-query hop K5 (frontier_fused.cu), so the three cannot drift apart.
// K1 and K2 give one warp to a row, whose lanes walk the row's candidate
// slots in steps of 32; K5 gives a row a group of lanes and brings its own
// prefix test (lane registers instead of memory reads).
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

// The row's Fig.-6 contributions from the warp's votes over all its slot
// groups: edges (= partials) and invalid.
__device__ __forceinline__ int row_edges(const Row& r) {
  return r.valid ? r.cnt : 0;
}

__device__ __forceinline__ int row_invalid(const Row& r, int dups,
                                           bool alive) {
  return dups + ((r.valid && !alive) ? 1 : 0);
}

}  // namespace frontier
