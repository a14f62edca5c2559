// The per-row logic of one IDX-DFS hop (the frontier masks), shared by K1
// (frontier.cu) and the resident deque round K2 (deque_round.cu), so the
// two cannot drift apart.  One warp works on one row; lanes walk the
// row's candidate slots in steps of 32.
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

__device__ __forceinline__ Row row_window(const int* prow,
                                          const int* __restrict__ begin,
                                          const int* __restrict__ end,
                                          int k1, int depth) {
  int b = k1 - 2 - depth;  // budget k - depth - 1, clipped like the TPU code
  b = b < 0 ? 0 : (b > k1 - 1 ? k1 - 1 : b);
  const bool depth_ok = depth >= 0 && depth < k1;
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

__device__ __forceinline__ Slot row_slot(const Row& r,
                                         const int* __restrict__ dst, int mf,
                                         int t, int j, int max_deg) {
  Slot s{kPad, j < max_deg && j < r.cnt, false, false, false};
  if (s.in_range) {
    int pos = r.bg + j;
    pos = pos < 0 ? 0 : (pos > mf - 1 ? mf - 1 : pos);
    s.v = dst[pos];
    for (int c = 0; c <= r.depth; ++c) s.dup |= (r.prow[c] == s.v);
  }
  s.emit = s.in_range && !s.dup && s.v == t;
  s.cont = s.in_range && !s.dup && s.v != t;
  return s;
}

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
