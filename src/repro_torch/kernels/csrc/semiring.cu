// K3 and K4: the two semiring products of the device walk-count DP.
//
// K3, counting SpMM, replaces src/repro/kernels/semiring_spmm.py
// `_counting_kernel` (entry `counting_spmm`): out = A @ x with A (n, n)
// float32 edge counts and x (n, q) float32 walk counts, accumulated in
// IEEE float32 with fused multiply-adds.  No TF32 and no tensor cores:
// TF32 keeps 10 mantissa bits, so it is not exact above 2^11.
//
// Why the kernels may sum in any order (and split K across blocks): every
// term a[i, k] * x[k, j] is a non-negative integer, so every partial sum,
// in whatever order it is taken, is at most the final value.  While the
// final value is below 2^24 (core/estimator.py EXACT_COUNT_MAX) every
// partial sum is an integer below 2^24, which float32 holds exactly, so
// each add is exact and the result is the same in every order.  When a
// value reaches 2^24 the DP discards the device tables and promotes itself
// to the host build.  The split-K partials are added by a second pass in a
// fixed order, with no float atomics, so every run gives the same bits
// even outside that range.
//
// K4, min-plus SpMV, replaces `_minplus_kernel` (entry `minplus_spmv`):
// out[v] = min(dist[v], inf, min_u adj[u, v] + dist[u]) with adj (n, n)
// float32 holding 1.0 for an edge and `inf` otherwise.  One launch runs k
// such relaxations (k = 1 for `minplus_spmv`, k levels for `bfs_dense`,
// the loop `repro` runs as one `fori_loop` program), forward or over
// adj's transpose (out[v] = min(dist[v], inf, min_u adj[v, u] + dist[u]),
// the reverse BFS, read along adj's rows with no transposed copy).
//
// What bounds them on the H100 at the DP's shapes (n <= 2048): for K4 and
// for K3 at q = 1, bytes -- the n*n*4 bytes of the matrix are read once
// and each element takes one add (or one FMA), about 0.25 to 0.5
// operations per byte.  For K3 at large q the product does 2*n*n*q
// float32 operations and is bound by the card's non-tensor float32 rate.
//
// Design:
//  * K3 at q = 1 is a GEMV that keeps many bytes in flight: one warp per
//    row, each lane issues all of its 16-byte loads of a 2048-column
//    stretch of the row (16 of them, unrolled into registers) before its
//    first FMA, and the block stages that stretch of x in shared memory
//    once while those loads are in flight.  At n = 2048 all 2048 warps fit
//    on the card at once, so the whole matrix is requested in one wave.
//  * K3 at q > 1 is a register-blocked SGEMM: 128 x 128 output tiles, 256
//    threads each holding an 8 x 8 micro-tile in registers (rows 16 apart,
//    two runs of four adjacent columns 64 apart, so a warp's reads of A
//    are four broadcast addresses and its reads of x 128 contiguous
//    bytes), A and x tiles of depth 32 in a three-stage
//    shared-memory ring filled by cp.async (16-byte copies where rows are
//    16-byte aligned, 4-byte ones otherwise), and split-K: when the output
//    tiles are fewer than the SMs, K is cut into slices (the wrapper picks
//    them), each block writes its slice's partial tile to a float32
//    scratch, and a second kernel adds the slices in order.  Ragged n and
//    q are masked inside the kernels (zero-filled copies, guarded stores).
//  * K4 is one cooperative, persistent launch (every block resident, a
//    grid barrier between levels, the levels in two buffers by parity).
//    Forward, the columns are cut into tiles of 64 and the rows into as
//    many slices (up to 16) as keep every tile on a block of its own with
//    all blocks resident: at n = 2048, 12 slices of 171 rows, 384 tiles on
//    three blocks an SM.  A tile's 16 row groups of 16 lanes read 16-byte
//    loads along v, eight rows in flight a lane before the first fminf,
//    and leave one partial min per column and slice.  The slices' partials are combined by a
//    second pass after the barrier, folded into the next level: each tile
//    rebuilds the distances of its own rows from the previous level and
//    the partials, and the tiles of column 0 store them.  Transposed, a
//    warp owns a row v and reads it with 16-byte loads (eight in flight a
//    lane) against the distances staged in shared memory, so no partial
//    crosses blocks.  Level 1 reads adj from device memory; at n <= 2048
//    it is 16.8 MB, inside the 50 MB L2, where the later levels find it.
//    Ragged n is masked inside the kernels (4-byte loads where rows are
//    not 16-byte aligned).  Min is exact and each add is the same float
//    operation in any order, so the result equals the plain version's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

// K3, q = 1
constexpr int kGemvWarps = 8;
constexpr int kGemvChunk = 2048;  // columns of one stretch (x in shared)
constexpr int kGemvVec = kGemvChunk / 4 / 32;  // float4 loads per lane
constexpr int kGemvScalar = kGemvChunk / 32;   // float loads per lane

// K3, q > 1
constexpr int kBM = 128;          // output rows of a block
constexpr int kBN = 128;          // output columns of a block
constexpr int kBK = 32;           // depth of one stage
constexpr int kAStride = kBK + 4;  // padded A rows: conflict-free reads
constexpr int kStages = 3;
constexpr int kGemmThreads = 256;
constexpr int kTM = 8;            // rows per thread, 16 apart
constexpr int kTN = 8;            // columns per thread: 4 + 4, 64 apart
constexpr int kGemmSmem =
    kStages * (kBM * kAStride + kBK * kBN) * static_cast<int>(sizeof(float));

template <bool kVec>
__global__ void __launch_bounds__(kGemvWarps * 32) counting_gemv_kernel(
    const float* __restrict__ a, const float* __restrict__ x,
    float* __restrict__ y, int n) {
  __shared__ __align__(16) float xs[kGemvChunk];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kGemvWarps + (threadIdx.x >> 5);
  const bool live = row < n;  // dead warps still stage x and sync
  const float* arow = a + static_cast<long long>(live ? row : 0) * n;
  float acc = 0.0f;
  for (int k0 = 0; k0 < n; k0 += kGemvChunk) {
    const int len = n - k0 < kGemvChunk ? n - k0 : kGemvChunk;
    if (kVec) {
      const float4* a4 = reinterpret_cast<const float4*>(arow + k0);
      float4 av[kGemvVec];
#pragma unroll
      for (int i = 0; i < kGemvVec; ++i) {
        const int e = lane + 32 * i;
        av[i] = (live && 4 * e < len) ? __ldg(a4 + e)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();  // the previous stretch's readers are done with xs
      const float4* x4 = reinterpret_cast<const float4*>(x + k0);
      for (int e = threadIdx.x; 4 * e < len; e += blockDim.x)
        reinterpret_cast<float4*>(xs)[e] = x4[e];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kGemvVec; ++i) {
        const int e = lane + 32 * i;
        if (4 * e < len) {
          const float4 xv = reinterpret_cast<const float4*>(xs)[e];
          acc = fmaf(av[i].x, xv.x, acc);
          acc = fmaf(av[i].y, xv.y, acc);
          acc = fmaf(av[i].z, xv.z, acc);
          acc = fmaf(av[i].w, xv.w, acc);
        }
      }
    } else {
      float av[kGemvScalar];
#pragma unroll
      for (int i = 0; i < kGemvScalar; ++i) {
        const int e = lane + 32 * i;
        av[i] = (live && e < len) ? __ldg(arow + k0 + e) : 0.0f;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < len; e += blockDim.x) xs[e] = x[k0 + e];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kGemvScalar; ++i) {
        const int e = lane + 32 * i;
        if (e < len) acc = fmaf(av[i], xs[e], acc);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (live && lane == 0) y[row] = acc;
}

// One block: the (kBM, kBN) output tile at (blockIdx.y, blockIdx.x) over
// the K slice [blockIdx.z * k_split, +k_split), written to
// out + blockIdx.z * n * q (the partials of slice z, or the output itself
// when there is one slice).  kVec: n and q are multiples of 4 and the
// pointers 16-byte aligned, so every row of A and x starts aligned.
template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads) counting_gemm_kernel(
    const float* __restrict__ a, const float* __restrict__ x,
    float* __restrict__ out, int n, int q, int k_split) {
  extern __shared__ __align__(16) float smem[];
  float* const as0 = smem;                             // [stage][row][k]
  float* const bs0 = smem + kStages * kBM * kAStride;  // [stage][k][col]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // a warp covers 4 row groups x 8 column groups, so its A reads are four
  // broadcast addresses and its x reads 128 contiguous bytes
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // rows ty + 16 i
  const int tx = (warp & 1) * 8 + (lane & 7);    // columns 4 tx (+ 64) ..
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * k_split;
  const int ke = n < kb + k_split ? n : kb + k_split;
  const int ktiles = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;

  auto load = [&](int stage, int kt) {
    const int k0 = kb + kt * kBK;
    float* at = as0 + stage * kBM * kAStride;
    float* bt = bs0 + stage * kBK * kBN;
    if (kVec) {
#pragma unroll
      for (int i = 0; i < kBM * kBK / 4 / kGemmThreads; ++i) {
        const int f = tid + i * kGemmThreads;
        const int r = f / (kBK / 4);
        const int c = (f % (kBK / 4)) * 4;
        const bool ok = row0 + r < n && k0 + c < ke;
        const float* src =
            ok ? a + static_cast<long long>(row0 + r) * n + k0 + c : a;
        sm90::cp_async16(at + r * kAStride + c, src, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < kBK * kBN / 4 / kGemmThreads; ++i) {
        const int f = tid + i * kGemmThreads;
        const int r = f / (kBN / 4);
        const int c = (f % (kBN / 4)) * 4;
        const bool ok = k0 + r < ke && col0 + c < q;
        const float* src =
            ok ? x + static_cast<long long>(k0 + r) * q + col0 + c : x;
        sm90::cp_async16(bt + r * kBN + c, src, ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBM * kBK / kGemmThreads; ++i) {
        const int f = tid + i * kGemmThreads;
        const int r = f / kBK;
        const int c = f % kBK;
        const bool ok = row0 + r < n && k0 + c < ke;
        const float* src =
            ok ? a + static_cast<long long>(row0 + r) * n + k0 + c : a;
        sm90::cp_async4(at + r * kAStride + c, src, ok ? 4 : 0);
      }
#pragma unroll
      for (int i = 0; i < kBK * kBN / kGemmThreads; ++i) {
        const int f = tid + i * kGemmThreads;
        const int r = f / kBN;
        const int c = f % kBN;
        const bool ok = k0 + r < ke && col0 + c < q;
        const float* src =
            ok ? x + static_cast<long long>(k0 + r) * q + col0 + c : x;
        sm90::cp_async4(bt + r * kBN + c, src, ok ? 4 : 0);
      }
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    sm90::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    sm90::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; stage (kt - 1) % kStages is free
    if (kt + kStages - 1 < ktiles)
      load((kt + kStages - 1) % kStages, kt + kStages - 1);
    sm90::cp_async_commit();
    const float* at = as0 + (kt % kStages) * kBM * kAStride;
    const float* bt = bs0 + (kt % kStages) * kBK * kBN;
#pragma unroll
    for (int k4 = 0; k4 < kBK; k4 += 4) {
      float4 av[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            at + (ty + 16 * i) * kAStride + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = bt + (k4 + kk) * kBN + 4 * tx;
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        const float4 b1 = *reinterpret_cast<const float4*>(brow + 64);
        const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w,
                               b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float ak = kk == 0 ? av[i].x
                         : kk == 1 ? av[i].y
                         : kk == 2 ? av[i].z
                                   : av[i].w;
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ak, bv[j], acc[i][j]);
        }
      }
    }
  }
  sm90::cp_async_wait<0>();

  float* o = out + static_cast<long long>(blockIdx.z) * n * q;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
    float* orow = o + static_cast<long long>(r) * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + 4 * tx + 64 * h;
      if (kVec) {
        if (c < q)
          *reinterpret_cast<float4*>(orow + c) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < q) orow[c + j] = acc[i][4 * h + j];
      }
    }
  }
}

// out = sum over the slices of part, slice 0 first (a fixed order);
// kVec: total is a multiple of 4 and the pointers 16-byte aligned
template <bool kVec>
__global__ void split_sum_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, long long total,
                                 int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVec) {
    const float4* p4 = reinterpret_cast<const float4*>(part);
    const long long total4 = total / 4;
    for (long long i = first; i < total4; i += stride) {
      float4 s = p4[i];
      for (int z = 1; z < splits; ++z) {
        const float4 v = p4[z * total4 + i];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      reinterpret_cast<float4*>(out)[i] = s;
    }
  } else {
    for (long long i = first; i < total; i += stride) {
      float s = part[i];
      for (int z = 1; z < splits; ++z) s += part[z * total + i];
      out[i] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// K4: k min-plus relaxations in one cooperative launch
// ---------------------------------------------------------------------------

constexpr int kMpThreads = 256;
constexpr int kMpWarps = kMpThreads / 32;
constexpr int kMpCols = 64;       // columns of a forward tile: 16 x float4
constexpr int kMpRowGroups = kMpThreads / (kMpCols / 4);  // 16
constexpr int kMpRowChunk = 256;  // rows whose distances a tile stages
constexpr int kMpMaxSlices = 16;
constexpr int kMpUnroll = 8;      // 16-byte loads in flight per lane
constexpr int kMpChunk = 2048;    // distances a transposed block stages
static_assert(kMpRowChunk == kMpThreads, "a thread stages one row");

struct Minplus {
  const float* adj;
  const float* dist0;  // level 0; nullptr: 0 at src, inf elsewhere
  float* out;
  float* buf;          // 2 x n: the levels, by parity
  float* part;         // 2 x slices x n: forward row slices' partial mins
  int n;
  int k;
  int src;
  float inf;
  int slices;
  int col_tiles;
};

__device__ __forceinline__ float level0(const Minplus& a, int u) {
  return a.dist0 != nullptr ? __ldg(a.dist0 + u) : (u == a.src ? 0.0f
                                                               : a.inf);
}

// min(d, the row slices' partial mins at u), every load issued before the
// first fminf: a level's prologue is one L2 round trip, not `slices`.
__device__ __forceinline__ float slices_min(float d, const float* part,
                                           long long nn, long long u,
                                           int slices) {
  float x[kMpMaxSlices];
#pragma unroll
  for (int i = 0; i < kMpMaxSlices; ++i)
    x[i] = i < slices ? __ldcg(part + i * nn + u) : d;
#pragma unroll
  for (int i = 0; i < kMpMaxSlices; ++i) d = fminf(d, x[i]);
  return d;
}

// Four adjacent entries of a row from column `col`; entries past n (and,
// for the scalar form, each one apart) read as inf.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* row, int col, int n,
                                        float inf) {
  if (kVec)
    return col < n ? __ldg(reinterpret_cast<const float4*>(row + col))
                   : make_float4(inf, inf, inf, inf);
  return make_float4(col < n ? __ldg(row + col) : inf,
                     col + 1 < n ? __ldg(row + col + 1) : inf,
                     col + 2 < n ? __ldg(row + col + 2) : inf,
                     col + 3 < n ? __ldg(row + col + 3) : inf);
}

__device__ __forceinline__ float4 min4(float4 m, float4 a, float4 d) {
  return make_float4(fminf(m.x, a.x + d.x), fminf(m.y, a.y + d.y),
                     fminf(m.z, a.z + d.z), fminf(m.w, a.w + d.w));
}

// Forward: out[v] = min(dist[v], inf, min_u adj[u, v] + dist[u]).  Tile
// (c, s) takes kMpCols columns from c * kMpCols over the rows of slice s
// and stores its partial min in part.  M_j, the distances after j
// relaxations, are never stored whole at level j: at level j + 1 each
// tile rebuilds M_j of its rows from M_{j-1} (buf) and the partials of
// level j, and the tiles of column 0 store it into buf for the level
// after.  One grid barrier a level.
template <bool kVec>
__global__ void __launch_bounds__(kMpThreads) minplus_forward_kernel(
    Minplus a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float sd[kMpRowChunk];
  __shared__ float4 red[kMpRowGroups][kMpCols / 4];
  const int n = a.n;
  const int tx = threadIdx.x % (kMpCols / 4);
  const int ty = threadIdx.x / (kMpCols / 4);
  const int rows_per_slice = (n + a.slices - 1) / a.slices;
  const int tiles = a.slices * a.col_tiles;
  const long long nn = n;

  for (int j = 1; j <= a.k; ++j) {
    const float* prev = a.buf + ((j - 2) & 1) * nn;      // M_{j-2}
    const float* ppart = a.part + ((j - 1) & 1) * nn * a.slices;
    float* keep = a.buf + ((j - 1) & 1) * nn;            // M_{j-1}
    float* mine = a.part + (j & 1) * nn * a.slices;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int c = tile % a.col_tiles;
      const int s = tile / a.col_tiles;
      const int r0 = s * rows_per_slice;
      const int r1 = r0 + rows_per_slice < n ? r0 + rows_per_slice : n;
      const int col = c * kMpCols + 4 * tx;
      float4 m = make_float4(a.inf, a.inf, a.inf, a.inf);
      for (int rc = r0; rc < r1; rc += kMpRowChunk) {
        const int re = rc + kMpRowChunk < r1 ? rc + kMpRowChunk : r1;
        __syncthreads();  // the previous chunk's readers are done with sd
        const int u = rc + threadIdx.x;
        if (u < re) {
          const float d =
              j == 1 ? level0(a, u)
                     : slices_min(__ldcg(prev + u), ppart, nn, u, a.slices);
          sd[threadIdx.x] = d;
          if (c == 0) keep[u] = d;
        }
        __syncthreads();
        for (int u0 = rc + ty; u0 < re; u0 += kMpRowGroups * kMpUnroll) {
          float4 av[kMpUnroll];
#pragma unroll
          for (int i = 0; i < kMpUnroll; ++i) {
            const int uu = u0 + kMpRowGroups * i;
            av[i] = uu < re ? load4<kVec>(a.adj + uu * nn, col, n, a.inf)
                            : make_float4(a.inf, a.inf, a.inf, a.inf);
          }
#pragma unroll
          for (int i = 0; i < kMpUnroll; ++i) {
            const int uu = u0 + kMpRowGroups * i;
            if (uu < re) {
              const float d = sd[uu - rc];
              m = min4(m, av[i], make_float4(d, d, d, d));
            }
          }
        }
      }
      red[ty][tx] = m;
      __syncthreads();
      if (threadIdx.x < kMpCols) {
        const int v = c * kMpCols + threadIdx.x;
        const float* r = reinterpret_cast<const float*>(&red[0][0]);
        float p = a.inf;
        for (int g = 0; g < kMpRowGroups; ++g)
          p = fminf(p, r[g * kMpCols + threadIdx.x]);
        if (v < n) mine[static_cast<long long>(s) * nn + v] = p;
      }
      __syncthreads();  // red is reused
    }
    grid.sync();
  }

  // M_k = min(M_{k-1}, the partials of level k)
  const long long stride = static_cast<long long>(gridDim.x) * kMpThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kMpThreads
                     + threadIdx.x;
       v < n; v += stride) {
    a.out[v] = a.k == 0
                   ? level0(a, static_cast<int>(v))
                   : slices_min(__ldcg(a.buf + ((a.k - 1) & 1) * nn + v),
                                a.part + (a.k & 1) * nn * a.slices, nn, v,
                                a.slices);
  }
}

// Transposed: out[v] = min(dist[v], inf, min_u adj[v, u] + dist[u]), the
// relaxation over adj's transpose read along adj's rows: a warp per row v,
// so no tile needs another's partial.  Level j reads M_{j-1} (staged in
// shared memory) and writes M_j (buf, the output at level k).
template <bool kVec>
__global__ void __launch_bounds__(kMpThreads) minplus_transposed_kernel(
    Minplus a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ __align__(16) float sd[kMpChunk];
  const int n = a.n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long nn = n;
  const int tiles = (n + kMpWarps - 1) / kMpWarps;
  const bool one_chunk = n <= kMpChunk;

  if (a.k == 0) {
    for (int v = blockIdx.x * kMpThreads + threadIdx.x; v < n;
         v += gridDim.x * kMpThreads)
      a.out[v] = level0(a, v);
    return;
  }
  for (int j = 1; j <= a.k; ++j) {
    const float* prev = a.buf + ((j - 1) & 1) * nn;
    float* next = j == a.k ? a.out : a.buf + (j & 1) * nn;
    auto dist = [&](int u) {
      return j == 1 ? level0(a, u) : __ldcg(prev + u);
    };
    auto stage = [&](int c0) {  // all loads in flight, then the stores
      __syncthreads();
      const int len = n - c0 < kMpChunk ? n - c0 : kMpChunk;
      float x[kMpChunk / kMpThreads];
#pragma unroll
      for (int r = 0; r < kMpChunk / kMpThreads; ++r) {
        const int i = threadIdx.x + r * kMpThreads;
        x[r] = i < len ? dist(c0 + i) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kMpChunk / kMpThreads; ++r) {
        const int i = threadIdx.x + r * kMpThreads;
        if (i < len) sd[i] = x[r];
      }
      __syncthreads();
    };
    if (one_chunk) stage(0);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int v = tile * kMpWarps + warp;
      const float* row = a.adj + (v < n ? v : 0) * nn;
      float m = a.inf;
      for (int c0 = 0; c0 < n; c0 += kMpChunk) {
        if (!one_chunk) stage(c0);
        const int len = n - c0 < kMpChunk ? n - c0 : kMpChunk;
        for (int e0 = 0; e0 < len; e0 += 4 * 32 * kMpUnroll) {
          float4 av[kMpUnroll];
#pragma unroll
          for (int i = 0; i < kMpUnroll; ++i) {
            const int e = e0 + 4 * (lane + 32 * i);
            av[i] = v < n && e < len ? load4<kVec>(row + c0, e, len, a.inf)
                                     : make_float4(a.inf, a.inf, a.inf,
                                                   a.inf);
          }
#pragma unroll
          for (int i = 0; i < kMpUnroll; ++i) {
            const int e = e0 + 4 * (lane + 32 * i);
            if (e < len) {
              float4 d;
              if (kVec) {
                d = *reinterpret_cast<const float4*>(sd + e);
              } else {
                d.x = sd[e];
                d.y = e + 1 < len ? sd[e + 1] : a.inf;
                d.z = e + 2 < len ? sd[e + 2] : a.inf;
                d.w = e + 3 < len ? sd[e + 3] : a.inf;
              }
              const float4 r = min4(make_float4(m, m, m, m), av[i], d);
              m = fminf(fminf(r.x, r.y), fminf(r.z, r.w));
            }
          }
        }
      }
      for (int off = 16; off > 0; off >>= 1)
        m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0 && v < n)
        next[v] = fminf(one_chunk ? sd[v] : dist(v), m);
    }
    if (j < a.k) grid.sync();  // the last level's output is read by no one
  }
}

// The SM count of the current device, read once per device.
int sm_count(int* dev) {
  static int sms[64] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (*dev < 0 || *dev >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  if (sms[*dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[*dev], cudaDevAttrMultiProcessorCount,
                                 *dev);
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  return sms[*dev];
}

// Blocks of one of the four kernels (`which` indexes them) that the card
// holds at once, read once per device; a negative cudaError_t on failure.
int resident(void (*kernel)(Minplus), int which) {
  static int per_sm[4][64] = {};
  int dev = 0;
  const int sms = sm_count(&dev);
  if (sms <= 0) return sms;
  if (per_sm[which][dev] == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[which][dev], kernel, kMpThreads, 0);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (per_sm[which][dev] < 1)
      return -static_cast<int>(cudaErrorInvalidConfiguration);
  }
  return per_sm[which][dev] * sms;
}

// Launch one of the four kernels on as many blocks as `tiles`, but no
// more than the card holds at once, as a cooperative launch needs.
int minplus_run(void (*kernel)(Minplus), int which, Minplus a, int tiles,
                cudaStream_t stream) {
  const int most = resident(kernel, which);
  if (most <= 0) return -most;
  const int grid = tiles < 1 ? 1 : (tiles < most ? tiles : most);
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(kernel), dim3(grid), dim3(kMpThreads), args, 0,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3.  q = 1 runs the GEMV.  q > 1 runs the SGEMM over `splits` K slices
// of `k_split` columns each (a multiple of kBK; the wrapper picks both);
// with more than one slice the partials go to `scratch` (splits * n * q
// floats) and a second kernel adds them into y.
extern "C" int counting_spmm_launch(const float* a, const float* x,
                                    float* y, float* scratch, int n, int q,
                                    int splits, int k_split,
                                    cudaStream_t stream) {
  if (n <= 0 || q <= 0) return 0;
  const bool aligned = reinterpret_cast<unsigned long long>(a) % 16 == 0 &&
                       reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
                       reinterpret_cast<unsigned long long>(y) % 16 == 0;
  if (q == 1) {
    const int blocks = (n + kGemvWarps - 1) / kGemvWarps;
    if (aligned && n % 4 == 0)
      counting_gemv_kernel<true><<<blocks, kGemvWarps * 32, 0, stream>>>(
          a, x, y, n);
    else
      counting_gemv_kernel<false><<<blocks, kGemvWarps * 32, 0, stream>>>(
          a, x, y, n);
    return static_cast<int>(cudaGetLastError());
  }
  if (splits < 1 || k_split % kBK != 0 ||
      static_cast<long long>(splits) * k_split < n)
    return static_cast<int>(cudaErrorInvalidValue);
  float* dst = splits > 1 ? scratch : y;
  const bool vec = aligned && n % 4 == 0 && q % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(dst) % 16 == 0;
  // above 48 KB of shared memory only when asked for (per device)
  void (*gemm)(const float*, const float*, float*, int, int, int) =
      vec ? counting_gemm_kernel<true> : counting_gemm_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((q + kBN - 1) / kBN, (n + kBM - 1) / kBM, splits);
  gemm<<<grid, kGemmThreads, kGemmSmem, stream>>>(a, x, dst, n, q, k_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long total = static_cast<long long>(n) * q;
  const bool vec4 = total % 4 == 0 &&
                    reinterpret_cast<unsigned long long>(y) % 16 == 0 &&
                    reinterpret_cast<unsigned long long>(scratch) % 16 == 0;
  const long long items = vec4 ? total / 4 : total;
  const long long want = (items + 255) / 256;
  const int blocks = static_cast<int>(want < 1024 ? want : 1024);
  if (vec4)
    split_sum_kernel<true><<<blocks, 256, 0, stream>>>(scratch, y, total,
                                                      splits);
  else
    split_sum_kernel<false><<<blocks, 256, 0, stream>>>(scratch, y, total,
                                                       splits);
  return static_cast<int>(cudaGetLastError());
}

// K4: `k` min-plus relaxations of `dist0` (nullptr: 0 at `src` and inf
// elsewhere) over adj (n, n), in one cooperative launch; `transposed`
// relaxes over adj's transpose.  `scratch` holds (2 + 2 * 16) * n floats.
// k = 1 is one relaxation (`minplus_spmv`), k levels a bounded BFS
// (`bfs_dense`).
extern "C" int minplus_launch(const float* adj, const float* dist0, int src,
                              float* out, float* scratch, int n, int k,
                              float inf, int transposed, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<unsigned long long>(adj) % 16 == 0;
  Minplus a{adj, dist0, out, scratch, scratch + 2LL * n, n, k, src, inf,
            1, 1};
  if (transposed) {
    const int tiles = (n + kMpWarps - 1) / kMpWarps;
    return vec ? minplus_run(minplus_transposed_kernel<true>, 0, a, tiles,
                             stream)
               : minplus_run(minplus_transposed_kernel<false>, 1, a, tiles,
                             stream);
  }
  // as many row slices as keep every tile on a block of its own
  void (*kernel)(Minplus) =
      vec ? minplus_forward_kernel<true> : minplus_forward_kernel<false>;
  const int which = vec ? 2 : 3;
  const int most = resident(kernel, which);
  if (most <= 0) return -most;
  a.col_tiles = (n + kMpCols - 1) / kMpCols;
  a.slices = most / a.col_tiles;
  a.slices = a.slices < 1 ? 1
             : (a.slices > kMpMaxSlices ? kMpMaxSlices : a.slices);
  return minplus_run(kernel, which, a, a.slices * a.col_tiles, stream);
}
