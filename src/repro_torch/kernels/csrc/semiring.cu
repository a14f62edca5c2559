// K3 and K4: the two semiring products of the device walk-count DP.
//
// K3, counting SpMM, replaces src/repro/kernels/semiring_spmm.py
// `_counting_kernel` (entry `counting_spmm`): out = A @ x with A (n, n)
// float32 edge counts and x (n, q) float32 walk counts, accumulated in
// IEEE float32 with fused multiply-adds.  No TF32 and no tensor cores:
// the DP's exactness certificate (EXACT_COUNT_MAX = 2^24 in
// core/estimator.py) needs every partial sum to be an exact float32
// integer, and then the order of the sum cannot change the result.
//
// K4, min-plus SpMV, replaces `_minplus_kernel` (entry `minplus_spmv`):
// out[v] = min(dist[v], inf, min_u adj[u, v] + dist[u]) with adj (n, n)
// float32 holding 1.0 for an edge and `inf` otherwise.
//
// What bounds them on the H100 at the DP's shapes (n <= 2048): for K4 and
// for K3 at q = 1, bytes -- the n*n*4 bytes of the matrix are read once
// and each element takes one add (or one FMA), about 0.25 to 0.5
// operations per byte.  For K3 at large q the product does 2*n*n*q
// float32 operations and is bound by the card's non-tensor float32 rate.
//
// Design:
//  * K3 at q = 1 is a matrix-vector product: one warp per row, lanes read
//    the row in consecutive 16-byte pieces (coalesced), and a shuffle tree
//    sums the lanes.  At q > 1 a 32x32 output tile per block: A and x
//    tiles are staged through shared memory, and each thread keeps four
//    rows of one column in registers.
//  * K4 reduces each column over u: a block owns 32 columns, its 16 warps
//    split the rows, each warp reads 32 consecutive floats of one row per
//    step (coalesced along v), and a shared-memory pass takes the min of
//    the 16 partial mins.  Min is exact, so the order does not matter.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kTileRowsPerThread = 4;  // 32 rows / 8 thread rows
constexpr int kMinplusWarps = 16;
constexpr int kGemvWarps = 8;

__global__ void counting_gemv_kernel(const float* __restrict__ a,
                                     const float* __restrict__ x,
                                     float* __restrict__ y, int n,
                                     bool vec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kGemvWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const float* arow = a + static_cast<long long>(row) * n;
  float acc = 0.0f;
  if (vec) {
    const float4* a4 = reinterpret_cast<const float4*>(arow);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int i = lane; i < n / 4; i += 32) {
      const float4 av = a4[i];
      const float4 xv = x4[i];
      acc = fmaf(av.x, xv.x, acc);
      acc = fmaf(av.y, xv.y, acc);
      acc = fmaf(av.z, xv.z, acc);
      acc = fmaf(av.w, xv.w, acc);
    }
  } else {
    for (int i = lane; i < n; i += 32) acc = fmaf(arow[i], x[i], acc);
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = acc;
}

__global__ void counting_tile_kernel(const float* __restrict__ a,
                                     const float* __restrict__ x,
                                     float* __restrict__ y, int n, int q) {
  __shared__ float as[kTile][kTile + 1];
  __shared__ float xs[kTile][kTile + 1];
  const int tx = threadIdx.x;  // output column within the tile
  const int ty = threadIdx.y;  // 0..7
  const int row0 = blockIdx.y * kTile;
  const int col = blockIdx.x * kTile + tx;
  float acc[kTileRowsPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < n; k0 += kTile) {
    for (int r = ty; r < kTile; r += kTile / kTileRowsPerThread) {
      const int ar = row0 + r;
      const int ac = k0 + tx;
      as[r][tx] = (ar < n && ac < n) ? a[static_cast<long long>(ar) * n + ac]
                                     : 0.0f;
      const int xr = k0 + r;
      xs[r][tx] = (xr < n && col < q) ? x[static_cast<long long>(xr) * q + col]
                                      : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) {
      const float xv = xs[kk][tx];
#pragma unroll
      for (int i = 0; i < kTileRowsPerThread; ++i)
        acc[i] = fmaf(as[ty + i * (kTile / kTileRowsPerThread)][kk], xv,
                      acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTileRowsPerThread; ++i) {
    const int r = row0 + ty + i * (kTile / kTileRowsPerThread);
    if (r < n && col < q) y[static_cast<long long>(r) * q + col] = acc[i];
  }
}

__global__ void minplus_spmv_kernel(const float* __restrict__ adj,
                                    const float* __restrict__ dist,
                                    float* __restrict__ out, int n,
                                    float inf) {
  __shared__ float part[kMinplusWarps][32];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int v = blockIdx.x * 32 + tx;
  float m = inf;
  if (v < n) {
    for (int u = ty; u < n; u += kMinplusWarps)
      m = fminf(m, adj[static_cast<long long>(u) * n + v] + dist[u]);
  }
  part[ty][tx] = m;
  __syncthreads();
  if (ty == 0 && v < n) {
    for (int i = 1; i < kMinplusWarps; ++i) m = fminf(m, part[i][tx]);
    out[v] = fminf(dist[v], m);
  }
}

}  // namespace

extern "C" int counting_spmm_launch(const float* a, const float* x,
                                    float* y, int n, int q,
                                    cudaStream_t stream) {
  if (n <= 0 || q <= 0) return 0;
  if (q == 1) {
    // 16-byte loads need every row start and x aligned to 16 bytes
    const bool vec = n % 4 == 0 &&
                     reinterpret_cast<unsigned long long>(a) % 16 == 0 &&
                     reinterpret_cast<unsigned long long>(x) % 16 == 0;
    const int blocks = (n + kGemvWarps - 1) / kGemvWarps;
    counting_gemv_kernel<<<blocks, kGemvWarps * 32, 0, stream>>>(a, x, y, n,
                                                                 vec);
  } else {
    const dim3 grid((q + kTile - 1) / kTile, (n + kTile - 1) / kTile);
    const dim3 block(kTile, kTile / kTileRowsPerThread);
    counting_tile_kernel<<<grid, block, 0, stream>>>(a, x, y, n, q);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int minplus_spmv_launch(const float* adj, const float* dist,
                                   float* out, int n, float inf,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  const dim3 block(32, kMinplusWarps);
  minplus_spmv_kernel<<<(n + 31) / 32, block, 0, stream>>>(adj, dist, out,
                                                           n, inf);
  return static_cast<int>(cudaGetLastError());
}
