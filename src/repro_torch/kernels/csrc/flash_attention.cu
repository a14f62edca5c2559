// K6 in float32: blocked online-softmax (flash) attention with grouped KV
// heads, on the tensor cores with an error-compensated TF32 split.
//
// Replaces src/repro/kernels/flash_attention.py `_flash_kernel` (entry
// `flash_attention`) for float32 inputs; bfloat16 runs on `wgmma` in
// flash_attention_sm90.cu.  q (B, Lq, H, D); k and v (B, Lk, Hkv, D), all
// contiguous float32; out (B, Lq, H, D).  The KV head of query head h is
// h / (H / Hkv): no repeated K or V is ever made.  Masks come from global
// indices with the offset Lk - Lq (the query rows are the last Lq
// positions): causal `row + off >= col`, and with a window
// `row + off - col < window`.  Masked logits are -1e30 and the output is
// acc / max(l, 1e-30), as in the TPU kernel.
//
// What bounds it on the H100: operations.  Each visible (row, col) pair
// costs 4*D float operations (one dot product for the logit, one
// multiply-add row of P @ V); at L = 2048 and D = 128 that is hundreds of
// operations per byte read, far above the card's ratio.  Plain TF32 on the
// tensor cores keeps 11 bits of each operand and breaks the float32
// contract's 2e-5, and float32 FMAs on the CUDA cores top out at
// 67 TFLOP/s.  The split keeps float32 on the tensor cores: each operand x
// becomes hi = tf32(x) and lo = x - hi (read as TF32), and every product
// is hi*hi + hi*lo + lo*hi with float32 accumulation, about 22 bits of each
// operand (the dropped lo*lo is 2^-22 of the product).  Three TF32
// products run at 495 / 3 = 165 TFLOP/s, 2.5x the CUDA cores' peak; the
// bound is 3 * operations / 495 TFLOP/s.
//
// Design:
//  * `mma.sync.m16n8k8` TF32 on each warp's 16 query rows: a block holds
//    128 query rows (64 for D = 256), one warp per 16.  One block per
//    (query tile, head, batch row); query tiles run heaviest (causal:
//    last) first.  A loop over KV tiles of 32 keys (16 for D = 256) inside
//    the block takes the place of the TPU grid's sequential axis; the
//    running max m, denominator l and the output accumulator stay in
//    registers, in float32.
//  * The loop's bounds skip every KV tile that is wholly masked for the
//    block's rows (past the diagonal, left of the window), and a warp skips
//    the tiles wholly masked for its own 16 rows; only tiles that cross a
//    mask edge evaluate the masks.  Ragged Lq and Lk are masked in the
//    kernel: rows past Lq are not stored, columns past Lk are masked.
//  * K and V tiles arrive by 16-byte `cp.async` into a two-stage ring, the
//    next tile in flight while this one is computed.  When a tile has
//    arrived, the block splits it once for all its warps: hi in place in
//    the ring, lo into a buffer of its own.  Q is staged once per block,
//    unsplit (split Q would not fit beside them), and each warp splits its
//    Q fragments as it loads them; a fragment serves a whole KV tile.  Rows
//    are padded (K and Q by 8 floats, V by 4) so the fragment loads hit 32
//    distinct banks.
//  * Sum order is free, which the fragments use twice.  S = Q K^T runs
//    over the head dim in the order (2t, 2t + 1) -> (t, t + 4) of the
//    k index, so each A and B fragment is one 8-byte load.  P goes from
//    S's accumulator straight into the A fragment of P V: the accumulator
//    holds columns (2t, 2t + 1) where A wants k = (t, t + 4), so V's rows
//    are read in the same permuted order instead of moving P.
//  * Rounding.  The tensor cores truncate their float32 sums, so the
//    small products go to accumulators of their own (S: hi*hi and
//    the two cross products apart), and P V sums one KV tile at a time
//    from zero and adds it to the output with a round-to-nearest FMA that
//    also applies the softmax rescale.  Q is scaled by scale * log2(e)
//    before its split, so S is in log2 units and the exponentials are
//    `ex2.approx`.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// x = hi + lo to about 22 bits.  hi is x rounded to TF32, to the nearest
// with ties away from zero (`cvt.rna.tf32.f32`'s rounding): add half a TF32
// ulp, clear the low 13 bits.  lo = x - hi is exact in float32 (at most 13
// significant bits) and goes to the tensor cores as it is: they read the
// top 19 bits of a TF32 operand and ignore the low 13 (CUTLASS's
// `round_half_ulp_truncate` converter relies on the same), which cuts lo
// to 11 bits, an error below 2^-22 of x.  Two integer ops and a
// subtraction in place of two `cvt.rna`, which compile with NaN tests and
// selects into several times as many instructions.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 2^x; flushes results below 2^-126 to zero, which only drops terms that
// an O(1) sum cannot hold anyway
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += A(16 x 8) * B(8 x 8), TF32 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tile geometry of head dim D: BQ query rows a block (16 a warp), BK keys
// a KV tile, NB output column blocks of 8 summed together in P V, and the
// padded row strides of the Q, K and V tiles in shared memory.  Shared
// memory holds Q, the two-stage K and V ring and the lo parts of one K and
// one V tile: 168.5 KiB at D = 128, 128.5 KiB at D = 96 (12 k-steps of
// the m16n8k8 product, NB = 4), 164.25 KiB at D = 256.
template <int D>
struct Tiles {
  static constexpr int BQ = D == 256 ? 64 : 128;
  static constexpr int BK = D == 256 ? 16 : 32;
  static constexpr int NB = D == 256 ? 2 : (D / 8 < 4 ? D / 8 : 4);
  static_assert((D / 8) % NB == 0, "NB must divide the head-dim blocks");
  static constexpr int WARPS = BQ / 16;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int SQ = D + 8;
  static constexpr int SK = D + 8;
  static constexpr int SV = D + 4;
  static constexpr size_t SMEM =
      sizeof(float) * (static_cast<size_t>(BQ) * SQ +
                       3 * static_cast<size_t>(BK) * (SK + SV));
};

// Split a K or V tile of BK rows (row stride S floats) that has arrived in
// the ring: hi back in place, lo into `lo`; the block's threads share it.
template <int D>
__device__ __forceinline__ void split_tile(float* tile, float* lo, int S,
                                           int tid) {
  using T = Tiles<D>;
  constexpr int SEGS = D / 4;
  for (int e = tid; e < T::BK * SEGS; e += T::THREADS) {
    const int at = (e / SEGS) * S + 4 * (e % SEGS);
    const float4 x = *reinterpret_cast<const float4*>(tile + at);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(tile + at) = h;
    *reinterpret_cast<uint4*>(lo + at) = l;
  }
}

template <int D>
__global__ void __launch_bounds__(Tiles<D>::THREADS, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Lq,
             int Lk, int H, int Hkv, float scale, int causal, int window) {
  using T = Tiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, NB = T::NB;
  constexpr int SQ = T::SQ, SK = T::SK, SV = T::SV;
  constexpr int NKB = BK / 8;   // key blocks of 8 in a KV tile
  constexpr int NDB = D / 8;    // head-dim blocks of 8
  constexpr int SEGS = D / 4;   // 16-byte pieces of a row
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* kring = qs + BQ * SQ;
  float* vring = kring + 2 * BK * SK;
  float* klo = vring + 2 * BK * SV;
  float* vlo = klo + BK * SK;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row (and B column)
  const int t = lane & 3;   // fragment column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int off = Lk - Lq;
  const float c = scale * kLog2e;

  // Q tile, scaled by c so S comes out in log2 units: rows past Lq are
  // zeros
  for (int e = tid; e < BQ * SEGS; e += T::THREADS) {
    const int r = e / SEGS, s = e % SEGS;
    const int row = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < Lq)
      x = *reinterpret_cast<const float4*>(
          q + ((b * Lq + row) * H + h) * D + 4 * s);
    x.x *= c;
    x.y *= c;
    x.z *= c;
    x.w *= c;
    *reinterpret_cast<float4*>(qs + r * SQ + 4 * s) = x;
  }

  // KV columns any real row of this tile can see: [col_begin, col_end)
  int col_begin = 0;
  int col_end = Lk;
  if (causal) {
    const int last_row = min(q0 + BQ, Lq) - 1;
    col_end = max(0, min(Lk, last_row + off + 1));
    if (window > 0) col_begin = max(0, q0 + off - window + 1);
  }
  const int t_begin = col_begin / BK;
  const int t_end = (col_end + BK - 1) / BK;

  // this warp's rows, in key positions
  const int wrow = warp * 16;
  const int wfirst = q0 + wrow + off;
  const int wlast = min(q0 + wrow + 15, Lq - 1) + off;

  auto load_tile = [&](int tile, int stage) {
    const int c0 = tile * BK;
    float* ks = kring + stage * BK * SK;
    float* vs = vring + stage * BK * SV;
    for (int e = tid; e < BK * SEGS; e += T::THREADS) {
      const int r = e / SEGS, s = e % SEGS;
      const int col = c0 + r;
      const bool in = col < Lk;
      const long long idx =
          in ? ((b * Lk + col) * Hkv + hk) * D + 4 * s : 0;
      sm90::cp_async16(ks + r * SK + 4 * s, k + idx, in ? 16 : 0);
      sm90::cp_async16(vs + r * SV + 4 * s, v + idx, in ? 16 : 0);
    }
  };

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[NDB][4];
#pragma unroll
  for (int n = 0; n < NDB; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  if (t_begin < t_end) load_tile(t_begin, 0);
  sm90::cp_async_commit();

  for (int tile = t_begin, it = 0; tile < t_end; ++tile, ++it) {
    if (tile + 1 < t_end) load_tile(tile + 1, (it + 1) & 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    __syncthreads();
    // split the tile once for all warps: hi in place, lo apart
    split_tile<D>(kring + (it & 1) * BK * SK, klo, SK, tid);
    split_tile<D>(vring + (it & 1) * BK * SV, vlo, SV, tid);
    __syncthreads();

    const int c0 = tile * BK;
    // the tile holds a column this warp's rows can see (warp-uniform)
    bool active = wfirst - off < Lq && c0 < Lk;
    if (causal) {
      active = active && c0 <= wlast;
      if (window > 0) active = active && wfirst - (c0 + BK - 1) < window;
    }
    if (active) {
      const float* ks = kring + (it & 1) * BK * SK;
      const float* vs = vring + (it & 1) * BK * SV;

      // S = Q K^T: hi*hi and the two cross products in separate sums
      float shh[NKB][4], sx[NKB][4];
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) shh[j][i] = sx[j][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NDB; ++kk) {
        const int d = kk * 8 + 2 * t;
        const float2 q0v = *reinterpret_cast<const float2*>(
            qs + (wrow + g) * SQ + d);
        const float2 q1v = *reinterpret_cast<const float2*>(
            qs + (wrow + g + 8) * SQ + d);
        uint32_t ah[4], al[4];
        split(q0v.x, ah[0], al[0]);
        split(q1v.x, ah[1], al[1]);
        split(q0v.y, ah[2], al[2]);
        split(q1v.y, ah[3], al[3]);
        uint32_t bh[NKB][2], bl[NKB][2];
#pragma unroll
        for (int j = 0; j < NKB; ++j) {
          const uint2 kh =
              *reinterpret_cast<const uint2*>(ks + (j * 8 + g) * SK + d);
          const uint2 kl =
              *reinterpret_cast<const uint2*>(klo + (j * 8 + g) * SK + d);
          bh[j][0] = kh.x;
          bh[j][1] = kh.y;
          bl[j][0] = kl.x;
          bl[j][1] = kl.y;
        }
        // independent products first, so no product waits on the last
#pragma unroll
        for (int j = 0; j < NKB; ++j) mma(shh[j], ah, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NKB; ++j) mma(sx[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NKB; ++j) mma(sx[j], al, bh[j][0], bh[j][1]);
      }

      // masks only where the tile crosses an edge of this warp's rows
      bool edge = c0 + BK > Lk;
      if (causal) {
        edge = edge || c0 + BK - 1 > wfirst;
        if (window > 0) edge = edge || wlast - c0 >= window;
      }
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float s = shh[j][i] + sx[j][i];
          if (edge) {
            const int col = c0 + j * 8 + 2 * t + (i & 1);
            const int row = wfirst + g + 8 * (i >> 1);
            bool ok = col < Lk;
            if (causal) {
              ok = ok && row >= col;
              if (window > 0) ok = ok && row - col < window;
            }
            s = ok ? s : kNegInf;
          }
          shh[j][i] = s;
          mt[i >> 1] = fmaxf(mt[i >> 1], s);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m[r], mt[r]);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
      uint32_t ph[NKB][4], pl[NKB][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NKB; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = ex2(shh[j][i] - m[i >> 1]);
          rs[i >> 1] += p;
          split(p, ph[j][i], pl[j][i]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * alpha[r] + rs[r];
      }

      // O = O * alpha + P V, the tile's P V summed from zero; key k of
      // block j is read at row j*8 + 2t (k = t) and j*8 + 2t + 1 (k = t+4)
#pragma unroll
      for (int n0 = 0; n0 < NDB; n0 += NB) {
        float th[NB][4], tx[NB][4];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) th[nb][i] = tx[nb][i] = 0.f;
#pragma unroll
        for (int j = 0; j < NKB; ++j) {
          const uint32_t ah[4] = {ph[j][0], ph[j][2], ph[j][1], ph[j][3]};
          const uint32_t al[4] = {pl[j][0], pl[j][2], pl[j][1], pl[j][3]};
          const int v0 = (j * 8 + 2 * t) * SV + g;
          uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const int col = v0 + (n0 + nb) * 8;
            bh[nb][0] = __float_as_uint(vs[col]);
            bh[nb][1] = __float_as_uint(vs[SV + col]);
            bl[nb][0] = __float_as_uint(vlo[col]);
            bl[nb][1] = __float_as_uint(vlo[SV + col]);
          }
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            mma(th[nb], ah, bh[nb][0], bh[nb][1]);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            mma(tx[nb], ah, bl[nb][0], bl[nb][1]);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            mma(tx[nb], al, bh[nb][0], bh[nb][1]);
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[n0 + nb][i] = fmaf(acc[n0 + nb][i], alpha[i >> 1],
                                   th[nb][i] + tx[nb][i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wrow + g + 8 * r;
    if (row >= Lq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    float* orow = o + ((b * Lq + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NDB; ++n)
      *reinterpret_cast<float2*>(orow + n * 8) =
          make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Lq, int Lk, int H, int Hkv, float scale, int causal,
           int window, cudaStream_t stream) {
  using T = Tiles<D>;
  auto kernel = flash_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + T::BQ - 1) / T::BQ, H, B);
  kernel<<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Lq, Lk, H, Hkv,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 only; window <= 0 means no window; the window applies only
// when causal.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Lq,
                                      int Lk, int H, int Hkv, int D,
                                      float scale, int causal, int window,
                                      cudaStream_t stream) {
  if (B <= 0 || Lq <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || Lk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, B, Lq, Lk, H, Hkv, scale, causal, window,
                        stream);
    case 32:
      return launch<32>(q, k, v, o, B, Lq, Lk, H, Hkv, scale, causal, window,
                        stream);
    case 64:
      return launch<64>(q, k, v, o, B, Lq, Lk, H, Hkv, scale, causal, window,
                        stream);
    case 96:
      return launch<96>(q, k, v, o, B, Lq, Lk, H, Hkv, scale, causal, window,
                        stream);
    case 128:
      return launch<128>(q, k, v, o, B, Lq, Lk, H, Hkv, scale, causal,
                         window, stream);
    case 256:
      return launch<256>(q, k, v, o, B, Lq, Lk, H, Hkv, scale, causal,
                         window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
