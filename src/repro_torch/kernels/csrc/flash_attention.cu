// K6: blocked online-softmax (flash) attention with grouped KV heads.
//
// Replaces src/repro/kernels/flash_attention.py `_flash_kernel` (entry
// `flash_attention`) for float32 inputs; bfloat16 runs on the tensor
// cores in flash_attention_sm90.cu.  q (B, Lq, H, D); k and v
// (B, Lk, Hkv, D), all contiguous float32; out (B, Lq, H, D).  The KV
// head of query head h is h / (H / Hkv): no repeated K or V is ever made.
// Masks come from global indices with the offset Lk - Lq (the query rows
// are the last Lq positions): causal `row + off >= col`, and with a window
// `row + off - col < window`.  Masked logits are -1e30 and the output is
// acc / max(l, 1e-30), as in the TPU kernel.
//
// What bounds it on the H100: operations.  Each visible (row, col) pair
// costs 4*D float operations (one dot product for the logit, one
// multiply-add row of P @ V); at L = 4096 and D = 128 that is over a
// thousand operations per byte read, far above the card's ratio.  It
// runs float32 FMAs on the CUDA cores (67 TFLOP/s): TF32 `wgmma` would
// round the products past the float32 contract's 2e-5.
//
// Design (simple and right first):
//  * One block per (query tile of 64 rows, head, batch row).  A loop over
//    KV tiles inside the block takes the place of the TPU grid's
//    sequential innermost axis; the running max m, denominator l and the
//    output accumulator stay in registers, in float32.
//  * The loop's bounds skip every KV tile that is wholly masked for the
//    block's rows: past the diagonal, and left of the window.  That is the
//    block sparsity the TPU kernel gets from `pl.when`.
//  * Ragged Lq and Lk are masked in the kernel (rows past Lq are not
//    stored, columns past Lk are masked); nothing is padded or copied.
//  * 256 threads as a 16 x 16 grid: a thread owns rows ty + 16 i of the
//    tile, logit columns tx + 16 j and output columns tx + 16 j.  The 16
//    threads of a row sit in one half-warp, so row max and row sum are
//    warp shuffles.  Q, K, V and P tiles are staged in shared memory
//    (Q and K rows padded by one float against bank conflicts).

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBQ = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr int kv_tile() { return D >= 128 ? 32 : 64; }

template <int D, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ) * (D + 1) + BK * (D + 1) + BK * D +
          kBQ * (BK + 1));
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Lq, int Lk,
             int H, int Hkv, float scale, int causal, int window) {
  constexpr int RI = kBQ / 16;  // query rows per thread
  constexpr int CJ = BK / 16;   // logit columns per thread
  constexpr int DJ = D / 16;    // output columns per thread
  constexpr int QS = D + 1;     // padded row stride of the Q and K tiles
  constexpr int PS = BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * QS;
  float* vs = ks + BK * QS;
  float* ps = vs + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int off = Lk - Lq;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int row = q0 + r;
    qs[r * QS + d] =
        row < Lq ? to_f32(q[((b * Lq + row) * H + h) * D + d]) : 0.0f;
  }

  // KV columns any real row of this tile can see: [col_begin, col_end)
  int col_begin = 0;
  int col_end = Lk;
  if (causal) {
    const int last_row = min(q0 + kBQ, Lq) - 1;
    col_end = max(0, min(Lk, last_row + off + 1));
    if (window > 0) col_begin = max(0, q0 + off - window + 1);
  }
  const int t_begin = col_begin / BK;
  const int t_end = (col_end + BK - 1) / BK;

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * BK;
    for (int e = tid; e < BK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const int col = c0 + c;
      float kv = 0.0f, vv = 0.0f;
      if (col < Lk) {
        const long long idx = ((b * Lk + col) * Hkv + hk) * D + d;
        kv = to_f32(k[idx]);
        vv = to_f32(v[idx]);
      }
      ks[c * QS + d] = kv;
      vs[c * D + d] = vv;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i + off;  // in key positions
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = c0 + tx + 16 * j;
        bool ok = col < Lk;
        if (causal) {
          ok = ok && row >= col;
          if (window > 0) ok = ok && row - col < window;
        }
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((b * Lq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(orow + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Lq, int Lk, int H, int Hkv, float scale, int causal,
           int window, cudaStream_t stream) {
  constexpr int BK = kv_tile<D>();
  constexpr size_t smem = smem_bytes<D, BK>();
  auto kernel = flash_kernel<T, D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Lq, Lk, H, Hkv, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int Lq, int Lk, int H, int Hkv, float scale, int causal,
             int window, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Lq, Lk, H, Hkv, scale, causal,
                           window, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Lq, Lk, H, Hkv, scale, causal,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Lq, Lk, H, Hkv, scale, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Lq, Lk, H, Hkv, scale, causal,
                            window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Lq, Lk, H, Hkv, scale, causal,
                            window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
  return dispatch<float>(D, q, k, v, o, B, Lq, Lk, H, Hkv, scale, causal,
                         window, stream);
}
