// K7: single-token attention with grouped KV heads over a KV cache.
//
// Replaces src/repro/kernels/decode_attention.py `_decode_kernel` (entry
// `decode_attention`).  q (B, H, D); k and v caches (B, S, Hkv, D), all
// contiguous, float32 or bfloat16; lengths (B,) int32; out (B, H, D) in
// q's type.  Row b attends over its first lengths[b] cache positions
// (clamped to [0, S]); a row of length 0 gives zeros, as the TPU kernel's
// finalize does.  Masked logits are -1e30 and the output is
// acc / max(l, 1e-30).
//
// What bounds it on the H100: bytes.  Each visible position costs 2*D
// cache elements read and 4*G*D operations for the G query heads of its
// KV group, about G/2 operations per byte in float32 -- far below the
// card's ratio, so the least time is the cache bytes over 3.35 TB/s.
//
// Design (simple and right first):
//  * One block per (KV head, batch row) holds that group's G query rows.
//    It streams only the first lengths[b] positions, 32 at a time, through
//    shared memory, and all G heads read each staged tile: the cache is
//    read once per group, not once per head, which is the GQA saving the
//    TPU kernel was built around.
//  * The online softmax (running max, denominator, accumulator) stays in
//    float32 in shared memory.  The cache is read in place: no copy, and
//    no padding of S to a tile multiple (the JAX wrapper pads the whole
//    cache on every step).
//  * Logits: one warp per (head, position) pair, lanes splitting D, then a
//    shuffle sum.  Softmax update: one warp per head (32 lanes, one
//    position each).  Accumulator: one thread per (head, column).
//  * At the serving engine's shape (B = 8, Hkv = 8) this is 64 blocks on
//    132 SMs, under half the card, each streaming its rows alone.
//    Splitting S across blocks, with a second pass that combines their
//    partial (m, l, acc), is the first lever for the PR that makes K7
//    fast; double-buffering the tiles with cp.async is the second.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBS = 32;  // cache positions per tile: one per lane
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) * (2 * static_cast<size_t>(G) * D +
                          2 * static_cast<size_t>(kBS) * D + G * kBS + 3 * G);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              T* __restrict__ o, int S, int H, int Hkv, float scale) {
  const int hk = blockIdx.x;
  const long long b = blockIdx.y;
  const int G = H / Hkv;
  extern __shared__ float smem[];
  float* qs = smem;             // (G, D) queries
  float* acc = qs + G * D;      // (G, D) accumulator
  float* ks = acc + G * D;      // (kBS, D) K tile
  float* vs = ks + kBS * D;     // (kBS, D) V tile
  float* lg = vs + kBS * D;     // (G, kBS) logits, then p
  float* m = lg + G * kBS;      // (G,) running max
  float* l = m + G;             // (G,) running denominator
  float* alpha = l + G;         // (G,) this tile's rescale

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = max(0, min(lengths[b], S));
  const long long qbase = (b * H + static_cast<long long>(hk) * G) * D;

  for (int e = tid; e < G * D; e += kThreads) {
    qs[e] = to_f32(q[qbase + e]);
    acc[e] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m[g] = kNegInf;
    l[g] = 0.0f;
  }
  __syncthreads();

  for (int s0 = 0; s0 < len; s0 += kBS) {
    for (int e = tid; e < kBS * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const int pos = s0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (pos < len) {
        const long long idx = ((b * S + pos) * Hkv + hk) * D + d;
        kv = to_f32(kc[idx]);
        vv = to_f32(vc[idx]);
      }
      ks[e] = kv;
      vs[e] = vv;
    }
    __syncthreads();

    for (int pr = warp; pr < G * kBS; pr += kWarps) {
      const int g = pr / kBS, r = pr % kBS;
      float part = 0.0f;
      for (int d = lane; d < D; d += 32)
        part = fmaf(qs[g * D + d], ks[r * D + d], part);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, w);
      if (lane == 0) lg[g * kBS + r] = s0 + r < len ? part * scale : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      const float x = lg[g * kBS + lane];
      const float m_old = m[g];
      float mt = x;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
      const float m_new = fmaxf(m_old, mt);
      const float p = expf(x - m_new);
      float rs = p;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      lg[g * kBS + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[g] = a;
        l[g] = l[g] * a + rs;
        m[g] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D, d = e % D;
      float a = acc[e] * alpha[g];
#pragma unroll 8
      for (int r = 0; r < kBS; ++r) a = fmaf(lg[g * kBS + r], vs[r * D + d], a);
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < G * D; e += kThreads)
    store(o + qbase + e, acc[e] / fmaxf(l[e / D], 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const int* lengths,
           void* o, int B, int S, int H, int Hkv, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, D);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lengths, static_cast<T*>(o), S, H, Hkv,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* kc, const void* vc,
             const int* lengths, void* o, int B, int S, int H, int Hkv,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, kc, vc, lengths, o, B, S, H, Hkv, scale, stream);
    case 32:
      return launch<T, 32>(q, kc, vc, lengths, o, B, S, H, Hkv, scale, stream);
    case 64:
      return launch<T, 64>(q, kc, vc, lengths, o, B, S, H, Hkv, scale, stream);
    case 128:
      return launch<T, 128>(q, kc, vc, lengths, o, B, S, H, Hkv, scale,
                            stream);
    case 256:
      return launch<T, 256>(q, kc, vc, lengths, o, B, S, H, Hkv, scale,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const int* lengths,
                                       void* o, int B, int S, int H, int Hkv,
                                       int D, int bf16, float scale,
                                       cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? dispatch<__nv_bfloat16>(D, q, kc, vc, lengths, o, B, S, H,
                                        Hkv, scale, stream)
              : dispatch<float>(D, q, kc, vc, lengths, o, B, S, H, Hkv, scale,
                                stream);
}
