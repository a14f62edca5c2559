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
// Design:
//  * The cache is split along S into `splits` chunks (the wrapper picks
//    the count from the shapes and the SM count alone, never from the
//    lengths, so no decode step waits for the host).  One block takes one
//    (chunk, KV head and group of GT of its query heads, batch row) and
//    streams only the positions of its chunk below lengths[b]: every
//    query head of the group reads each position once from the cache.
//  * Within a block, each warp splits into lane groups; a lane group
//    takes kU positions a step, its lanes splitting D into 16-byte
//    vectors (8 bfloat16 or 4 float32 values).  A group has a power of
//    two of lanes, so the logit's shuffle reduction stays in the group:
//    where D holds no power of two of vectors (D = 96: 24 float32 or 12
//    bfloat16 vectors) the group rounds up to 32 or 16 lanes and the
//    lanes past D's vectors load nothing and add zeros.  The loads are cp.async
//    copies into a two-stage ring in shared memory, one step ahead; each
//    lane reads back only the bytes it copied itself, so the ring needs
//    no barrier.  Logits reduce over the group's lanes with shuffles, and
//    each lane group keeps its own online softmax (m, l, acc) in float32
//    registers, in base 2 (q scaled by scale * log2 e).
//  * At the end the block's lane groups combine through shared memory
//    (the only barriers).  With one split the block writes the output;
//    otherwise it writes float32 partials (m, l, acc) to scratch the
//    wrapper allocated, and a second kernel combines the chunks.  A chunk
//    past a row's length writes m = -1e30, l = 0.
//  * Short caches (the serving engine's) take one split: one launch, no
//    combine pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 4;       // positions per lane group per step
constexpr int kStages = 2;  // cp.async ring depth
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// the VEC values of one 16-byte vector, as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the least power of two at or above x
constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}

template <typename T, int D>
struct Geometry {
  static constexpr int VEC = 16 / sizeof(T);                   // per vector
  static constexpr int VPR = D / VEC;                          // vec/row
  static constexpr int LPP = VPR < 32 ? pow2_at_least(VPR) : 32;  // lanes
  static constexpr int NV = (VPR + LPP - 1) / LPP;             // vec/lane
  static_assert(VPR <= LPP || VPR % LPP == 0, "lanes must split D evenly");
  static constexpr bool FULL = NV * LPP == VPR;                // no idle lane
  static constexpr int PPW = 32 / LPP;                         // pos/warp
  static constexpr int NG = kWarps * PPW;                      // groups
  static constexpr int STEP = NG * kU;                         // pos/step
  static constexpr size_t RING = sizeof(uint4) * kStages * kU * 2 * NV *
                                 kThreads;
};

template <typename T, int D, int GT>
size_t smem_bytes() {
  using Geo = Geometry<T, D>;
  const size_t combine = sizeof(float) * Geo::NG * GT * (D + 2);
  return Geo::RING > combine ? Geo::RING : combine;
}

template <typename T, int D, int GT>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int S, int H, int Hkv,
                    int chunk, float scale_log2) {
  using Geo = Geometry<T, D>;
  constexpr int VEC = Geo::VEC, LPP = Geo::LPP, NV = Geo::NV;
  constexpr int PPW = Geo::PPW, NG = Geo::NG;
  constexpr int W = NV * VEC;  // values of D this lane holds
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const long long b = blockIdx.z;
  const int G = H / Hkv;
  const int hk = blockIdx.y / (G / GT);
  const int h0 = hk * G + (blockIdx.y % (G / GT)) * GT;
  const int len = max(0, min(lengths[b], S));
  const int start = split * chunk;
  const int end = min(start + chunk, len);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int li = lane % LPP;                         // lane in its group
  const int grp = (tid / 32) * PPW + lane / LPP;     // group in the block
  // the lane holds a part of D (every lane does unless D's vectors fall
  // short of the group's lanes: NV is then 1)
  const bool on = Geo::FULL || li < Geo::VPR;

  float qf[GT][W], acc[GT][W], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    const T* qg = q + (b * H + h0 + g) * D;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      float f[VEC];
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      unpack(on ? *reinterpret_cast<const uint4*>(qg + (v * LPP + li) * VEC)
                : zero, f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qf[g][v * VEC + e] = f[e] * scale_log2;
        acc[g][v * VEC + e] = 0.0f;
      }
    }
    m[g] = kNegInf;
    l[g] = 0.0f;
  }

  // this thread's slot of the ring: stage, position, K or V, vector
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);
  auto slot = [&](int stage, int u, int kv, int v) -> uint4* {
    return ring + (((stage * kU + u) * 2 + kv) * NV + v) * kThreads + tid;
  };
  const long long row_stride = static_cast<long long>(Hkv) * D;
  const T* kb = kc + (b * S * Hkv + hk) * D;
  const T* vb = vc + (b * S * Hkv + hk) * D;
  auto fetch = [&](int st) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int pos = start + (st * NG + grp) * kU + u;
      const bool ok = pos < end;
      const long long at = (ok ? pos : 0) * row_stride;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int d0 = on ? (v * LPP + li) * VEC : 0;
        sm90::cp_async16(slot(st % kStages, u, 0, v), kb + at + d0,
                         ok && on ? 16 : 0);
        sm90::cp_async16(slot(st % kStages, u, 1, v), vb + at + d0,
                         ok && on ? 16 : 0);
      }
    }
  };

  const int steps = end > start ? (end - start + Geo::STEP - 1) / Geo::STEP
                                : 0;
  if (steps > 0) fetch(0);
  sm90::cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) fetch(st + 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<1>();
    const int stage = st % kStages;

    float sc[kU][GT];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int g = 0; g < GT; ++g) sc[u][g] = 0.0f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float f[VEC];
        unpack(*slot(stage, u, 0, v), f);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            sc[u][g] = fmaf(qf[g][v * VEC + e], f[e], sc[u][g]);
      }
    }
#pragma unroll
    for (int w = LPP / 2; w > 0; w >>= 1)
#pragma unroll
      for (int u = 0; u < kU; ++u)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], w);

    const int pos0 = start + (st * NG + grp) * kU;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (pos0 + u < end) mx = fmaxf(mx, sc[u][g]);
      const float m_new = fmaxf(m[g], mx);
      const float alpha = exp2f(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < W; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        sc[u][g] = pos0 + u < end ? exp2f(sc[u][g] - m_new) : 0.0f;
        l[g] += sc[u][g];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float f[VEC];
        unpack(*slot(stage, u, 1, v), f);
#pragma unroll
        for (int g = 0; g < GT; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][v * VEC + e] = fmaf(sc[u][g], f[e], acc[g][v * VEC + e]);
      }
  }
  sm90::cp_async_wait<0>();
  __syncthreads();  // the ring's memory becomes the combine's

  float* cm = reinterpret_cast<float*>(smem_raw);  // (NG, GT)
  float* cl = cm + NG * GT;                        // (NG, GT)
  float* ca = cl + NG * GT;                        // (NG, GT, D)
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (li == 0) {
      cm[grp * GT + g] = m[g];
      cl[grp * GT + g] = l[g];
    }
    if (!on) continue;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        ca[(grp * GT + g) * D + (v * LPP + li) * VEC + e] =
            acc[g][v * VEC + e];
  }
  __syncthreads();
  for (int e = tid; e < GT * D; e += kThreads) {
    const int g = e / D, d = e % D;
    float M = kNegInf;
    for (int n = 0; n < NG; ++n) M = fmaxf(M, cm[n * GT + g]);
    float L = 0.0f, A = 0.0f;
    for (int n = 0; n < NG; ++n) {
      const float w = exp2f(cm[n * GT + g] - M);
      L = fmaf(cl[n * GT + g], w, L);
      A = fmaf(ca[(n * GT + g) * D + d], w, A);
    }
    const long long hrow = b * H + h0 + g;
    if (splits == 1) {
      store(o + hrow * D + d, A / fmaxf(L, 1e-30f));
    } else {
      const long long p = hrow * splits + split;
      part_acc[p * D + d] = A;
      if (d == 0) {
        part_m[p] = M;
        part_l[p] = L;
      }
    }
  }
}

// out[b, h] from the splits' partials of row (b, h): one block per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, T* __restrict__ o,
                      int splits, int D) {
  const long long hrow = blockIdx.x;
  const float* pm = part_m + hrow * splits;
  const float* pl = part_l + hrow * splits;
  const float* pa = part_acc + hrow * splits * D;
  float M = kNegInf;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, pm[s]);
  float L = 0.0f;
  for (int s = 0; s < splits; ++s) L = fmaf(pl[s], exp2f(pm[s] - M), L);
  const float denom = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float A = 0.0f;
    for (int s = 0; s < splits; ++s)
      A = fmaf(pa[s * D + d], exp2f(pm[s] - M), A);
    store(o + hrow * D + d, A / denom);
  }
}

template <typename T, int D, int GT>
int launch(const void* q, const void* kc, const void* vc, const int* lengths,
           void* o, float* part_m, float* part_l, float* part_acc, int B,
           int S, int H, int Hkv, float scale, int splits, int chunk,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D, GT>();
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decode_split_kernel<T, D, GT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, Hkv * (H / Hkv / GT), B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lengths, static_cast<T*>(o), part_m,
      part_l, part_acc, S, H, Hkv, chunk, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  decode_combine_kernel<T><<<B * H, kThreads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(o), splits, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_group(const void* q, const void* kc, const void* vc,
             const int* lengths, void* o, float* pm, float* pl, float* pa,
             int B, int S, int H, int Hkv, float scale, int splits,
             int chunk, cudaStream_t stream) {
  const int G = H / Hkv;
  if (G % 8 == 0)
    return launch<T, D, 8>(q, kc, vc, lengths, o, pm, pl, pa, B, S, H, Hkv,
                           scale, splits, chunk, stream);
  if (G % 4 == 0)
    return launch<T, D, 4>(q, kc, vc, lengths, o, pm, pl, pa, B, S, H, Hkv,
                           scale, splits, chunk, stream);
  if (G % 2 == 0)
    return launch<T, D, 2>(q, kc, vc, lengths, o, pm, pl, pa, B, S, H, Hkv,
                           scale, splits, chunk, stream);
  return launch<T, D, 1>(q, kc, vc, lengths, o, pm, pl, pa, B, S, H, Hkv,
                         scale, splits, chunk, stream);
}

template <typename T>
int dispatch(int D, const void* q, const void* kc, const void* vc,
             const int* lengths, void* o, float* pm, float* pl, float* pa,
             int B, int S, int H, int Hkv, float scale, int splits,
             int chunk, cudaStream_t stream) {
  switch (D) {
    case 16:
      return by_group<T, 16>(q, kc, vc, lengths, o, pm, pl, pa, B, S, H, Hkv,
                             scale, splits, chunk, stream);
    case 32:
      return by_group<T, 32>(q, kc, vc, lengths, o, pm, pl, pa, B, S, H, Hkv,
                             scale, splits, chunk, stream);
    case 64:
      return by_group<T, 64>(q, kc, vc, lengths, o, pm, pl, pa, B, S, H, Hkv,
                             scale, splits, chunk, stream);
    case 96:
      return by_group<T, 96>(q, kc, vc, lengths, o, pm, pl, pa, B, S, H, Hkv,
                             scale, splits, chunk, stream);
    case 128:
      return by_group<T, 128>(q, kc, vc, lengths, o, pm, pl, pa, B, S, H,
                              Hkv, scale, splits, chunk, stream);
    case 256:
      return by_group<T, 256>(q, kc, vc, lengths, o, pm, pl, pa, B, S, H,
                              Hkv, scale, splits, chunk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// splits * chunk >= S; with splits > 1, part_m and part_l hold
// B * H * splits floats and part_acc B * H * splits * D (else unused).
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const int* lengths,
                                       void* o, float* part_m, float* part_l,
                                       float* part_acc, int B, int S, int H,
                                       int Hkv, int D, int is_bf16, float scale,
                                       int splits, int chunk,
                                       cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || S < 0 || splits < 1 ||
      static_cast<long long>(splits) * chunk < S)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_bf16 ? dispatch<bf16>(D, q, kc, vc, lengths, o, part_m, part_l,
                                  part_acc, B, S, H, Hkv, scale, splits,
                                  chunk, stream)
                 : dispatch<float>(D, q, kc, vc, lengths, o, part_m, part_l,
                                   part_acc, B, S, H, Hkv, scale, splits,
                                   chunk, stream);
}
