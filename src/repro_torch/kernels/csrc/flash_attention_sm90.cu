// K6 in bfloat16: flash attention on Hopper's tensor cores (wgmma).
//
// Replaces src/repro/kernels/flash_attention.py `_flash_kernel` (entry
// `flash_attention`) for bfloat16 inputs; float32 keeps the SIMT kernel
// of flash_attention.cu.  q (B, Lq, H, D); k and v (B, Lk, Hkv, D), all
// contiguous bfloat16; out (B, Lq, H, D) bfloat16.  The KV head of query
// head h is h / (H / Hkv).  Masks come from global indices with the offset
// Lk - Lq: causal `row + off >= col`, and with a window
// `row + off - col < window`.  Masked logits are -1e30 and the output is
// acc / max(l, 1e-30), as in the TPU kernel.  Ragged Lq and Lk are masked
// here (zero-filled loads, rows past Lq not stored): nothing is padded.
//
// What bounds it on the H100: operations.  Each visible (row, col) pair
// costs 4*D operations, over a thousand per byte read at L = 4096, so the
// least time is the bfloat16 tensor-core rate (989 TFLOP/s).  Only
// `wgmma` reaches it; the SIMT kernel's float32 FMAs top out at 67.
//
// Design:
//  * One block per (query tile of 128 rows, head, batch row): two
//    warpgroups of 128 threads, each owning 64 query rows.  The Q tile is
//    loaded once into shared memory; the loop over KV tiles of BK
//    positions (128, or 64 for D = 256 to stay within shared memory)
//    takes the place of the TPU grid's sequential innermost axis.
//  * Q, K and V tiles are loaded by TMA (`cp.async.bulk.tensor` on a 4-d
//    tensor map of each input, completing on an mbarrier), swizzled as
//    wgmma reads them (sm90.cuh); rows past Lq or Lk arrive as zeros.  K
//    and V go through a ring of three stages (two for D = 256), one
//    thread issuing each tile two tiles ahead, so the loads overlap the
//    products.  A stage is refilled once every thread has arrived on its
//    `empty` mbarrier; no block barrier runs in the loop, so the two
//    warpgroups drift apart and one's softmax overlaps the other's
//    products.
//  * S = Q K^T: D/16 `wgmma` m64nBKk16, both operands from shared memory,
//    float32 accumulators in registers.  D = 96 keeps its tiles as three
//    32-column blocks (64-byte swizzle); the k-walk steps through them and
//    P V runs as m64n96k16 over the same blocks.
//  * The online softmax runs on the accumulator fragment in registers, in
//    float32 and base 2 (logits scaled by scale * log2 e): each thread
//    holds two rows; row max and row sum reduce over the four lanes that
//    share a row.  Masks are evaluated only on tiles that need them.
//  * O += P V: P is rounded to bfloat16 in registers (as the plain
//    version's `p.to(v.dtype)`) and fed as the register A operand of
//    BK/16 `wgmma` m64nDk16, V read MN-major from shared memory.
//  * Block sparsity: the loop's bounds skip KV tiles past the diagonal
//    and left of the window; query tiles run longest first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBQ = 64 * kWarpgroups;  // query rows per block
constexpr size_t kMaxSmem = 232448;

template <int D>
constexpr int kv_tile() { return D <= 128 ? 128 : 64; }

// columns of one swizzled block of a tile (sm90.cuh's layout): D itself
// below 64, 64 where it divides D, else 32 (D = 96: three blocks of 32,
// each with the 64-byte swizzle, so every column arrives and none is
// padding)
template <int D>
__host__ __device__ constexpr int block_cols() {
  return D < 64 ? D : D % 64 == 0 ? 64 : 32;
}

template <int D, int BK, int STAGES>
constexpr size_t smem_bytes() {
  // the tiles, their mbarriers, and room to align the base to 1024 bytes
  return sizeof(bf16) * (static_cast<size_t>(kBQ) * D + 2 * STAGES * BK * D) +
         8 * (2 * STAGES + 1) + 1024;
}

// three stages of K and V where they fit beside the Q tile, else two
template <int D>
constexpr int kv_stages() {
  return smem_bytes<D, kv_tile<D>(), 3>() <= kMaxSmem ? 3 : 2;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keep the compiler from moving register accesses across wgmma's
// asynchronous reads and writes of them
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// TMA loads of `rows` rows from row `row` of head `head` of batch row `b`
// into a tile at dst: one box per W-column block (sm90.cuh's layout)
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row, int head,
                                          int b) {
  constexpr int W = block_cols<D>();
#pragma unroll
  for (int j = 0; j < D / W; ++j)
    sm90::tma_load_4d(dst + j * ROWS * W, map, bar, j * W, head, row, b);
}

template <int D, int BK, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   bf16* __restrict__ o, int Lq, int Lk, int H, int Hkv,
                   float scale_log2, int causal, int window) {
  constexpr int W = block_cols<D>();  // columns of a swizzled block
  constexpr int RB = 2 * W;           // bytes of one of its rows
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* ks = qs + kBQ * D;          // STAGES of (BK, D)
  bf16* vs = ks + STAGES * BK * D;  // STAGES of (BK, D)
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + STAGES * BK * D);
  uint64_t* qbar = full + STAGES;
  uint64_t* empty = qbar + 1;  // STAGES: every thread is done with a tile

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int off = Lk - Lq;

  // KV columns any real row of this block can see: [col_begin, col_end)
  int col_begin = 0;
  int col_end = Lk;
  if (causal) {
    const int last_row = min(q0 + kBQ, Lq) - 1;
    col_end = max(0, min(Lk, last_row + off + 1));
    if (window > 0) col_begin = max(0, q0 + off - window + 1);
  }
  const int t_begin = col_begin / BK;
  const int t_end = (col_end + BK - 1) / BK;

  // thread 0 loads: the Q tile once, KV tile t into its stage of the ring
  // (rows past Lq or Lk arrive as zeros)
  auto load_kv = [&](int t) {
    if (t < t_end) {
      const int stage = (t - t_begin) % STAGES;
      sm90::mbar_expect_tx(&full[stage], 2 * BK * D * sizeof(bf16));
      load_tile<D, BK>(ks + stage * BK * D, &kmap, &full[stage], t * BK, hk,
                       b);
      load_tile<D, BK>(vs + stage * BK * D, &vmap, &full[stage], t * BK, hk,
                       b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) sm90::mbar_init(&full[i], 1);
    for (int i = 0; i < STAGES; ++i) sm90::mbar_init(&empty[i], kThreads);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(qbar, kBQ * D * sizeof(bf16));
    load_tile<D, kBQ>(qs, &qmap, qbar, q0, h, b);
    for (int i = 0; i < STAGES - 1; ++i) load_kv(t_begin + i);
  }

  // this thread's rows of the accumulator fragment: row0 and row0 + 8
  const int wg_row = q0 + wg * 64;
  const int row0 = wg_row + warp * 16 + lane / 4;
  const uint32_t qw = sm90::smem_addr(qs + wg * 64 * W);  // its 64 rows
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  sm90::mbar_wait(qbar, 0);

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) % STAGES;
    const int c0 = t * BK;
    // the next load overwrites tile t - 1's stage once every thread is
    // done with it; the warpgroups are otherwise free to drift apart, so
    // one's softmax overlaps the other's products
    if (tid == 0 && t + STAGES - 1 < t_end) {
      if (t > t_begin)
        sm90::mbar_wait(&empty[(t - 1 - t_begin) % STAGES],
                        ((t - 1 - t_begin) / STAGES) & 1);
      load_kv(t + STAGES - 1);
    }
    sm90::mbar_wait(&full[stage], ((t - t_begin) / STAGES) & 1);
    const uint32_t kt = sm90::smem_addr(ks + stage * BK * D);
    const uint32_t vt = sm90::smem_addr(vs + stage * BK * D);

    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
    fence_regs(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // columns 16 kk..16 kk+15: block (16 kk) / W, 32-byte step inside it
      sm90::WgmmaSS<BK>::run(
          s,
          sm90::make_desc<RB>(qw + (kk * 16 / W) * kBQ * RB +
                                  (kk * 16 % W) * 2, 16, 8 * RB),
          sm90::make_desc<RB>(kt + (kk * 16 / W) * BK * RB +
                                  (kk * 16 % W) * 2, 16, 8 * RB),
          kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_regs(s);
    const bool need_mask =
        c0 + BK > Lk ||
        (causal && (c0 + BK - 1 > wg_row + off ||
                    (window > 0 && c0 <= wg_row + 63 + off - window)));
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i / 2) % 2;
      float x = s[i] * scale_log2;
      if (need_mask) {
        const int col = c0 + (i / 4) * 8 + (lane % 4) * 2 + i % 2;
        const int row = row0 + 8 * r + off;  // in key positions
        bool ok = col < Lk;
        if (causal) {
          ok = ok && row >= col;
          if (window > 0) ok = ok && row - col < window;
        }
        x = ok ? x : kNegInf;
      }
      s[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i / 2) % 2;
      s[i] = ex2(s[i] - m[r]);
      l[r] += s[i];  // this thread's part of the row sum
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

    uint32_t p[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[kk][j] = sm90::pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    fence_regs(acc);
    fence_regs(p);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::WgmmaRS<D>::run(
          acc, p[kk], sm90::make_desc<RB>(vt + kk * 16 * RB, BK * RB, 8 * RB),
          1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_regs(acc);
    sm90::mbar_arrive(&empty[stage]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int r = (i / 2) % 2;
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    const int col = (i / 4) * 8 + (lane % 4) * 2;
    *reinterpret_cast<__nv_bfloat162*>(
        o + ((static_cast<long long>(b) * Lq + row) * H + h) * D + col) =
        __floats2bfloat162_rn(acc[i] / l[r], acc[i + 1] / l[r]);
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime so
// the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (B, L, heads, D) tensor at `base` as a 4-d map (D, heads, L, B),
// whose box is `rows` rows of one head by W columns, swizzled by 2 W
// bytes; positions past L read as zeros.
template <int D>
bool make_map(CUtensorMap* map, const void* base, int B, int L, int heads,
              int rows) {
  constexpr int W = block_cols<D>();
  const CUtensorMapSwizzle swizzle =
      W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
              : W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t esize = sizeof(bf16);
  const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {D * esize, D * esize * heads,
                                 D * esize * heads * L};
  const cuuint32_t box[4] = {W, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const EncodeTiled encode = encode_tiled();
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Lq, int Lk, int H, int Hkv, float scale, int causal,
           int window, cudaStream_t stream) {
  constexpr int BK = kv_tile<D>();
  constexpr int STAGES = kv_stages<D>();
  constexpr size_t smem = smem_bytes<D, BK, STAGES>();
  static_assert(smem <= kMaxSmem, "tiles exceed shared memory");
  // an empty cache is never read: map q in its place
  const bool empty = Lk == 0;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map<D>(&qmap, q, B, Lq, H, kBQ) ||
      !make_map<D>(&kmap, empty ? q : k, B, empty ? Lq : Lk,
                   empty ? H : Hkv, BK) ||
      !make_map<D>(&vmap, empty ? q : v, B, empty ? Lq : Lk,
                   empty ? H : Hkv, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_wgmma_kernel<D, BK, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(qmap, kmap, vmap,
                                           static_cast<bf16*>(o), Lq, Lk, H,
                                           Hkv, scale * kLog2e, causal,
                                           window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bfloat16 only; window <= 0 means no window; the window applies only
// when causal.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int Lq, int Lk, int H, int Hkv,
                                           int D, float scale, int causal,
                                           int window, cudaStream_t stream) {
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
