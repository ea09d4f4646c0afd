// Sampling kernels for Hopper (sm_90a), bf16 or f32, sharing the JAX
// package's per-image counter hash (common.cuh::hash_gumbel):
//
// 1. Fused sampling head: CFG feature mix, linear head, temperature and
//    Gumbel argmax in one kernel.
//    Replaces: paella_tpu/kernels/sampling.py::fused_head_categorical (the
//    Pallas TPU kernel; pallas_call at sampling.py:215), once per sampler step:
//
//      f      = f_c * w + f_u * (1 - w)          f32, then rounded to the dtype
//      logit  = f @ W_out^T                       f32 accumulation, (M, K)
//      score  = logit * (1/T) + (-log(-log u))    u from a counter hash
//      token  = argmax_k score                    first index on ties
//
// 2. Gumbel categorical over materialized logits: the same score and argmax
//    with the logits read from device memory.
//    Replaces: paella_tpu/kernels/sampling.py::gumbel_categorical (pallas_call
//    at sampling.py:256), once per step of the sampler's "xla" route.
//
// u is the JAX package's per-image counter hash, bit for bit: the murmur3
// finalizer twice over (image-local row * K + k) and the image's seed pair,
// keeping the high 24 bits, scaled by 2^-24 and offset by 2^-25
// (sampler.py::_hash_uniform, kernels/sampling.py:97-107). The score is
// formed with round-to-nearest intrinsics (no FMA contraction), so the kernels
// and their plain torch versions agree exactly.
//
// Head design: a block takes 32 rows, mixes their features once into shared
// memory, then walks K in tiles of 64 head rows; each tile's 32x64 logits
// live in registers and shared memory only, and each thread keeps a running
// (best score, index) for one row over its 16 columns of every tile. The
// 8192-wide logits never reach device memory (M x K x 4 = 134 MB per step at
// the flagship's 4096 rows).
//
// What bounds the head on an H100: 17 GFLOP of head product per step (M 4096,
// C 256, K 8192) and 33.5 M hash + two-log evaluations (SFU work); the head
// weight (4 MB bf16) is read once per 32-row block, 512 MB from L2 per step.
// This first form is bound by that L2 traffic and by the per-element hash and
// logs, not by the tensor cores; larger row tiles (fewer weight re-reads) and
// a wgmma product are the later steps.
//
// Gumbel design: one warp per row. Each lane walks the row in 16-byte vector
// loads (8 bf16 or 4 f32 logits), strided by the warp's 512 or 128 columns,
// keeping a running (best score, index) with a strict >, so the lane's first
// index wins; a shuffle reduction merges the lanes, lower index on ties.
// What bounds it: the flagship step reads 4096 x 8192 bf16 logits, 67 MB
// (20 us of HBM time at 3.35 TB/s), and evaluates 33.5 M hashes and 67 M
// logf; the per-element hash and logs (about 80 instructions an element) make
// it compute-bound first.
#include "common.cuh"

namespace paella {
namespace {

constexpr int BM = 32, BN = 64, BK = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads) head_kernel(
    const T* __restrict__ fc, const T* __restrict__ fu, float cfg_w, float cfg_1mw,
    const T* __restrict__ w, const uint32_t* __restrict__ seeds, float inv_temp,
    int32_t* __restrict__ out, int M, int C, int K, int hw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = C + smem_pad<T>();
  constexpr int LDB = BK + smem_pad<T>(), LDC = BN + 4;
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + BM * lda;
  float* Cs = reinterpret_cast<float*>(Bs + BN * LDB);
  const int m0 = blockIdx.x * BM;

  // CFG mix of this block's rows, rounded to the dtype as the head's input
  for (int e = threadIdx.x; e < BM * C; e += kThreads) {
    const int r = e / C, c = e % C, m = m0 + r;
    float v = 0.f;
    if (m < M) {
      v = to_f<T>(fc[(size_t)m * C + c]);
      if (fu != nullptr) v = __fadd_rn(__fmul_rn(v, cfg_w), __fmul_rn(to_f<T>(fu[(size_t)m * C + c]), cfg_1mw));
    }
    As[r * lda + c] = from_f<T>(v);
  }

  const int r = threadIdx.x >> 2, cq = (threadIdx.x & 3) * 16;
  const int m = m0 + r;
  const int img = m < M ? m / hw : 0;
  const uint32_t local = (uint32_t)(m - img * hw);
  const uint32_t s0 = seeds[2 * img], s1 = seeds[2 * img + 1];
  float best = __int_as_float(0xff800000);  // -inf
  int best_k = 0;

  TileProduct<T, BM, BN> tile;
  for (int n0 = 0; n0 < K; n0 += BN) {
    tile.zero();
    for (int k0 = 0; k0 < C; k0 += BK) {
      load_tile<T, BN, BK>(Bs, LDB, w, C, n0, K, k0, C);
      __syncthreads();
      tile.step(As + k0, lda, Bs, LDB, BK);
      __syncthreads();
    }
    tile.store(Cs, LDC);
    __syncthreads();
    if (m < M) {
#pragma unroll 4
      for (int j = 0; j < 16; ++j) {
        const int col = cq + j, k = n0 + col;
        const float g = hash_gumbel(local * (uint32_t)K + (uint32_t)k, s0, s1);
        const float s = __fadd_rn(__fmul_rn(Cs[r * LDC + col], inv_temp), g);
        if (s > best) {
          best = s;
          best_k = k;
        }
      }
    }
    __syncthreads();  // Cs is rewritten by the next tile
  }
  // the four threads of a row are neighbouring lanes of one warp
  for (int o = 1; o < 4; o <<= 1)
    argmax_merge(best, best_k, __shfl_xor_sync(0xffffffffu, best, o), __shfl_xor_sync(0xffffffffu, best_k, o));
  if ((threadIdx.x & 3) == 0 && m < M) out[m] = best_k;
}

template <typename T>
int launch_head(const void* fc, const void* fu, float cfg_w, float cfg_1mw, const void* w,
                const uint32_t* seeds, float inv_temp, int32_t* out, int M, int C, int K, int hw,
                cudaStream_t st) {
  const size_t smem = sizeof(T) * (BM * (C + smem_pad<T>()) + BN * (BK + smem_pad<T>())) +
                      sizeof(float) * BM * (BN + 4);
  cudaError_t err = cudaFuncSetAttribute(head_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  head_kernel<T><<<(M + BM - 1) / BM, kThreads, smem, st>>>(
      (const T*)fc, (const T*)fu, cfg_w, cfg_1mw, (const T*)w, seeds, inv_temp, out, M, C, K, hw);
  return (int)cudaGetLastError();
}

constexpr int kGumbelWarps = 8;  // rows per block

template <typename T>
__global__ void __launch_bounds__(kGumbelWarps * 32) gumbel_kernel(
    const T* __restrict__ logits, const uint32_t* __restrict__ seeds, float inv_temp,
    int32_t* __restrict__ out, int M, int K, int hw) {
  constexpr int V = 16 / sizeof(T);  // logits per 16-byte load
  const int m = blockIdx.x * kGumbelWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (m >= M) return;  // the whole warp leaves together
  const int img = m / hw;
  const uint32_t base = (uint32_t)(m - img * hw) * (uint32_t)K;
  const uint32_t s0 = seeds[2 * img], s1 = seeds[2 * img + 1];
  const T* row = logits + (size_t)m * K;
  float best = __int_as_float(0xff800000);  // -inf
  int best_k = 0;
  for (int k0 = lane * V; k0 < K; k0 += 32 * V) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + k0);
    const T* pv = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int k = k0 + i;
      const float g = hash_gumbel(base + (uint32_t)k, s0, s1);
      const float s = __fadd_rn(__fmul_rn(to_f<T>(pv[i]), inv_temp), g);
      if (s > best) {
        best = s;
        best_k = k;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    argmax_merge(best, best_k, __shfl_xor_sync(0xffffffffu, best, o), __shfl_xor_sync(0xffffffffu, best_k, o));
  if (lane == 0) out[m] = best_k;
}

template <typename T>
int launch_gumbel(const void* logits, const uint32_t* seeds, float inv_temp, int32_t* out, int M,
                  int K, int hw, cudaStream_t st) {
  const int blocks = (M + kGumbelWarps - 1) / kGumbelWarps;
  gumbel_kernel<T><<<blocks, kGumbelWarps * 32, 0, st>>>((const T*)logits, seeds, inv_temp, out, M, K, hw);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace paella

// C interface for ctypes. fc, fu (M, C) (fu may be null: no CFG mix);
// w (K, C), the head weight as torch stores it; seeds (M / hw, 2) uint32;
// out (M,) int32. C % 32 == 0, K % 64 == 0. cfg_1mw is 1 - cfg_w, computed
// in f32 by the caller. Returns a cudaError_t.
extern "C" int paella_head_categorical(const void* fc, const void* fu, float cfg_w, float cfg_1mw,
                                       const void* w, const void* seeds, float inv_temp,
                                       void* out, int M, int C, int K, int hw, int is_bf16,
                                       void* stream) {
  using namespace paella;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_head<__nv_bfloat16>(fc, fu, cfg_w, cfg_1mw, w, (const uint32_t*)seeds, inv_temp,
                                      (int32_t*)out, M, C, K, hw, st);
  return launch_head<float>(fc, fu, cfg_w, cfg_1mw, w, (const uint32_t*)seeds, inv_temp,
                            (int32_t*)out, M, C, K, hw, st);
}

// logits (M, K), 16-byte aligned, K a multiple of 8 (bf16) or 4 (f32);
// seeds (M / hw, 2) uint32; out (M,) int32; inv_temp is f32(1) / f32(T),
// computed by the caller. Returns a cudaError_t.
extern "C" int paella_gumbel_categorical(const void* logits, const void* seeds, float inv_temp,
                                         void* out, int M, int K, int hw, int is_bf16, void* stream) {
  using namespace paella;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_gumbel<__nv_bfloat16>(logits, (const uint32_t*)seeds, inv_temp, (int32_t*)out, M, K, hw, st);
  return launch_gumbel<float>(logits, (const uint32_t*)seeds, inv_temp, (int32_t*)out, M, K, hw, st);
}
