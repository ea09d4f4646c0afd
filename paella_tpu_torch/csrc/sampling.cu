// Fused sampling head for Hopper (sm_90a): CFG feature mix, linear head,
// temperature and Gumbel argmax in one kernel. bf16 or f32 features and head.
//
// Replaces: paella_tpu/kernels/sampling.py::fused_head_categorical (the
// Pallas TPU kernel; pallas_call at sampling.py:215), once per sampler step:
//
//   f      = f_c * w + f_u * (1 - w)          f32, then rounded to the dtype
//   logit  = f @ W_out^T                       f32 accumulation, (M, K)
//   score  = logit * (1/T) + (-log(-log u))    u from a counter hash
//   token  = argmax_k score                    first index on ties
//
// u is the JAX package's per-image counter hash, bit for bit: the murmur3
// finalizer twice over (image-local row * K + k) and the image's seed pair,
// keeping the high 24 bits, scaled by 2^-24 and offset by 2^-25
// (sampler.py::_hash_uniform, kernels/sampling.py:97-107). uint32 arithmetic
// wraps in CUDA as on the TPU.
//
// Design: a block takes 32 rows, mixes their features once into shared
// memory, then walks K in tiles of 64 head rows; each tile's 32x64 logits
// live in registers and shared memory only, and each thread keeps a running
// (best score, index) for one row over its 16 columns of every tile. The
// 8192-wide logits never reach device memory (M x K x 4 = 134 MB per step at
// the flagship's 4096 rows).
//
// What bounds it on an H100: 17 GFLOP of head product per step (M 4096,
// C 256, K 8192) and 33.5 M hash + two-log evaluations (SFU work); the head
// weight (4 MB bf16) is read once per 32-row block, 512 MB from L2 per step.
// This first form is bound by that L2 traffic and by the per-element hash and
// logs, not by the tensor cores; larger row tiles (fewer weight re-reads) and
// a wgmma product are the later steps.
#include "common.cuh"

namespace paella {
namespace {

constexpr int BM = 32, BN = 64, BK = 32;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

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
      load_tile<T, BN, BK>(Bs, LDB, w, C, n0, K, k0);
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
        const uint32_t bits = mix32(mix32((local * (uint32_t)K + (uint32_t)k) ^ s0) + s1);
        const float u = (float)(bits >> 8) * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
        const float g = -logf(-logf(u));
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
  for (int o = 1; o < 4; o <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int ok = __shfl_xor_sync(0xffffffffu, best_k, o);
    if (ob > best || (ob == best && ok < best_k)) {
      best = ob;
      best_k = ok;
    }
  }
  if ((threadIdx.x & 3) == 0 && m < M) out[m] = best_k;
}

template <typename T>
int launch(const void* fc, const void* fu, float cfg_w, float cfg_1mw, const void* w,
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
    return launch<__nv_bfloat16>(fc, fu, cfg_w, cfg_1mw, w, (const uint32_t*)seeds, inv_temp,
                                 (int32_t*)out, M, C, K, hw, st);
  return launch<float>(fc, fu, cfg_w, cfg_1mw, w, (const uint32_t*)seeds, inv_temp,
                       (int32_t*)out, M, C, K, hw, st);
}
