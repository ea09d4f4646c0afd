// Codebook nearest-neighbour search for Hopper (sm_90a), f32: for each token
// z (C values) the index of the code e_k minimizing |z - e_k|^2.
//
// Replaces: paella_tpu/kernels/quantize.py::fused_codebook_lookup (the Pallas
// TPU kernel; pallas_call at quantize.py:82), once per codec encode and once
// per latent interpolation:
//
//   dist_k = |e_k|^2 - 2 z.e_k          |z|^2 is the same for every code
//   idx    = argmin_k dist_k            first index on ties
//
// Rounding: the norm and the dot are sequential round-to-nearest f32 sums over
// c = 0..C-1 (__fmul_rn / __fadd_rn, no FMA contraction), in the order the
// plain torch version (kernels/quantize.py::codebook_lookup_plain) uses, so
// the two agree bit for bit.
//
// Design: the (tokens x K) distance matrix never reaches device memory. A
// block takes 128 tokens (one a thread, held in registers) and one split of
// 512 codes, staged with their norms in shared memory (8 KB + 2 KB at C = 4);
// each thread keeps a running (min, argmin) with a strict <, so its first
// index wins. The splits of K run in separate blocks so that the flagship's
// 4096 tokens fill the card (32 x 16 = 512 blocks, where one token a thread
// over all of K would give 32 blocks for 132 SMs); they merge with a 64-bit
// atomicMin on (order-preserving bits of the distance, index), which keeps
// the least distance and, among equal ones, the lowest index. Codes past K
// are never read (the Pallas kernel pads them with +inf norms instead).
//
// What bounds it on an H100: 4096 x 8192 x ~10 f32 operations, 0.34 GFLOP, a
// few microseconds of SIMT work; the bytes (64 KB of tokens, 128 KB of
// codebook) are nothing. Launch latency and the three launches (clear,
// search, pack) dominate at the flagship size. Latents wider than 8 (the
// codec's is 4) run a variant compiled apart that reads the token and the
// codes from device memory instead of registers and shared memory.
#include "common.cuh"

namespace paella {
namespace {

constexpr int kTokens = 128;  // tokens (threads) per block
constexpr int kCodes = 512;   // codes per block: one split of K
constexpr int kMaxC = 8;      // widest latent held in registers and shared memory

// The order of unsigned keys is the order of (distance, index).
__device__ __forceinline__ unsigned long long dist_key(float d, int idx) {
  uint32_t u = __float_as_uint(__fadd_rn(d, 0.f));  // -0 -> +0: equal distances, equal bits
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (uint32_t)idx;
}

// kWide: a latent wider than kMaxC; the token and the codes are read from
// device memory (cached) and each code's norm is formed by every thread, in
// the same order, so the results are the narrow path's.
template <bool kWide>
__global__ void __launch_bounds__(kTokens) lookup_kernel(const float* __restrict__ z,
                                                         const float* __restrict__ cb,
                                                         unsigned long long* __restrict__ best,
                                                         int M, int K, int C) {
  __shared__ float cs[kWide ? 1 : kCodes * kMaxC];
  __shared__ float cn[kWide ? 1 : kCodes];
  const int k0 = blockIdx.y * kCodes;
  const int nk = min(kCodes, K - k0);
  if constexpr (!kWide) {
    for (int e = threadIdx.x; e < nk * C; e += kTokens) cs[e] = cb[(size_t)k0 * C + e];
    __syncthreads();
    for (int j = threadIdx.x; j < nk; j += kTokens) {
      const float* e = cs + j * C;
      float n = __fmul_rn(e[0], e[0]);
      for (int c = 1; c < C; ++c) n = __fadd_rn(n, __fmul_rn(e[c], e[c]));
      cn[j] = n;
    }
    __syncthreads();
  }

  const int m = blockIdx.x * kTokens + threadIdx.x;
  if (m >= M) return;
  float bd = __int_as_float(0x7f800000);  // +inf
  int bi = 0;
  if constexpr (!kWide) {
    float zr[kMaxC];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) zr[c] = c < C ? z[(size_t)m * C + c] : 0.f;
    for (int j = 0; j < nk; ++j) {
      const float* e = cs + j * C;
      float d = __fmul_rn(zr[0], e[0]);
#pragma unroll
      for (int c = 1; c < kMaxC; ++c)
        if (c < C) d = __fadd_rn(d, __fmul_rn(zr[c], e[c]));
      const float dist = __fsub_rn(cn[j], __fmul_rn(2.f, d));
      if (dist < bd) {
        bd = dist;
        bi = j;
      }
    }
  } else {
    const float* zm = z + (size_t)m * C;
    for (int j = 0; j < nk; ++j) {
      const float* e = cb + (size_t)(k0 + j) * C;
      float n = __fmul_rn(__ldg(e), __ldg(e));
      float d = __fmul_rn(__ldg(zm), __ldg(e));
      for (int c = 1; c < C; ++c) {
        const float ec = __ldg(e + c);
        n = __fadd_rn(n, __fmul_rn(ec, ec));
        d = __fadd_rn(d, __fmul_rn(__ldg(zm + c), ec));
      }
      const float dist = __fsub_rn(n, __fmul_rn(2.f, d));
      if (dist < bd) {
        bd = dist;
        bi = j;
      }
    }
  }
  atomicMin(best + m, dist_key(bd, k0 + bi));
}

__global__ void pack_kernel(const unsigned long long* __restrict__ best, int32_t* __restrict__ out, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < M) out[m] = (int32_t)(uint32_t)(best[m] & 0xffffffffull);
}

}  // namespace
}  // namespace paella

// C interface for ctypes. z (M, C) f32, codebook (K, C) f32, both contiguous;
// scratch (M,) 64-bit words; out (M,) int32. Any C >= 1 (past kMaxC the
// wide variant, compiled apart). Returns a cudaError_t.
extern "C" int paella_codebook_lookup(const void* z, const void* codebook, void* scratch, void* out,
                                      int M, int K, int C, void* stream) {
  using namespace paella;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 1 || M < 1 || K < 1) return (int)cudaErrorInvalidValue;
  unsigned long long* best = static_cast<unsigned long long*>(scratch);
  cudaError_t err = cudaMemsetAsync(best, 0xff, sizeof(unsigned long long) * (size_t)M, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kTokens - 1) / kTokens, (K + kCodes - 1) / kCodes);
  if (C <= kMaxC)
    lookup_kernel<false><<<grid, kTokens, 0, st>>>((const float*)z, (const float*)codebook, best, M, K, C);
  else
    lookup_kernel<true><<<grid, kTokens, 0, st>>>((const float*)z, (const float*)codebook, best, M, K, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pack_kernel<<<(M + 255) / 256, 256, 0, st>>>(best, (int32_t*)out, M);
  return (int)cudaGetLastError();
}
