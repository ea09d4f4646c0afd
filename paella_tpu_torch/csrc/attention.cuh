// The attention core shared by K5 (attention.cu) and K6 (attn_block.cu):
// one block of 4 warps computes 64 query rows of one head,
//
//   s = (q . k) * scale              f32, scale = D^-1/2 of the true head dim
//   s = -1e9 where the key is masked
//   p = exp(s - max_j s) / sum_j exp(s - max_j s)     f32
//   o = sum_j round_T(p) * v_j       f32 accumulation, rounded to T at the end
//
// which are the rounding points of paella_tpu/kernels/attention.py:32-53 and
// of the attention phase of paella_tpu/kernels/attn_block.py:93-127.
//
// K and V stream through shared memory in tiles of 64 keys, so any sequence
// length fits; keys past the end score -inf (weight exactly 0) and read as
// zero rows. Two passes over the key tiles: the first finds each row's max
// and the sum of exp(s - max); the second recomputes the scores with the same
// instructions, normalises p in f32, rounds it to T (the point where the TPU
// kernel rounds it) and accumulates p @ V. An online softmax would round the
// unnormalised p instead, a different point. No atomics: every sum has a
// fixed order.
//
// Each warp owns 16 query rows. bf16 tiles run on mma.sync m16n8k16 with f32
// accumulation: QK^T in k-steps of 16 over D (D = 80 is 5 steps, no padding)
// against 8 key tiles of 8, PV in 10 n-tiles of 8 over D = 80. f32 tiles run
// as FMA in the same fragment layout, so an f32 call is full f32.
#pragma once

#include <math.h>

#include "common.cuh"

namespace paella {

constexpr int kAttnRows = 64;  // query rows per block (16 per warp)
constexpr int kAttnKeys = 64;  // keys per streamed tile
constexpr int kAttnMaxD = 128;
constexpr int kKeyTiles = kAttnKeys / 8;
constexpr float kMaskedScore = -1e9f;  // nn/attention.py's mask fill

// c[nt] (16x8 tiles, mma C layout: lane (g, t) holds rows g and g+8,
// columns 2t and 2t+1) += A[16][kdepth] * B[nt*8 .. nt*8+8][kdepth]^T for
// nt < count <= NT, both K-contiguous in shared memory. The A fragment is
// loaded once per k-step and the NT independent products follow it.
template <typename T, int NT>
__device__ __forceinline__ void warp_tiles(const T* A, int lda, const T* B, int ldb, int kdepth,
                                           float c[NT][4], int count) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (is_bf16<T>()) {
    for (int kk = 0; kk < kdepth; kk += 16) {
      const T* pa = A + g * lda + kk + 2 * t;
      const uint32_t a0 = ld_b32(pa), a1 = ld_b32(pa + 8 * lda), a2 = ld_b32(pa + 8),
                     a3 = ld_b32(pa + 8 * lda + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= count) break;
        const T* pb = B + (nt * 8 + g) * ldb + kk + 2 * t;
        const uint32_t b0 = ld_b32(pb), b1 = ld_b32(pb + 8);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[nt][0]), "+f"(c[nt][1]), "+f"(c[nt][2]), "+f"(c[nt][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  } else {
    for (int k = 0; k < kdepth; ++k) {
      const float a_lo = A[g * lda + k], a_hi = A[(g + 8) * lda + k];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= count) break;
        const float b_0 = B[(nt * 8 + 2 * t) * ldb + k], b_1 = B[(nt * 8 + 2 * t + 1) * ldb + k];
        c[nt][0] = fmaf(a_lo, b_0, c[nt][0]);
        c[nt][1] = fmaf(a_lo, b_1, c[nt][1]);
        c[nt][2] = fmaf(a_hi, b_0, c[nt][2]);
        c[nt][3] = fmaf(a_hi, b_1, c[nt][3]);
      }
    }
  }
}

// Rows [0, nrows) x columns [0, D) of a global tile (leading dimension ld)
// into shared memory, smem[r][d] (or smem[d][r] with TRANSPOSE); rows at or
// past nvalid read as zero. 16-byte global loads: D, ld and the base are
// multiples of 16 bytes (the wrappers check).
template <typename T, bool TRANSPOSE>
__device__ __forceinline__ void load_rows(T* smem, int lds, const T* g, int ld, int nvalid, int nrows,
                                          int D) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = D / V;
  for (int e = threadIdx.x; e < nrows * vpr; e += blockDim.x) {
    const int r = e / vpr, d = (e % vpr) * V;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) u = *reinterpret_cast<const uint4*>(g + (size_t)r * ld + d);
    const T* pv = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (TRANSPOSE)
        smem[(d + i) * lds + r] = pv[i];
      else
        smem[r * lds + d + i] = pv[i];
    }
  }
}

template <typename T>
__host__ __device__ constexpr int attn_ld_d(int D) { return D + smem_pad<T>(); }
template <typename T>
__host__ __device__ constexpr int attn_ld_keys() { return kAttnKeys + smem_pad<T>(); }

// Dynamic shared memory of one attention block: Q and K tiles [64][D], V^T
// [D][64] and the warps' p rows [64][64].
template <typename T>
__host__ __device__ constexpr size_t attn_smem_bytes(int D) {
  return (size_t)(2 * kAttnRows * attn_ld_d<T>(D) + (D + kAttnRows) * attn_ld_keys<T>()) * sizeof(T);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The warp's scores for keys [s0, s0 + 64) in the C layout (sc[n-tile][i]).
// Key j attends iff mask is null, j < mask_from, or mask[j - mask_from].
template <typename T>
__device__ __forceinline__ void tile_scores(const T* Qw, const T* Ks, int ldd, int D, float scale,
                                            int s0, int S, const uint8_t* mask, int mask_from,
                                            float sc[kKeyTiles][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
  warp_tiles<T, kKeyTiles>(Qw, ldd, Ks, ldd, D, sc, kKeyTiles);
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = s0 + nt * 8 + 2 * t + (i & 1);
      float s = sc[nt][i] * scale;
      if (j >= S)
        s = -INFINITY;
      else if (mask != nullptr && j >= mask_from && !mask[j - mask_from])
        s = kMaskedScore;
      sc[nt][i] = s;
    }
  }
}

// One block (kThreads) computes out rows [0, n_rows) (n_rows <= 64) of one
// head: q, k, v and out point at the head's first element of their first
// row; ld* are row strides in elements. smem holds attn_smem_bytes<T>(D).
template <typename T>
__device__ void attention_tile(const T* __restrict__ q, int ldq, int n_rows, const T* __restrict__ k,
                               int ldk, const T* __restrict__ v, int ldv, int S,
                               const uint8_t* __restrict__ mask, int mask_from, T* __restrict__ out,
                               int ldo, int D, float scale, T* smem) {
  const int ldd = attn_ld_d<T>(D), ldp = attn_ld_keys<T>();
  T* Qs = smem;
  T* Ks = Qs + kAttnRows * ldd;
  T* Vt = Ks + kAttnKeys * ldd;
  T* Ps = Vt + D * ldp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* Qw = Qs + warp * 16 * ldd;
  T* Pw = Ps + warp * 16 * ldp;

  load_rows<T, false>(Qs, ldd, q, ldq, n_rows, kAttnRows, D);

  // pass 1: row max and sum of exp(s - max) (rows g and g + 8 of the warp)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float sc[kKeyTiles][4];
  for (int s0 = 0; s0 < S; s0 += kAttnKeys) {
    const int nk = min(kAttnKeys, S - s0);
    load_rows<T, false>(Ks, ldd, k + (size_t)s0 * ldk, ldk, nk, kAttnKeys, D);
    __syncthreads();
    tile_scores<T>(Qw, Ks, ldd, D, scale, s0, S, mask, mask_from, sc);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
      const float m_new = fmaxf(m_run[r], quad_max(mx));  // finite: key s0 is real
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
        sum += expf(sc[nt][2 * r] - m_new) + expf(sc[nt][2 * r + 1] - m_new);
      l_run[r] = l_run[r] * expf(m_run[r] - m_new) + quad_sum(sum);
      m_run[r] = m_new;
    }
  }

  // pass 2: p = exp(s - max) / sum rounded to T, o += p @ V
  const int nd = D / 8;
  float o[kAttnMaxD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kAttnMaxD / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  for (int s0 = 0; s0 < S; s0 += kAttnKeys) {
    const int nk = min(kAttnKeys, S - s0);
    load_rows<T, false>(Ks, ldd, k + (size_t)s0 * ldk, ldk, nk, kAttnKeys, D);
    load_rows<T, true>(Vt, ldp, v + (size_t)s0 * ldv, ldv, nk, kAttnKeys, D);
    __syncthreads();
    tile_scores<T>(Qw, Ks, ldd, D, scale, s0, S, mask, mask_from, sc);
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float p = __fdiv_rn(expf(sc[nt][i] - m_run[r]), l_run[r]);
        Pw[(g + 8 * r) * ldp + nt * 8 + 2 * t + (i & 1)] = from_f<T>(p);
      }
    __syncwarp();
    warp_tiles<T, kAttnMaxD / 8>(Pw, ldp, Vt, ldp, kAttnKeys, o, nd);
    __syncthreads();
  }

#pragma unroll
  for (int dn = 0; dn < kAttnMaxD / 8; ++dn) {
    if (dn >= nd) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = warp * 16 + g + 8 * (i >> 1);
      if (row < n_rows) out[(size_t)row * ldo + dn * 8 + 2 * t + (i & 1)] = from_f<T>(o[dn][i]);
    }
  }
}

// Shared memory above 48 KB needs the kernel's opt-in before the launch.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace paella
