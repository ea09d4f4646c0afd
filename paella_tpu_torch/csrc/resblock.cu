// Fused ResBlock(+FiLM) for Hopper (sm_90a), bf16 or f32 activations and
// weights, f32 accumulation.
//
// Replaces: paella_tpu/kernels/resblock.py::fused_resblock_stacked (the
// Pallas TPU kernel; pallas_call at resblock.py:497), which runs every
// ResBlock+TimestepBlock pair of the denoiser, 56 per forward:
//
//   xn = LN(depthwise3x3(x [, skip]) + dw_b)          eps 1e-6, f32 stats
//   h  = gelu(xn @ W1^T + b1)                          exact erf
//   s  = gamma * (||h||_HW / mean_C ||h||_HW + 1e-6) + 1   GRN, per (batch, 4C)
//   y  = (h * s) @ W2^T + beta@W2 + b2 + x             beta folded into beta@W2
//   y  = y * (1 + film_a) + film_b                     optional FiLM
//
// The Pallas kernel walks one sequential grid and keeps xn and h in VMEM
// between its phases. Hopper blocks run in no order, so the GRN reduction
// over all of HW between the two products becomes a phase boundary:
//   1. dw_ln_kernel  one block per token: 3x3 depthwise (the skip variant
//                    reads concat channels 2c, 2c+1 straight from x and skip),
//                    bias and LayerNorm -> xn (M, C).
//   2. fc1_kernel    64x64 tiles of xn @ W1^T with a bias + GELU epilogue that
//                    writes h (M, 4C) and, for each batch item the M-tile
//                    touches, each column's f32 sum of squares over the
//                    tile's rows into a partials buffer (no atomics).
//   3. grn_scale_kernel  one block per batch item: sums its partials in tile
//                    order (so the GRN scale is the same on every run, as the
//                    Pallas kernel's sequential grid makes it) -> scale (B, 4C).
//   4. fc2_kernel    64x64 tiles of (h * scale) @ W2^T, the scale applied as
//                    the A tile is loaded, with a beta@W2 + b2 + residual +
//                    FiLM epilogue. Its grid is only (C/64) x (M/64) blocks
//                    (40 at M 128, C 1280), so the wrapper splits K = 4C
//                    until there are about two blocks per SM; the splits
//                    write f32 partials that fc2_reduce_kernel sums in a
//                    fixed order before the same epilogue.
// Rounding follows the Pallas kernel: xn and h are stored in the activation
// dtype, h is rescaled in f32 and rounded again, and every product
// accumulates in f32.
//
// What bounds it on an H100: the two products are over 99% of a block's
// FLOPs (16 M C^2: 13.4 GFLOP at M 2048 x C 640 and at 512 x 1280, 3.4 at
// 128 x 1280) and read 3.3 MB (C 640) or 13.1 MB (C 1280) of bf16 weights,
// about 4000, 1000 and 260 FLOP per weight byte: compute-bound except at
// M 128, which sits near the card's ~295 FLOP/byte ridge. This first form
// runs the products on mma.sync (bf16) without a copy pipeline, so it is
// bound by shared-memory loads and latency, well below the tensor cores'
// rate; xn and h make one round trip through L2/HBM (M x 5C elements), which
// the 50 MB L2 mostly absorbs. wgmma, TMA and a persistent schedule are the
// later steps.
#include "common.cuh"

namespace paella {
namespace {

constexpr int BM = 64, BN = 64, BK = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads) dw_ln_kernel(const T* __restrict__ x,
                                                         const T* __restrict__ skip,
                                                         const T* __restrict__ dw_w,
                                                         const T* __restrict__ dw_b,
                                                         T* __restrict__ xn, int H, int W, int C) {
  extern __shared__ float s_acc[];  // C floats
  __shared__ float red[32];
  const int m = blockIdx.x;
  const int hw = H * W;
  const int b = m / hw, p = m % hw, y = p / W, xq = p % W;
  const int cpg = skip != nullptr ? 2 : 1;
  float lsum = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < cpg; ++j) {
      // the grouped conv over concat [x, skip] (groups = C) reads channels
      // (2c, 2c + 1) for group c
      const T* src = x;
      int ch = c;
      if (skip != nullptr) {
        const int q = 2 * c + j;
        src = q < C ? x : skip;
        ch = q < C ? q : q - C;
      }
      for (int ky = 0; ky < 3; ++ky) {
        const int yy = y + ky - 1;
        if (yy < 0 || yy >= H) continue;
        for (int kx = 0; kx < 3; ++kx) {
          const int xx = xq + kx - 1;
          if (xx < 0 || xx >= W) continue;
          acc += to_f<T>(src[((size_t)(b * H + yy) * W + xx) * C + ch]) *
                 to_f<T>(dw_w[((ky * 3 + kx) * cpg + j) * C + c]);
        }
      }
    }
    acc += to_f<T>(dw_b[c]);
    s_acc[c] = acc;
    lsum += acc;
  }
  const float mean = block_sum(lsum, red) / C;
  float lvar = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float d = s_acc[c] - mean;
    lvar += d * d;
  }
  const float var = block_sum(lvar, red) / C;
  const float inv = rsqrtf(var + 1e-6f);
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    xn[(size_t)m * C + c] = from_f<T>((s_acc[c] - mean) * inv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fc1_kernel(const T* __restrict__ xn,
                                                       const T* __restrict__ w1,
                                                       const T* __restrict__ b1,
                                                       T* __restrict__ h, float* __restrict__ gx_part,
                                                       int M, int K, int N, int hw, int slots) {
  constexpr int LDS = BK + smem_pad<T>(), LDC = BN + 4;
  __shared__ __align__(16) T As[BM * LDS];
  __shared__ __align__(16) T Bs[BN * LDS];
  __shared__ float Cs[BM * LDC];
  __shared__ float half_sq[kThreads];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  TileProduct<T, BM, BN> tile;
  tile.zero();
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<T, BM, BK>(As, LDS, xn, K, m0, M, k0);
    load_tile<T, BN, BK>(Bs, LDS, w1, K, n0, N, k0);
    __syncthreads();
    tile.step(As, LDS, Bs, LDS, BK);
    __syncthreads();
  }
  tile.store(Cs, LDC);
  __syncthreads();
  // epilogue: one column per thread, rows strided by kThreads / BN; the f32
  // GELU output stays in Cs for the GRN statistics
  const int c = threadIdx.x % BN, n = n0 + c;
  const float bias = to_f<T>(b1[n]);
  for (int r = threadIdx.x / BN; r < BM; r += kThreads / BN) {
    const int m = m0 + r;
    if (m >= M) break;
    float v = Cs[r * LDC + c] + bias;
    v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
    h[(size_t)m * N + n] = from_f<T>(v);
    Cs[r * LDC + c] = v;
  }
  __syncthreads();
  // GRN statistics from the f32 values, before rounding, one partial per
  // batch item the tile touches, at slot (tile, batch item - the tile's first
  // batch item). A tile inside one batch item (every tile at the flagship's
  // shapes): two threads per column sum rows [0, 32) and [32, 64), added in
  // that order. Otherwise one thread per column walks the rows in order.
  const int first_b = m0 / hw, rows = min(BM, M - m0);
  if ((m0 + rows - 1) / hw == first_b) {
    const int half = threadIdx.x / BN;
    float sq = 0.f;
#pragma unroll 8
    for (int r = half * (BM / 2); r < (half + 1) * (BM / 2); ++r) {
      const float v = r < rows ? Cs[r * LDC + c] : 0.f;
      sq += v * v;
    }
    half_sq[threadIdx.x] = sq;
    __syncthreads();
    if (threadIdx.x < BN) gx_part[(size_t)blockIdx.y * slots * N + n] = half_sq[c] + half_sq[BN + c];
  } else if (threadIdx.x < BN) {
    float* part = gx_part + (size_t)blockIdx.y * slots * N + n;
    int cur_b = first_b;
    float sq = 0.f;
    for (int r = 0; r < BM && m0 + r < M; ++r) {
      const int bi = (m0 + r) / hw;
      if (bi != cur_b) {
        part[(size_t)(cur_b - first_b) * N] = sq;
        cur_b = bi;
        sq = 0.f;
      }
      const float v = Cs[r * LDC + c];
      sq += v * v;
    }
    part[(size_t)(cur_b - first_b) * N] = sq;
  }
}

// One block of 1024 threads per batch item b: each column's gx = sum of its
// partials, tile by tile in order, kept in shared memory (N floats), then
// the GRN scale gamma * gx / (mean_N gx + 1e-6) + 1.
__global__ void __launch_bounds__(1024) grn_scale_kernel(const float* __restrict__ gx_part,
                                                         const float* __restrict__ gamma,
                                                         float* __restrict__ scale, int N, int hw,
                                                         int slots) {
  extern __shared__ float s_norm[];
  __shared__ float red[32];
  const int b = blockIdx.x;
  const int t0 = b * hw / BM, t1 = ((b + 1) * hw - 1) / BM;
  float s = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float g = 0.f;
#pragma unroll 4
    for (int t = t0; t <= t1; ++t) g += gx_part[((size_t)t * slots + b - t * BM / hw) * N + n];
    s_norm[n] = sqrtf(g);
    s += s_norm[n];
  }
  const float denom = block_sum(s, red) / N + 1e-6f;
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    scale[(size_t)b * N + n] = gamma[n] * (s_norm[n] / denom) + 1.f;
}

// y = acc + beta@W2 + b2 + x, then FiLM, in the Pallas kernel's order
template <typename T>
__device__ __forceinline__ T fc2_finish(float acc, int m, int n, int N, int hw,
                                        const float* __restrict__ bw2, const T* __restrict__ b2,
                                        const T* __restrict__ x, const T* __restrict__ film) {
  float v = acc + bw2[n];
  v = v + to_f<T>(b2[n]);
  v = v + to_f<T>(x[(size_t)m * N + n]);
  if (film != nullptr) {
    const T* f = film + (size_t)(m / hw) * 2 * N;
    v = v * (1.f + to_f<T>(f[n])) + to_f<T>(f[N + n]);
  }
  return from_f<T>(v);
}

// fc2 over the K range of split blockIdx.z (k_split columns). With one split
// the epilogue runs here; with several, each writes its f32 partial tile to
// part[z] and fc2_reduce_kernel sums the splits in a fixed order (no
// atomics, so the result does not depend on block timing).
template <typename T>
__global__ void __launch_bounds__(kThreads) fc2_kernel(
    const T* __restrict__ h, const float* __restrict__ scale, const T* __restrict__ w2,
    const float* __restrict__ bw2, const T* __restrict__ b2, const T* __restrict__ x,
    const T* __restrict__ film, T* __restrict__ out, float* __restrict__ part, int M, int K,
    int N, int hw, int k_split) {
  constexpr int LDS = BK + smem_pad<T>(), LDC = BN + 4;
  __shared__ __align__(16) T As[BM * LDS];
  __shared__ __align__(16) T Bs[BN * LDS];
  __shared__ float Cs[BM * LDC];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_split;
  TileProduct<T, BM, BN> tile;
  tile.zero();
  for (int k0 = kb; k0 < kb + k_split; k0 += BK) {
    load_tile<T, BM, BK>(As, LDS, h, K, m0, M, k0, scale, K, hw);  // GRN scale as A loads
    load_tile<T, BN, BK>(Bs, LDS, w2, K, n0, N, k0);
    __syncthreads();
    tile.step(As, LDS, Bs, LDS, BK);
    __syncthreads();
  }
  tile.store(Cs, LDC);
  __syncthreads();
  const int c = threadIdx.x % BN, n = n0 + c;
  for (int r = threadIdx.x / BN; r < BM; r += kThreads / BN) {
    const int m = m0 + r;
    if (m >= M) break;
    if (part != nullptr) {
      part[((size_t)blockIdx.z * M + m) * N + n] = Cs[r * LDC + c];
    } else {
      out[(size_t)m * N + n] = fc2_finish<T>(Cs[r * LDC + c], m, n, N, hw, bw2, b2, x, film);
    }
  }
}

template <typename T>
__global__ void fc2_reduce_kernel(const float* __restrict__ part, int splits,
                                  const float* __restrict__ bw2, const T* __restrict__ b2,
                                  const T* __restrict__ x, const T* __restrict__ film,
                                  T* __restrict__ out, int M, int N, int hw) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  float acc = part[i];
  for (int z = 1; z < splits; ++z) acc += part[(size_t)z * M * N + i];
  out[i] = fc2_finish<T>(acc, (int)(i / N), (int)(i % N), N, hw, bw2, b2, x, film);
}

template <typename T>
int launch(const void* x, const void* skip, const void* dw_w, const void* dw_b, const void* w1,
           const void* b1, const float* gamma, const void* w2, const float* bw2, const void* b2,
           const void* film, void* out, void* xn, void* h, float* gx_part, int slots, float* scale,
           float* part, int splits, int B, int H, int W, int C, cudaStream_t st) {
  const int hw = H * W, M = B * hw, N1 = 4 * C;
  cudaError_t err;
  dw_ln_kernel<T><<<M, kThreads, C * sizeof(float), st>>>(
      (const T*)x, (const T*)skip, (const T*)dw_w, (const T*)dw_b, (T*)xn, H, W, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fc1_kernel<T><<<dim3(N1 / BN, (M + BM - 1) / BM), kThreads, 0, st>>>(
      (const T*)xn, (const T*)w1, (const T*)b1, (T*)h, gx_part, M, C, N1, hw, slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  grn_scale_kernel<<<B, 1024, N1 * sizeof(float), st>>>(gx_part, gamma, scale, N1, hw, slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fc2_kernel<T><<<dim3(C / BN, (M + BM - 1) / BM, splits), kThreads, 0, st>>>(
      (const T*)h, scale, (const T*)w2, bw2, (const T*)b2, (const T*)x, (const T*)film, (T*)out,
      splits > 1 ? part : nullptr, M, N1, C, hw, N1 / splits);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return (int)err;
  const int n_out = M * C;
  fc2_reduce_kernel<T><<<(n_out + 255) / 256, 256, 0, st>>>(
      part, splits, bw2, (const T*)b2, (const T*)x, (const T*)film, (T*)out, M, C, hw);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace paella

// C interface for ctypes. Shapes: x, skip, out (B,H,W,C); dw_w (3,3,cpg,C);
// dw_b, b2 (C); w1 (4C,C); b1 (4C); gamma (4C) f32; w2 (C,4C); bw2 (C) f32;
// film (B,2C) [a | b]; scratch xn (B*H*W, C), h (B*H*W, 4C), gx_part
// (ceil(B*H*W / 64) * slots, 4C) f32 with slots the most batch items one
// 64-row tile touches, scale (B, 4C) f32, and with splits > 1 part (splits,
// B*H*W, C) f32, the fc2 split-K partials (4C / splits a multiple of 32).
// skip and film may be null. C % 64 == 0. Returns a cudaError_t.
extern "C" int paella_resblock(const void* x, const void* skip, const void* dw_w,
                               const void* dw_b, const void* w1, const void* b1,
                               const void* gamma, const void* w2, const void* bw2,
                               const void* b2, const void* film, void* out, void* xn, void* h,
                               void* gx_part, void* scale, void* part, int slots, int splits,
                               int B, int H, int W, int C, int is_bf16, void* stream) {
  using namespace paella;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, skip, dw_w, dw_b, w1, b1, (const float*)gamma, w2,
                                 (const float*)bw2, b2, film, out, xn, h, (float*)gx_part, slots,
                                 (float*)scale, (float*)part, splits, B, H, W, C, st);
  return launch<float>(x, skip, dw_w, dw_b, w1, b1, (const float*)gamma, w2, (const float*)bw2,
                       b2, film, out, xn, h, (float*)gx_part, slots, (float*)scale, (float*)part,
                       splits, B, H, W, C, st);
}
