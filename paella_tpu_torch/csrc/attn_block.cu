// Fused attention block for Hopper (sm_90a), bf16 or f32 activations and
// weights, f32 accumulation.
//
// Replaces: paella_tpu/kernels/attn_block.py::fused_attn_block_stacked (the
// Pallas TPU kernel; pallas_call at attn_block.py:258), which runs the
// AttnBlock of repetitions >= 1 of every attention level under
// attn_block_kernel=True (40 calls per flagship forward):
//
//   t   = LN(x)                        eps 1e-6, f32 stats, rounded to T
//   q   = t @ Wq^T + bq                over the B*N pixel rows only
//   k|v = [t ; kv] @ Wkv^T + bkv       over all B*S rows, S = N + S_cond
//   a   = attention(q ; k, v)          keys: pixels always, cond rows by mask
//   y   = a @ Wo^T + bo + x            rounded to T
//
// with every product accumulated in f32, biases rounded to T first, and q,
// k, v, a rounded to T where the TPU kernel stores them (attn_block.py:70-143).
// The TPU kernel walks one sequential grid with its scratch in VMEM and pads
// each head to 128 lanes in the weights; here the phases are kernels on one
// stream with the scratch in device memory (mostly in the 50 MB L2), the
// weights are read in their packed (3C, C) in_proj layout with no padding,
// and Q is projected for the pixel rows only:
//   1. ln_rows_kernel   one block per row of [pixels ; cond] per batch item:
//                       LN(x) to xn and rows, cond kv copied into rows
//   2. linear_kernel    64x64 tiles of xn @ Wq^T + bq -> q (B*N, C)
//   3. linear_kernel    rows @ Wkv^T + bkv -> kv (B*S, 2C) = [k | v]
//   4. block_attention  attention.cuh's core, grid (ceil(N/64), H, B)
//   5. linear_kernel    a @ Wo^T + bo + x -> out (B,H,W,C)
//
// What bounds it on an H100: the three products are 2 C^2 (2 B N + 2 B S)
// = 7.7 GFLOP at level 1 (M_q 512, M_kv 656, C 1280) and 2.4 at level 2
// (M_q 128, M_kv 272) against 13.1 MB of bf16 weights: ~590 and ~180 FLOP
// per weight byte, near the ~295 FLOP/byte ridge. The products use the same
// mma.sync tiles as K1 with no copy pipeline, so they are bound by shared
// loads and latency, and level 2's 40-block products leave most SMs idle;
// split-K, wgmma and TMA are the later steps.
#include "attention.cuh"

namespace paella {
namespace {

constexpr int BM = 64, BN = 64, BK = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads) ln_rows_kernel(const T* __restrict__ x,
                                                           const T* __restrict__ kv,
                                                           T* __restrict__ xn, T* __restrict__ rows,
                                                           int N, int S, int C) {
  extern __shared__ float s_row[];  // C floats
  __shared__ float red[32];
  const int row = blockIdx.x, b = row / S, j = row % S;
  T* dst = rows + (size_t)row * C;
  if (j >= N) {  // a conditioning token, as the kv mapper gave it
    const T* src = kv + ((size_t)b * (S - N) + (j - N)) * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) dst[c] = src[c];
    return;
  }
  const T* src = x + ((size_t)b * N + j) * C;
  float lsum = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float v = to_f<T>(src[c]);
    s_row[c] = v;
    lsum += v;
  }
  const float mean = block_sum(lsum, red) / C;
  float lvar = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float d = s_row[c] - mean;
    lvar += d * d;
  }
  const float inv = rsqrtf(block_sum(lvar, red) / C + 1e-6f);
  T* xrow = xn + ((size_t)b * N + j) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const T o = from_f<T>((s_row[c] - mean) * inv);
    dst[c] = o;
    xrow[c] = o;
  }
}

// out (M, N) = round_T(A (M, K) @ W (N, K)^T + bias [+ resid]), in that order.
template <typename T>
__global__ void __launch_bounds__(kThreads) linear_kernel(const T* __restrict__ A,
                                                          const T* __restrict__ W,
                                                          const T* __restrict__ bias,
                                                          const T* __restrict__ resid,
                                                          T* __restrict__ out, int M, int N, int K) {
  constexpr int LDS = BK + smem_pad<T>(), LDC = BN + 4;
  __shared__ __align__(16) T As[BM * LDS];
  __shared__ __align__(16) T Bs[BN * LDS];
  __shared__ float Cs[BM * LDC];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  TileProduct<T, BM, BN> tile;
  tile.zero();
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<T, BM, BK>(As, LDS, A, K, m0, M, k0);
    load_tile<T, BN, BK>(Bs, LDS, W, K, n0, N, k0);
    __syncthreads();
    tile.step(As, LDS, Bs, LDS, BK);
    __syncthreads();
  }
  tile.store(Cs, LDC);
  __syncthreads();
  const int c = threadIdx.x % BN, n = n0 + c;
  const float bn = to_f<T>(bias[n]);
  for (int r = threadIdx.x / BN; r < BM; r += kThreads / BN) {
    const int m = m0 + r;
    if (m >= M) break;
    float v = Cs[r * LDC + c] + bn;
    if (resid != nullptr) v = v + to_f<T>(resid[(size_t)m * N + n]);
    out[(size_t)m * N + n] = from_f<T>(v);
  }
}

// q (B*N, C), kv (B*S, 2C) = [k | v]; keys j < N are pixels (always
// attended), j >= N cond tokens, attended where cmask[b][j - N].
template <typename T>
__global__ void __launch_bounds__(kThreads) block_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kv, const uint8_t* __restrict__ cmask,
    T* __restrict__ att, int N, int S, int C, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q0 = blockIdx.x * kAttnRows, h = blockIdx.y, b = blockIdx.z;
  const T* kb = kv + (size_t)b * S * 2 * C + h * D;
  attention_tile<T>(q + ((size_t)b * N + q0) * C + h * D, C, min(kAttnRows, N - q0), kb, 2 * C,
                    kb + C, 2 * C, S, cmask != nullptr ? cmask + (size_t)b * (S - N) : nullptr, N,
                    att + ((size_t)b * N + q0) * C + h * D, C, D, scale,
                    reinterpret_cast<T*>(smem_raw));
}

template <typename T>
int launch(const void* x, const void* kv, const void* cmask, const void* wqkv, const void* bqkv,
           const void* wo, const void* bo, void* out, void* xn, void* rows, void* qb, void* kvb,
           void* att, int B, int N, int Sc, int C, int H, float scale, cudaStream_t st) {
  const int S = N + Sc, D = C / H, Mq = B * N, Mkv = B * S;
  const T* w = (const T*)wqkv;
  const T* bias = (const T*)bqkv;
  ln_rows_kernel<T><<<Mkv, kThreads, C * sizeof(float), st>>>((const T*)x, (const T*)kv, (T*)xn,
                                                               (T*)rows, N, S, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  linear_kernel<T><<<dim3(C / BN, (Mq + BM - 1) / BM), kThreads, 0, st>>>(
      (const T*)xn, w, bias, nullptr, (T*)qb, Mq, C, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  linear_kernel<T><<<dim3(2 * C / BN, (Mkv + BM - 1) / BM), kThreads, 0, st>>>(
      (const T*)rows, w + (size_t)C * C, bias + C, nullptr, (T*)kvb, Mkv, 2 * C, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t bytes = attn_smem_bytes<T>(D);
  if ((err = allow_smem(block_attention_kernel<T>, bytes)) != cudaSuccess) return (int)err;
  block_attention_kernel<T><<<dim3((N + kAttnRows - 1) / kAttnRows, H, B), kThreads, bytes, st>>>(
      (const T*)qb, (const T*)kvb, (const uint8_t*)cmask, (T*)att, N, S, C, D, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  linear_kernel<T><<<dim3(C / BN, (Mq + BM - 1) / BM), kThreads, 0, st>>>(
      (const T*)att, (const T*)wo, (const T*)bo, (const T*)x, (T*)out, Mq, C, C);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace paella

// C interface for ctypes. x, out (B,H,W,C) with N = H*W; kv (B,Sc,C) the
// block's kv-mapper output; cmask (B,Sc) bytes (1 = attend) or null; wqkv
// (3C,C) packed q|k|v rows and bqkv (3C); wo (C,C), bo (C); scratch xn, qb,
// att (B*N, C), rows (B*(N+Sc), C), kvb (B*(N+Sc), 2C). All in the dtype,
// contiguous and 16-byte aligned; C % 64 == 0, (C / H) % 16 == 0,
// C / H <= 128. scale = (C/H)^-1/2 in f32. Returns a cudaError_t.
extern "C" int paella_attn_block(const void* x, const void* kv, const void* cmask,
                                 const void* wqkv, const void* bqkv, const void* wo,
                                 const void* bo, void* out, void* xn, void* rows, void* qb,
                                 void* kvb, void* att, int B, int N, int Sc, int C, int H,
                                 float scale, int is_bf16, void* stream) {
  using namespace paella;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, kv, cmask, wqkv, bqkv, wo, bo, out, xn, rows, qb, kvb, att, B,
                                 N, Sc, C, H, scale, st);
  return launch<float>(x, kv, cmask, wqkv, bqkv, wo, bo, out, xn, rows, qb, kvb, att, B, N, Sc, C,
                       H, scale, st);
}
