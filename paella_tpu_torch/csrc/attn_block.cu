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
//   y   = a @ Wo^T + bo + x            rounded to T once
//
// with every product accumulated in f32, biases rounded to T first, and q,
// k, v, a rounded to T where the TPU kernel stores them (attn_block.py:70-143).
// The TPU kernel walks one sequential grid with its scratch in VMEM and pads
// each head to 128 lanes in the weights; here the phases are kernels on one
// stream with the scratch in device memory (mostly in the 50 MB L2), and the
// weights are read in their packed (3C, C) in_proj layout with no padding.
//
// bf16 (the flagship's path), 4 launches (5 or 6 where a product splits K):
//   1. ln_rows_kernel       one block per row of [pixels ; cond] per batch
//                           item: LN(x) of a pixel row; a cond row (the kv
//                           mapper's output) copied as it is
//   2. linear_wgmma_kernel  q|k|v = rows @ Wqkv^T + bqkv, one (B*S, 3C)
//                           product on gemm_sm90.cuh's wgmma tile (128 x BN
//                           x 64 steps, 6-stage cp.async ring), bias in the
//                           epilogue, rounded and stored coalesced; the cond
//                           rows' q is computed and never read
//   3. block_attention_kernel  K5's kernel (attention.cuh, under K6's name
//                           so that a profile tells them apart) reading q, k
//                           and v out of the product (rows 3C apart), the
//                           pixel rows as an always-attended key prefix and
//                           the (B, S_cond) cond mask
//   4. linear_wgmma_kernel  the o-projection + bias + residual x, one rounding
//   (+) linear_reduce_kernel  where a product's grid leaves most SMs idle its
//                           K is split; the f32 partials are summed in split
//                           order, then bias (and x) added and rounded
// The tile widths and split counts (kernels/attn_block.py::attn_block_plan,
// K1's rule in kernels/resblock.py::gemm_tiles) come from one CFG pair's N
// and S, never from B, and every sum has a fixed
// order, so runs are bitwise equal and an image's output does not depend on
// its batchmates. f32 runs the same phases with the simple products
// (linear_kernel: common.cuh's 64x64x32 FMA tiles).
//
// What bounds it on an H100: the products a call needs are 2 C^2 (2 B N +
// 2 B S) = 7.7 GFLOP at level 1 (B 2, N 256, S 328, C 1280) and 2.6 at level
// 2 (N 64, S 136) against 13.1 MB of bf16 weights, ~580 and ~200 FLOP per
// weight byte, near the ~295 FLOP/byte ridge: 8.6 and 4.2 us at the card's
// peaks. At these row counts the products fill the card poorly (level 2's o
// has one 128-row tile of rows), so the design is about tiles in flight, and
// its time splits about evenly between the products and the latency-bound
// attention core. Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 9): 60 / 37 us a call at levels 1 / 2 (LN 5 / 4, q|k|v 22 / 12,
// attention 24 / 13, o 9 / 8), against 311 / 226 us for the former design
// (mma.sync products without a copy ring around an attention core of one
// warp per 16 rows). Tried: q over the pixel rows and k|v over all rows as
// two problems in one grid, which skips the cond rows' q (+0.47 GFLOP) but
// measured the same (22.7 vs 22.3 us at level 1, 11.5 vs 11.7 at level 2);
// K splits, which cost more than they fill at level 1 (36 vs 22 us for
// q|k|v) and win for level 2's o (7.6 us for 4 splits of 64-wide tiles
// against 12.1 unsplit at 128).
#include "attention.cuh"

namespace paella {
namespace {

using bf16 = __nv_bfloat16;
constexpr int BM = 64, BN = 64, BK = 32;  // linear_kernel's f32 tiles

__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }

// LN of pixel row j of item b into rows[b S + j] (pitch C, or with kPadded
// pitch ldr, its columns past C zero; compiled apart, as resblock.cu's
// dw_ln_kernel is); cond row j >= N is the kv mapper's row, copied as it is.
template <typename T, bool kPadded>
__global__ void __launch_bounds__(kThreads) ln_rows_kernel(const T* __restrict__ x, const T* __restrict__ kv,
                                                           T* __restrict__ rows, int N, int S, int C, int ldr) {
  extern __shared__ float s_row[];  // C floats
  __shared__ float red[32];
  const int row = blockIdx.x, b = row / S, j = row % S;
  T* dst = rows + (size_t)row * (kPadded ? ldr : C);
  if (j >= N) {  // a conditioning token, as the kv mapper gave it
    const T* src = kv + ((size_t)b * (S - N) + (j - N)) * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) dst[c] = src[c];
    if constexpr (kPadded)
      for (int c = C + threadIdx.x; c < ldr; c += blockDim.x) dst[c] = from_f<T>(0.f);
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
  for (int c = threadIdx.x; c < C; c += blockDim.x) dst[c] = from_f<T>((s_row[c] - mean) * inv);
  if constexpr (kPadded)
    for (int c = C + threadIdx.x; c < ldr; c += blockDim.x) dst[c] = from_f<T>(0.f);
}

// f32: out (M, N) = A (M, K) @ W (N, K)^T + bias [+ resid], in that order,
// on 64x64 FMA tiles; ragged tiles in M, N and K (K % 8 == 0) read zeros.
__global__ void __launch_bounds__(kThreads) linear_kernel(const float* __restrict__ A, const float* __restrict__ W,
                                                          const float* __restrict__ bias,
                                                          const float* __restrict__ resid, float* __restrict__ out,
                                                          int M, int N, int K) {
  constexpr int LDS = BK + smem_pad<float>(), LDC = BN + 4;
  __shared__ __align__(16) float As[BM * LDS];
  __shared__ __align__(16) float Bs[BN * LDS];
  __shared__ float Cs[BM * LDC];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  TileProduct<float, BM, BN> tile;
  tile.zero();
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<float, BM, BK>(As, LDS, A, K, m0, M, k0, K);
    load_tile<float, BN, BK>(Bs, LDS, W, K, n0, N, k0, K);
    __syncthreads();
    tile.step(As, LDS, Bs, LDS, BK);
    __syncthreads();
  }
  tile.store(Cs, LDC);
  __syncthreads();
  const int c = threadIdx.x % BN, n = n0 + c;
  if (n >= N) return;
  const float bn = bias[n];
  for (int r = threadIdx.x / BN; r < BM; r += kThreads / BN) {
    const int m = m0 + r;
    if (m >= M) break;
    float v = Cs[r * LDC + c] + bn;
    if (resid != nullptr) v = v + resid[(size_t)m * N + n];
    out[(size_t)m * N + n] = v;
  }
}

// One product of the bf16 path: out (M, N) = round(A (M, K) @ W (N, K)^T +
// bias [+ resid]) with every row ld K (A, W) or N (resid, out); with K
// splits, each split (k_split columns of K, whole 64-deep steps) writes its
// f32 partial to part (splits, M, N) instead. N % 8 != 0 (the o-projection
// at C % 8 != 0) takes the kScalar variants, which store one value at a
// time.
struct Product {
  const bf16* A;
  const bf16* W;
  const bf16* bias;
  const bf16* resid;  // or null
  bf16* out;
  float* part;  // or null: one split
  int M, N, K, n_tiles, k_split;
};

// out[i .. i + 8) of row m, column n = v + bias [+ resid], rounded once.
__device__ __forceinline__ void finish8(const Product& p, size_t i, int n, const float (&v)[8]) {
  const uint4 bu = *reinterpret_cast<const uint4*>(p.bias + n);
  const bf16* bb = reinterpret_cast<const bf16*>(&bu);
  uint4 ru = make_uint4(0u, 0u, 0u, 0u);
  if (p.resid != nullptr) ru = *reinterpret_cast<const uint4*>(p.resid + i);
  const bf16* rr = reinterpret_cast<const bf16*>(&ru);
  uint4 u;
  bf16* o = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float y = v[j] + __bfloat162float(bb[j]);
    if (p.resid != nullptr) y = y + __bfloat162float(rr[j]);
    o[j] = __float2bfloat16_rn(y);
  }
  *reinterpret_cast<uint4*>(p.out + i) = u;
}

// out[i] of row m, column n = v + bias [+ resid], rounded once.
__device__ __forceinline__ void finish1(const Product& p, size_t i, int n, float v) {
  float y = v + __bfloat162float(p.bias[n]);
  if (p.resid != nullptr) y = y + __bfloat162float(p.resid[i]);
  p.out[i] = __float2bfloat16_rn(y);
}

// Grid (tiles, splits), 256 threads: one 128 x BN tile over one K split,
// staged through shared memory (over the drained ring) to store 8
// consecutive outputs a thread.
template <int BNT, bool kRagged, bool kScalar>
__global__ void __launch_bounds__(sm90::kGemmThreads, 1) linear_wgmma_kernel(const Product p) {
  constexpr int LDC = BNT + 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const int m0 = blockIdx.x / p.n_tiles * sm90::kBM, n0 = blockIdx.x % p.n_tiles * BNT;
  sm90::GemmTile<BNT> tile;
  tile.template run<kRagged>(smem, p.A, p.W, p.K, p.M, p.N, p.K, m0, n0, blockIdx.y * p.k_split,
                             (p.k_split + sm90::kBK - 1) / sm90::kBK);
  float* Cs = reinterpret_cast<float*>(smem);
  tile.for_each([&](int r, int c, float v) { Cs[r * LDC + c] = v; });
  __syncthreads();
  for (int e = threadIdx.x; e < sm90::kBM * (BNT / 8); e += blockDim.x) {
    const int r = e / (BNT / 8), c = (e % (BNT / 8)) * 8, m = m0 + r, n = n0 + c;
    if (m >= p.M) break;
    if (kRagged && n >= p.N) continue;
    const size_t i = (size_t)m * p.N + n;
    if constexpr (kScalar) {
      for (int j = 0; j < 8 && n + j < p.N; ++j) {
        if (p.part != nullptr) p.part[(size_t)blockIdx.y * p.M * p.N + i + j] = Cs[r * LDC + c + j];
        else finish1(p, i + j, n + j, Cs[r * LDC + c + j]);
      }
      continue;
    }
    const float4 v0 = *reinterpret_cast<const float4*>(Cs + r * LDC + c);
    const float4 v1 = *reinterpret_cast<const float4*>(Cs + r * LDC + c + 4);
    if (p.part != nullptr) {
      float4* dst = reinterpret_cast<float4*>(p.part + (size_t)blockIdx.y * p.M * p.N + i);
      dst[0] = v0;
      dst[1] = v1;
    } else {
      const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      finish8(p, i, n, v);
    }
  }
}

// The split partials of one product summed in split order, then finish8
// (kScalar: one value a thread, then finish1).
template <bool kScalar>
__global__ void __launch_bounds__(256) linear_reduce_kernel(const Product p, int splits) {
  const size_t mn = (size_t)p.M * p.N;
  if constexpr (kScalar) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= mn) return;
    float v = p.part[i];
    for (int z = 1; z < splits; ++z) v += p.part[z * mn + i];
    finish1(p, i, (int)(i % p.N), v);
    return;
  }
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= mn) return;
  const float4* src = reinterpret_cast<const float4*>(p.part + i);
  float4 a = src[0], b = src[1];
  float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  for (int z = 1; z < splits; ++z) {
    src = reinterpret_cast<const float4*>(p.part + z * mn + i);
    a = src[0];
    b = src[1];
    const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] += w[j];
  }
  finish8(p, i, (int)(i % p.N), v);
}

// One product launch (BNT wide, `splits` K splits), then a split launch's reduce.
template <int BNT, bool kRagged, bool kScalar = false>
cudaError_t run_product(const Product& p, int splits, cudaStream_t st) {
  constexpr int smem = sm90::GemmTile<BNT>::kSmem;
  cudaError_t err = sm90::reserve_smem<linear_wgmma_kernel<BNT, kRagged, kScalar>>(smem);
  if (err != cudaSuccess) return err;
  const int tiles = (p.M + sm90::kBM - 1) / sm90::kBM * p.n_tiles;
  linear_wgmma_kernel<BNT, kRagged, kScalar><<<dim3(tiles, splits), sm90::kGemmThreads, smem, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  const size_t threads = (size_t)p.M * p.N / (kScalar ? 1 : 8);
  linear_reduce_kernel<kScalar><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(p, splits);
  return cudaGetLastError();
}

cudaError_t launch_product(const bf16* A, const bf16* W, const bf16* bias, const bf16* resid, bf16* out, float* part,
                           int M, int N, int K, int bn, int splits, cudaStream_t st) {
  const int steps = (K + sm90::kBK - 1) / sm90::kBK;
  if ((bn != 64 && bn != 128) || splits < 1 || (splits > 1 && (K % sm90::kBK || steps % splits)))
    return cudaErrorInvalidValue;
  const Product p{A, W, bias, resid, out, splits > 1 ? part : nullptr, M, N, K, (N + bn - 1) / bn, K / splits};
  // the ragged tile variant only where K or N leaves a partial tile
  const bool ragged = K % sm90::kBK || N % bn;
  if (N % 8) return bn == 128 ? run_product<128, true, true>(p, splits, st) : run_product<64, true, true>(p, splits, st);
  if (bn == 128) return ragged ? run_product<128, true>(p, splits, st) : run_product<128, false>(p, splits, st);
  return ragged ? run_product<64, true>(p, splits, st) : run_product<64, false>(p, splits, st);
}

struct Args {
  const void *x, *kv, *wqkv, *bqkv, *wo, *bo;
  const uint8_t* cmask;
  void *out, *rows, *qkv, *att;
  float* part;
  int B, N, Sc, C, H;
  float scale;
  int bn_qkv, splits_qkv, bn_o, splits_o;
};

// Widths: the rows have pitch Cp = round8(C) and each head's q, k and v
// columns D8 = round8(D), their pads zero (kernels/attn_block.py pads Wqkv's
// columns and head rows and Wo's head columns once), so the products run
// over zero-padded K and the attention over zero-padded heads, with 16-byte
// aligned rows; x and out keep pitch C.
template <typename T>
int launch(const Args& a, cudaStream_t st) {
  const int S = a.N + a.Sc, C = a.C, Cp = round8(C), Cq = a.H * round8(C / a.H), Mq = a.B * a.N, Mkv = a.B * S;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.wqkv);
  const T* bias = static_cast<const T*>(a.bqkv);
  T* rows = static_cast<T*>(a.rows);
  T* qkv = static_cast<T*>(a.qkv);  // (B*S, 3C): q | k | v of every row
  T* att = static_cast<T*>(a.att);
  const auto ln_rows = Cp != C ? ln_rows_kernel<T, true> : ln_rows_kernel<T, false>;
  ln_rows<<<Mkv, kThreads, C * sizeof(float), st>>>(x, static_cast<const T*>(a.kv), rows, a.N, S, C, Cp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (is_bf16<T>()) {
    err = launch_product(rows, w, bias, nullptr, qkv, a.part, Mkv, 3 * Cq, Cp, a.bn_qkv, a.splits_qkv, st);
  } else {
    linear_kernel<<<dim3((3 * Cq + BN - 1) / BN, (Mkv + BM - 1) / BM), kThreads, 0, st>>>(rows, w, bias, nullptr, qkv,
                                                                                      Mkv, 3 * Cq, Cp);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  err = launch_attention<T, true>(qkv, qkv + Cq, qkv + 2 * Cq, a.cmask, att, a.B, a.N, S, a.H, Cq / a.H, 3 * Cq,
                                  3 * Cq, 3 * Cq, (size_t)S * 3 * Cq, a.N, a.scale, st);
  if (err != cudaSuccess) return (int)err;
  const T* wo = static_cast<const T*>(a.wo);
  const T* bo = static_cast<const T*>(a.bo);
  T* out = static_cast<T*>(a.out);
  if constexpr (is_bf16<T>()) {
    return (int)launch_product(att, wo, bo, x, out, a.part, Mq, C, Cq, a.bn_o, a.splits_o, st);
  } else {
    linear_kernel<<<dim3((C + BN - 1) / BN, (Mq + BM - 1) / BM), kThreads, 0, st>>>(att, wo, bo, x, out, Mq, C, Cq);
    return (int)cudaGetLastError();
  }
}

}  // namespace
}  // namespace paella

// C interface for ctypes. x, out (B,H,W,C) with N = H*W; kv (B,Sc,C) the
// block's kv-mapper output; cmask (B,Sc) bytes (1 = attend) or null. With
// Cp = C and D8 = C/H rounded up to multiples of 8, and Cq = H*D8: wqkv
// (3Cq,Cp) packed q|k|v rows, each head's D8 rows and each row's Cp columns
// zero past the true ones, and bqkv (3Cq) likewise; wo (C,Cq) with zero head
// pad columns, bo (C). Scratch in the dtype: rows (B*(N+Sc), Cp), qkv
// (B*(N+Sc), 3Cq), att (B*N, Cq); part f32, with splits the larger of
// splits_qkv * B*(N+Sc)*3Cq and splits_o * B*N*C, else null. All contiguous
// and 16-byte aligned. Any C that H divides. scale = (C/H)^-1/2 in f32. bf16
// only: the products' tile widths bn_qkv, bn_o (64 or 128) and K splits
// (each split whole 64-deep steps) from kernels/attn_block.py::attn_block_plan.
// Returns a cudaError_t.
extern "C" int paella_attn_block(const void* x, const void* kv, const void* cmask, const void* wqkv,
                                 const void* bqkv, const void* wo, const void* bo, void* out, void* rows,
                                 void* qkv, void* att, void* part, int B, int N, int Sc, int C, int H, float scale,
                                 int is_bf16, int bn_qkv, int splits_qkv, int bn_o, int splits_o, void* stream) {
  using namespace paella;
  const Args a{x, kv, wqkv, bqkv, wo, bo, static_cast<const uint8_t*>(cmask), out, rows, qkv, att,
               static_cast<float*>(part), B, N, Sc, C, H, scale, bn_qkv, splits_qkv, bn_o, splits_o};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}
