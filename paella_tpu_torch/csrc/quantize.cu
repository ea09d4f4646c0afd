// Codebook nearest-neighbour search for Hopper (sm_90a), f32: for each token
// z (C values) the index of the code e_k minimizing |z - e_k|^2.
//
// Replaces: paella_tpu/kernels/quantize.py::fused_codebook_lookup (the Pallas
// TPU kernel; pallas_call at quantize.py:82), once per codec encode and once
// per latent interpolation:
//
//   dist_k = |e_k|^2 - 2 z.e_k          |z|^2 is the same for every code
//   idx    = argmin_k dist_k            lowest index on ties
//
// Rounding: the norm and the dot are sequential round-to-nearest f32 sums over
// c = 0..C-1 (__fmul_rn / __fadd_rn, no FMA contraction), in the order the
// plain torch version (kernels/quantize.py::codebook_lookup_plain) uses, and
// n - 2 d is one __fmaf_rn(-2, d, n), which equals __fsub_rn(n, 2 d) bit for
// bit because 2 d is exact; so the kernel's indices equal the plain version's
// bit for bit wherever no distance is NaN, and for a token whose every
// distance is NaN (index 0). Where some distances of a token are NaN (an
// infinite latent) and others are not, a NaN never wins here, where torch's
// argmin takes the first NaN: both indices are in range.
//
// What bounds it on an H100: not the bytes (64 KB of tokens, 128 KB of
// codebook at the codec's encode shape, M 4096 x K 8192 x C 4) and not the
// f32 operations as such (0.3 GFLOP, 4 us at 67 TFLOP/s), but the
// instructions issued for each (token, code) element: 4 products, 3 sums,
// the fused n - 2 d, a compare and two selects, 11 a thread, and the loads
// of a code and its norm shared by four tokens: 11.94 SASS instructions an
// element in the C = 4 loop (chip_smoke.py counts them), 12 us of issue at
// M 4096. Tensor cores do not fit: a TF32 or 3xTF32 product would move the
// rounding points, and the indices would no longer be the plain version's.
//
// Design, one launch a call:
// - A block of 512 threads owns a row tile of 512 tokens: 128 token lanes of
//   4 tokens each (held in registers), so one shared-memory load of a code
//   (a float4 at C = 4) and of its norm serves four tokens; the block's four
//   parts of 128 threads take the four quarters of each staged chunk of
//   codes (16 warps an SM at the codec's encode shape, to hide latency).
// - The codes go through shared memory in chunks of 512 with their norms,
//   formed once a chunk in the plain version's order.
// - The K codes split among `split` blocks of the same row tile (up to 16,
//   enough that the row tiles x splits fill the card: 8 x 16 at M 4096), so
//   the flagship's 4096 tokens fill 128 of the 132 SMs.
// - The splits merge inside the launch, by the key (distance, then index), a
//   total order, so the result does not depend on the split: each block
//   leaves its (distance, index) partials in device memory and the row
//   tile's last block to arrive (an atomic count that it resets to zero)
//   merges them, as the head kernel (sampling.cu) does. (A thread-block
//   cluster merging through distributed shared memory took 32 against 18 us
//   at M 4096: clusters of 16 blocks are placed less evenly on the SMs.)
// - A lane starts at its split's first code with distance +inf, so a token
//   whose every distance is NaN or +inf gets an index in range (the first
//   code, as the plain version's argmin gives for such a row), and an empty
//   split (k0 >= K) loses every tie to the splits before it.
// - C = 4 (the codec's width) runs a variant compiled for it, its loops
//   unrolled; other widths up to 8 hold the token in registers with loops
//   over a run-time C, and wider latents (kWide) read the codes from device
//   memory and form each code's norm in every thread, in the same order.
#include "common.cuh"

namespace paella {
namespace {

constexpr int kLanes = 128;                    // token lanes a block
constexpr int kTok = 4;                        // tokens a lane
constexpr int kParts = 4;                      // code parts a block: threads [0,128), [128,256), ...
constexpr int kBlock = kLanes * kParts;        // threads a block
constexpr int kRowTile = kLanes * kTok;        // tokens a block: 512
constexpr int kChunk = 512;                    // codes staged in shared memory at a time
constexpr int kMaxC = 8;                       // widest latent held in registers and shared memory
constexpr int kMaxSplit = 16;                  // blocks sharing a row tile's codes

// (distance, index) b before a: a lower distance, or an equal one and a lower index.
__device__ __forceinline__ void take_min(float& d, int& i, float d2, int i2) {
  if (d2 < d || (d2 == d && i2 < i)) {
    d = d2;
    i = i2;
  }
}

struct LookupArgs {
  const float* z;   // (M, C)
  const float* cb;  // (K, C)
  int32_t* out;     // (M,)
  uint2* partials;     // (split, M) (distance bits, index)
  unsigned* counters;  // one arrival count a row tile, zero between calls
  int M, K, C, split;
};

// kC: the latent width compiled in (4), or 0 for a run-time C <= kMaxC.
template <int kC, bool kWide>
__global__ void __launch_bounds__(kBlock) lookup_kernel(const LookupArgs a) {
  constexpr int kW = kWide ? 1 : (kC ? kC : kMaxC);  // register / shared-memory width a code
  __shared__ __align__(16) float cs[kWide ? 4 : kChunk * kW];
  __shared__ float cn[kWide ? 1 : kChunk];
  __shared__ float tile_d[kParts / 2][kRowTile];  // the parts' merge; then the block's result in [0]
  __shared__ int tile_i[kParts / 2][kRowTile];
  const int C = kC ? kC : a.C;
  const int lane = threadIdx.x % kLanes, part = threadIdx.x / kLanes;
  const int m0 = blockIdx.x * kRowTile;
  const int per_split = (a.K + a.split - 1) / a.split;
  const int k0 = blockIdx.y * per_split, k1 = min(a.K, k0 + per_split);

  // this lane's tokens m0 + lane + i * 128: neighbouring lanes, neighbouring rows
  float zr[kTok][kW];
#pragma unroll
  for (int i = 0; i < kTok; ++i) {
    const int m = min(m0 + lane + i * kLanes, a.M - 1);
#pragma unroll
    for (int c = 0; c < kW; ++c) zr[i][c] = (!kWide && c < C) ? a.z[(size_t)m * C + c] : 0.f;
  }
  float bd[kTok];
  int bi[kTok];
#pragma unroll
  for (int i = 0; i < kTok; ++i) {
    bd[i] = __int_as_float(0x7f800000);  // +inf
    bi[i] = k0;                          // the split's first code until one is less
  }

  for (int kc = k0; kc < k1; kc += kChunk) {
    const int n = min(kChunk, k1 - kc);
    if constexpr (!kWide) {
      __syncthreads();  // the previous chunk is no longer read
      for (int e = threadIdx.x; e < n * C; e += kBlock) cs[(e / C) * kW + e % C] = a.cb[(size_t)kc * C + e];
      __syncthreads();
      for (int j = threadIdx.x; j < n; j += kBlock) {
        const float* e = cs + j * kW;
        float nj = __fmul_rn(e[0], e[0]);
#pragma unroll
        for (int c = 1; c < kW; ++c)
          if (c < C) nj = __fadd_rn(nj, __fmul_rn(e[c], e[c]));
        cn[j] = nj;
      }
      __syncthreads();
    }
    const int len = (n + kParts - 1) / kParts;
    const int j0 = part * len, j1 = min(n, j0 + len);
    if constexpr (kC == 4 && !kWide) {
      const float4* c4 = reinterpret_cast<const float4*>(cs);
#pragma unroll 4
      for (int j = j0; j < j1; ++j) {
        const float4 e = c4[j];
        const float nj = cn[j];
        const int k = kc + j;
#pragma unroll
        for (int i = 0; i < kTok; ++i) {
          float d = __fmul_rn(zr[i][0], e.x);
          d = __fadd_rn(d, __fmul_rn(zr[i][1], e.y));
          d = __fadd_rn(d, __fmul_rn(zr[i][2], e.z));
          d = __fadd_rn(d, __fmul_rn(zr[i][3], e.w));
          const float dist = __fmaf_rn(-2.f, d, nj);
          if (dist < bd[i]) {  // strict: the lane's first index wins
            bd[i] = dist;
            bi[i] = k;
          }
        }
      }
    } else if constexpr (!kWide) {
      for (int j = j0; j < j1; ++j) {
        const float* e = cs + j * kW;
        const float nj = cn[j];
        const int k = kc + j;
#pragma unroll
        for (int i = 0; i < kTok; ++i) {
          float d = __fmul_rn(zr[i][0], e[0]);
#pragma unroll
          for (int c = 1; c < kW; ++c)
            if (c < C) d = __fadd_rn(d, __fmul_rn(zr[i][c], e[c]));
          const float dist = __fmaf_rn(-2.f, d, nj);
          if (dist < bd[i]) {
            bd[i] = dist;
            bi[i] = k;
          }
        }
      }
    } else {
      int rows[kTok];
#pragma unroll
      for (int i = 0; i < kTok; ++i) rows[i] = min(m0 + lane + i * kLanes, a.M - 1) * C;
      for (int j = j0; j < j1; ++j) {
        const int k = kc + j;
        const float* e = a.cb + (size_t)k * C;
        float e0 = __ldg(e);
        float nj = __fmul_rn(e0, e0);
        float d[kTok];
#pragma unroll
        for (int i = 0; i < kTok; ++i) d[i] = __fmul_rn(__ldg(a.z + rows[i]), e0);
        for (int c = 1; c < C; ++c) {
          const float ec = __ldg(e + c);
          nj = __fadd_rn(nj, __fmul_rn(ec, ec));
#pragma unroll
          for (int i = 0; i < kTok; ++i) d[i] = __fadd_rn(d[i], __fmul_rn(__ldg(a.z + rows[i] + c), ec));
        }
#pragma unroll
        for (int i = 0; i < kTok; ++i) {
          const float dist = __fmaf_rn(-2.f, d[i], nj);
          if (dist < bd[i]) {
            bd[i] = dist;
            bi[i] = k;
          }
        }
      }
    }
  }

  // the block's parts (parts [w, 2w) hand theirs to parts [0, w)), then the
  // row tile's splits
#pragma unroll
  for (int w = kParts / 2; w >= 1; w /= 2) {
    if (part >= w && part < 2 * w) {
#pragma unroll
      for (int i = 0; i < kTok; ++i) {
        tile_d[part - w][lane + i * kLanes] = bd[i];
        tile_i[part - w][lane + i * kLanes] = bi[i];
      }
    }
    __syncthreads();
    if (part < w) {
#pragma unroll
      for (int i = 0; i < kTok; ++i) take_min(bd[i], bi[i], tile_d[part][lane + i * kLanes], tile_i[part][lane + i * kLanes]);
    }
    __syncthreads();
  }
  if (part == 0) {
#pragma unroll
    for (int i = 0; i < kTok; ++i) {
      tile_d[0][lane + i * kLanes] = bd[i];
      tile_i[0][lane + i * kLanes] = bi[i];
    }
  }
  __shared__ bool last;
  __syncthreads();
  for (int t = threadIdx.x; t < kRowTile; t += kBlock)
    if (m0 + t < a.M)
      a.partials[(size_t)blockIdx.y * a.M + m0 + t] = make_uint2(__float_as_uint(tile_d[0][t]), (uint32_t)tile_i[0][t]);
  __threadfence();  // the partials are visible before the arrival is counted
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.counters + blockIdx.x, 1u) == (unsigned)a.split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int t = threadIdx.x; t < kRowTile && m0 + t < a.M; t += kBlock) {
    float d = __int_as_float(0x7f800000);
    int i = 0x7fffffff;
    for (int q = 0; q < a.split; ++q) {
      const uint2 p = __ldcg(a.partials + (size_t)q * a.M + m0 + t);
      take_min(d, i, __uint_as_float(p.x), (int)p.y);
    }
    a.out[m0 + t] = i;
  }
  if (threadIdx.x == 0) a.counters[blockIdx.x] = 0;
}

// Splits of K for M tokens: the fewest (at least enough blocks for every SM,
// at most 16 and at most K) whose largest per-SM share of the work is least.
int lookup_split(int M, int K) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  const int tiles = (M + kRowTile - 1) / kRowTile;
  const int hi = min(kMaxSplit, K);
  int best = min(hi, max(1, (sms + tiles - 1) / tiles));
  double best_share = 1e30;
  for (int s = best; s <= hi; ++s) {
    const double share = (double)((tiles * s + sms - 1) / sms) / s;  // blocks on the busiest SM x each block's work
    if (share < best_share - 1e-9) {
      best_share = share;
      best = s;
    }
  }
  return best;
}

template <int kC, bool kWide>
int launch_lookup(const LookupArgs& a, cudaStream_t st) {
  const dim3 grid((a.M + kRowTile - 1) / kRowTile, a.split);
  lookup_kernel<kC, kWide><<<grid, kBlock, 0, st>>>(a);
  return (int)cudaGetLastError();
}

int launch_lookup(const LookupArgs& a, cudaStream_t st) {
  if (a.C == 4) return launch_lookup<4, false>(a, st);
  if (a.C <= kMaxC) return launch_lookup<0, false>(a, st);
  return launch_lookup<0, true>(a, st);
}

}  // namespace
}  // namespace paella

// C interface for ctypes. z (M, C) f32 and codebook (K, C) f32, both
// contiguous; out (M,) int32. Any C >= 1. partials:
// paella_codebook_lookup_split(M, K) x M 8-byte words; counters: ceil(M /
// 512) words that are zero and are left zero (calls that share them must not
// overlap: one stream). One kernel launch. Returns a cudaError_t.
extern "C" int paella_codebook_lookup(const void* z, const void* codebook, void* out, void* partials,
                                      void* counters, int M, int K, int C, void* stream) {
  using namespace paella;
  if (C < 1 || M < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const LookupArgs a{(const float*)z, (const float*)codebook, (int32_t*)out, (uint2*)partials, (unsigned*)counters,
                     M, K, C, lookup_split(M, K)};
  return launch_lookup(a, static_cast<cudaStream_t>(stream));
}

// The number of blocks that share a row tile's codes at M tokens and K codes.
extern "C" int paella_codebook_lookup_split(int M, int K) {
  if (M < 1 || K < 1) return 0;
  return paella::lookup_split(M, K);
}
