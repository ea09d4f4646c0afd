// Sampling kernels for Hopper (sm_90a), bf16 or f32, sharing the JAX
// package's per-image counter hash and one per-element draw
// (common.cuh::gumbel_score):
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
// and their plain torch versions agree exactly. Seeds arrive as the (n_img, 2)
// int64 tensor the sampler holds; the kernels read each value's low 32 bits.
//
// What bounds both on an H100: not the bytes (the head's 4 MB weight and 4 MB
// of features; K3's 67 MB of bf16 logits, 20 us of HBM time) and not the head
// product (17.2 GFLOP a flagship step, 17 us at the bf16 peak), but the draw:
// every one of the M x K (row, label) pairs (33.5 M a flagship step) needs two
// murmur3 rounds, u, two logs bit-exact with torch.log and a compare, ~65-75
// issued instructions (chip_smoke.py counts them in the SASS), 65-75 us of
// issue on 132 SMs. Both kernels are built to keep the ALUs issuing that draw
// and to hide everything else under it; the shared draw (common.cuh) drops
// the log's branches for arguments it never sees and keeps no branch at all.
//
// Head design (bf16, C <= 448): a block owns 256 rows (four warpgroups of 64
// on gemm_sm90.cuh's wgmma; 128 rows and two where C > 256) and a contiguous
// range of 64-label tiles. The CFG-mixed A tile is staged once, mixed in f32
// and rounded as it is written into 128-byte-swizzled shared memory, and stays
// resident (128 KB at C 256); the head weight's label tiles stream through a
// two-slot cp.async ring. The logits live only in registers: each label
// tile's product (wgmma m64n64k16, f32 accumulators) goes into one of two
// accumulator sets while the threads draw from the other, so the tensor cores
// work under the draw. Each thread keeps a running (best, index) for its two
// rows; the quad's four lanes merge at the end. Where the row tiles are too
// few to fill the card (M 4096: 16 tiles for 132 SMs) the labels split among
// up to 16 blocks (8 x 1024 at M 4096), which leave their (best, index)
// partials in device memory; the row tile's last block to arrive (an atomic
// count, left at zero for the next call) merges them, so one launch does it
// all. (A thread-block cluster merging through distributed shared memory ran
// the flagship step in two waves: fewer clusters of four fit on the card at
// once than the step has row tiles.) The merge key (higher score, then lower
// index) is a total order and each logit's sum over C runs in the same order
// wherever its row sits, so the tokens do not depend on the split or on the
// batch. Each tile's products are issued on every step, also past the block's
// range (into registers nobody reads), since a product issued on a branch
// made ptxas wait for every product before the draw (its note C7520). C past
// a multiple of 64 and K past a multiple of 64 (or unaligned operands) run a
// variant compiled apart: the features and weight are staged by element loads
// with zero columns up to C's 16-wide product step and zero rows past K, the
// last K step issues only the 16-wide slices that C reaches, and labels past
// K never compete. f32 (TF32 off: the plain spec is exact f32), and bf16 past
// C 448 (where A no longer fits beside the ring), run a SIMT kernel instead:
// 32-row blocks, FMA (f32) or mma.sync (bf16) tiles, A resident up to ~160 KB
// and streamed per K step past that.
//
// Gumbel design: one warp per row, all rows of a flagship step in flight at
// once (31 warps an SM). Each lane walks the row in 16-byte vector loads (8
// bf16 or 4 f32 logits), strided by the warp's 256 or 128 columns, with the
// next vector's load issued before the current one's draw, keeping a running
// (best score, index) with a strict >, so the lane's first index wins; a
// shuffle reduction merges the lanes, lower index on ties. Rows that are not
// 16-byte aligned, or K not a multiple of the vector, run a variant compiled
// apart with a scalar head up to the first aligned address and a scalar tail.
#include "gemm_sm90.cuh"

namespace paella {
namespace {

using bf16 = __nv_bfloat16;

struct HeadArgs {
  const void* fc;  // (M, C) conditional features
  const void* fu;  // (M, C) unconditional features, or null: no CFG mix
  // the step's CFG weight w (unread without fu) and temperature T, one f32
  // each in device memory, so a captured graph replays with new values
  const float* cfg_w_in;
  const float* temp_in;
  float cfg_w, cfg_1mw, inv_temp;  // w, 1 - w and 1 / T in f32, formed once a block (load_scalars)
  const void* w;          // (K, C) head weight, torch layout
  const int64_t* seeds;   // (M / hw, 2)
  int32_t* out;           // (M,)
  int M, C, K, hw;
  // wgmma path: blocks sharing one row tile's labels, their (score, label)
  // partials (split x M) and a zeroed arrival count a row tile
  int split;
  uint2* partials;
  unsigned* counters;

  // The JAX kernel's f32 arithmetic on its scalar operands: 1 - w and 1 / T
  // correctly rounded, as the wrappers' plain versions form them.
  __device__ __forceinline__ void load_scalars() {
    cfg_w = fu != nullptr ? __ldg(cfg_w_in) : 0.f;
    cfg_1mw = __fsub_rn(1.f, cfg_w);
    inv_temp = __fdiv_rn(1.f, __ldg(temp_in));
  }
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Row m's draw state: its counter base (image-local row * K) and seed pair.
struct RowDraw {
  uint32_t base, s0, s1;
  __device__ __forceinline__ void init(const HeadArgs& a, int m) {
    const int img = m < a.M ? m / a.hw : 0;
    base = (uint32_t)(m - img * a.hw) * (uint32_t)a.K;
    s0 = (uint32_t)a.seeds[2 * img];
    s1 = (uint32_t)a.seeds[2 * img + 1];
  }
};

// The CFG mix of one feature in f32, rounded to the dtype by the caller.
template <typename T>
__device__ __forceinline__ float mix_feature(const HeadArgs& a, size_t i) {
  const float v = to_f<T>(static_cast<const T*>(a.fc)[i]);
  if (a.fu == nullptr) return v;
  return __fadd_rn(__fmul_rn(v, a.cfg_w), __fmul_rn(to_f<T>(static_cast<const T*>(a.fu)[i]), a.cfg_1mw));
}

// ---------------------------------------------------------------- wgmma head
constexpr int kHeadBN = 64;       // labels a tile: wgmma m64n64, 32 accumulators a thread
constexpr int kHeadSlots = 2;     // label tiles in the copy ring
constexpr int kHeadMaxKS = 7;     // resident A K steps (64 columns each): C <= 448
constexpr int kHeadMaxSplit = 16;  // blocks sharing a row tile's labels

// kWG warpgroups of 64 rows, kHeadBN labels a tile
template <int kWG>
__host__ __device__ constexpr size_t head_wgmma_smem(int ks) {
  // A, the ring, alignment slack
  return (size_t)ks * (64 * kWG * 128 + kHeadSlots * kHeadBN * 128) + 1024;
}

// kKS: K steps of 64 columns, C / 64, at whole widths; the ragged variant
// (kRagged, kKS 0) takes ks = ceil(C / 64) at run time. The issue of each
// tile's products is unconditional (a tile past the block's range multiplies
// stale shared memory into registers nobody reads): a product issued on a
// branch made ptxas wait for every product before the draw (C7520).
template <bool kRagged, int kKS, int kWG>
__global__ void __launch_bounds__(128 * kWG, 1) head_wgmma_kernel(const HeadArgs args) {
  using namespace sm90;
  HeadArgs a = args;
  a.load_scalars();
  constexpr int kBN = kHeadBN, kRows = 64 * kWG, kThr = 128 * kWG, kAcc = kBN / 2;
  constexpr int kATile = kRows * 128, kBTile = kBN * 128;  // one K step of A, of a label tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const int C = a.C, K = a.K, M = a.M;
  const int ks = kRagged ? (C + 63) / 64 : kKS;
  uint8_t* a_tiles = smem;
  uint8_t* ring = smem + ks * kATile;
  const int slot_bytes = ks * kBTile;
  const uint32_t a_addr = smem_addr(a_tiles), ring_addr = smem_addr(ring);
  const bf16* W = static_cast<const bf16*>(a.w);

  const int m0 = blockIdx.y * kRows, rank = blockIdx.x;
  const int ntiles = (K + kBN - 1) / kBN;
  const int t0 = (int)((long long)rank * ntiles / a.split);
  const int n = (int)((long long)(rank + 1) * ntiles / a.split) - t0;
  // 16-wide product slices of the last K step: C rounded up to 16 (zero columns)
  const int last_slices = kRagged ? ((C - 64 * (ks - 1)) + 15) / 16 : 4;

  // 1. the CFG-mixed A tile, rounded to bf16 as it is written, zeros past C
  //    (to the K step's end) and past M
  for (int e = threadIdx.x; e < kRows * ks * 8; e += kThr) {
    const int r = e / (ks * 8), q = e % (ks * 8), col = q * 8;
    const int m = m0 + r;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (m < M) {
      if constexpr (!kRagged) {
        const uint4 f = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.fc) + (size_t)m * C + col);
        v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
        if (a.fu != nullptr) {
          const uint4 g = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.fu) + (size_t)m * C + col);
          const uint32_t u[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[i]));
            const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
            const __nv_bfloat162 mixed = __floats2bfloat162_rn(
                __fadd_rn(__fmul_rn(x.x, a.cfg_w), __fmul_rn(y.x, a.cfg_1mw)),
                __fadd_rn(__fmul_rn(x.y, a.cfg_w), __fmul_rn(y.y, a.cfg_1mw)));
            v[i] = *reinterpret_cast<const uint32_t*>(&mixed);
          }
        }
      } else {
        bf16* h = reinterpret_cast<bf16*>(v);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          h[i] = col + i < C ? __float2bfloat16_rn(mix_feature<bf16>(a, (size_t)m * C + col + i)) : __float2bfloat16_rn(0.f);
      }
    }
    *reinterpret_cast<uint4*>(a_tiles + (q >> 3) * kATile + r * 128 + (((q & 7) ^ (r & 7)) << 4)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }

  // label tile j (of this block's range) into ring slot j % 2: cp.async
  // copies, or (kRagged) element loads, zeros past C and K; always one commit
  auto load_tile = [&](int j) {
    if (j < n) {
      const int n0 = (t0 + j) * kBN;
      const int slot = (j % kHeadSlots) * slot_bytes;
      if constexpr (!kRagged) {  // a whole number of copies a thread, offsets by shifts
#pragma unroll
        for (int i = 0; i < kKS * kBN * 8 / kThr; ++i) {
          const unsigned e = threadIdx.x + i * kThr, s = e / (kBN * 8), r = (e >> 3) % kBN, c = e & 7;
          cp_async16(ring_addr + slot + s * kBTile + r * 128 + ((c ^ (r & 7)) << 4),
                     W + (size_t)(n0 + r) * (kKS * 64) + s * 64 + c * 8, true);
        }
      } else {
        for (int e = threadIdx.x; e < ks * kBN * 8; e += kThr) {
          const int s = e / (kBN * 8), r = (e >> 3) % kBN, c = e & 7;
          const int row = n0 + r, col = s * 64 + c * 8;
          bf16 h[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            h[i] = row < K && col + i < C ? W[(size_t)row * C + col + i] : __float2bfloat16_rn(0.f);
          *reinterpret_cast<uint4*>(ring + slot + s * kBTile + r * 128 + ((c ^ (r & 7)) << 4)) =
              *reinterpret_cast<const uint4*>(h);
        }
      }
    }
    cp_async_commit();
  };

  // this thread's rows and columns in the wgmma accumulator layout
  // (GemmTile::for_each): rows r0 and r0 + 8, columns c0 + {0, 1} + 8 i
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int r0 = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  RowDraw rows[2];
  rows[0].init(a, m0 + r0);
  rows[1].init(a, m0 + r0 + 8);
  float best[2] = {neg_inf(), neg_inf()};
  int best_k[2] = {0, 0};

  // label tile j's logits into d (scale-d 0 on the first slice: no zeroing)
  // (a descriptor's address field is the byte address >> 4, so a K step's
  // tile is its first's descriptor plus the step's offset >> 4)
  const uint64_t da0 = desc_sw128(a_addr + wg * 64 * 128);
  auto issue = [&](float(&d)[kAcc], int j) {
    const uint64_t db0 = desc_sw128(ring_addr + (j % kHeadSlots) * slot_bytes);
    fence_operands(d);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < (kRagged ? kHeadMaxKS : kKS); ++s) {
      if (kRagged && s == ks) break;
      const uint64_t da = da0 + (s * kATile >> 4), db = db0 + (s * kBTile >> 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (!kRagged || s < ks - 1 || kk < last_slices) Wgmma<kBN, bf16>::mma(d, da + 2 * kk, db + 2 * kk, s | kk);
    }
    wgmma_commit();
    fence_operands(d);
  };
  // the epilogue: label tile j's draw from d, columns in increasing order per row
  auto draw = [&](const float(&d)[kAcc], int j) {
    const int n0 = (t0 + j) * kBN;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int h = (i >> 1) & 1, k = n0 + (i >> 2) * 8 + c0 + (i & 1);
      if (!kRagged || k < K) {
        const float s = gumbel_score(d[i], a.inv_temp, rows[h].base + (uint32_t)k, rows[h].s0, rows[h].s1);
        if (s > best[h]) {
          best[h] = s;
          best_k[h] = k;
        }
      }
    }
  };
  // one label tile: tile j+1's products go in flight on `nxt` while the
  // threads draw tile j from `cur`
  auto step = [&](float(&cur)[kAcc], float(&nxt)[kAcc], int j) {
    cp_async_wait<0>();  // this thread's copies of tile j+1
    fence_proxy_async();
    __syncthreads();  // everyone's copies of tile j+1; every warpgroup past tile j's products
    load_tile(j + 2);  // into tile j's slot
    issue(nxt, j + 1);
    draw(cur, j);
    wgmma_wait<0>();
    fence_operands(nxt);
  };

  float acc0[kAcc], acc1[kAcc];
  load_tile(0);
  load_tile(1);
  cp_async_wait<1>();
  fence_proxy_async();  // the A tile's and tile 0's shared-memory writes
  __syncthreads();
  issue(acc0, 0);
  wgmma_wait<0>();
  fence_operands(acc0);
  int j = 0;
  for (; j + 2 <= n; j += 2) {
    step(acc0, acc1, j);
    step(acc1, acc0, j + 1);
  }
  if (j < n) draw(acc0, j);  // an odd range's last tile, multiplied by the last step
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h)
    for (int o = 1; o < 4; o <<= 1)  // the quad's four lanes share the row
      argmax_merge(best[h], best_k[h], __shfl_xor_sync(0xffffffffu, best[h], o),
                   __shfl_xor_sync(0xffffffffu, best_k[h], o));
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r0 + 8 * h;
      if (m < M) {
        if (a.split == 1)
          a.out[m] = best_k[h];
        else
          a.partials[(size_t)rank * M + m] = make_uint2(__float_as_uint(best[h]), (uint32_t)best_k[h]);
      }
    }
  }
  if (a.split == 1) return;
  // the row tile's last block to arrive merges every block's partials, in
  // rank order, and clears the count for the next launch
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0) last = atomicAdd(a.counters + blockIdx.y, 1u) == (unsigned)a.split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int r = threadIdx.x; r < kRows && m0 + r < M; r += kThr) {
    float b = neg_inf();
    int bk = 0;
    for (int q = 0; q < a.split; ++q) {
      const uint2 p = __ldcg(a.partials + (size_t)q * M + m0 + r);
      argmax_merge(b, bk, __uint_as_float(p.x), (int)p.y);
    }
    a.out[m0 + r] = bk;
  }
  if (threadIdx.x == 0) a.counters[blockIdx.y] = 0;
}

// Blocks sharing one row tile's labels: as many as keep the grid within one
// wave of the card (one block an SM), at most kHeadMaxSplit, and every block
// with a label tile.
int head_split(int row_tiles, int label_tiles) {
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& n_sm = sms[dev < 64 ? dev : 0];
  if (n_sm == 0 && cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) n_sm = 132;
  int split = n_sm / row_tiles;
  if (split > kHeadMaxSplit) split = kHeadMaxSplit;
  if (split > label_tiles) split = label_tiles;
  return split < 1 ? 1 : split;
}

template <bool kRagged, int kKS, int kWG>
int launch_head_wgmma(HeadArgs a, cudaStream_t st) {
  constexpr auto kernel = head_wgmma_kernel<kRagged, kKS, kWG>;
  const size_t smem = head_wgmma_smem<kWG>((a.C + 63) / 64);
  cudaError_t err = sm90::reserve_smem<kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (a.M + 64 * kWG - 1) / (64 * kWG);
  a.split = head_split(row_tiles, (a.K + kHeadBN - 1) / kHeadBN);
  kernel<<<dim3(a.split, row_tiles), 128 * kWG, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Warpgroups a block: four (256 rows) where A and the ring fit beside each
// other (C <= 256), else two (128 rows, C <= 448).
__host__ __device__ constexpr int head_wg(int ks) { return ks <= 4 ? 4 : 2; }

template <int kKS>
int launch_head_whole(const HeadArgs& a, cudaStream_t st) {
  return launch_head_wgmma<false, kKS, head_wg(kKS)>(a, st);
}

// bf16 at C <= 448: a variant compiled for each whole C / 64, else a ragged one
int launch_head_bf16(const HeadArgs& a, bool whole, cudaStream_t st) {
  if (whole) switch (a.C / 64) {
      case 1: return launch_head_whole<1>(a, st);
      case 2: return launch_head_whole<2>(a, st);
      case 3: return launch_head_whole<3>(a, st);
      case 4: return launch_head_whole<4>(a, st);
      case 5: return launch_head_whole<5>(a, st);
      case 6: return launch_head_whole<6>(a, st);
      case 7: return launch_head_whole<7>(a, st);
    }
  if (a.C <= 256) return launch_head_wgmma<true, 0, 4>(a, st);
  return launch_head_wgmma<true, 0, 2>(a, st);
}

// ----------------------------------------------------------------- SIMT head
constexpr int BM = 32, BN = 64, BK = 32;
constexpr size_t kSimtResidentA = 160 * 1024;  // A resident up to this; streamed per K step past it

__host__ __device__ constexpr int simt_cp(int c) { return (c + BK - 1) / BK * BK; }

template <typename T, bool kStreamA>
__host__ __device__ constexpr int simt_lda(int c) { return (kStreamA ? BK : simt_cp(c)) + smem_pad<T>(); }

template <typename T, bool kStreamA>
__host__ __device__ constexpr size_t simt_smem(int c) {
  return sizeof(T) * (BM * simt_lda<T, kStreamA>(c) + BN * (BK + smem_pad<T>())) + sizeof(float) * BM * (BN + 4);
}

// Columns [c0, c0 + width) of this block's mixed rows into As (zeros past C and M).
template <typename T>
__device__ __forceinline__ void stage_mixed(const HeadArgs& a, T* As, int lda, int m0, int c0, int width) {
  for (int e = threadIdx.x; e < BM * width; e += kThreads) {
    const int r = e / width, c = e % width, m = m0 + r;
    As[r * lda + c] = from_f<T>(m < a.M && c0 + c < a.C ? mix_feature<T>(a, (size_t)m * a.C + c0 + c) : 0.f);
  }
}

// kVecB: C a multiple of the 16-byte vector and W 16-byte aligned (vector
// weight loads); else element loads. kStreamA: A staged per K step.
template <typename T, bool kVecB, bool kStreamA>
__global__ void __launch_bounds__(kThreads) head_simt_kernel(const HeadArgs args) {
  HeadArgs a = args;
  a.load_scalars();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = a.C, K = a.K, cp = simt_cp(C);
  const int lda = simt_lda<T, kStreamA>(C);
  constexpr int LDB = BK + smem_pad<T>(), LDC = BN + 4;
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + BM * lda;
  float* Cs = reinterpret_cast<float*>(Bs + BN * LDB);
  const T* W = static_cast<const T*>(a.w);
  const int m0 = blockIdx.x * BM;
  if constexpr (!kStreamA) stage_mixed<T>(a, As, lda, m0, 0, cp);

  const int r = threadIdx.x >> 2, cq = (threadIdx.x & 3) * 16;
  RowDraw row;
  row.init(a, m0 + r);
  float best = neg_inf();
  int best_k = 0;
  TileProduct<T, BM, BN> tile;
  for (int n0 = 0; n0 < K; n0 += BN) {
    tile.zero();
    for (int k0 = 0; k0 < cp; k0 += BK) {
      if constexpr (kStreamA) stage_mixed<T>(a, As, lda, m0, k0, BK);
      if constexpr (kVecB) {
        load_tile<T, BN, BK>(Bs, LDB, W, C, n0, K, k0, C);
      } else {
        for (int e = threadIdx.x; e < BN * BK; e += kThreads) {
          const int br = e / BK, bc = e % BK;
          Bs[br * LDB + bc] = n0 + br < K && k0 + bc < C ? W[(size_t)(n0 + br) * C + k0 + bc] : from_f<T>(0.f);
        }
      }
      __syncthreads();
      tile.step(As + (kStreamA ? 0 : k0), lda, Bs, LDB, BK);
      __syncthreads();
    }
    tile.store(Cs, LDC);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const int k = n0 + cq + j;
      if (k < K) {
        const float s = gumbel_score(Cs[r * LDC + cq + j], a.inv_temp, row.base + (uint32_t)k, row.s0, row.s1);
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
  if ((threadIdx.x & 3) == 0 && m0 + r < a.M) a.out[m0 + r] = best_k;
}

template <typename T, bool kVecB, bool kStreamA>
int launch_head_simt(const HeadArgs& a, cudaStream_t st) {
  const size_t smem = simt_smem<T, kStreamA>(a.C);
  cudaError_t err = sm90::reserve_smem<head_simt_kernel<T, kVecB, kStreamA>>(smem);
  if (err != cudaSuccess) return (int)err;
  head_simt_kernel<T, kVecB, kStreamA><<<(a.M + BM - 1) / BM, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_head_simt(const HeadArgs& a, bool vec_b, cudaStream_t st) {
  const bool stream_a = sizeof(T) * BM * simt_lda<T, false>(a.C) > kSimtResidentA;
  if (stream_a) return vec_b ? launch_head_simt<T, true, true>(a, st) : launch_head_simt<T, false, true>(a, st);
  return vec_b ? launch_head_simt<T, true, false>(a, st) : launch_head_simt<T, false, false>(a, st);
}

// ------------------------------------------------------------ Gumbel (K3)
constexpr int kGumbelWarps = 8;  // rows per block

// kVec: every row 16-byte aligned and K a multiple of the vector; else a
// scalar head up to the row's first aligned address and a scalar tail.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kGumbelWarps * 32) gumbel_kernel(
    const T* __restrict__ logits, long long ld, const int64_t* __restrict__ seeds, const float* __restrict__ temp,
    int32_t* __restrict__ out, int M, int K, int hw) {
  constexpr int V = 16 / sizeof(T);  // logits per 16-byte load
  const int m = blockIdx.x * kGumbelWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (m >= M) return;  // the whole warp leaves together
  const float inv_temp = __fdiv_rn(1.f, __ldg(temp));  // f32(1) / f32(T), as the plain version forms it
  const int img = m / hw;
  const uint32_t base = (uint32_t)(m - img * hw) * (uint32_t)K;
  const uint32_t s0 = (uint32_t)seeds[2 * img], s1 = (uint32_t)seeds[2 * img + 1];
  const T* row = logits + (size_t)m * ld;
  float best = neg_inf();
  int best_k = 0;
  // a lane's labels come in increasing order: head, vectors, tail
  auto take = [&](float logit, int k) {
    const float s = gumbel_score(logit, inv_temp, base + (uint32_t)k, s0, s1);
    if (s > best) {
      best = s;
      best_k = k;
    }
  };
  int head = 0, body_end = K;
  if constexpr (!kVec) {
    const int mis = (int)((reinterpret_cast<uintptr_t>(row) & 15) / sizeof(T));
    head = min(K, mis ? V - mis : 0);
    body_end = head + (K - head) / V * V;
    if (lane < head) take(to_f<T>(row[lane]), lane);
  }
  int k0 = head + lane * V;
  if (k0 < body_end) {
    uint4 cur = *reinterpret_cast<const uint4*>(row + k0);
    for (;;) {
      const int kn = k0 + 32 * V;
      uint4 nxt = cur;
      if (kn < body_end) nxt = *reinterpret_cast<const uint4*>(row + kn);  // in flight during the draw
      const T* pv = reinterpret_cast<const T*>(&cur);
#pragma unroll
      for (int i = 0; i < V; ++i) take(to_f<T>(pv[i]), k0 + i);
      if (kn >= body_end) break;
      cur = nxt;
      k0 = kn;
    }
  }
  if constexpr (!kVec)
    for (int k = body_end + lane; k < K; k += 32) take(to_f<T>(row[k]), k);
  for (int o = 16; o > 0; o >>= 1)
    argmax_merge(best, best_k, __shfl_xor_sync(0xffffffffu, best, o), __shfl_xor_sync(0xffffffffu, best_k, o));
  if (lane == 0) out[m] = best_k;
}

template <typename T>
int launch_gumbel(const void* logits, long long ld, const int64_t* seeds, const float* temp, int32_t* out, int M,
                  int K, int hw, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int blocks = (M + kGumbelWarps - 1) / kGumbelWarps;
  const bool vec = reinterpret_cast<uintptr_t>(logits) % 16 == 0 && ld % V == 0 && K % V == 0;
  if (vec)
    gumbel_kernel<T, true><<<blocks, kGumbelWarps * 32, 0, st>>>((const T*)logits, ld, seeds, temp, out, M, K, hw);
  else
    gumbel_kernel<T, false><<<blocks, kGumbelWarps * 32, 0, st>>>((const T*)logits, ld, seeds, temp, out, M, K, hw);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The shared draw's noise for given hash bits (tests hold it against torch).
__global__ void noise_kernel(const uint32_t* __restrict__ bits, float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = gumbel_noise(bits[i]);
}

}  // namespace
}  // namespace paella

// C interface for ctypes. fc, fu (M, C) contiguous (fu may be null: no CFG
// mix); w (K, C) contiguous, the head weight as torch stores it; seeds
// (M / hw, 2) int64, contiguous (the low 32 bits of each are the seed);
// out (M,) int32. Any C, K >= 1 and any element alignment. cfg_w (unread
// when fu is null) and temp point to one f32 each in device memory, the
// CFG weight w and the temperature T; each block reads them once and forms
// 1 - w and 1 / T in f32. Scratch for the
// blocks that share a row tile's labels: partials, 16 M 8-byte words, and
// counters, M / 128 + 1 words that are zero and are left zero; calls that
// share them must not overlap (one stream). One kernel launch. Returns a
// cudaError_t.
extern "C" int paella_head_categorical(const void* fc, const void* fu, const void* cfg_w, const void* w,
                                       const void* seeds, const void* temp, void* out, int M, int C, int K,
                                       int hw, int is_bf16, void* partials, void* counters, void* stream) {
  using namespace paella;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || C < 1 || K < 1 || hw < 1 || temp == nullptr || (fu != nullptr && cfg_w == nullptr))
    return (int)cudaErrorInvalidValue;
  const HeadArgs a{fc, fu, (const float*)cfg_w, (const float*)temp, 0.f, 0.f, 0.f, w, (const int64_t*)seeds,
                   (int32_t*)out, M, C, K, hw, 1, (uint2*)partials, (unsigned*)counters};
  if (is_bf16 && C <= 64 * kHeadMaxKS) {
    const bool whole = C % 64 == 0 && K % kHeadBN == 0 && aligned16(fc) && aligned16(w) &&
                       (fu == nullptr || aligned16(fu));
    return launch_head_bf16(a, whole, st);
  }
  const int vec = 16 / (is_bf16 ? 2 : 4);
  const bool vec_b = C % vec == 0 && aligned16(w);
  return is_bf16 ? launch_head_simt<__nv_bfloat16>(a, vec_b, st) : launch_head_simt<float>(a, vec_b, st);
}

// The head's launch plan at these sizes: the number of blocks that share a
// row tile's labels on the wgmma path (1 to 16), or 0 where the SIMT kernel
// runs (f32, or bf16 past C 448).
extern "C" int paella_head_plan(int M, int C, int K, int is_bf16) {
  using namespace paella;
  if (!is_bf16 || C > 64 * kHeadMaxKS || M < 1 || K < 1) return 0;
  const int rows = 64 * head_wg((C + 63) / 64);
  return head_split((M + rows - 1) / rows, (K + kHeadBN - 1) / kHeadBN);
}

// logits (M, K) with row stride ld elements (K contiguous), any alignment;
// seeds (M / hw, 2) int64, contiguous; out (M,) int32; temp points to the
// temperature T, one f32 in device memory, whose f32(1) / T each warp forms.
// Returns a cudaError_t.
extern "C" int paella_gumbel_categorical(const void* logits, long long ld, const void* seeds, const void* temp,
                                         void* out, int M, int K, int hw, int is_bf16, void* stream) {
  using namespace paella;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || hw < 1 || temp == nullptr) return (int)cudaErrorInvalidValue;
  const float* t = static_cast<const float*>(temp);
  if (is_bf16) return launch_gumbel<__nv_bfloat16>(logits, ld, (const int64_t*)seeds, t, (int32_t*)out, M, K, hw, st);
  return launch_gumbel<float>(logits, ld, (const int64_t*)seeds, t, (int32_t*)out, M, K, hw, st);
}

// out[i] = -log(-log u(bits[i])), the noise of the kernels' shared draw
// routine (common.cuh::gumbel_noise), for n 32-bit hash values. Returns a
// cudaError_t.
extern "C" int paella_gumbel_noise(const void* bits, void* out, int n, void* stream) {
  using namespace paella;
  if (n < 1) return (int)cudaErrorInvalidValue;
  noise_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>((const uint32_t*)bits, (float*)out, n);
  return (int)cudaGetLastError();
}
