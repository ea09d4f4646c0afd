// Fused ResBlock(+FiLM) for Hopper (sm_90a): bf16 or f32 activations, with
// float weights (K1), int8 weights (K1b weight-only) or int8 weights and int8
// activations (K1b W8A8).
//
// Replaces: paella_tpu/kernels/resblock.py::fused_resblock_stacked (the
// Pallas TPU kernel; pallas_call at resblock.py:497), which runs every
// ResBlock+TimestepBlock pair of the denoiser, 56 per forward, in its float
// mode and, with int8 fc kernels (quant.quantize_paella_int8), in its
// weight-only and W8A8 (act_quant) modes:
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
//                    bias and LayerNorm -> xn (M, C). In the channelwise-skip
//                    mode (Stable Cascade's ResBlock) the conv reads x alone
//                    and the skip row is copied beside the LN row: xn (M, 2C)
//                    = [LN(dw(x) + dw_b) | skip], and fc1 runs over K = 2C.
//   2. fc1           xn @ W1^T with a bias + GELU epilogue that writes h
//                    (M, 4C) and, for each batch item the M-tile touches,
//                    each column's f32 sum of squares over the tile's rows
//                    into a partials buffer (no atomics). The M-tiles cut
//                    every image at the same image-relative rows: absolute
//                    tiles where hw % bm == 0 or bm % hw == 0 (the
//                    flagship's 256^2 canvas), else tiles per image
//                    (tile_rows), so the GRN sums of an image do not
//                    depend on where it sits in the batch at any canvas.
//   3. grn_scale_kernel  one block per batch item: sums its partials in tile
//                    order (so the GRN scale is the same on every run, as the
//                    Pallas kernel's sequential grid makes it) -> scale (B, 4C).
//   4. fc2           (h * scale) @ W2^T with a beta@W2 + b2 + residual + FiLM
//                    epilogue. Its grid has few output tiles, so the wrapper
//                    splits K = 4C; the splits write partials that
//                    fc2_reduce_kernel sums in a fixed order before the same
//                    epilogue.
// The bf16 modes and W8A8 run phases 2 and 4 on wgmma (gemm_sm90.cuh:
// 128-row tiles, 64 or 128 wide, fed by a 6-stage cp.async ring):
// fc1_wgmma_kernel, grn_scale_kernel over 128-row tile partials, the GRN
// scale's application (grn_apply_kernel, h = round(h * scale) in place; in
// W8A8 requant_kernel) and fc2_wgmma_kernel. The wrapper picks the tile
// widths and the split count per CFG pair (kernels/resblock.py::launch_plan).
// f32 activations in the float and weight-only modes run fc1_kernel /
// fc2_kernel: 64x64 tiles on common.cuh's FMA tile product with the GRN
// scale applied as fc2's A tile is loaded.
// Rounding follows the Pallas kernel: xn and h are stored in the activation
// dtype, h is rescaled in f32 and rounded again, and every product
// accumulates in f32.
//
// Widths: the float modes take any C. xn and h (and the derived W1, W2 and
// the GRN scale) have a padded pitch, C and 4C rounded up to 8 with zero pad
// columns (kernels/resblock.py::prepare_resblock_weights pads the weights
// once), so the products run over a zero-padded K, which adds exactly
// nothing, with 16-byte aligned rows; LN and the GRN mean divide by the true
// C and 4C. x, skip, film and out keep their true pitch: where C % 8 != 0,
// fc2's epilogue stores one value at a time (a variant compiled apart, as
// kRagged is). The int8 modes keep the TPU kernel's alignment, C % 64 == 0.
//
// The int8 modes (K1b) keep those phases:
// - weight-only: W1 and W2 stay int8 codes in device memory. In bf16 the
//   products run on the bf16 wgmma ring with each B tile's codes widened to
//   bf16 (exact) in the kernel on their way into the swizzled stage
//   (GemmTile::run_codes), so no bf16 copy of a weight is made and the weight
//   bytes read are the codes'. f32 widens them into the FMA tile. The
//   epilogues apply the per-output-channel scales: fc1 acc*s1 + b1, fc2
//   (acc + beta@Wq2) * s2 + b2, as the TPU kernel does.
// - W8A8: phase 1 quantizes each LN row to s8 codes with one scale (sx);
//   fc1 and fc2 run wgmma m64nNk32 s8 x s8 -> s32 (GemmTile<BN, int8_t>: a
//   128-byte stage row holds 128 codes); fc1's epilogue is f32(acc) * (sx *
//   s1) + b1 -> GELU, written to an f32 h, and the GRN sums come from it; a
//   requant phase (requant_kernel, one block per row) takes the TPU kernel's
//   provisional codes per (row, 512-column fc1 tile), dequantizes them,
//   multiplies by the GRN scale and requantizes to one scale per row (sh2);
//   fc2's epilogue is f32(acc) * (sh2 * s2) + beta_w2 + b2 + x -> FiLM. Its
//   split-K partials are s32, exact in any order. Codes are clip(rint(v *
//   (1/s)), +-127) with s = max(amax, 1e-6) * f32(1/127), half to even,
//   every product and sum of the quantization rounded separately (no
//   contraction into fma), as the TPU kernel rounds.
// No float atomic is used anywhere, so two runs are bitwise equal, and an
// image's output does not depend on its batchmates (the split count is
// chosen per CFG pair by the wrapper).
//
// What bounds it on an H100: the two products are over 99% of a block's
// operations (16 M C^2: 13.4 G at M 2048 x C 640 and at 512 x 1280, 3.4 G
// at 128 x 1280) and read 3.3 MB (C 640) or 13.1 MB (C 1280) of bf16 weights,
// about 4000, 1000 and 260 operations per weight byte: compute-bound except
// at M 128, which sits near the card's ~295 FLOP/byte bf16 ridge; int8
// halves the weight bytes (M 128 then HBM-bound on its 6.6 MB at the int8
// rate) and W8A8 doubles the tensor-core rate. The wgmma phases reach about a
// quarter of the bf16 peak (PERF.md has the measurements and what was tried);
// a short K (10 steps at C 640) leaves the epilogue a large share of a tile.
// Weight-only pays the codes' widening in issue slots beside the products.
// W8A8's h makes an f32 round trip through memory for the requant phase
// (M 4C 4 bytes: 21 MB at M 2048 x C 640). xn and h make one round trip
// through L2/HBM, which the 50 MB L2 mostly absorbs.
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace paella {
namespace {

constexpr int BM = 64, BN = 64, BK = 32;  // the FMA tiles (f32 activations)
enum Mode { kFloat = 0, kInt8 = 1, kW8A8 = 2 };
constexpr float kInv127 = 1.0f / 127.0f;  // f32(1/127), the TPU kernel's (1.0 / 127.0)

__host__ __device__ constexpr int round8(int n) { return (n + 7) & ~7; }

// Max over the block (values >= 0; blockDim.x a multiple of 32); every
// thread gets it. `red` holds 32 floats of shared memory.
__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, o));
  return t;
}

// The TPU kernel's per-row scale and code: s = max(amax, 1e-6) * f32(1/127),
// code = clip(round(v * (1/s)), -127, 127), half to even.
__device__ __forceinline__ float row_scale(float amax) { return __fmul_rn(fmaxf(amax, 1e-6f), kInv127); }
__device__ __forceinline__ float s8_code(float v, float inv) {
  return fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
}

// Load rows [row0, row0+ROWS) x K-columns [k0, k0+BK) of an int8 row-major
// matrix (leading dimension ld) into smem[ROWS][lds] of f32, each code
// widened (exact). Rows past nrows read as zero. 16-byte vector loads: ld
// and k0 are multiples of 16 and the base pointer 16-byte aligned (the
// wrapper checks).
template <int ROWS>
__device__ __forceinline__ void load_codes_f32(float* smem, int lds, const int8_t* g, int ld, int row0, int nrows,
                                               int k0) {
  constexpr int VPR = BK / 16;
  for (int e = threadIdx.x; e < ROWS * VPR; e += kThreads) {
    const int r = e / VPR, kv = (e % VPR) * 16;
    const int m = row0 + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (m < nrows) u = *reinterpret_cast<const uint4*>(g + (size_t)m * ld + k0 + kv);
    const int8_t* pv = reinterpret_cast<const int8_t*>(&u);
    float* dst = smem + r * lds + kv;
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = (float)pv[i];
  }
}

// Phase 1: depthwise 3x3 + bias + LayerNorm of token blockIdx.x -> xn row
// (pitch C, or with kPadded pitch ldo, its columns past C zero), in the
// dtype, or (Q8) as s8 codes with the row's scale in sx. kPadded is
// compiled apart (C % 8 != 0): the flagship's widths keep the unpadded
// stores, which measured 10-20% faster than the padded form.
// With cat (the channelwise skip), the row is [LN | skip] of width 2C: the
// skip's values copied as they are, or in W8A8 quantized with the LN values
// under the one scale of the whole row.
template <typename T, bool Q8, bool kPadded>
__global__ void __launch_bounds__(kThreads) dw_ln_kernel(const T* __restrict__ x,
                                                         const T* __restrict__ skip,
                                                         const T* __restrict__ dw_w,
                                                         const T* __restrict__ dw_b,
                                                         void* __restrict__ xn_, float* __restrict__ sx,
                                                         int H, int W, int C, int ldo, int cat) {
  extern __shared__ float s_acc[];  // C floats
  __shared__ float red[32];
  const int m = blockIdx.x;
  const int hw = H * W;
  const int b = m / hw, p = m % hw, y = p / W, xq = p % W;
  const int cpg = skip != nullptr && !cat ? 2 : 1;
  const int width = cat ? 2 * C : C;
  float lsum = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= cpg) break;
      // the grouped conv over concat [x, skip] (groups = C) reads channels
      // (2c, 2c + 1) for group c
      const T* src = x;
      int ch = c;
      if (cpg == 2) {
        const int q = 2 * c + j;
        src = q < C ? x : skip;
        ch = q < C ? q : q - C;
      }
      // all nine taps load at once; a tap outside the image reads the centre
      // pixel and adds 0 * w, which leaves acc bit for bit as skipping it
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int yy = y + ky - 1;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int xx = xq + kx - 1;
          const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W;
          const float xv = to_f<T>(src[((size_t)(b * H + (in ? yy : y)) * W + (in ? xx : xq)) * C + ch]);
          acc += (in ? xv : 0.f) * to_f<T>(dw_w[((ky * 3 + kx) * cpg + j) * C + c]);
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
  if constexpr (Q8) {
    float amax = 0.f;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      s_acc[c] = (s_acc[c] - mean) * inv;  // each thread rewrites only its own columns
      amax = fmaxf(amax, fabsf(s_acc[c]));
    }
    const T* srow = cat ? skip + (size_t)m * C : nullptr;
    if (cat)
      for (int c = threadIdx.x; c < C; c += blockDim.x) amax = fmaxf(amax, fabsf(to_f<T>(srow[c])));
    const float s = row_scale(block_max(amax, red));
    const float inv_s = __fdiv_rn(1.f, s);
    int8_t* xn = static_cast<int8_t*>(xn_) + (size_t)m * width;
    for (int c = threadIdx.x; c < C; c += blockDim.x) xn[c] = (int8_t)s8_code(s_acc[c], inv_s);
    if (cat)
      for (int c = threadIdx.x; c < C; c += blockDim.x) xn[C + c] = (int8_t)s8_code(to_f<T>(srow[c]), inv_s);
    if (threadIdx.x == 0) sx[m] = s;
  } else {
    const int ld = kPadded ? ldo : width;
    T* xn = static_cast<T*>(xn_) + (size_t)m * ld;
    for (int c = threadIdx.x; c < C; c += blockDim.x) xn[c] = from_f<T>((s_acc[c] - mean) * inv);
    if (cat)
      for (int c = threadIdx.x; c < C; c += blockDim.x) xn[C + c] = skip[(size_t)m * C + c];
    if constexpr (kPadded)
      for (int c = width + threadIdx.x; c < ldo; c += blockDim.x) xn[c] = from_f<T>(0.f);
  }
}

// Rows [m0, mend) of fc1 M-tile `tile` (bm rows). tpi 0: tiles at absolute
// multiples of bm, used where they cut every image at the same image-relative
// rows (hw % bm == 0, or bm % hw == 0: each image inside one tile). Else tpi
// tiles per image, each inside its image (the last one short), so an image's
// row partition, and the order of its GRN sums, never depend on where it
// sits in the batch (kernels/resblock.py::launch_plan decides).
__device__ __forceinline__ void tile_rows(int tile, int bm, int M, int hw, int tpi, int& m0, int& mend) {
  if (tpi > 0) {
    const int b = tile / tpi;
    m0 = b * hw + (tile % tpi) * bm;
    mend = min(m0 + bm, (b + 1) * hw);
  } else {
    m0 = tile * bm;
    mend = min(m0 + bm, M);
  }
}

// The GELU input of fc1 output (row m, column n) from its product, in the
// Pallas kernel's order per mode: acc + b1 (float); acc * s1 + b1
// (weight-only); f32(acc) * (sx * s1) + b1 (W8A8, acc the s32 sum).
template <int MODE>
__device__ __forceinline__ float fc1_pre(float acc, float b1, float s1, float sx) {
  if constexpr (MODE == kW8A8) return __fadd_rn(__fmul_rn(acc, __fmul_rn(sx, s1)), b1);
  else if constexpr (MODE == kInt8) return __fadd_rn(__fmul_rn(acc, s1), b1);
  else return acc + b1;
}

__device__ __forceinline__ float gelu(float v) { return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)); }

// Phase 2 on the FMA tile (f32 activations; float and weight-only): fc1
// tile, bias + GELU epilogue, GRN partials. xn (M, K) and W1 (N, K), K the
// padded width; h (M, ldh) in the dtype, its pad columns written as the
// zeros they compute to.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) fc1_kernel(const T* __restrict__ xn, const void* __restrict__ w1_,
                                                       const T* __restrict__ b1, const float* __restrict__ s1,
                                                       T* __restrict__ h, float* __restrict__ gx_part, int M, int K,
                                                       int N, int ldh, int hw, int slots, int tpi) {
  constexpr int LDS = BK + smem_pad<T>(), LDC = BN + 4;
  __shared__ __align__(16) T As[BM * LDS];
  __shared__ __align__(16) T Bs[BN * LDS];
  __shared__ float Cs[BM * LDC];
  __shared__ float half_sq[kThreads];
  const int n0 = blockIdx.x * BN;
  int m0, mend;
  tile_rows(blockIdx.y, BM, M, hw, tpi, m0, mend);
  TileProduct<T, BM, BN> tile;
  tile.zero();
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<T, BM, BK>(As, LDS, xn, K, m0, mend, k0, K);
    if constexpr (MODE == kFloat) {
      load_tile<T, BN, BK>(Bs, LDS, static_cast<const T*>(w1_), K, n0, N, k0, K);
    } else {
      load_codes_f32<BN>(Bs, LDS, static_cast<const int8_t*>(w1_), K, n0, N, k0);
    }
    __syncthreads();
    tile.step(As, LDS, Bs, LDS, BK);
    __syncthreads();
  }
  tile.store(Cs, LDC);
  __syncthreads();
  // epilogue: one column per thread, rows strided by kThreads / BN; the f32
  // GELU output replaces the product in Cs for the GRN statistics
  const int c = threadIdx.x % BN, n = n0 + c;
  const bool col = n < N;  // a ragged last column tile (narrow widths)
  const float bias = col ? to_f<T>(b1[n]) : 0.f;
  const float s1n = MODE == kFloat || !col ? 1.f : s1[n];
  for (int r = threadIdx.x / BN; r < BM; r += kThreads / BN) {
    const int m = m0 + r;
    if (m >= mend) break;
    const float v = gelu(fc1_pre<MODE>(Cs[r * LDC + c], bias, s1n, 0.f));
    if (n < ldh) h[(size_t)m * ldh + n] = from_f<T>(v);
    Cs[r * LDC + c] = v;
  }
  __syncthreads();
  // GRN statistics from the f32 values, before rounding, one partial per
  // batch item the tile touches, at slot (tile, batch item - the tile's first
  // batch item). A tile inside one batch item (every tile at the flagship's
  // shapes, and every tile with tpi): two threads per column sum rows [0, 32)
  // and [32, 64), added in that order. Otherwise (images of fewer than 64
  // rows, each inside this tile) one thread per column walks the rows in order.
  const int first_b = m0 / hw, rows = mend - m0;
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
    if (threadIdx.x < BN && col) gx_part[(size_t)blockIdx.y * slots * N + n] = half_sq[c] + half_sq[BN + c];
  } else if (threadIdx.x < BN && col) {
    float* part = gx_part + (size_t)blockIdx.y * slots * N + n;
    int cur_b = first_b;
    float sq = 0.f;
    for (int r = 0; r < rows; ++r) {
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

// Phase 2 on wgmma (gemm_sm90.cuh), every mode with bf16 activations and
// W8A8 with either: one 128 x BN tile of xn @ W1^T (bf16 products; the
// weight-only codes widened in the kernel; s8 products in W8A8), then the
// mode's scales, bias and GELU from the accumulators, staged in shared memory
// as f32 to store h coalesced (rounded to bf16; f32 in W8A8, for the requant
// phase) and to take each column's GRN sum of squares over the tile's rows
// in a fixed order: where every 32-row segment of the tile lies inside one
// image (hw a multiple of 32, as at the flagship's shapes, or tpi tiles per
// image), the segments are summed row by row and then added segment by
// segment per image; otherwise (images of fewer than 32 rows, each inside
// this tile) one thread per column walks the rows in order. One partial per
// image the tile touches, at slot (tile, image - the tile's first image), as
// fc1_kernel writes them for 64-row tiles. xn (M, K) and W1 (N, K), K the
// padded width; h (M, ldh), its pad columns written as the zeros they
// compute to.
template <int BN, bool kRagged, int MODE, typename T>
__global__ void __launch_bounds__(sm90::kGemmThreads, 1) fc1_wgmma_kernel(
    const void* __restrict__ xn, const void* __restrict__ w1, const T* __restrict__ b1, const float* __restrict__ s1,
    const float* __restrict__ sx, void* __restrict__ h, float* __restrict__ gx_part, int M, int K, int N, int ldh,
    int hw, int slots, int tpi) {
  constexpr int LDC = BN + 4, kSeg = 32, kSegs = sm90::kBM / kSeg;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const int n0 = blockIdx.x * BN;
  int m0, mend;
  tile_rows(blockIdx.y, sm90::kBM, M, hw, tpi, m0, mend);
  const int rows = mend - m0;
  const int ncols = kRagged ? min(BN, N - n0) : BN;  // fewer in a ragged last column tile
  float* Cs = reinterpret_cast<float*>(smem);  // [128][LDC], over the drained ring
  float* seg = Cs + sm90::kBM * LDC;            // [kSegs][BN]
  auto epilogue = [&](int r, int c, float acc) {
    const bool in = c < ncols;
    const float bias = in ? to_f<T>(b1[n0 + c]) : 0.f;
    const float s1n = MODE == kFloat || !in ? 1.f : s1[n0 + c];
    const float sxm = MODE == kW8A8 && r < rows ? sx[m0 + r] : 0.f;
    Cs[r * LDC + c] = gelu(fc1_pre<MODE>(acc, bias, s1n, sxm));
  };
  if constexpr (MODE == kW8A8) {
    sm90::GemmTile<BN, int8_t> tile;
    tile.template run<kRagged>(smem, static_cast<const int8_t*>(xn), static_cast<const int8_t*>(w1), K, mend, N, K,
                               m0, n0, 0, (K + tile.kK - 1) / tile.kK);
    tile.for_each([&](int r, int c, int acc) { epilogue(r, c, (float)acc); });
  } else if constexpr (MODE == kInt8) {
    sm90::GemmTile<BN> tile;
    tile.run_codes(smem, static_cast<const bf16*>(xn), static_cast<const int8_t*>(w1), K, mend, m0, n0, 0,
                   K / sm90::kBK);
    tile.for_each(epilogue);
  } else {
    sm90::GemmTile<BN> tile;
    tile.template run<kRagged>(smem, static_cast<const bf16*>(xn), static_cast<const bf16*>(w1), K, mend, N, K, m0,
                               n0, 0, (K + sm90::kBK - 1) / sm90::kBK);
    tile.for_each(epilogue);
  }
  __syncthreads();
  const int first_b = m0 / hw, last_b = (m0 + rows - 1) / hw;
  for (int e = threadIdx.x; e < sm90::kBM * (BN / 8); e += blockDim.x) {
    const int r = e / (BN / 8), c = (e % (BN / 8)) * 8;
    if (r >= rows) break;
    if (c >= ncols) continue;
    const float* src = Cs + r * LDC + c;
    if constexpr (MODE == kW8A8) {
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(h) + (size_t)(m0 + r) * ldh + n0 + c);
      dst[0] = *reinterpret_cast<const float4*>(src);
      dst[1] = *reinterpret_cast<const float4*>(src + 4);
    } else {
      uint4 u;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
      *reinterpret_cast<uint4*>(static_cast<bf16*>(h) + (size_t)(m0 + r) * ldh + n0 + c) = u;
    }
  }
  float* part = gx_part + (size_t)blockIdx.y * slots * N + n0;
  if (tpi > 0 || hw % kSeg == 0) {
    for (int e = threadIdx.x; e < kSegs * BN; e += blockDim.x) {
      const int s = e / BN, c = e % BN;
      float sq = 0.f;
      for (int r = s * kSeg; r < min((s + 1) * kSeg, rows); ++r) {
        const float v = Cs[r * LDC + c];
        sq += v * v;
      }
      seg[s * BN + c] = sq;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < (last_b - first_b + 1) * BN; e += blockDim.x) {
      const int slot = e / BN, c = e % BN;
      if (c >= ncols) continue;
      float g = 0.f;
#pragma unroll
      for (int s = 0; s < kSegs; ++s)
        if (s * kSeg < rows && (m0 + s * kSeg) / hw == first_b + slot) g += seg[s * BN + c];
      part[(size_t)slot * N + c] = g;
    }
  } else if (threadIdx.x < ncols) {
    const int c = threadIdx.x;
    int cur_b = first_b;
    float sq = 0.f;
    for (int r = 0; r < rows; ++r) {
      const int bi = (m0 + r) / hw;
      if (bi != cur_b) {
        part[(size_t)(cur_b - first_b) * N + c] = sq;
        cur_b = bi;
        sq = 0.f;
      }
      const float v = Cs[r * LDC + c];
      sq += v * v;
    }
    part[(size_t)(cur_b - first_b) * N + c] = sq;
  }
}

// One block of 1024 threads per batch item b: each column's gx = sum of its
// partials, tile by tile in order (tiles of bm rows, absolute or tpi per
// image as tile_rows cuts them), kept in shared memory (N floats), then the
// GRN scale gamma * gx / (mean_N gx + 1e-6) + 1, at pitch N (kPadded: ld,
// its pad columns 0).
template <bool kPadded>
__global__ void __launch_bounds__(1024) grn_scale_kernel(const float* __restrict__ gx_part,
                                                         const float* __restrict__ gamma,
                                                         float* __restrict__ scale, int N, int ld, int hw,
                                                         int slots, int bm, int tpi) {
  extern __shared__ float s_norm[];
  __shared__ float red[32];
  const int b = blockIdx.x;
  const int t0 = tpi > 0 ? b * tpi : b * hw / bm, t1 = tpi > 0 ? t0 + tpi - 1 : ((b + 1) * hw - 1) / bm;
  float s = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float g = 0.f;
#pragma unroll 4
    for (int t = t0; t <= t1; ++t) g += gx_part[((size_t)t * slots + (tpi > 0 ? 0 : b - t * bm / hw)) * N + n];
    s_norm[n] = sqrtf(g);
    s += s_norm[n];
  }
  const float denom = block_sum(s, red) / N + 1e-6f;
  const int pitch = kPadded ? ld : N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) scale[(size_t)b * pitch + n] = gamma[n] * (s_norm[n] / denom) + 1.f;
  if constexpr (kPadded)
    for (int n = N + threadIdx.x; n < ld; n += blockDim.x) scale[(size_t)b * ld + n] = 0.f;
}

// W8A8 phase 3b, one block per row m of h (f32, N = 4C wide): the TPU
// kernel's provisional codes per `group`-column fc1 tile, dequantized and
// multiplied by the GRN scale (resblock.py:252-266), then requantized to one
// scale per row: hq (s8) and sh2.
__global__ void __launch_bounds__(256) requant_kernel(const float* __restrict__ h,
                                                      const float* __restrict__ scale,
                                                      int8_t* __restrict__ hq, float* __restrict__ sh2,
                                                      int N, int hw, int group) {
  extern __shared__ float s_deq[];  // N floats; block_max's barrier orders the writes before the reads
  __shared__ float red[32];
  const int m = blockIdx.x;
  const float* row = h + (size_t)m * N;
  const float* sc = scale + (size_t)(m / hw) * N;
  float rmax = 0.f;
  for (int g0 = 0; g0 < N; g0 += group) {
    float gmax = 0.f;
    for (int n = g0 + threadIdx.x; n < g0 + group; n += blockDim.x) gmax = fmaxf(gmax, fabsf(row[n]));
    const float s = row_scale(block_max(gmax, red));
    const float inv = __fdiv_rn(1.f, s);
    for (int n = g0 + threadIdx.x; n < g0 + group; n += blockDim.x) {
      const float d = __fmul_rn(__fmul_rn(s8_code(row[n], inv), s), sc[n]);
      s_deq[n] = d;
      rmax = fmaxf(rmax, fabsf(d));
    }
  }
  const float s = row_scale(block_max(rmax, red));
  const float inv = __fdiv_rn(1.f, s);
  for (int n = threadIdx.x; n < N; n += blockDim.x) hq[(size_t)m * N + n] = (int8_t)s8_code(s_deq[n], inv);
  if (threadIdx.x == 0) sh2[m] = s;
}

// y from the full fc2 sum of output (m, n), then + b2 + x and FiLM, in the
// Pallas kernel's order per mode: acc + beta@W2 (float); (acc + beta@Wq2) *
// s2 (weight-only); acc * (sh2 * s2) + beta_w2 (W8A8, acc the f32 of the
// s32 sum).
template <typename T, int MODE>
__device__ __forceinline__ T fc2_finish(float acc, int m, int n, int N, int hw,
                                        const float* __restrict__ bw2, const float* __restrict__ s2,
                                        const float* __restrict__ sh2, const T* __restrict__ b2,
                                        const T* __restrict__ x, const T* __restrict__ film) {
  float v;
  if constexpr (MODE == kW8A8) {
    v = __fadd_rn(__fmul_rn(acc, __fmul_rn(sh2[m], s2[n])), bw2[n]);
  } else if constexpr (MODE == kInt8) {
    v = __fmul_rn(__fadd_rn(acc, bw2[n]), s2[n]);
  } else {
    v = acc + bw2[n];
  }
  v = v + to_f<T>(b2[n]);
  v = v + to_f<T>(x[(size_t)m * N + n]);
  if (film != nullptr) {
    const T* f = film + (size_t)(m / hw) * 2 * N;
    v = v * (1.f + to_f<T>(f[n])) + to_f<T>(f[N + n]);
  }
  return from_f<T>(v);
}

struct Fc2Args {
  const void* h;  // (M, K): the dtype (scaled by the GRN already, or as the FMA tile's A loads) or s8 codes (W8A8)
  const float* scale;
  const void* w2;
  const float* bw2;
  const float* s2;
  const float* sh2;
  const void* b2;
  const void* x;
  const void* film;
  void* out;
  float* part;  // split-K partials: f32, or s32 in W8A8
};

// fc2 on the FMA tile (f32 activations; float and weight-only) over the K
// range of split blockIdx.z (k_split columns); K is the padded width, the
// pitch of h, W2 and the GRN scale. With one split the epilogue runs here;
// with several, each writes its partial tile to part[z] and
// fc2_reduce_kernel sums the splits in a fixed order (no atomics, so the
// result does not depend on block timing).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) fc2_kernel(Fc2Args a, int M, int K, int N, int hw, int k_split) {
  constexpr int LDS = BK + smem_pad<T>(), LDC = BN + 4;
  __shared__ __align__(16) T As[BM * LDS];
  __shared__ __align__(16) T Bs[BN * LDS];
  __shared__ float Cs[BM * LDC];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_split;
  const T* h = static_cast<const T*>(a.h);
  TileProduct<T, BM, BN> tile;
  tile.zero();
  for (int k0 = kb; k0 < kb + k_split; k0 += BK) {
    load_tile<T, BM, BK>(As, LDS, h, K, m0, M, k0, K, a.scale, K, hw);  // GRN scale as A loads
    if constexpr (MODE == kFloat) {
      load_tile<T, BN, BK>(Bs, LDS, static_cast<const T*>(a.w2), K, n0, N, k0, K);
    } else {
      load_codes_f32<BN>(Bs, LDS, static_cast<const int8_t*>(a.w2), K, n0, N, k0);
    }
    __syncthreads();
    tile.step(As, LDS, Bs, LDS, BK);
    __syncthreads();
  }
  tile.store(Cs, LDC);
  __syncthreads();
  const int c = threadIdx.x % BN, n = n0 + c;
  if (n >= N) return;  // a ragged last column tile (narrow widths)
  for (int r = threadIdx.x / BN; r < BM; r += kThreads / BN) {
    const int m = m0 + r;
    if (m >= M) break;
    const size_t i = (size_t)m * N + n;
    if (a.part != nullptr) {
      a.part[(size_t)blockIdx.z * M * N + i] = Cs[r * LDC + c];
    } else {
      static_cast<T*>(a.out)[i] = fc2_finish<T, MODE>(Cs[r * LDC + c], m, n, N, hw, a.bw2, a.s2, a.sh2,
                                                      static_cast<const T*>(a.b2), static_cast<const T*>(a.x),
                                                      static_cast<const T*>(a.film));
    }
  }
}

template <typename T, int MODE>
__global__ void fc2_reduce_kernel(Fc2Args a, int splits, int M, int N, int hw) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  float acc;
  if constexpr (MODE == kW8A8) {
    const int* part = reinterpret_cast<const int*>(a.part);
    int s = part[i];
    for (int z = 1; z < splits; ++z) s += part[(size_t)z * M * N + i];
    acc = (float)s;
  } else {
    acc = a.part[i];
    for (int z = 1; z < splits; ++z) acc += a.part[(size_t)z * M * N + i];
  }
  static_cast<T*>(a.out)[i] = fc2_finish<T, MODE>(acc, (int)(i / N), (int)(i % N), N, hw, a.bw2, a.s2, a.sh2,
                                                  static_cast<const T*>(a.b2), static_cast<const T*>(a.x),
                                                  static_cast<const T*>(a.film));
}

// bf16 float and weight-only modes, between the GRN scale and fc2: h =
// round(h * scale[b]) in place, in f32 and rounded to bf16 (load_tile's
// row_scale arithmetic), 8 values a thread; h and the scale have pitch N.
// wgmma reads its operands from shared memory as the copy ring lands them,
// so the scale cannot ride on the A tile's load.
__global__ void __launch_bounds__(256) grn_apply_kernel(__nv_bfloat16* __restrict__ h, const float* __restrict__ scale,
                                                         int M, int N, int hw) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= (size_t)M * N) return;
  const int m = (int)(i / N), k = (int)(i % N);
  uint4 u = *reinterpret_cast<const uint4*>(h + i);
  const float4* s = reinterpret_cast<const float4*>(scale + (size_t)(m / hw) * N + k);
  const float4 s0 = s[0], s1 = s[1];
  const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = __float2bfloat16_rn(__bfloat162float(p[j]) * sv[j]);
  *reinterpret_cast<uint4*>(h + i) = u;
}

// Phase 4 on wgmma: one 128 x BN tile of h @ W2^T over the K range of split
// blockIdx.z (h already scaled: bf16 products, the weight-only codes widened
// in the kernel; s8 codes hq and s8 products in W8A8), K the padded width
// (the pitch of h and W2); then the epilogue as fc2_kernel's: fc2_finish with
// one split, else the partial (f32, or s32 in W8A8) to part[z] for
// fc2_reduce_kernel. kScalarOut: C % 8 != 0, so out and the partials, at the
// true pitch, are stored one value at a time.
template <int BN, bool kRagged, int MODE, typename T, bool kScalarOut>
__global__ void __launch_bounds__(sm90::kGemmThreads, 1) fc2_wgmma_kernel(Fc2Args a, int M, int K, int N, int hw,
                                                                          int k_split) {
  using bf16 = __nv_bfloat16;
  constexpr int LDC = BN + 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align1024(smem_raw);
  const int m0 = blockIdx.y * sm90::kBM, n0 = blockIdx.x * BN, kb = blockIdx.z * k_split;
  float* Cs = reinterpret_cast<float*>(smem);  // f32 sums, or the s32 sums' bits in W8A8
  if constexpr (MODE == kW8A8) {
    sm90::GemmTile<BN, int8_t> tile;
    tile.template run<kRagged>(smem, static_cast<const int8_t*>(a.h), static_cast<const int8_t*>(a.w2), K, M, N, K,
                               m0, n0, kb, (k_split + tile.kK - 1) / tile.kK);
    tile.for_each([&](int r, int c, int v) { reinterpret_cast<int*>(Cs)[r * LDC + c] = v; });
  } else if constexpr (MODE == kInt8) {
    sm90::GemmTile<BN> tile;
    tile.run_codes(smem, static_cast<const bf16*>(a.h), static_cast<const int8_t*>(a.w2), K, M, m0, n0, kb,
                   k_split / sm90::kBK);
    tile.for_each([&](int r, int c, float v) { Cs[r * LDC + c] = v; });
  } else {
    sm90::GemmTile<BN> tile;
    tile.template run<kRagged>(smem, static_cast<const bf16*>(a.h), static_cast<const bf16*>(a.w2), K, M, N, K, m0,
                               n0, kb, (k_split + sm90::kBK - 1) / sm90::kBK);
    tile.for_each([&](int r, int c, float v) { Cs[r * LDC + c] = v; });
  }
  __syncthreads();
  // 8 consecutive outputs a thread, their loads independent of each other
  for (int e = threadIdx.x; e < sm90::kBM * (BN / 8); e += blockDim.x) {
    const int r = e / (BN / 8), c = (e % (BN / 8)) * 8, m = m0 + r;
    if (m >= M) break;
    if (kRagged && n0 + c >= N) continue;
    const size_t i = (size_t)m * N + n0 + c;
    if constexpr (kScalarOut) {  // the float mode at C % 8 != 0
      for (int j = 0; j < 8 && n0 + c + j < N; ++j) {
        const float v = Cs[r * LDC + c + j];
        if (a.part != nullptr) a.part[(size_t)blockIdx.z * M * N + i + j] = v;
        else static_cast<T*>(a.out)[i + j] = fc2_finish<T, MODE>(v, m, n0 + c + j, N, hw, a.bw2, a.s2, a.sh2,
                                                                 static_cast<const T*>(a.b2), static_cast<const T*>(a.x),
                                                                 static_cast<const T*>(a.film));
      }
      continue;
    }
    const uint4 v0 = *reinterpret_cast<const uint4*>(Cs + r * LDC + c);
    const uint4 v1 = *reinterpret_cast<const uint4*>(Cs + r * LDC + c + 4);
    if (a.part != nullptr) {  // the 32 bytes as they are: f32 sums or s32 bits
      uint4* dst = reinterpret_cast<uint4*>(a.part + (size_t)blockIdx.z * M * N + i);
      dst[0] = v0;
      dst[1] = v1;
    } else {
      const uint32_t bits[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      uint4 u[sizeof(T) / 2];  // 8 outputs
      T* o = reinterpret_cast<T*>(u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = MODE == kW8A8 ? (float)(int)bits[j] : __uint_as_float(bits[j]);
        o[j] = fc2_finish<T, MODE>(v, m, n0 + c + j, N, hw, a.bw2, a.s2, a.sh2, static_cast<const T*>(a.b2),
                                   static_cast<const T*>(a.x), static_cast<const T*>(a.film));
      }
#pragma unroll
      for (int j = 0; j < (int)sizeof(T) / 2; ++j) reinterpret_cast<uint4*>(static_cast<T*>(a.out) + i)[j] = u[j];
    }
  }
}

struct Args {
  const void *x, *skip, *dw_w, *dw_b, *w1, *b1;
  const float *gamma;
  const void* w2;
  const float* bw2;
  const void *b2, *film;
  const float *s1, *s2;
  void *out, *xn, *h;
  float *gx_part, *scale, *part, *sx;
  int8_t* hq;
  float* sh2;
  int slots, splits, B, H, W, C, group, bn1, bn2, tpi, cat;
};

// fc1's depth: the width of an xn row, C or (channelwise skip) 2C, before
// its padding to the pitch K1 = round8(width).
inline int fc1_width(const Args& a) { return a.cat ? 2 * a.C : a.C; }

// fc1's M-tiles of bm rows: tpi per image, or absolute (tile_rows).
inline int fc1_tiles(const Args& a, int bm) {
  return a.tpi > 0 ? a.B * a.tpi : (a.B * a.H * a.W + bm - 1) / bm;
}

// Phase 1 and the GRN scale, in their padded variants only where the pitch
// (K1 or K2) exceeds the width.
template <typename T, bool Q8>
cudaError_t launch_dw_ln(const Args& a, int M, int K1, cudaStream_t st) {
  const auto kernel = K1 != fc1_width(a) ? dw_ln_kernel<T, Q8, true> : dw_ln_kernel<T, Q8, false>;
  kernel<<<M, kThreads, a.C * sizeof(float), st>>>((const T*)a.x, (const T*)a.skip, (const T*)a.dw_w,
                                                     (const T*)a.dw_b, a.xn, a.sx, a.H, a.W, a.C, K1, a.cat);
  return cudaGetLastError();
}

inline cudaError_t launch_grn_scale(const Args& a, int N1, int K2, int hw, int bm, cudaStream_t st) {
  const auto kernel = K2 != N1 ? grn_scale_kernel<true> : grn_scale_kernel<false>;
  kernel<<<a.B, 1024, N1 * sizeof(float), st>>>(a.gx_part, a.gamma, a.scale, N1, K2, hw, a.slots, bm, a.tpi);
  return cudaGetLastError();
}

template <int BN, bool kRagged, int MODE, typename T>
cudaError_t fc1_at(const Args& a, int M, int K, int N1, int ldh, int hw, cudaStream_t st) {
  constexpr auto kernel = fc1_wgmma_kernel<BN, kRagged, MODE, T>;
  constexpr int smem = MODE == kInt8 ? sm90::GemmTile<BN>::kSmemCodes : sm90::GemmTile<BN>::kSmem;
  cudaError_t err = sm90::reserve_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((N1 + BN - 1) / BN, fc1_tiles(a, sm90::kBM)), sm90::kGemmThreads, smem, st>>>(
      a.xn, a.w1, (const T*)a.b1, a.s1, a.sx, a.h, a.gx_part, M, K, N1, ldh, hw, a.slots, a.tpi);
  return cudaGetLastError();
}

template <int BN, bool kRagged, int MODE, typename T, bool kScalarOut = false>
cudaError_t fc2_at(const Fc2Args& f, int M, int K, int C, int hw, int splits, cudaStream_t st) {
  constexpr auto kernel = fc2_wgmma_kernel<BN, kRagged, MODE, T, kScalarOut>;
  constexpr int smem = MODE == kInt8 ? sm90::GemmTile<BN>::kSmemCodes : sm90::GemmTile<BN>::kSmem;
  cudaError_t err = sm90::reserve_smem<kernel>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((C + BN - 1) / BN, (M + sm90::kBM - 1) / sm90::kBM, splits), sm90::kGemmThreads, smem, st>>>(
      f, M, K, C, hw, K / splits);
  return cudaGetLastError();
}

// fc1 at the plan's width, in the tile variant its widths need: ragged where
// K or N leaves a partial tile. Weight-only's codes need whole tiles, which
// its widths (C % 64 == 0) give.
template <int MODE, typename T>
cudaError_t launch_fc1(const Args& a, int M, int K, int N1, int ldh, int hw, cudaStream_t st) {
  constexpr int kK = MODE == kW8A8 ? 128 : sm90::kBK;
  const bool ragged = K % kK || N1 % a.bn1;
  if constexpr (MODE == kInt8) {
    if (ragged) return cudaErrorInvalidValue;
    return a.bn1 == 128 ? fc1_at<128, false, MODE, T>(a, M, K, N1, ldh, hw, st)
                        : fc1_at<64, false, MODE, T>(a, M, K, N1, ldh, hw, st);
  } else {
    if (a.bn1 == 128)
      return ragged ? fc1_at<128, true, MODE, T>(a, M, K, N1, ldh, hw, st)
                    : fc1_at<128, false, MODE, T>(a, M, K, N1, ldh, hw, st);
    return ragged ? fc1_at<64, true, MODE, T>(a, M, K, N1, ldh, hw, st)
                  : fc1_at<64, false, MODE, T>(a, M, K, N1, ldh, hw, st);
  }
}

// fc2 likewise; the int8 modes' widths never leave a partial fc2 tile, and
// only the float mode takes C % 8 != 0 (kScalarOut).
template <int MODE, typename T>
cudaError_t launch_fc2(const Args& a, const Fc2Args& f, int M, int K, int C, int hw, cudaStream_t st) {
  constexpr int kK = MODE == kW8A8 ? 128 : sm90::kBK;
  const bool ragged = K % kK || C % a.bn2;
  if constexpr (MODE != kFloat) {
    if (ragged) return cudaErrorInvalidValue;
    return a.bn2 == 128 ? fc2_at<128, false, MODE, T>(f, M, K, C, hw, a.splits, st)
                        : fc2_at<64, false, MODE, T>(f, M, K, C, hw, a.splits, st);
  } else {
    if (C % 8)
      return a.bn2 == 128 ? fc2_at<128, true, MODE, T, true>(f, M, K, C, hw, a.splits, st)
                          : fc2_at<64, true, MODE, T, true>(f, M, K, C, hw, a.splits, st);
    if (a.bn2 == 128)
      return ragged ? fc2_at<128, true, MODE, T>(f, M, K, C, hw, a.splits, st)
                    : fc2_at<128, false, MODE, T>(f, M, K, C, hw, a.splits, st);
    return ragged ? fc2_at<64, true, MODE, T>(f, M, K, C, hw, a.splits, st)
                  : fc2_at<64, false, MODE, T>(f, M, K, C, hw, a.splits, st);
  }
}

// The wgmma path (every bf16 mode, and W8A8 at either dtype): dw+LN, fc1 on
// wgmma (128-row tiles, bn1 wide), the GRN scale over 128-row tile partials,
// its application to h (in place; W8A8 requantizes h instead), fc2 on wgmma
// (bn2 wide, `splits` K splits of whole K steps) and, with splits, the
// fixed-order reduce. bn1, bn2, splits and tpi come from
// kernels/resblock.py::launch_plan. K1 = round8(C) (round8(2C) with the
// channelwise skip), K2 = round8(4C): the padded pitches of xn and h.
template <typename T, int MODE>
int launch_wgmma(const Args& a, cudaStream_t st) {
  constexpr bool Q8 = MODE == kW8A8;
  const int hw = a.H * a.W, M = a.B * hw, C = a.C, N1 = 4 * C, K1 = round8(fc1_width(a)), K2 = round8(N1);
  const int step = Q8 ? 128 : sm90::kBK;
  const bool tiles_ok = (a.bn1 == 64 || a.bn1 == 128) && (a.bn2 == 64 || a.bn2 == 128) && a.splits >= 1 &&
                        (a.splits == 1 || K2 % (a.splits * step) == 0);
  if (!tiles_ok) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = launch_dw_ln<T, Q8>(a, M, K1, st)) != cudaSuccess) return (int)err;
  if ((err = launch_fc1<MODE, T>(a, M, K1, N1, K2, hw, st)) != cudaSuccess) return (int)err;
  if ((err = launch_grn_scale(a, N1, K2, hw, sm90::kBM, st)) != cudaSuccess) return (int)err;
  if constexpr (Q8) {
    requant_kernel<<<M, 256, N1 * sizeof(float), st>>>((const float*)a.h, a.scale, a.hq, a.sh2, N1, hw, a.group);
  } else {
    const size_t vecs = (size_t)M * K2 / 8;
    grn_apply_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, st>>>((__nv_bfloat16*)a.h, a.scale, M, K2, hw);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  Fc2Args f{Q8 ? (const void*)a.hq : (const void*)a.h, a.scale, a.w2, a.bw2, a.s2, a.sh2, a.b2, a.x, a.film,
            a.out, a.splits > 1 ? a.part : nullptr};
  err = launch_fc2<MODE, T>(a, f, M, K2, C, hw, st);
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  fc2_reduce_kernel<T, MODE><<<(M * C + 255) / 256, 256, 0, st>>>(f, a.splits, M, C, hw);
  return (int)cudaGetLastError();
}

// f32 activations, float and weight-only modes: the same phases on the FMA
// tiles (64-row fc1 tiles; fc2 splits of whole 32-deep K tiles).
template <typename T, int MODE>
int launch_fma(const Args& a, cudaStream_t st) {
  const int hw = a.H * a.W, M = a.B * hw, C = a.C, N1 = 4 * C, K1 = round8(fc1_width(a)), K2 = round8(N1);
  if (a.splits < 1 || (a.splits > 1 && (K2 % a.splits || (K2 / a.splits) % BK))) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = launch_dw_ln<T, false>(a, M, K1, st)) != cudaSuccess) return (int)err;
  fc1_kernel<T, MODE><<<dim3((N1 + BN - 1) / BN, fc1_tiles(a, BM)), kThreads, 0, st>>>(
      (const T*)a.xn, a.w1, (const T*)a.b1, a.s1, (T*)a.h, a.gx_part, M, K1, N1, K2, hw, a.slots, a.tpi);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_grn_scale(a, N1, K2, hw, BM, st)) != cudaSuccess) return (int)err;
  Fc2Args f{a.h, a.scale, a.w2, a.bw2, a.s2, a.sh2, a.b2, a.x, a.film, a.out, a.splits > 1 ? a.part : nullptr};
  fc2_kernel<T, MODE><<<dim3((C + BN - 1) / BN, (M + BM - 1) / BM, a.splits), kThreads, 0, st>>>(f, M, K2, C, hw,
                                                                                                 K2 / a.splits);
  if ((err = cudaGetLastError()) != cudaSuccess || a.splits == 1) return (int)err;
  fc2_reduce_kernel<T, MODE><<<(M * C + 255) / 256, 256, 0, st>>>(f, a.splits, M, C, hw);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace paella

// C interface for ctypes. Shapes: x, skip, out (B,H,W,C); dw_w (3,3,cpg,C);
// dw_b, b2 (C); w1 (4C,K1); b1 (4C); gamma (4C) f32; w2 (C,K2); bw2 (C) f32;
// film (B,2C) [a | b]; with K1 = C and K2 = 4C each rounded up to a multiple
// of 8 (zero pad columns in w1 and w2). Scratch: xn (B*H*W, K1), h (B*H*W,
// K2), gx_part (fc1 tiles * slots, 4C) f32 with fc1 tiles B*tpi (tpi > 0: tpi
// bm-row tiles per image) or ceil(B*H*W / bm) (tpi 0: absolute tiles) and
// slots the most batch items one tile touches (bm 128 on the wgmma path:
// every bf16 mode and W8A8; 64 on the FMA path: f32 float and weight-only),
// scale (B, K2) f32, and with splits > 1 part (splits, B*H*W, C) f32, the fc2
// split-K partials (K2 / splits a whole number of K steps: 32 deep on the
// FMA path, 64 bf16 or 128 s8 codes on the wgmma path). bn1, bn2: the wgmma
// path's fc1 and fc2 tile widths (64 or 128); the FMA path ignores them.
// mode 0 (float): w1, w2, xn and h in the dtype; s1, s2, sx, hq, sh2 null.
// mode 1 (weight-only int8): w1, w2 int8 codes with f32 scales s1 (4C), s2
// (C). mode 2 (W8A8): as mode 1, plus xn int8 with sx (B*H*W) f32, h f32,
// hq (B*H*W, 4C) int8 and sh2 (B*H*W) f32, and h's provisional codes taken
// per `group` columns (4C % group == 0). skip and film may be null. Any C in
// float mode; C % 64 == 0 in the int8 modes. cat 1 is the channelwise skip:
// dw_w (3,3,1,C), w1 (4C, round8(2C)) (int8: (4C, 2C)), xn (B*H*W,
// round8(2C)), skip not null. Returns a cudaError_t.
extern "C" int paella_resblock(const void* x, const void* skip, const void* dw_w, const void* dw_b,
                               const void* w1, const void* b1, const void* gamma, const void* w2,
                               const void* bw2, const void* b2, const void* film, const void* s1,
                               const void* s2, void* out, void* xn, void* h, void* gx_part, void* scale,
                               void* part, void* sx, void* hq, void* sh2, int slots, int splits, int B,
                               int H, int W, int C, int is_bf16, int mode, int group, int bn1, int bn2,
                               int tpi, int cat, void* stream) {
  using namespace paella;
  using bf16 = __nv_bfloat16;
  const Args a{x, skip, dw_w, dw_b, w1, b1, (const float*)gamma, w2, (const float*)bw2, b2, film,
               (const float*)s1, (const float*)s2, out, xn, h, (float*)gx_part, (float*)scale,
               (float*)part, (float*)sx, (int8_t*)hq, (float*)sh2, slots, splits, B, H, W, C, group, bn1, bn2, tpi,
               cat};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((mode != kFloat && C % 64) || mode < kFloat || mode > kW8A8 || (cat && skip == nullptr))
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    switch (mode) {
      case kFloat: return launch_wgmma<bf16, kFloat>(a, st);
      case kInt8: return launch_wgmma<bf16, kInt8>(a, st);
      default: return launch_wgmma<bf16, kW8A8>(a, st);
    }
  }
  switch (mode) {  // f32: the FMA tiles, and the s8 products on wgmma
    case kFloat: return launch_fma<float, kFloat>(a, st);
    case kInt8: return launch_fma<float, kInt8>(a, st);
    default: return launch_wgmma<float, kW8A8>(a, st);
  }
}
