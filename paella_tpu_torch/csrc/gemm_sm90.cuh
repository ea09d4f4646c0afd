// A tile product for Hopper (sm_90a) on wgmma, fed by a cp.async ring:
// C[128][BN] = A[128 rows][K range] * B[BN rows][K range]^T with both
// operands K-contiguous as they lie in device memory (A the activations
// (M, K), B a torch Linear weight (N, K)), in one of three element forms:
//   bf16 x bf16 -> f32   GemmTile<BN>::run: K1's and K6's bf16 products
//   s8 x s8 -> s32       GemmTile<BN, int8_t>::run: K1b's W8A8 products
//   bf16 x s8 codes      GemmTile<BN>::run_codes: K1b's weight-only products,
//                        the codes widened to bf16 (exactly) in the kernel
//
// Block: 256 threads, two warpgroups; warpgroup w owns rows [64w, 64w + 64)
// of the tile and issues wgmma.mma_async m64nBNk16 (bf16) or m64nBNk32 (s8),
// A and B from shared memory, into BN/2 accumulator registers a thread (f32
// or s32). Integer wgmma has no transpose operand, so both operands are
// K-major, as the port stores them.
//
// Shared memory: a ring of kStages stages, each a 128-row A tile and a
// BN-row B tile of 128-byte rows (64 bf16 or 128 s8 codes: one K step; 192 KB
// at BN 128). A row is stored with the 128-byte swizzle wgmma's descriptors
// name (16-byte chunk c of row r at chunk c ^ (r % 8); 8-row groups 1024 bytes
// apart), so the tensor cores read it without bank conflicts; the layout and
// the descriptors are the same byte for byte for both element types, and a
// 32-byte k-slice is 16 bf16 or 32 s8 codes. Each thread copies its share of
// a stage with 16-byte cp.async.cg (L2 only) straight to the swizzled
// addresses; rows past M or N and 16-byte chunks past K are zero-filled by
// the copy itself (src-size 0), so ragged tiles (K6's row counts, the narrow
// widths' K % 64 != 0) need no other care.
//
// Why cp.async and not TMA: the operands are a few MB and every call gets
// new scratch tensors (xn, h), so TMA would need a tensor map encoded on the
// host per call with cuTensorMapEncodeTiled (libcuda, linked with -lcuda),
// while cp.async needs nothing beyond the pointers the kernels already take.
// TMA would free the copy's issue slots; at 128 x BN x 64 tiles those are a
// small share of a k-step (8 or 6 copies a thread).
//
// The ring: stages k+1 .. k+kStages-2 are in flight while the tensor cores
// work on stage k and may still finish stage k-1 (wgmma.wait_group 1 keeps
// one product group in flight). The barrier at the top of step k is where
// every warpgroup has retired step k-2's products, so step k refills that
// stage.
#pragma once

#include "common.cuh"

namespace paella {
namespace sm90 {

// kBK: a K step in bf16 elements (one 128-byte row)
constexpr int kBM = 128, kBK = 64, kStages = 6, kGemmThreads = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's generic-proxy shared-memory writes (cp.async lands
// through it) visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle: start address >> 4 (bits 0-13), leading byte offset (unused for
// swizzled K-major; 1), stride byte offset 1024 >> 4 between 8-row groups
// (bits 32-45), swizzle mode 1 = 128 bytes (bits 62-63). The tile base is
// 1024-byte aligned, so the base offset (bits 49-51) is 0. The k-th 32-byte
// slice of a 128-byte row starts 32 k bytes in: add 2 k to the descriptor.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// Pins accumulator registers around a batch of wgmma: without it the
// compiler may move them between the asynchronous products and then has to
// serialize those.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define PAELLA_ACC32(C)                                                                                              \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), C(d[8]), C(d[9]), C(d[10]), C(d[11]),    \
      C(d[12]), C(d[13]), C(d[14]), C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]), C(d[22]), \
      C(d[23]), C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31])
#define PAELLA_ACC64(C)                                                                                              \
  PAELLA_ACC32(C), C(d[32]), C(d[33]), C(d[34]), C(d[35]), C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]),        \
      C(d[41]), C(d[42]), C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), C(d[48]), C(d[49]), C(d[50]), C(d[51]), \
      C(d[52]), C(d[53]), C(d[54]), C(d[55]), C(d[56]), C(d[57]), C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]), \
      C(d[63])
#define PAELLA_F(x) "+f"(x)
#define PAELLA_R(x) "+r"(x)
#define PAELLA_REGS32                                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                                           \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define PAELLA_REGS64                                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"                                           \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"                                 \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"                                 \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// One 32-byte K slice of a 64-row wgmma: bf16 (k16, scale-a/b 1, no
// transpose) or s8 (k32; integer wgmma takes no scale or transpose operands).
template <int BN, typename E>
struct Wgmma;

template <>
struct Wgmma<64, __nv_bfloat16> {
  // scale_d 0: d = A B^T, the accumulators' old values ignored (K2's tiles)
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d = 1) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PAELLA_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : PAELLA_ACC32(PAELLA_F)
                 : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128, __nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PAELLA_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : PAELLA_ACC64(PAELLA_F)
                 : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64, int8_t> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t da, uint64_t db) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " PAELLA_REGS32 ", %32, %33, p;\n}\n"
                 : PAELLA_ACC32(PAELLA_R)
                 : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128, int8_t> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " PAELLA_REGS64 ", %64, %65, p;\n}\n"
                 : PAELLA_ACC64(PAELLA_R)
                 : "l"(da), "l"(db), "r"(1));
  }
};

// m64n64k16 bf16 with A from registers (four .b32 of bf16 pairs a thread, the
// m16n8k16 A-fragment of its warp's 16 rows) and B from shared memory,
// K-major (kTransB 0) or MN-major (kTransB 1: B's rows are its K index, its N
// index contiguous). scale_d 0: d = A B, the old accumulators ignored. K5's
// wgmma variant (attention.cuh): QK^T with Q in registers, p V with p there.
template <int kTransB>
struct WgmmaRS {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PAELLA_REGS32
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
                 : PAELLA_ACC32(PAELLA_F)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

#undef PAELLA_ACC32
#undef PAELLA_ACC64
#undef PAELLA_F
#undef PAELLA_R
#undef PAELLA_REGS32
#undef PAELLA_REGS64

// 16 s8 codes -> 16 bf16, exact, in two 16-byte halves (codes 0-7, 8-15):
// each byte b + 128 goes into the mantissa of the f32 2^23 (a byte permute),
// 2^23 + 128 is subtracted, and the pair's upper halves are the bf16 values
// (|code| <= 128 has at most 8 significant bits, so truncation is exact).
__device__ __forceinline__ void widen_codes(uint4 codes, uint4& lo, uint4& hi) {
  const uint32_t in[4] = {codes.x ^ 0x80808080u, codes.y ^ 0x80808080u, codes.z ^ 0x80808080u,
                          codes.w ^ 0x80808080u};
  uint32_t out[8];
#pragma unroll
  for (int w = 0; w < 4; ++w)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float f0 = __uint_as_float(__byte_perm(in[w], 0x4B000000u, 0x7650 + 2 * p)) - 8388736.f;
      const float f1 = __uint_as_float(__byte_perm(in[w], 0x4B000000u, 0x7651 + 2 * p)) - 8388736.f;
      out[2 * w + p] = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
    }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// One block's 128 x BN tile of E x E products. smem is 1024-byte aligned and
// holds kSmem - 1024 bytes (kSmemCodes - 1024 for run_codes; the launch adds
// 1024 bytes of slack for the alignment).
template <int BN, typename E = __nv_bfloat16>
struct GemmTile {
  static_assert(BN == 64 || BN == 128, "wgmma tile width");
  using Acc = std::conditional_t<sizeof(E) == 1, int, float>;  // s32 sums of s8, f32 of bf16
  static constexpr int kK = 128 / sizeof(E);        // a K step in elements
  static constexpr int kChunk = 16 / sizeof(E);     // elements per 16-byte copy
  static constexpr int kAcc = BN / 2;
  static constexpr int kStageA = kBM * 128, kStageB = BN * 128;
  static constexpr int kStage = kStageA + kStageB;
  static constexpr int kSmem = kStages * kStage + 1024;
  // run_codes: the A ring, a ring of raw s8 code tiles (64 codes a row) and
  // three widened bf16 B tiles
  static constexpr int kCodeStage = BN * 64, kWideSlots = 3;
  static constexpr int kSmemCodes = kStages * (kStageA + kCodeStage) + kWideSlots * kStageB + 1024;
  Acc acc[kAcc];

  // rows [row0, row0 + ROWS) x K-columns [k0, k0 + kK) of a row-major
  // matrix (leading dimension ld) into the swizzled tile at dst; rows at or
  // past nrows read as zero
  template <int ROWS>
  static __device__ __forceinline__ void load(uint32_t dst, const E* g, int ld, int row0, int nrows, int k0) {
    static_assert(ROWS * 8 % kGemmThreads == 0, "whole copies per thread");
#pragma unroll
    for (int i = 0; i < ROWS * 8 / kGemmThreads; ++i) {
      const int e = threadIdx.x + i * kGemmThreads, r = e >> 3, c = e & 7;
      const bool ok = row0 + r < nrows;
      const E* src = g + (size_t)(ok ? row0 + r : 0) * ld + k0 + c * kChunk;
      cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), src, ok);
    }
  }
  // the same with 16-byte chunks at or past column ncols (a multiple of
  // kChunk) read as zero too
  template <int ROWS>
  static __device__ __forceinline__ void load_ragged(uint32_t dst, const E* g, int ld, int row0, int nrows, int k0,
                                                     int ncols) {
#pragma unroll
    for (int i = 0; i < ROWS * 8 / kGemmThreads; ++i) {
      const int e = threadIdx.x + i * kGemmThreads, r = e >> 3, c = e & 7;
      const bool ok = row0 + r < nrows && k0 + c * kChunk < ncols;
      cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), g + (ok ? (size_t)(row0 + r) * ld + k0 + c * kChunk : 0), ok);
    }
  }

  // acc = A[m0 .. m0+128)[kb .. kb + kK ksteps) * B[n0 .. n0+BN)[same]^T.
  // A has M rows, B has N; both have K columns (a multiple of kChunk) and
  // leading dimension ld. Rows past M read as zero. kRagged: so do rows past N
  // and columns past K, for a ragged last column tile or K step; without it
  // (K % kK == 0 and N % BN == 0, every product at the flagship's widths)
  // the copies keep row bounds the compiler folds away, which measured
  // 10-25% faster products than checking them. Ends with every copy and
  // product retired and a barrier, so smem may be reused.
  template <bool kRagged>
  __device__ __forceinline__ void run(uint8_t* smem, const E* A, const E* B, int ld, int M, int N, int K, int m0,
                                      int n0, int kb, int ksteps) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    const uint32_t base = smem_addr(smem);
    const int wg = threadIdx.x >> 7;
    auto issue = [&](int k) {
      if (k < ksteps) {
        const uint32_t st = base + (k % kStages) * kStage;
        if constexpr (kRagged) {
          load_ragged<kBM>(st, A, ld, m0, M, kb + k * kK, K);
          load_ragged<BN>(st + kStageA, B, ld, n0, N, kb + k * kK, K);
        } else {
          load<kBM>(st, A, ld, m0, M, kb + k * kK);
          load<BN>(st + kStageA, B, ld, n0, n0 + BN, kb + k * kK);
        }
      }
      cp_async_commit();  // an empty group past the end keeps the count uniform
    };
#pragma unroll
    for (int k = 0; k < kStages - 2; ++k) issue(k);
    for (int k = 0; k < ksteps; ++k) {
      cp_async_wait<kStages - 3>();  // this thread's copies of stage k have landed
      fence_proxy_async();
      __syncthreads();  // everyone's copies of stage k; every warpgroup past step k-2
      issue(k + kStages - 2);
      const uint32_t st = base + (k % kStages) * kStage;
      const uint64_t da = desc_sw128(st + wg * 64 * 128), db = desc_sw128(st + kStageA);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<BN, E>::mma(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      fence_operands(acc);
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_operands(acc);
    cp_async_wait<0>();
    __syncthreads();
  }

  // bf16 A times s8 weight codes B (N, K), widened to bf16 in the kernel:
  // cp.async cannot convert, so each thread copies its 16-byte chunks of a
  // stage's codes into a raw ring beside the A ring. Once step k's products
  // are issued, each thread waits for its own copies of stage k+1 (no
  // barrier needed: it reads only what it copied), widens the same chunks
  // into swizzled bf16 B tile (k+1) % 3 while the tensor cores work, and
  // fences them into the async proxy before step k+1's barrier. That slot was
  // last read by step k-2's products, which every warpgroup retired before it
  // passed step k's barrier. (Widening before the barrier instead, with the
  // products of step k-1 in flight, made ptxas serialize the wgmma, note
  // C7515, and took up to 8% more device time a call; PERF.md §6.)
  // Requires K % 64 == 0 and N % BN == 0
  // (the int8 modes' widths, C % 64 == 0); rows past M read as zero.
  __device__ __forceinline__ void run_codes(uint8_t* smem, const __nv_bfloat16* A, const int8_t* B, int ld, int M,
                                            int m0, int n0, int kb, int ksteps) {
    static_assert(sizeof(E) == 2, "bf16 products");
    constexpr int kCopies = BN * 4 / kGemmThreads;  // 16-code chunks a thread
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    const uint32_t base = smem_addr(smem);
    const int wg = threadIdx.x >> 7;
    uint8_t* raw = smem + kStages * kStageA;
    const uint32_t wide = base + kStages * (kStageA + kCodeStage);
    auto issue = [&](int k) {
      if (k < ksteps) {
        const int s = k % kStages, k0 = kb + k * kK;
        load<kBM>(base + s * kStageA, A, ld, m0, M, k0);
#pragma unroll
        for (int i = 0; i < kCopies; ++i) {
          const int e = threadIdx.x + i * kGemmThreads, r = e >> 2, q = e & 3;
          cp_async16(smem_addr(raw + s * kCodeStage + e * 16), B + (size_t)(n0 + r) * ld + k0 + q * 16, true);
        }
      }
      cp_async_commit();
    };
    // this thread's code chunks of stage k widened into wide slot k % 3
    auto widen = [&](int k) {
      const uint8_t* rs = raw + (k % kStages) * kCodeStage;
      uint8_t* wt = smem + kStages * (kStageA + kCodeStage) + (k % kWideSlots) * kStageB;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        const int e = threadIdx.x + i * kGemmThreads, r = e >> 2, q = e & 3;
        uint4 lo, hi;
        widen_codes(*reinterpret_cast<const uint4*>(rs + e * 16), lo, hi);
        *reinterpret_cast<uint4*>(wt + r * 128 + (((2 * q) ^ (r & 7)) << 4)) = lo;
        *reinterpret_cast<uint4*>(wt + r * 128 + (((2 * q + 1) ^ (r & 7)) << 4)) = hi;
      }
    };
#pragma unroll
    for (int k = 0; k < kStages - 2; ++k) issue(k);
    cp_async_wait<kStages - 3>();
    widen(0);
    for (int k = 0; k < ksteps; ++k) {
      fence_proxy_async();
      __syncthreads();
      issue(k + kStages - 2);
      const uint64_t da = desc_sw128(base + (k % kStages) * kStageA + wg * 64 * 128);
      const uint64_t db = desc_sw128(wide + (k % kWideSlots) * kStageB);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<BN, E>::mma(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      if (k + 1 < ksteps) {  // while the tensor cores work on step k
        cp_async_wait<kStages - 3>();
        widen(k + 1);
      }
      fence_operands(acc);
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_operands(acc);
    cp_async_wait<0>();
    __syncthreads();
  }

  // Accumulator i of this thread: tile row (wg*64 + warp*16 + g + 8*(i%4/2)),
  // column (i/4*8 + 2t + i%2), the wgmma m64nN layout of f32 and s32 alike.
  template <typename F>
  __device__ __forceinline__ void for_each(F f) const {
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r0 = wg * 64 + warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) f(r0 + 8 * ((i >> 1) & 1), (i >> 2) * 8 + c0 + (i & 1), acc[i]);
  }
};

// Opts kKernel into `bytes` of dynamic shared memory, once per device: the
// runtime call would otherwise cost host time on every launch.
template <auto kKernel>
__host__ cudaError_t reserve_smem(size_t bytes) {
  constexpr int kDevices = 64;
  static size_t granted[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && granted[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kDevices) granted[dev] = bytes;
  return err;
}

// The first 1024-byte aligned address of a dynamic shared-memory buffer.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

}  // namespace sm90
}  // namespace paella
