// A bf16 tile product for Hopper (sm_90a) on wgmma, fed by a cp.async ring:
// C[128][BN] = A[128 rows][K range] * B[BN rows][K range]^T, f32 sums, with
// both operands K-contiguous as they lie in device memory (A the activations
// (M, K), B a torch Linear weight (N, K)). Used by K1's two products
// (resblock.cu, bf16 float mode) and K6's two (attn_block.cu, bf16).
//
// Block: 256 threads, two warpgroups; warpgroup w owns rows [64w, 64w + 64)
// of the tile and issues wgmma.mma_async m64nBNk16 (A and B from shared
// memory) into BN/2 f32 registers a thread.
//
// Shared memory: a ring of kStages stages, each a 128 x 64 A tile and a
// BN x 64 B tile (192 KB at BN 128). A tile row is 64 bf16 = 128 bytes, stored with the 128-byte
// swizzle wgmma's descriptors name (16-byte chunk c of row r at chunk
// c ^ (r % 8); 8-row groups 1024 bytes apart), so the tensor cores read it
// without bank conflicts. Each thread copies its share of a stage with 16-byte
// cp.async.cg (L2 only) straight to the swizzled addresses; rows past M or N
// and 16-byte chunks past K are zero-filled by the copy itself (src-size 0),
// so ragged tiles (K6's row counts, the narrow widths' K % 64 != 0) need no
// other care.
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
// 1024-byte aligned, so the base offset (bits 49-51) is 0. The k-th 16-deep
// slice of a 64-deep row starts 32 k bytes in: add 2 k to the descriptor.
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

template <int BN>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

// One block's 128 x BN tile. smem is 1024-byte aligned and holds kSmem - 1024
// bytes (the launch adds 1024 bytes of slack for the alignment).
template <int BN>
struct GemmTile {
  static_assert(BN == 64 || BN == 128, "wgmma tile width");
  static constexpr int kAcc = BN / 2;
  static constexpr int kStageA = kBM * kBK * 2, kStageB = BN * kBK * 2;
  static constexpr int kStage = kStageA + kStageB;
  static constexpr int kSmem = kStages * kStage + 1024;
  float acc[kAcc];

  // rows [row0, row0 + ROWS) x K-columns [k0, k0 + 64) of a row-major bf16
  // matrix (leading dimension ld) into the swizzled tile at dst; rows at or
  // past nrows read as zero
  template <int ROWS>
  static __device__ __forceinline__ void load(uint32_t dst, const __nv_bfloat16* g, int ld, int row0, int nrows,
                                              int k0) {
    static_assert(ROWS * 8 % kGemmThreads == 0, "whole copies per thread");
#pragma unroll
    for (int i = 0; i < ROWS * 8 / kGemmThreads; ++i) {
      const int e = threadIdx.x + i * kGemmThreads, r = e >> 3, c = e & 7;
      const bool ok = row0 + r < nrows;
      const __nv_bfloat16* src = g + (size_t)(ok ? row0 + r : 0) * ld + k0 + c * 8;
      cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), src, ok);
    }
  }
  // the same with 16-byte chunks at or past column ncols (a multiple of 8)
  // read as zero too
  template <int ROWS>
  static __device__ __forceinline__ void load_ragged(uint32_t dst, const __nv_bfloat16* g, int ld, int row0,
                                                     int nrows, int k0, int ncols) {
#pragma unroll
    for (int i = 0; i < ROWS * 8 / kGemmThreads; ++i) {
      const int e = threadIdx.x + i * kGemmThreads, r = e >> 3, c = e & 7;
      const bool ok = row0 + r < nrows && k0 + c * 8 < ncols;
      cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), g + (ok ? (size_t)(row0 + r) * ld + k0 + c * 8 : 0), ok);
    }
  }

  // acc = A[m0 .. m0+128)[kb .. kb + 64 ksteps) * B[n0 .. n0+BN)[same]^T.
  // A has M rows, B has N; both have K columns (a multiple of 8) and leading
  // dimension ld. Rows past M read as zero. kRagged: so do rows past N and
  // columns past K, for a ragged last column tile or K step; without it
  // (K % 64 == 0 and N % BN == 0, every product at the flagship's widths)
  // the copies keep row bounds the compiler folds away, which measured
  // 10-25% faster products than checking them. Ends with every copy and
  // product retired and a barrier, so smem may be reused.
  template <bool kRagged>
  __device__ __forceinline__ void run(uint8_t* smem, const __nv_bfloat16* A, const __nv_bfloat16* B, int ld,
                                      int M, int N, int K, int m0, int n0, int kb, int ksteps) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    const uint32_t base = smem_addr(smem);
    const int wg = threadIdx.x >> 7;
    auto issue = [&](int k) {
      if (k < ksteps) {
        const uint32_t st = base + (k % kStages) * kStage;
        if constexpr (kRagged) {
          load_ragged<kBM>(st, A, ld, m0, M, kb + k * kBK, K);
          load_ragged<BN>(st + kStageA, B, ld, n0, N, kb + k * kBK, K);
        } else {
          load<kBM>(st, A, ld, m0, M, kb + k * kBK);
          load<BN>(st + kStageA, B, ld, n0, n0 + BN, kb + k * kBK);
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
      for (int kk = 0; kk < kBK / 16; ++kk) Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      fence_operands(acc);
      wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_operands(acc);
    cp_async_wait<0>();
    __syncthreads();
  }

  // Accumulator i of this thread: tile row (wg*64 + warp*16 + g + 8*(i%4/2)),
  // column (i/4*8 + 2t + i%2), the wgmma m64nN f32 layout.
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
