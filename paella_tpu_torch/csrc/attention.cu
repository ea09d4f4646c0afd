// Fused masked multi-head attention core for Hopper (sm_90a), bf16 or f32.
//
// Replaces: paella_tpu/kernels/attention.py::fused_attention (the Pallas TPU
// kernel; pallas_call at attention.py:97), the attention core of repetition 0
// of every attention level under attention_impl="pallas": q (B,N,H,D) against
// k, v (B,S,H,D) with a (B,S) key mask, out (B,N,H,D). The TPU kernel pads D
// to 128 lanes and holds one (batch, head)'s whole problem in VMEM; here one
// block of 4 warps takes 64 query rows of one (batch, head) and streams the
// keys through shared memory in tiles of 64 (attention.cuh), so any S fits and
// D = 80 needs no padding. Grid (ceil(N/64), H, B).
//
// What bounds it on an H100: at the flagship's shapes (B 2, H 16, D 80; N 256,
// S 328 at level 1; N 64, S 136 at level 2) it is 4 N S D B H = 0.43 and 0.04
// GFLOP (the scores twice: 0.54 and 0.06) over 5.2 and 1.5 MB of bf16 q, k,
// v and out, ~100 FLOP/byte: below the card's ~295 FLOP/byte ridge, but the
// two passes re-read K from L2, and 128 (level 1) or 32 (level 2) blocks
// leave SMs idle, so latency and occupancy bound it, not HBM. Larger tiles,
// cp.async double buffering and more query tiles per block are later steps.
#include "attention.cuh"

namespace paella {
namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_kernel(const T* __restrict__ q,
                                                             const T* __restrict__ k,
                                                             const T* __restrict__ v,
                                                             const uint8_t* __restrict__ mask,
                                                             T* __restrict__ out, int N, int S, int H,
                                                             int D, int ldq, int ldk, int ldv,
                                                             float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q0 = blockIdx.x * kAttnRows, h = blockIdx.y, b = blockIdx.z;
  const int ldo = H * D;
  attention_tile<T>(q + ((size_t)b * N + q0) * ldq + h * D, ldq, min(kAttnRows, N - q0),
                    k + (size_t)b * S * ldk + h * D, ldk, v + (size_t)b * S * ldv + h * D, ldv, S,
                    mask != nullptr ? mask + (size_t)b * S : nullptr, 0,
                    out + ((size_t)b * N + q0) * ldo + h * D, ldo, D, scale,
                    reinterpret_cast<T*>(smem_raw));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int N,
           int S, int H, int D, int ldq, int ldk, int ldv, float scale, cudaStream_t st) {
  const size_t bytes = attn_smem_bytes<T>(D);
  cudaError_t err = allow_smem(attention_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  attention_kernel<T><<<dim3((N + kAttnRows - 1) / kAttnRows, H, B), kThreads, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)mask, (T*)out, N, S, H, D, ldq, ldk, ldv,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace paella

// C interface for ctypes. q (B,N,H,D), k, v (B,S,H,D) with contiguous (H,D)
// rows ldq, ldk, ldv elements apart (a multiple of 8 bf16 or 4 f32 values);
// out (B,N,H,D) contiguous; mask (B,S) bytes (1 = attend) or null. Pointers
// 16-byte aligned. D % 16 == 0, D <= 128, S >= 1. scale = D^-1/2 in f32.
// Returns a cudaError_t.
extern "C" int paella_attention(const void* q, const void* k, const void* v, const void* mask,
                                void* out, int B, int N, int S, int H, int D, int ldq, int ldk,
                                int ldv, float scale, int is_bf16, void* stream) {
  using namespace paella;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, out, B, N, S, H, D, ldq, ldk, ldv, scale, st);
  return launch<float>(q, k, v, mask, out, B, N, S, H, D, ldq, ldk, ldv, scale, st);
}
