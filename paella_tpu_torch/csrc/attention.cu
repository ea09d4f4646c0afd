// Fused masked multi-head attention core for Hopper (sm_90a), bf16 or f32.
//
// Replaces: paella_tpu/kernels/attention.py::fused_attention (the Pallas TPU
// kernel; pallas_call at attention.py:97), the attention core of repetition 0
// of every attention level under attention_impl="pallas": q (B,N,H,D) against
// k, v (B,S,H,D) with a (B,S) key mask, out (B,N,H,D),
//
//   s = (q . k) * D^-1/2      f32; -1e9 where the key is masked
//   p = exp(s - max) / sum    f32, then rounded to the dtype
//   o = sum_j p_j v_j         f32 accumulation, rounded to the dtype
//
// the rounding points of paella_tpu/kernels/attention.py:32-53. The TPU
// kernel holds one (batch, head)'s whole problem in VMEM; here one block of
// 1-8 warps takes a query tile of one (batch, head): 16 query rows a warp,
// the key tiles split among the warps that share query rows. Head dims
// D % 8 == 0 (kernels/attention.py pads others); bf16 zero-pads a head to
// the next multiple of 16 in shared memory only (D 80, the flagship's, is not
// padded); heads wider than 128 split their output columns among blocks
// (attention.cuh).
//
// What bounds it on an H100: at the flagship's shapes (B 2, H 16, D 80; N 256,
// S 328 at level 1; N 64, S 136 at level 2) it is 0.86 and 0.09 GFLOP over
// 6.0 and 2.0 MB, ~1-2 µs of either tensor cores or HBM: far below launch and
// memory latency, so the design is about latency:
// - Fill the card: about four query blocks per (batch, head) whatever N
//   (64 rows at N 256, 16 at N 64), 128 blocks at both flagship levels; and
//   more than one warp per scheduler: up to 8 warps a block, the query warps
//   repeated over 8 / (query warps) key groups, group k taking every k-th
//   key tile (2 groups at level 1, 3 at level 2). The groups' softmax
//   statistics are merged after pass 1 and their p @ V partials summed after
//   pass 2, in group order.
// - Copy asynchronously. K and V tiles of 64 keys come in with 16-byte
//   cp.async.cg. Where the whole of K and V fits in shared memory (S 328 in
//   bf16: 2 x 6 tiles of 11 KB), every copy is issued at the start, V behind
//   K, one group a round of key tiles: pass 1 waits only for the K tiles it
//   needs, V lands meanwhile, and pass 2 reads K again from shared memory,
//   not L2. TMA is not needed: the rows are 160 bytes strided by H D and the
//   whole problem is a few MB, and cp.async needs no tensor map per call.
//   Longer S (conditioning of up to ~780 tokens gives S ~1036) streams K,
//   then K and V, through a ring of 3 rounds (2 if shared memory is short)
//   of one tile per key group, two rounds in flight.
// - No transpose of V: it stays row-major and the PV B-fragments come from
//   ldmatrix.trans. Rows are padded to 16-byte multiples that put the 8 rows
//   of one ldmatrix in distinct banks (D + 8 bf16, D + 4 f32).
// - P stays in registers: the QK^T m16n8k16 C-fragments of keys [16c, 16c+16)
//   are the PV A-fragment of k-step c once packed to bf16x2.
// - The batch item's mask is read once into shared memory.
// Two passes over the keys, as the TPU kernel's rounding point needs: pass 1
// takes each row's max and sum of exp(s - max) (an online rescale), pass 2
// recomputes the scores with the same instructions, normalises p in f32,
// rounds it and accumulates p @ V. An online softmax would round the
// unnormalised p, another point. Every sum has a fixed order and nothing
// depends on the batch or on block timing, so runs are bitwise equal and an
// image's output does not depend on its batchmates.
// bf16 products run on mma.sync m16n8k16 (f32 accumulate): K5's products are
// small (D 80), so tensor-core rate is not the limit and wgmma's 64-row tiles
// would only cut the number of blocks. f32 runs the same structure on FMA
// (in the same C layout), P passed between lanes by shuffles, full f32.
// The kernel itself (attention_ring_kernel) and its launch policy live in
// attention.cuh, which K6's attention phase (attn_block.cu) shares; this file
// is K5's C interface.
//
// Stable Cascade's Stage C attends 576 pixel queries over 576 + 85 keys, 32
// heads of 64, at CFG batch 8: 24.9 GFLOP a call, bound by the tensor cores
// (25.2 us at 989 TFLOP/s) and hardly less by bytes (24.2 us), where the ring
// above took 731 us. attention.cuh's attention_wgmma_kernel takes such shapes
// (wgmma with K and V resident in shared memory, read from the q|k|v product
// and the conditioning cache where they lie): 136.6 us on an H100 80GB HBM3
// at 700 W (chip_smoke.py item 9). attention_design gives it every bf16 head
// of 64 with S <= 768: in the sweep of both designs forced it was faster or
// within a µs of the ring at every size down to 16 x 40 (attention.cuh has
// the readings); Paella's head dim 80, f32 and K6 keep the ring.
//
// Stable Cascade's Stage B attends 1024 pixel queries over 1024 + 4 keys at
// its level 2 (20 heads of 64, batch 4: 21.8 us of tensor cores), where K and
// V no longer fit a block together and the ring took ~550 us a call, 37% of
// a decoder call. The variant's streamed form keeps K resident and streams V
// through a ring of 8 KB slots filled by a warp of its own: 142 us on an H100
// 80GB HBM3 at 700 W (chip_smoke.py's Stage B timings), in the same bits as
// the resident form. attention_design gives it bf16 heads of 64 with 768 < S
// <= 1536; longer keys keep the ring.
#include "attention.cuh"

// C interface for ctypes. q (B,N,H,D); keys [0, S1) from k, v (B,S1,H,D)
// and keys [S1, S) from k2, v2 (B,S-S1,H,D) (null where S1 == S), each with
// contiguous (H,D) rows ldq, ldk, ldv, ldk2, ldv2 elements apart (a multiple
// of 8 bf16 or 4 f32 values); out (B,N,H,D) contiguous; mask (B,S) bytes (1 =
// attend) or null. Pointers 16-byte aligned. D % 8 == 0, 1 <= S1 <= S.
// scale = D^-1/2 of the true head dim in f32 (D may be that dim padded with
// zero columns). design: -1 as paella_attention_design picks, 0 the ring,
// else the wgmma variant with k >= 1 query tiles a block: k with K and V
// resident, 256 + k with V streamed (attention.cuh's wgv codes). Returns
// cudaErrorInvalidValue where even the smallest tiles of a head dim this
// wide exceed shared memory (D over ~1100 in f32, ~2200 in bf16), or the
// wgmma variant does not fit the shapes.
// Returns a cudaError_t.
extern "C" int paella_attention(const void* q, const void* k, const void* v, const void* k2, const void* v2,
                                const void* mask, void* out, int B, int N, int S, int S1, int H, int D, int ldq,
                                int ldk, int ldv, int ldk2, int ldv2, float scale, int is_bf16, int design,
                                void* stream) {
  using namespace paella;
  if (S1 < 1 || S1 > S || (S1 < S && (k2 == nullptr || v2 == nullptr))) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t qbs = (size_t)N * ldq;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const KVSecond<T> two = S1 < S ? KVSecond<T>{(const T*)k2, (const T*)v2, S1, ldk2, ldv2} : KVSecond<T>{};
    return (int)launch_attention<T, false>((const T*)q, (const T*)k, (const T*)v, m, (T*)out, B, N, S, H, D, ldq, ldk,
                                           ldv, qbs, 0, scale, st, two, design);
  }
  const KVSecond<float> two =
      S1 < S ? KVSecond<float>{(const float*)k2, (const float*)v2, S1, ldk2, ldv2} : KVSecond<float>{};
  return (int)launch_attention<float, false>((const float*)q, (const float*)k, (const float*)v, m, (float*)out, B, N, S,
                                             H, D, ldq, ldk, ldv, qbs, 0, scale, st, two, design);
}

// The design paella_attention's policy takes at these shapes, as
// paella_attention's `design` codes it (paella::attention_design).
extern "C" int paella_attention_design(int B, int N, int S, int H, int D, int is_bf16) {
  return paella::attention_design(B, N, S, H, D, is_bf16 != 0);
}
