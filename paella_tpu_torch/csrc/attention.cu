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
// the key tiles split among the warps that share query rows.
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
// (warp_tiles' f32 layout), P passed between lanes by shuffles, full f32.
// attention.cuh's attention_tile stays the core of K6.
#include "attention.cuh"
#include "gemm_sm90.cuh"

namespace paella {
namespace {

using sm90::cp_async16;
using sm90::smem_addr;

constexpr int kTileKeys = 64;                      // keys per K / V tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kResidentBytes = 200 * 1024;      // K and V kept whole up to here
constexpr size_t kMaxSmem = 227 * 1024;            // a block's shared memory on an H100

template <typename T>
__host__ __device__ constexpr int ring_ld(int D) { return D + (is_bf16<T>() ? 8 : 4); }
__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// Up to n cp.async groups of this thread may stay pending (n >= 15: 15).
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
#define PAELLA_WAIT(k) case k: sm90::cp_async_wait<k>(); break;
    PAELLA_WAIT(0) PAELLA_WAIT(1) PAELLA_WAIT(2) PAELLA_WAIT(3) PAELLA_WAIT(4) PAELLA_WAIT(5) PAELLA_WAIT(6)
    PAELLA_WAIT(7) PAELLA_WAIT(8) PAELLA_WAIT(9) PAELLA_WAIT(10) PAELLA_WAIT(11) PAELLA_WAIT(12) PAELLA_WAIT(13)
    PAELLA_WAIT(14)
#undef PAELLA_WAIT
    default: sm90::cp_async_wait<15>();
  }
}

// Rows [0, nrows) x [0, D) of a global tile (leading dimension ld) into
// smem[r][d] (leading dimension lds) with 16-byte cp.async; rows at or past
// nvalid are zero-filled.
template <typename T>
__device__ __forceinline__ void copy_rows(T* smem, int lds, const T* g, int ld, int nvalid, int nrows, int D) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = D / V;
  for (int e = threadIdx.x; e < nrows * vpr; e += blockDim.x) {
    const int r = e / vpr, d = (e % vpr) * V;
    const bool ok = r < nvalid;
    cp_async16(smem_addr(smem + r * lds + d), g + (size_t)(ok ? r : 0) * ld + d, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The warp's raw scores against one key tile, sc[n-tile][i] in the m16n8k16
// C layout (rows g, g + 8; keys 8 nt + 2t + i % 2). bf16: Q's A-fragments
// are in registers (qf), K's B-fragments come from ldmatrix. f32: both from
// shared memory on FMA.
template <typename T>
__device__ __forceinline__ void raw_scores(const uint32_t (&qf)[kAttnMaxD / 16][4], const T* Qw, const T* Kt, int ld,
                                           int D, float (&sc)[kKeyTiles][4]) {
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
  if constexpr (is_bf16<T>()) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < kAttnMaxD / 16; ++kk) {
      if (kk * 16 >= D) break;
#pragma unroll
      for (int np = 0; np < kKeyTiles / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, Kt + ((2 * np + (lane >> 4)) * 8 + (lane & 7)) * ld + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }
  } else {
    warp_tiles<T, kKeyTiles>(Qw, ld, Kt, ld, D, sc, kKeyTiles);
  }
}

// o (rows g, g + 8; d columns 8 dn + 2t + i % 2) += round_T(p) @ V over one
// key tile, p (f32, normalised) in the scores' C layout. bf16 rounds p to
// nearest even as it packs the A-fragments; f32 takes it as it is.
template <typename T>
__device__ __forceinline__ void add_pv(const float (&p)[kKeyTiles][4], const T* Vt, int ld, int D,
                                       float (&o)[kAttnMaxD / 8][4]) {
  const int lane = threadIdx.x & 31;
  if constexpr (is_bf16<T>()) {
#pragma unroll
    for (int c = 0; c < kKeyTiles / 2; ++c) {
      const uint32_t a[4] = {pack_bf16(p[2 * c][0], p[2 * c][1]), pack_bf16(p[2 * c][2], p[2 * c][3]),
                             pack_bf16(p[2 * c + 1][0], p[2 * c + 1][1]), pack_bf16(p[2 * c + 1][2], p[2 * c + 1][3])};
      const T* vrow = Vt + (16 * c + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
      for (int dp = 0; dp < kAttnMaxD / 16; ++dp) {
        if (dp * 16 >= D) break;
        uint32_t b[4];
        ldsm_x4_trans(b, vrow + dp * 16);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  } else {
    const int t = lane & 3, quad = lane & ~3;
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 8; ++e) {  // key 8 nt + e, held by lane (g, e / 2)
        const float p_lo = __shfl_sync(0xffffffffu, p[nt][e & 1], quad | (e >> 1));
        const float p_hi = __shfl_sync(0xffffffffu, p[nt][2 + (e & 1)], quad | (e >> 1));
        const T* vrow = Vt + (nt * 8 + e) * ld + 2 * t;
#pragma unroll
        for (int dn = 0; dn < kAttnMaxD / 8; ++dn) {
          if (dn * 8 >= D) break;
          const float2 v = *reinterpret_cast<const float2*>(vrow + dn * 8);
          o[dn][0] = fmaf(p_lo, v.x, o[dn][0]);
          o[dn][1] = fmaf(p_lo, v.y, o[dn][1]);
          o[dn][2] = fmaf(p_hi, v.x, o[dn][2]);
          o[dn][3] = fmaf(p_hi, v.y, o[dn][3]);
        }
      }
  }
}

// Grid (ceil(N / (16 wq)), H, B), 32 wq wk threads: warp w takes query rows
// [16 (w % wq), +16) and, in round r of each pass, key tile r wk + w / wq.
// Shared memory: the item's key flags [S rounded up to 64, then 16 bytes]
// (1 attend, 0 masked, 2 past S), the key groups' row statistics
// [wk][16 wq][2] f32, Q [16 wq][ld], then the K tiles and the V tiles, each
// [64][ld]: all ceil(S / 64) of them where resident (ring == 0), tile j in
// slot j, every copy issued at once; else a ring of `ring` rounds of wk
// tiles, K (pass 1) then K and V (pass 2), ring - 1 rounds in flight. Each
// round is one cp.async group (round 0's also holds Q). The key groups'
// (max, sum) are merged after pass 1 and their p @ V partials summed after
// pass 2, both in group order.
template <typename T>
__global__ void __launch_bounds__(256) attention_ring_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                             const T* __restrict__ v,
                                                             const uint8_t* __restrict__ mask, T* __restrict__ out,
                                                             int N, int S, int H, int D, int ldq, int ldk, int ldv,
                                                             float scale, int wq, int ring) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wk = (blockDim.x >> 5) / wq, qw = warp % wq, kgrp = warp / wq, rows = 16 * wq;
  const int q0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  const int nkt = (S + kTileKeys - 1) / kTileKeys, ld = ring_ld<T>(D);
  const int rounds = (nkt + wk - 1) / wk, resident = ring == 0, slots = resident ? nkt : ring * wk;
  uint8_t* flags = smem_raw;
  float* stats = reinterpret_cast<float*>(smem_raw + round16(nkt * kTileKeys));
  T* Qs = reinterpret_cast<T*>(reinterpret_cast<uint8_t*>(stats) + round16(wk * rows * 8));
  T* Ks = Qs + rows * ld;
  T* Vs = Ks + slots * kTileKeys * ld;
  const T* kg = k + (size_t)b * S * ldk + h * D;
  const T* vg = v + (size_t)b * S * ldv + h * D;
  const int n_rows = min(rows, N - q0);

  // round i < rounds: K tiles of pass 1; round rounds + r: V tiles (and K
  // tiles unless resident) of pass 2
  const int jobs = 2 * rounds;
  auto slot_of = [&](int i, int grp) { return resident ? (i % rounds) * wk + grp : (i % ring) * wk + grp; };
  auto issue = [&](int i) {
    if (i < jobs) {
      const bool pass2 = i >= rounds;
      for (int grp = 0; grp < wk; ++grp) {
        const int j = (i % rounds) * wk + grp, slot = slot_of(i, grp);
        if (j >= nkt) break;
        const int nk = min(kTileKeys, S - j * kTileKeys);
        if (!pass2 || !resident)
          copy_rows(Ks + slot * kTileKeys * ld, ld, kg + (size_t)j * kTileKeys * ldk, ldk, nk, kTileKeys, D);
        if (pass2)
          copy_rows(Vs + slot * kTileKeys * ld, ld, vg + (size_t)j * kTileKeys * ldv, ldv, nk, kTileKeys, D);
      }
    }
    sm90::cp_async_commit();
  };
  copy_rows(Qs, ld, q + ((size_t)b * N + q0) * ldq + h * D, ldq, n_rows, rows, D);
  int issued = 0;
  for (; issued < (resident ? jobs : ring - 1); ++issued) issue(issued);
  const uint8_t* mb = mask != nullptr ? mask + (size_t)b * S : nullptr;
  for (int j = threadIdx.x; j < nkt * kTileKeys; j += blockDim.x)
    flags[j] = j >= S ? 2 : (mb == nullptr || mb[j] ? 1 : 0);

  const T* Qw = Qs + qw * 16 * ld;
  uint32_t qf[kAttnMaxD / 16][4];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, inv_l[2];
  float o[kAttnMaxD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kAttnMaxD / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  bool q_loaded = false;

  // Scores are kept in log2 units, s2 = s log2 e (masked: -1e9 log2 e), so
  // each exponential is one exp2f: exp2(s2 - m2) = exp(s - m).
  const float scale2 = scale * kLog2e;
  // one key tile j (in `slot`) of pass 1 or 2, after a barrier that made it visible
  auto step = [&](bool pass2, int j, int slot) {
    if constexpr (is_bf16<T>()) {
      if (!q_loaded) {
#pragma unroll
        for (int kk = 0; kk < kAttnMaxD / 16; ++kk)
          if (kk * 16 < D) ldsm_x4(qf[kk], Qw + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + kk * 16 + (lane >> 4) * 8);
        q_loaded = true;
      }
    }
    const int s0 = j * kTileKeys;
    float sc[kKeyTiles][4];
    raw_scores<T>(qf, Qw, Ks + slot * kTileKeys * ld, ld, D, sc);
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = flags[s0 + nt * 8 + 2 * t + (e & 1)];
        sc[nt][e] = f == 1 ? sc[nt][e] * scale2 : (f == 0 ? kMaskedScore * kLog2e : -INFINITY);
      }
    if (!pass2) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * r], sc[nt][2 * r + 1]));
        const float m_new = fmaxf(m_run[r], quad_max(mx));  // finite: key s0 is real
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kKeyTiles; ++nt) sum += exp2f(sc[nt][2 * r] - m_new) + exp2f(sc[nt][2 * r + 1] - m_new);
        l_run[r] = l_run[r] * exp2f(m_run[r] - m_new) + quad_sum(sum);
        m_run[r] = m_new;
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = exp2f(sc[nt][e] - m_run[e >> 1]) * inv_l[e >> 1];
      add_pv<T>(sc, Vs + slot * kTileKeys * ld, ld, D, o);
    }
  };

  for (int i = 0; i < jobs; ++i) {
    cp_async_wait_at_most(issued - i - 1);  // round i has landed (this thread's copies)
    __syncthreads();                        // everyone's; and every warp is past round i - 1
    if (!resident) issue(issued++);         // into the slots round i - 1 used
    if (i == rounds) {                      // pass 1 is done in every warp
      if (wk > 1) {                         // merge the key groups' (max, sum) in group order
        const int row = qw * 16 + g;
        if (t == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            stats[(kgrp * rows + row + 8 * r) * 2] = m_run[r];
            stats[(kgrp * rows + row + 8 * r) * 2 + 1] = l_run[r];
          }
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* st = stats + (row + 8 * r) * 2;
          float m = -INFINITY, l = 0.f;
          for (int grp = 0; grp < wk; ++grp) m = fmaxf(m, st[grp * rows * 2]);
          for (int grp = 0; grp < wk; ++grp) l += st[grp * rows * 2 + 1] * exp2f(st[grp * rows * 2] - m);
          m_run[r] = m;
          l_run[r] = l;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) inv_l[r] = 1.f / l_run[r];
    }
    const int j = (i % rounds) * wk + kgrp;
    if (j < nkt) step(i >= rounds, j, slot_of(i, kgrp));
  }

  const int ldo = H * D;
  T* og = out + ((size_t)b * N + q0) * ldo + h * D;
  if (wk == 1) {
#pragma unroll
    for (int dn = 0; dn < kAttnMaxD / 8; ++dn) {
      if (dn * 8 >= D) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qw * 16 + g + 8 * r;
        if (row >= n_rows) continue;
        T* dst = og + (size_t)row * ldo + dn * 8 + 2 * t;
        dst[0] = from_f<T>(o[dn][2 * r]);
        dst[1] = from_f<T>(o[dn][2 * r + 1]);
      }
    }
    return;
  }
  // sum the key groups' p @ V partials in group order, over the K/V tiles
  float* part = reinterpret_cast<float*>(Ks);  // [wk][rows][D]
  sm90::cp_async_wait<0>();                    // no copy still lands there
  __syncthreads();                             // every warp is done with K and V
#pragma unroll
  for (int dn = 0; dn < kAttnMaxD / 8; ++dn) {
    if (dn * 8 >= D) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* dst = part + (size_t)(kgrp * rows + qw * 16 + g + 8 * r) * D + dn * 8 + 2 * t;
      dst[0] = o[dn][2 * r];
      dst[1] = o[dn][2 * r + 1];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_rows * D; e += blockDim.x) {
    const int row = e / D, col = e % D;
    float sum = part[(size_t)row * D + col];
    for (int grp = 1; grp < wk; ++grp) sum += part[(size_t)(grp * rows + row) * D + col];
    og[(size_t)row * ldo + col] = from_f<T>(sum);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int N, int S, int H,
           int D, int ldq, int ldk, int ldv, float scale, cudaStream_t st) {
  // about four query blocks per (batch, head), 16-row warps, at most 4; the
  // key tiles split among up to 8 / wq groups, so that every SM has more
  // than one warp per scheduler to hide latency
  const int wq = min(4, (N + 63) / 64), rows = 16 * wq;
  const int nkt = (S + kTileKeys - 1) / kTileKeys;
  const size_t tile = (size_t)kTileKeys * ring_ld<T>(D) * sizeof(T);
  const size_t fixed = round16(nkt * kTileKeys) + (size_t)rows * ring_ld<T>(D) * sizeof(T);
  int wk = min(nkt, 8 / wq), ring = 0;
  auto bytes = [&]() {
    return fixed + round16(wk * rows * 8) + 2 * (ring == 0 ? nkt : ring * wk) * tile;
  };
  if (bytes() > kResidentBytes) {  // stream: 3 rounds in the ring, fewer groups or 2 rounds if need be
    ring = 3;
    while (bytes() > kMaxSmem && wk > 1) --wk;
    if (bytes() > kMaxSmem) ring = 2;
  }
  if (bytes() > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = sm90::reserve_smem<attention_ring_kernel<T>>(bytes());
  if (err != cudaSuccess) return (int)err;
  attention_ring_kernel<T><<<dim3((N + rows - 1) / rows, H, B), 32 * wq * wk, bytes(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)mask, (T*)out, N, S, H, D, ldq, ldk, ldv, scale, wq,
      ring);
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
