// The masked multi-head attention core of K5 (attention.cu) and of K6's
// attention phase (attn_block.cu), for Hopper (sm_90a), bf16 or f32:
//
//   s = (q . k) * scale              f32, scale = D^-1/2 of the true head dim
//   s = -1e9 where the key is masked
//   p = exp(s - max_j s) / sum_j exp(s - max_j s)     f32
//   o = sum_j round_T(p) * v_j       f32 accumulation, rounded to T at the end
//
// the rounding points of paella_tpu/kernels/attention.py:32-53 and of the
// attention phase of paella_tpu/kernels/attn_block.py:93-127. Two designs,
// picked from the shapes (attention_design): the ring, latency-bound, where
// one block of 1-8 warps takes a query tile of one (batch, head): 16 query
// rows a warp, the key tiles split among the warps that share query rows
// (attention.cu's header has the design and what it measured); and K5's
// compute-bound wgmma variant for bf16 heads of 64, in two forms: K and V
// resident in shared memory up to 768 keys (Stage C's attention), K resident
// and V streamed through a ring of slots up to 1536 keys (Stage B's level
// 2), whose notes are beside them below. K and V may come from two sources
// (KVSecond).
//
// Keys j < prefix always attend; key j >= prefix attends where
// mask[b][j - prefix] (mask (B, S - prefix) bytes, or null for all). K5
// passes prefix 0 and its (B, S) mask; K6 passes N, its pixel rows, and the
// (B, S_cond) cond mask, so no (B, S) mask is built.
//
// Head dims: any D % 8 == 0 (the wrappers pad other head dims to the next
// multiple of 8 with zeros, passing the true head dim's scale). In bf16 a
// head is zero-padded to the next multiple of 16 in shared memory only (the
// m16n8k16 k-step): the padded q and k columns add zero to the scores, and
// the padded output columns are never stored. f32 runs FMA over D itself.
// Up to kAttnMaxD (128) a warp keeps its 16 x D outputs, and in bf16 its Q
// fragments, in registers. A wider head (the kWide variant) splits the
// output columns into 128-wide chunks, one per block (a grid dimension):
// each block takes the scores over the whole D from shared memory, 16 head
// dims a k-step, with the same instructions in every chunk, so every chunk
// normalises the same p; it keeps only its chunk of each V tile, its key
// tiles hold 16 keys, so that the K tiles of a wide head fit shared memory
// (up to D ~1100 in f32, ~2200 in bf16), and its key tiles are not split
// among warps.
#pragma once

#include <math.h>

#include <algorithm>

#include "gemm_sm90.cuh"

namespace paella {

constexpr int kAttnMaxD = 128;                 // output columns a warp keeps in registers
constexpr float kMaskedScore = -1e9f;          // nn/attention.py's mask fill
constexpr float kLog2e = 1.4426950408889634f;
constexpr size_t kResidentBytes = 200 * 1024;  // K and V kept whole up to here
constexpr size_t kMaxSmem = 227 * 1024;        // a block's shared memory on an H100

// Keys per K / V tile: 64, or 16 for a wide head.
template <bool kWide>
__host__ __device__ constexpr int tile_keys() { return kWide ? 16 : 64; }
// The head dim as shared memory holds it: bf16 rounds it up to the k-step.
template <typename T>
__host__ __device__ constexpr int padded_head(int D) { return is_bf16<T>() ? (D + 15) & ~15 : D; }
// Row stride of a shared-memory tile: 16-byte rows that put the 8 rows of one
// ldmatrix in distinct banks (Dp + 8 bf16, Dp + 4 f32).
template <typename T>
__host__ __device__ constexpr int ring_ld(int Dp) { return Dp + (is_bf16<T>() ? 8 : 4); }
__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

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

// Rows [0, nrows) x [0, Dp) of a global tile (leading dimension ld) into
// smem[r][d] (leading dimension lds) with 16-byte cp.async; rows at or past
// nvalid and columns at or past D (the head's padding) are zero-filled.
template <typename T>
__device__ __forceinline__ void copy_rows(T* smem, int lds, const T* g, int ld, int nvalid, int nrows, int D,
                                          int Dp) {
  constexpr int V = 16 / sizeof(T);
  const int vpr = Dp / V;
  if (D == Dp) {  // no padding (the flagship's D 80): rows only
    for (int e = threadIdx.x; e < nrows * vpr; e += blockDim.x) {
      const int r = e / vpr, d = (e % vpr) * V;
      const bool ok = r < nvalid;
      sm90::cp_async16(sm90::smem_addr(smem + r * lds + d), g + (size_t)(ok ? r : 0) * ld + d, ok);
    }
    return;
  }
  for (int e = threadIdx.x; e < nrows * vpr; e += blockDim.x) {
    const int r = e / vpr, d = (e % vpr) * V;
    const bool ok = r < nvalid && d < D;
    sm90::cp_async16(sm90::smem_addr(smem + r * lds + d), g + (ok ? (size_t)r * ld + d : 0), ok);
  }
}

// The second source of keys where K and V come from two (Stage C reads its
// pixel rows' k and v out of the q|k|v product and the conditioning's out of
// its per-block cache, with no concatenation): keys [S1, S) of item b at k
// and v from row b (S - S1), rows ldk and ldv elements apart. Keys [0, S1)
// lie in the first source as one source's [0, S) do. k null: one source.
template <typename T>
struct KVSecond {
  const T *k = nullptr, *v = nullptr;
  int S1 = 0, ldk = 0, ldv = 0;
};

// copy_rows of key tile j (keys [j KT, j KT + nrows)) of one item: from g
// (item b's row 0 of the first source, leading dimension ld) below S1, from
// g2 (the second's, ld2) from S1 on. One source (kTwo false) is copy_rows at
// g + j KT ld; with two, only the tile that straddles S1 goes row by row.
template <bool kTwo, int KT, typename T>
__device__ __forceinline__ void copy_keys(T* smem, int lds, const T* g, int ld, const T* g2, int ld2, int S1, int j,
                                          int nvalid, int nrows, int D, int Dp) {
  const int j0 = j * KT;
  if (!kTwo || j0 + nvalid <= S1) return copy_rows(smem, lds, g + (size_t)j * KT * ld, ld, nvalid, nrows, D, Dp);
  if (j0 >= S1) return copy_rows(smem, lds, g2 + (size_t)(j0 - S1) * ld2, ld2, nvalid, nrows, D, Dp);
  constexpr int V = 16 / sizeof(T);
  const int vpr = Dp / V;
  for (int e = threadIdx.x; e < nrows * vpr; e += blockDim.x) {
    const int r = e / vpr, d = (e % vpr) * V, j = j0 + r;
    const bool ok = r < nvalid && d < D;
    const T* src = !ok ? g : (j < S1 ? g + (size_t)j * ld : g2 + (size_t)(j - S1) * ld2) + d;
    sm90::cp_async16(sm90::smem_addr(smem + r * lds + d), src, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p))
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

// A warp's Q A-fragment of k-step kk (its 16 rows x head dims [16 kk, +16)).
template <typename T>
__device__ __forceinline__ void q_fragment(uint32_t (&a)[4], const T* Qw, int ld, int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, Qw + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + kk * 16 + (lane >> 4) * 8);
}

// The warp's raw scores against one key tile of KT keys, sc[n-tile][i] in
// the m16n8k16 C layout (rows g, g + 8; keys 8 nt + 2t + i % 2). bf16: Q's
// A-fragments are in registers (qf), or (kWide) loaded from shared memory
// k-step by k-step, K's B-fragments come from ldmatrix. f32: both from
// shared memory on FMA, in the same layout.
template <typename T, int KT, bool kWide, int NQ>
__device__ __forceinline__ void raw_scores(const uint32_t (&qf)[NQ][4], const T* Qw, const T* Kt, int ld, int D,
                                           float (&sc)[KT / 8][4]) {
  constexpr int kKeyTiles = KT / 8;
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
  const int lane = threadIdx.x & 31;
  if constexpr (is_bf16<T>() && kWide) {
    for (int kk = 0; kk * 16 < D; ++kk) {
      uint32_t a[4];
      q_fragment(a, Qw, ld, kk);
#pragma unroll
      for (int np = 0; np < kKeyTiles / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, Kt + ((2 * np + (lane >> 4)) * 8 + (lane & 7)) * ld + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], a, b[0], b[1]);
        mma_bf16(sc[2 * np + 1], a, b[2], b[3]);
      }
    }
  } else if constexpr (is_bf16<T>()) {
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
    const int g = lane >> 2, t = lane & 3;
    for (int k = 0; k < D; ++k) {
      const float a_lo = Qw[g * ld + k], a_hi = Qw[(g + 8) * ld + k];
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt) {
        const float b_0 = Kt[(nt * 8 + 2 * t) * ld + k], b_1 = Kt[(nt * 8 + 2 * t + 1) * ld + k];
        sc[nt][0] = fmaf(a_lo, b_0, sc[nt][0]);
        sc[nt][1] = fmaf(a_lo, b_1, sc[nt][1]);
        sc[nt][2] = fmaf(a_hi, b_0, sc[nt][2]);
        sc[nt][3] = fmaf(a_hi, b_1, sc[nt][3]);
      }
    }
  }
}

// o (rows g, g + 8; d columns 8 dn + 2t + i % 2) += round_T(p) @ V over one
// key tile of KT keys and D columns, p (f32, normalised) in the scores' C
// layout. bf16 rounds p to nearest even as it packs the A-fragments; f32
// takes it as it is.
template <typename T, int KT>
__device__ __forceinline__ void add_pv(const float (&p)[KT / 8][4], const T* Vt, int ld, int D,
                                       float (&o)[kAttnMaxD / 8][4]) {
  constexpr int kKeyTiles = KT / 8;
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

// Grid (ceil(N / (16 wq)) x chunks, H, B), 32 wq wk threads: warp w takes
// query rows [16 (w % wq), +16) and, in round r of each pass, key tile r wk
// + w / wq; block x takes query tile x / chunks and output columns [128 (x %
// chunks), +128) (chunks 1 unless kWide). q row n of item b is at q + b qbs
// + n ldq; k and v rows at b S ld + j ld; out is (B, N, H, D) contiguous.
// Shared memory: the item's key flags [S rounded up to KT, then 16 bytes]
// (1 attend, 0 masked, 2 past S), the key groups' row statistics [wk][16
// wq][2] f32, Q [16 wq][ld], then the K tiles [KT][ld] and the V tiles
// [KT][ldv] (ldv = ld, or a 128-column chunk's in kWide): all ceil(S / KT)
// of them where resident (ring == 0), tile j in slot j, every copy issued at
// once; else a ring of `ring` rounds of wk tiles, K (pass 1) then K and V
// (pass 2), ring - 1 rounds in flight. Each round is one cp.async group
// (round 0's also holds Q). The key groups' (max, sum) are merged after pass
// 1 and their p @ V partials summed after pass 2, both in group order.
// Second: empty for one source (the kernel's arguments are then those of a
// one-source kernel), KVSecond<T> for two.
template <typename T, bool kWide, typename... Second>
__device__ __forceinline__ void attention_ring(const T* __restrict__ q, const T* __restrict__ k,
                                               const T* __restrict__ v, const uint8_t* __restrict__ mask,
                                               T* __restrict__ out, int N, int S, int H, int D, int ldq, int ldk,
                                               int ldv, size_t qbs, int prefix, float scale, int wq, int ring,
                                               Second... second) {
  constexpr bool kTwo = sizeof...(Second) > 0;
  const KVSecond<T> two{second...};
  constexpr int KT = tile_keys<kWide>(), kKeyTiles = KT / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wk = (blockDim.x >> 5) / wq, qw = warp % wq, kgrp = warp / wq, rows = 16 * wq;
  const int Dp = padded_head<T>(D), ld = ring_ld<T>(Dp);
  const int chunks = kWide ? (Dp + kAttnMaxD - 1) / kAttnMaxD : 1, d0 = kWide ? blockIdx.x % chunks * kAttnMaxD : 0;
  const int Dv = kWide ? min(D - d0, kAttnMaxD) : D, Dvp = kWide ? min(Dp - d0, kAttnMaxD) : Dp;
  const int ldvs = kWide ? ring_ld<T>(kAttnMaxD) : ld;
  const int q0 = blockIdx.x / chunks * rows, h = blockIdx.y, b = blockIdx.z;
  const int nkt = (S + KT - 1) / KT;
  const int rounds = (nkt + wk - 1) / wk, resident = ring == 0, slots = resident ? nkt : ring * wk;
  uint8_t* flags = smem_raw;
  float* stats = reinterpret_cast<float*>(smem_raw + round16(nkt * KT));
  T* Qs = reinterpret_cast<T*>(reinterpret_cast<uint8_t*>(stats) + round16(wk * rows * 8));
  T* Ks = Qs + rows * ld;
  T* Vs = Ks + slots * KT * ld;
  const int S1 = kTwo ? two.S1 : S;
  const T* kg = k + (size_t)b * S1 * ldk + h * D;
  const T* vg = v + (size_t)b * S1 * ldv + h * D + d0;
  const T* kg2 = kTwo ? two.k + (size_t)b * (S - S1) * two.ldk + h * D : nullptr;
  const T* vg2 = kTwo ? two.v + (size_t)b * (S - S1) * two.ldv + h * D + d0 : nullptr;
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
        const int nk = min(KT, S - j * KT);
        if (!pass2 || !resident)
          copy_keys<kTwo, KT>(Ks + slot * KT * ld, ld, kg, ldk, kg2, two.ldk, S1, j, nk, KT, D, Dp);
        if (pass2) copy_keys<kTwo, KT>(Vs + slot * KT * ldvs, ldvs, vg, ldv, vg2, two.ldv, S1, j, nk, KT, Dv, Dvp);
      }
    }
    sm90::cp_async_commit();
  };
  copy_rows(Qs, ld, q + b * qbs + (size_t)q0 * ldq + h * D, ldq, n_rows, rows, D, Dp);
  int issued = 0;
  for (; issued < (resident ? jobs : ring - 1); ++issued) issue(issued);
  const uint8_t* mb = mask != nullptr ? mask + (size_t)b * (S - prefix) : nullptr;
  for (int j = threadIdx.x; j < nkt * KT; j += blockDim.x)
    flags[j] = j >= S ? 2 : (j < prefix || mb == nullptr || mb[j - prefix] ? 1 : 0);

  const T* Qw = Qs + qw * 16 * ld;
  uint32_t qf[kWide ? 1 : kAttnMaxD / 16][4];
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
    if constexpr (is_bf16<T>() && !kWide) {
      if (!q_loaded) {
#pragma unroll
        for (int kk = 0; kk < kAttnMaxD / 16; ++kk)
          if (kk * 16 < D) q_fragment(qf[kk], Qw, ld, kk);
        q_loaded = true;
      }
    }
    const int s0 = j * KT;
    float sc[kKeyTiles][4];
    raw_scores<T, KT, kWide>(qf, Qw, Ks + slot * KT * ld, ld, D, sc);
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
      add_pv<T, KT>(sc, Vs + slot * KT * ldvs, ldvs, Dv, o);
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
  T* og = out + ((size_t)b * N + q0) * ldo + h * D + d0;
  if (wk == 1) {
#pragma unroll
    for (int dn = 0; dn < kAttnMaxD / 8; ++dn) {
      if (dn * 8 >= Dv) break;
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
  // (never kWide: its launch keeps one key group)
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

// The same kernel under two names, so that a profile tells K5's launches
// (attention.cu) from K6's attention phase (attn_block.cu).
#define PAELLA_ATTENTION_KERNEL(name)                                                                              \
  template <typename T, bool kWide, typename... Second>                                                             \
  __global__ void __launch_bounds__(256)                                                                            \
      name(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,                               \
           const uint8_t* __restrict__ mask, T* __restrict__ out, int N, int S, int H, int D, int ldq, int ldk,     \
           int ldv, size_t qbs, int prefix, float scale, int wq, int ring, Second... two) {                         \
    attention_ring<T, kWide>(q, k, v, mask, out, N, S, H, D, ldq, ldk, ldv, qbs, prefix, scale, wq, ring, two...);  \
  }
PAELLA_ATTENTION_KERNEL(attention_ring_kernel)
PAELLA_ATTENTION_KERNEL(block_attention_kernel)
#undef PAELLA_ATTENTION_KERNEL

template <typename T, bool kBlock, bool kWide, bool kTwo>
constexpr auto attention_kernel() {
  if constexpr (kBlock) return &block_attention_kernel<T, kWide>;
  else if constexpr (kTwo) return &attention_ring_kernel<T, kWide, KVSecond<T>>;
  else return &attention_ring_kernel<T, kWide>;
}

// ---- K5's compute-bound variant: bf16 heads of 64 on wgmma ----
//
// Stage C's attention (B 8, H 32, N 576 pixel queries, S 661 = 576 + 85
// keys, D 64) is 24.9 GFLOP a call over 81 MB: 25.2 us of tensor cores at 989
// TFLOP/s and 24.2 us of HBM, against ~1-2 us for Paella's shapes. Each (batch,
// head) holds 576 x 661 scores, so the work is no longer latency-bound: the
// ring design's mma.sync tiles (16-row warps, 8 warps a block) cannot reach
// Hopper's tensor-core rate, and its two passes of exp2 over every score
// (2 x 97 M a call through the 16-a-clock MUFU unit, ~50 us) have to overlap
// the products. This variant:
// - A block of three warpgroups takes query tiles of 192 rows of one (batch
//   item, head), one after the other: one tile, or all of them where the
//   pairs alone fill the card (attention_design); 576 = 3 x 192, so no query
//   row is padding. Each warpgroup owns 64 query rows (wgmma's M) over every
//   key, so no statistics are merged between warps and no partials summed.
// - K and V of the (batch item, head) stay resident: up to 768 keys x 128
//   bytes each (661 -> 704, 176 KB at Stage C's shape), in the 128-byte
//   swizzle the wgmma descriptors name (16-byte chunk c of key j at c ^ j %
//   8), copied with 16-byte cp.async straight from where they lie: the keys
//   [0, S1) from the q|k|v product, the rest from the conditioning cache
//   (KVSecond), one cp.async group per 64-key chunk of K, then V; the first
//   tile's pass 1 waits for each K chunk only, so it starts while V lands,
//   and later tiles find both in place. Keys past S are zero and score
//   -inf. Q goes from device memory straight into registers: its 16
//   A-fragment registers a thread are the QK^T product's A operand.
// - Pass 1: S = Q K^T on wgmma m64n64k16 (A from registers, K from shared
//   memory, f32 accumulators), 64 keys at a time; the rows' max and sum of
//   exp2(s - max) with an online rescale. Pass 2 recomputes each chunk's
//   scores with the same instructions, normalises p = exp2(s - max) / sum in
//   f32, rounds it to bf16 into the A fragments of p V (the accumulator
//   layout of 16 keys is the A-fragment layout) and issues p V on wgmma with
//   V as the MN-major B operand; the next chunk's QK^T is issued behind it.
//   The rounding points are the ring's: f32 scores, p normalised
//   in f32 before its round, f32 accumulation of p V, one round of the
//   output.
// - Every sum has a fixed order (a thread's 16 scores of a row in key order,
//   then the quad's shuffles, chunk after chunk), and nothing depends on B or
//   timing: runs are bitwise equal, and an image's output does not depend on
//   its batchmates.
// Scores are in log2 units as in the ring: exp2(s scale log2 e - m2) is one
// FFMA and one MUFU.EX2 (ftz: a p below 2^-126 is 0).
//
// Past 768 keys K and V no longer fit a block's 227 KB together (Stage B's
// level 2: 1024 queries over 1024 + 4 keys, 1088 padded, 2 x 136 KB). The
// streamed form (attention_streamed_kernel) keeps K resident as above and
// streams V through a ring of 8 KB chunk slots, as many as fit beside K up to
// kMaxRing (8 at 1028 keys; 4 at the form's longest K, 1536 keys). A 13th
// warp fills the ring: V chunk after chunk, over every query tile of the
// block, into the next slot once each of the 12 consumer warps has retired
// its p V on the slot's last chunk (the slot's `freed` mbarrier, one arrival
// a warp), with cp.async whose landing arrives on the slot's `landed`
// mbarrier (cp.async.mbarrier.arrive); a consumer waits there, then fences
// the async proxy before its wgmma reads the slot. So the first slots fill
// during pass 1, the copies stay ring - 1 chunks ahead of the slowest
// warpgroup, and no block-wide barrier is taken past the first tile's pass 1
// (a named barrier over the consumers while K lands). The ring's warp copies
// a chunk of one source as 16 strided cp.async a lane (the general per-piece
// copy, whose address arithmetic took issue slots from the consumer warps
// on its scheduler and cost ~14% of the call, only for a chunk that straddles
// S1 or S). The arithmetic is the resident form's instruction for
// instruction, so both give the same bits.
namespace wgv {
constexpr int kD = 64;                           // the head dim: one 128-byte row, the swizzle's width
constexpr int kChunk = 64;                       // keys a QK^T product (wgmma N), 4 k-steps of p V
constexpr int kGroups = 3;                       // warpgroups a block
constexpr int kRows = 64 * kGroups;              // query rows a block
constexpr int kBlockThreads = 128 * kGroups;
constexpr int kMaxKeys = 768;                    // K and V resident: 2 x 768 x 128 bytes
constexpr int kMaxRing = 8;                      // the streamed form's V chunk slots, at most
constexpr int kMaxStreamKeys = 1536;             // K resident beside a ring of 4 slots
constexpr int kRowBytes = 2 * kD;
constexpr int kChunkBytes = kChunk * kRowBytes;  // 8 KB
// attention_design's codes past the ring (0): the resident form with k query
// tiles a block (k), the streamed form with k (kStreamed + k)
constexpr int kStreamed = 256, kMaxQtiles = 255;
__host__ __device__ constexpr int padded_keys(int S) { return (S + kChunk - 1) / kChunk * kChunk; }
// K, V, the key flags, the chunks' all-attend flags, 1024 bytes of alignment slack
__host__ __device__ constexpr size_t smem_bytes(int S) {
  return 1024 + 2 * (size_t)padded_keys(S) * kRowBytes + padded_keys(S) + 16;
}
// The streamed form: K, the ring of `ring` slots, its 2 kMaxRing mbarriers,
// the key flags, the chunks' flags (up to 24), the slack; as many slots as fit
// beside K, up to kMaxRing (8 at Stage B's 1028 keys, 4 at 1536).
__host__ __device__ constexpr size_t stream_smem_bytes(int S, int ring) {
  return 1024 + (size_t)padded_keys(S) * kRowBytes + (size_t)ring * kChunkBytes + 16 * kMaxRing + padded_keys(S) + 32;
}
__host__ __device__ constexpr int ring_slots(int S) {
  const int fit = (int)((kMaxSmem - stream_smem_bytes(S, 0)) / kChunkBytes);
  return fit < kMaxRing ? fit : kMaxRing;
}
static_assert(ring_slots(kMaxStreamKeys) >= 4, "the streamed form's longest K beside 4 slots");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// Shared-memory barriers of the streamed form's ring (release on arrive,
// acquire on a successful wait).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(sm90::smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(sm90::smem_addr(bar))
               : "memory");
}
// Whether the phase of `parity` has completed; the thread is suspended until
// it does (up to 10 ms a try), so a waiting warp takes no issue slots from the
// warps that share its scheduler.
__device__ __forceinline__ bool mbar_done(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(sm90::smem_addr(bar)), "r"(parity), "r"(10000000)
      : "memory");
  return done != 0;
}
// An arrival on `bar` once every cp.async this thread issued has landed
// (the barrier counts it among the arrivals it was initialised to expect).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(sm90::smem_addr(bar)) : "memory");
}
// A barrier over the streamed form's consumer warps only (the ring's warp
// takes no part).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// This thread's 32 raw scores of one 64-key chunk (at shared address kchunk):
// sc[i] is query row g + 8 ((i >> 1) & 1) of its warp's 16 against key 8 (i
// >> 2) + 2t + (i & 1) of the chunk, the wgmma m64n64 accumulator layout.
// Waits for every product this warpgroup issued before it too.
__device__ __forceinline__ void scores(float (&sc)[32], const uint32_t (&qf)[4][4], uint32_t kchunk) {
  sm90::fence_operands(sc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::WgmmaRS<0>::mma(sc, qf[kk], sm90::desc_sw128(kchunk) + 2 * kk, kk);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_operands(sc);
}

// A chunk with masked or padded keys: a masked key's raw score is -1e9 / scale
// (-1e9 once scaled, as nn/attention.py fills it), a key past S's is -inf.
__device__ __forceinline__ void flag_scores(float (&sc)[32], const uint8_t* flags, int t, float masked) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int f = flags[(i >> 2) * 8 + 2 * t + (i & 1)];
    sc[i] = f == 1 ? sc[i] : (f == 0 ? masked : -INFINITY);
  }
}
}  // namespace wgv

// The variant's body. kStream false: K and V resident
// (attention_wgmma_kernel); true: K resident, V through the ring, whose warp
// is threads kBlockThreads on (attention_streamed_kernel).
template <typename T, bool kStream>
__device__ __forceinline__ void attention_wgmma(const T* __restrict__ q, const T* __restrict__ k,
                                                const T* __restrict__ v, const uint8_t* __restrict__ mask,
                                                T* __restrict__ out, int N, int S, int H, int ldq, int ldk, int ldv,
                                                size_t qbs, int prefix, float scale, int qtiles,
                                                const KVSecond<T>& two) {
  static_assert(is_bf16<T>(), "wgmma variant: bf16");
  using namespace wgv;
  extern __shared__ __align__(16) uint8_t wg_smem[];
  uint8_t* Ks = sm90::align1024(wg_smem);
  const int nch = (S + kChunk - 1) / kChunk, sp = nch * kChunk;
  const int ring = kStream ? ring_slots(S) : 0;
  uint8_t* Vs = Ks + (size_t)sp * kRowBytes;                                // all of V, or the ring's slots
  uint64_t* landed = reinterpret_cast<uint64_t*>(Vs + ring * kChunkBytes);  // streamed: a slot's chunk in place
  uint64_t* freed = landed + kMaxRing;                                      // streamed: a slot read by every warp
  uint8_t* flags = kStream ? reinterpret_cast<uint8_t*>(freed + kMaxRing)   // 1 attend, 0 masked, 2 past S
                           : Vs + (size_t)sp * kRowBytes;
  uint8_t* full = flags + sp;                                               // chunk c's keys all attend
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, col = h * kD;
  const int S1 = two.k != nullptr ? two.S1 : S;
  const int ntiles = (N + kRows - 1) / kRows, tile0 = blockIdx.x * qtiles, tile_end = min(ntiles, tile0 + qtiles);

  // 64-key chunk c of item b's keys into the 8 KB at shared address dst, the
  // 16-byte pieces e = first, first + stride, ...; key j at g + j ld below
  // S1, at g2 + (j - S1) ld2 from S1 on (rows of a chunk are 8-aligned keys,
  // so the swizzle of row r is the key's)
  auto copy = [&](uint32_t dst, const T* g, int ld, const T* g2, int ld2, int c, int first, int stride) {
    for (int e = first; e < kChunk * 8; e += stride) {
      const int r = e >> 3, j = c * kChunk + r, ch = e & 7;
      const bool ok = j < S;
      const T* src = !ok ? g : (j < S1 ? g + (size_t)j * ld : g2 + (size_t)(j - S1) * ld2) + ch * 8;
      sm90::cp_async16(dst + r * kRowBytes + ((ch ^ (r & 7)) << 4), src, ok);
    }
  };
  // the same for a chunk of 64 rows at g (ld apart) by one warp: lane takes
  // the 16-byte piece lane % 8 of rows lane / 8 + 4 i
  auto copy_rows = [&](uint32_t dst, const T* g, int ld) {
    const int r0 = lane >> 3, ch = lane & 7;
    const uint32_t d0 = dst + r0 * kRowBytes + ((ch ^ r0) << 4);
    const uint32_t d1 = dst + (r0 + 4) * kRowBytes + ((ch ^ (r0 + 4)) << 4);  // rows r0 + 4 (i odd)
    g += (size_t)r0 * ld + ch * 8;
#pragma unroll
    for (int i = 0; i < 16; ++i, g += 4 * (size_t)ld)
      sm90::cp_async16((i & 1 ? d1 : d0) + (i >> 1) * 8 * kRowBytes, g, true);
  };
  const T* kg = k + (size_t)b * S1 * ldk + col;
  const T* vg = v + (size_t)b * S1 * ldv + col;
  const T* kg2 = two.k != nullptr ? two.k + (size_t)b * (S - S1) * two.ldk + col : kg;
  const T* vg2 = two.v != nullptr ? two.v + (size_t)b * (S - S1) * two.ldv + col : vg;
  const uint32_t kb = sm90::smem_addr(Ks), vb = sm90::smem_addr(Vs);

  if constexpr (kStream) {
    if (tid < ring) {
      mbar_init(landed + tid, 32);
      mbar_init(freed + tid, 4 * kGroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
    if (tid >= kBlockThreads) {  // the ring's warp: the V chunks of the block's tiles, slot after slot
      for (int tile = tile0, slot = 0, round = 0; tile < tile_end; ++tile)
        for (int c = 0; c < nch; ++c) {
          if (round > 0)  // every consumer warp has retired the p V of the slot's last chunk
            while (!__all_sync(0xffffffffu, mbar_done(freed + slot, (round - 1) & 1))) {
            }
          const int j0 = c * kChunk;
          if (j0 + kChunk <= S1 || (j0 >= S1 && j0 + kChunk <= S))  // 64 keys of one source
            copy_rows(vb + slot * kChunkBytes, j0 < S1 ? vg + (size_t)j0 * ldv : vg2 + (size_t)(j0 - S1) * two.ldv,
                      j0 < S1 ? ldv : two.ldv);
          else
            copy(vb + slot * kChunkBytes, vg, ldv, vg2, two.ldv, c, lane, 32);
          cp_async_arrive(landed + slot);  // once this lane's copies have landed
          sm90::cp_async_commit();
          if (++slot == ring) slot = 0, ++round;
        }
      sm90::cp_async_wait<0>();
      return;
    }
  }
  // cp.async group c < nch: K chunk c; resident, group nch: all of V
  for (int c = 0; c < nch; ++c) {
    copy(kb + c * kChunkBytes, kg, ldk, kg2, two.ldk, c, tid, kBlockThreads);
    sm90::cp_async_commit();
  }
  if constexpr (!kStream) {
    for (int c = 0; c < nch; ++c) copy(vb + c * kChunkBytes, vg, ldv, vg2, two.ldv, c, tid, kBlockThreads);
    sm90::cp_async_commit();
  }

  const uint8_t* mb = mask != nullptr ? mask + (size_t)b * (S - prefix) : nullptr;
  auto attends = [&](int j) { return j < prefix || mb == nullptr || mb[j - prefix] != 0; };
  for (int j = tid; j < sp; j += kBlockThreads) flags[j] = j >= S ? 2 : (attends(j) ? 1 : 0);
  if (tid < nch) {
    bool all = (tid + 1) * kChunk <= S;
    for (int j = tid * kChunk; all && j < (tid + 1) * kChunk; ++j) all = attends(j);
    full[tid] = all;
  }

  const float scale2 = scale * kLog2e, masked = kMaskedScore / scale;
  int slot = 0, round = 0, last = 0;  // streamed: the ring slot of the next V chunk, its fill, the last chunk's slot
  for (int tile = tile0; tile < tile_end; ++tile) {
    const bool first = tile == tile0;  // K (and V) still landing
    // Q's A-fragments, k-step kk: rows n0 and n0 + 8, head dims 16 kk + 2t (+1) and 16 kk + 8 + 2t (+1)
    const int n0 = tile * kRows + wg * 64 + warp * 16 + g;
    uint32_t qf[4][4];
    {
      const T* r0 = q + b * qbs + (size_t)min(n0, N - 1) * ldq + col + 2 * t;
      const T* r1 = q + b * qbs + (size_t)min(n0 + 8, N - 1) * ldq + col + 2 * t;
      const bool ok0 = n0 < N, ok1 = n0 + 8 < N;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        qf[kk][0] = ok0 ? ld_u32(r0 + 16 * kk) : 0u;
        qf[kk][1] = ok1 ? ld_u32(r1 + 16 * kk) : 0u;
        qf[kk][2] = ok0 ? ld_u32(r0 + 16 * kk + 8) : 0u;
        qf[kk][3] = ok1 ? ld_u32(r1 + 16 * kk + 8) : 0u;
      }
    }
    float sc[32], m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    // pass 1: each row's max m2 (log2 units) and sum of exp2(s2 - m2)
    for (int c = 0; c < nch; ++c) {
      if (first) {
        cp_async_wait_at_most(nch - c - (kStream ? 1 : 0));  // K chunk c (this thread's copies)
        sm90::fence_proxy_async();
        if constexpr (kStream) consumers_sync(kBlockThreads);  // everyone's; the flags
        else __syncthreads();
      }
      scores(sc, qf, kb + c * kChunkBytes);
      if (!full[c]) flag_scores(sc, flags + c * kChunk, t, masked);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == r) mx = fmaxf(mx, sc[i]);
        const float m_new = fmaxf(m2[r], quad_max(mx) * scale2);  // finite: key 64 c is real
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == r) sum += ex2(fmaf(sc[i], scale2, -m_new));
        l[r] = l[r] * ex2(m2[r] - m_new) + quad_sum(sum);
        m2[r] = m_new;
      }
    }

    // pass 2: o += round(p) V, chunk after chunk
    if (!kStream && first) {
      sm90::cp_async_wait<0>();
      sm90::fence_proxy_async();
      __syncthreads();  // V
    }
    const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    uint32_t pf[4][4];  // p's A-fragments, k-step kc: keys 16 kc + [0, 16) of the chunk
    for (int c = 0; c < nch; ++c) {
      scores(sc, qf, kb + c * kChunkBytes);  // also retires chunk c - 1's p V, which read pf
      if constexpr (kStream)
        if (c > 0 && lane == 0) mbar_arrive(freed + last);
      if (!full[c]) flag_scores(sc, flags + c * kChunk, t, masked);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // rows g (e even), g + 8 (e odd); keys 16 kc + 8 (e / 2) + 2t (+1)
          const int i = 8 * kc + 2 * e, r = e & 1;
          pf[kc][e] = pack_bf16(ex2(fmaf(sc[i], scale2, -m2[r])) * inv_l[r],
                                ex2(fmaf(sc[i + 1], scale2, -m2[r])) * inv_l[r]);
        }
      uint32_t vchunk = vb + c * kChunkBytes;
      if constexpr (kStream) {
        while (!mbar_done(landed + slot, round & 1)) {
        }
        sm90::fence_proxy_async();  // the ring warp's copies, seen here, to wgmma
        vchunk = vb + slot * kChunkBytes;
        last = slot;
        if (++slot == ring) slot = 0, ++round;
      }
      fence_regs(pf);
      sm90::fence_operands(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        sm90::WgmmaRS<1>::mma(o, pf[kc], sm90::desc_sw128(vchunk + kc * 16 * kRowBytes), 1);
      sm90::wgmma_commit();
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(o);
    fence_regs(pf);
    if constexpr (kStream)
      if (lane == 0) mbar_arrive(freed + last);

    // o[i]: row n0 + 8 ((i >> 1) & 1), head dim 8 (i >> 2) + 2t + (i & 1)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int n = n0 + 8 * ((i >> 1) & 1);
      if (n < N)
        *reinterpret_cast<uint32_t*>(out + ((size_t)b * N + n) * H * kD + col + (i >> 2) * 8 + 2 * t) =
            pack_bf16(o[i], o[i + 1]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(wgv::kBlockThreads, 1)
    attention_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                           const uint8_t* __restrict__ mask, T* __restrict__ out, int N, int S, int H, int ldq,
                           int ldk, int ldv, size_t qbs, int prefix, float scale, int qtiles, const KVSecond<T> two) {
  attention_wgmma<T, false>(q, k, v, mask, out, N, S, H, ldq, ldk, ldv, qbs, prefix, scale, qtiles, two);
}
template <typename T>
__global__ void __launch_bounds__(wgv::kBlockThreads + 32, 1)
    attention_streamed_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                              const uint8_t* __restrict__ mask, T* __restrict__ out, int N, int S, int H, int ldq,
                              int ldk, int ldv, size_t qbs, int prefix, float scale, int qtiles,
                              const KVSecond<T> two) {
  attention_wgmma<T, true>(q, k, v, mask, out, N, S, H, ldq, ldk, ldv, qbs, prefix, scale, qtiles, two);
}

// K5's choice of design from the shapes it is given (attention.cu's
// paella_attention_design reports it): 0, the ring, or the wgmma variant
// (wgv's codes): the resident form for every bf16 head of 64 whose K and V
// stay resident (S <= 768), the streamed form for those whose K alone does
// (S <= 1536); the ring everything else: Paella's shapes (D 80), f32, longer
// key sequences, and always K6's attention phase.
// Measured on an H100 (chip_smoke.py item 9's sweep, device µs at D 64, each
// design forced, three runs): the variant was faster at every N x S from 64
// x 136 up and B x H 2, 32, 128 and 256 (19.2-19.4 vs 47.8-54.8 µs at 64 x
// 136 and B 8 x H 32, 29.2 vs 117-122 at Stage C's 576 x 661 and B 2 x H 16);
// at 16 x 40 it took about half the ring's time at B 1 x H 2 (4.86-4.91 vs
// 8.07-9.49), B 2 x H 16 (4.89-4.98 vs 8.22-9.65) and B 4 x H 32 (5.08-5.11 vs
// 8.09-9.67), and was within a µs of it at B 8 x H 32 (9.09-9.51 vs
// 8.52-10.42). So no problem size sends a head of 64 back to the ring.
// At Stage B's level 2 (B 4 x H 20, 1024 x 1028) the streamed form took
// 148-172 µs against the ring's 552, and 49 against 164 at B 1 (CUDA events).
// Query tiles a block, resident form: all of a (batch, head)'s where a block
// a tile would take as many waves of blocks as there are tiles anyway
// (ceil(B H tiles / SMs) >= tiles), so K and V are copied once a pair at no
// cost in waves; else one, so that more blocks are in flight. Measured at 576
// x 661: all three 130.6 vs 168.7 µs at B 8 x H 32, 64.6 vs 85.2 at B 4 x H
// 32; one 29.2 vs 61.6 at B 2 x H 16 (and at 200 x 130, two tiles: 32.1 vs
// 38.9, 16.7 vs 20.5, 15.5 vs 10.6). Streamed form: the k that takes the
// fewest tile times (waves of blocks x k), the largest such k, so K is copied
// fewest times: at level 2, B 4, k 2 (2 waves x 2 tiles) took 148 µs, k 1 (4
// x 1) 172, k 3 201 and k 6 186; at B 1, k 1 49 and k 2 72. The tiles a
// block takes change no arithmetic, so the output never depends on B.
// Two warpgroups a block (128 query rows) were timed too and lost at every
// shape (level 2, B 4: 173-206 µs; B 1: 59-192), so both forms take three.
inline bool wgmma_fits(int N, int S, int D, bool bf16) {
  return bf16 && D == wgv::kD && N >= 1 && S >= 1 && S <= wgv::kMaxKeys;
}
inline bool streamed_fits(int N, int S, int D, bool bf16) {
  return bf16 && D == wgv::kD && N >= 1 && S >= 1 && S <= wgv::kMaxStreamKeys;
}
inline int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& n = sms[dev < 64 ? dev : 0];
  if (n == 0 && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) n = 132;
  return n;
}
inline int attention_design(int B, int N, int S, int H, int D, bool bf16) {
  const long pairs = (long)B * H, tiles = (N + wgv::kRows - 1) / wgv::kRows, sms = sm_count();
  auto waves = [&](long k) { return (pairs * ((tiles + k - 1) / k) + sms - 1) / sms; };
  if (wgmma_fits(N, S, D, bf16)) return waves(1) >= tiles ? (int)std::min(tiles, (long)wgv::kMaxQtiles) : 1;
  if (!streamed_fits(N, S, D, bf16)) return 0;
  long best = 1;
  for (long k = 2; k <= std::min(tiles, (long)wgv::kMaxQtiles); ++k)
    if (waves(k) * k <= waves(best) * best) best = k;
  return wgv::kStreamed + (int)best;
}

// design: a wgv code (the form and its query tiles a block); invalid where
// the shapes do not fit the form.
template <typename T>
cudaError_t launch_attention_wgmma(const T* q, const T* k, const T* v, const uint8_t* mask, T* out, int B, int N, int S,
                                   int H, int D, int ldq, int ldk, int ldv, size_t qbs, int prefix, float scale,
                                   int design, const KVSecond<T>& two, cudaStream_t st) {
  using namespace wgv;
  const bool stream = design >= kStreamed;
  const int qtiles = design - (stream ? kStreamed : 0);
  if (qtiles < 1 || qtiles > kMaxQtiles || !(stream ? streamed_fits(N, S, D, true) : wgmma_fits(N, S, D, true)))
    return cudaErrorInvalidValue;
  const size_t bytes = stream ? stream_smem_bytes(S, ring_slots(S)) : smem_bytes(S);
  cudaError_t err = stream ? sm90::reserve_smem<attention_streamed_kernel<T>>(bytes)
                           : sm90::reserve_smem<attention_wgmma_kernel<T>>(bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((N + kRows - 1) / kRows + qtiles - 1) / qtiles, H, B);
  if (stream)
    attention_streamed_kernel<T><<<grid, kBlockThreads + 32, bytes, st>>>(q, k, v, mask, out, N, S, H, ldq, ldk, ldv,
                                                                          qbs, prefix, scale, qtiles, two);
  else
    attention_wgmma_kernel<T><<<grid, kBlockThreads, bytes, st>>>(q, k, v, mask, out, N, S, H, ldq, ldk, ldv, qbs,
                                                                  prefix, scale, qtiles, two);
  return cudaGetLastError();
}

// The ring's launch policy, shared by K5 and K6 (kBlock: under K6's kernel name):
// about four query blocks per (batch, head), 16-row warps, at most 4; the
// key tiles split among up to 8 / wq groups (one for a wide head), so that
// every SM has more than one warp per scheduler to hide latency. K and V
// stay resident in shared memory up to kResidentBytes, else stream through a
// ring of 3 rounds (fewer groups, or 2 rounds, or fewer query warps, if
// shared memory is short). Nothing here depends on B.
template <typename T, bool kBlock, bool kWide, bool kTwo>
cudaError_t launch_attention_at(const T* q, const T* k, const T* v, const uint8_t* mask, T* out, int B, int N, int S,
                                int H, int D, int ldq, int ldk, int ldv, size_t qbs, int prefix, float scale,
                                const KVSecond<T>& two, cudaStream_t st) {
  constexpr int KT = tile_keys<kWide>();
  const int Dp = padded_head<T>(D), ld = ring_ld<T>(Dp), ldvs = kWide ? ring_ld<T>(kAttnMaxD) : ld;
  const int chunks = kWide ? (Dp + kAttnMaxD - 1) / kAttnMaxD : 1, nkt = (S + KT - 1) / KT;
  const size_t tiles = (size_t)KT * (ld + ldvs) * sizeof(T);  // one K and one V tile
  int wq = min(4, (N + 63) / 64), wk = kWide ? 1 : min(nkt, 8 / wq), ring = 0;
  auto bytes = [&]() {
    const int rows = 16 * wq;
    return round16(nkt * KT) + (size_t)rows * ld * sizeof(T) + round16(wk * rows * 8) +
           (ring == 0 ? nkt : ring * wk) * tiles;
  };
  if (bytes() > kResidentBytes) {
    ring = 3;
    while (bytes() > kMaxSmem && wk > 1) --wk;
    if (bytes() > kMaxSmem) ring = 2;
    while (bytes() > kMaxSmem && wq > 1) --wq;
  }
  if (bytes() > kMaxSmem) return cudaErrorInvalidValue;
  constexpr auto kernel = attention_kernel<T, kBlock, kWide, kTwo>();
  cudaError_t err = sm90::reserve_smem<kernel>(bytes());
  if (err != cudaSuccess) return err;
  const int rows = 16 * wq;
  const dim3 grid((N + rows - 1) / rows * chunks, H, B);
  if constexpr (kTwo)
    kernel<<<grid, 32 * wq * wk, bytes(), st>>>(q, k, v, mask, out, N, S, H, D, ldq, ldk, ldv, qbs, prefix, scale, wq,
                                                ring, two);
  else
    kernel<<<grid, 32 * wq * wk, bytes(), st>>>(q, k, v, mask, out, N, S, H, D, ldq, ldk, ldv, qbs, prefix, scale, wq,
                                                ring);
  return cudaGetLastError();
}

// two: keys [two.S1, S) from a second source (two.k null: one source; K6
// reads one). design: -1 as attention_design picks (K6: the ring), 0 the
// ring, else the wgmma variant's form and query tiles a block as wgv codes
// them (cudaErrorInvalidValue where the shapes do not fit it).
template <typename T, bool kBlock>
cudaError_t launch_attention(const T* q, const T* k, const T* v, const uint8_t* mask, T* out, int B, int N, int S,
                             int H, int D, int ldq, int ldk, int ldv, size_t qbs, int prefix, float scale,
                             cudaStream_t st, const KVSecond<T>& two = {}, int design = -1) {
  if (D % 8) return cudaErrorInvalidValue;
  if constexpr (is_bf16<T>() && !kBlock) {
    if (design < 0) design = attention_design(B, N, S, H, D, true);
    if (design > 0)
      return launch_attention_wgmma<T>(q, k, v, mask, out, B, N, S, H, D, ldq, ldk, ldv, qbs, prefix, scale, design,
                                       two, st);
  } else {
    if (design > 0) return cudaErrorInvalidValue;
  }
  const bool wide = padded_head<T>(D) > kAttnMaxD;
  if constexpr (!kBlock) {
    if (two.k != nullptr) {
      if (wide)
        return launch_attention_at<T, kBlock, true, true>(q, k, v, mask, out, B, N, S, H, D, ldq, ldk, ldv, qbs, prefix,
                                                          scale, two, st);
      return launch_attention_at<T, kBlock, false, true>(q, k, v, mask, out, B, N, S, H, D, ldq, ldk, ldv, qbs, prefix,
                                                         scale, two, st);
    }
  }
  if (wide)
    return launch_attention_at<T, kBlock, true, false>(q, k, v, mask, out, B, N, S, H, D, ldq, ldk, ldv, qbs, prefix,
                                                       scale, two, st);
  return launch_attention_at<T, kBlock, false, false>(q, k, v, mask, out, B, N, S, H, D, ldq, ldk, ldv, qbs, prefix,
                                                      scale, two, st);
}

}  // namespace paella
