// The masked multi-head attention core of K5 (attention.cu) and of K6's
// attention phase (attn_block.cu), for Hopper (sm_90a), bf16 or f32:
//
//   s = (q . k) * scale              f32, scale = D^-1/2 of the true head dim
//   s = -1e9 where the key is masked
//   p = exp(s - max_j s) / sum_j exp(s - max_j s)     f32
//   o = sum_j round_T(p) * v_j       f32 accumulation, rounded to T at the end
//
// the rounding points of paella_tpu/kernels/attention.py:32-53 and of the
// attention phase of paella_tpu/kernels/attn_block.py:93-127. One block of
// 1-8 warps takes a query tile of one (batch, head): 16 query rows a warp,
// the key tiles split among the warps that share query rows (attention.cu's
// header has the design and what it measured).
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
template <typename T, bool kWide>
__device__ __forceinline__ void attention_ring(const T* __restrict__ q, const T* __restrict__ k,
                                               const T* __restrict__ v, const uint8_t* __restrict__ mask,
                                               T* __restrict__ out, int N, int S, int H, int D, int ldq, int ldk,
                                               int ldv, size_t qbs, int prefix, float scale, int wq, int ring) {
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
  const T* kg = k + (size_t)b * S * ldk + h * D;
  const T* vg = v + (size_t)b * S * ldv + h * D + d0;
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
        if (!pass2 || !resident) copy_rows(Ks + slot * KT * ld, ld, kg + (size_t)j * KT * ldk, ldk, nk, KT, D, Dp);
        if (pass2) copy_rows(Vs + slot * KT * ldvs, ldvs, vg + (size_t)j * KT * ldv, ldv, nk, KT, Dv, Dvp);
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
  template <typename T, bool kWide>                                                                                 \
  __global__ void __launch_bounds__(256)                                                                            \
      name(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,                               \
           const uint8_t* __restrict__ mask, T* __restrict__ out, int N, int S, int H, int D, int ldq, int ldk,     \
           int ldv, size_t qbs, int prefix, float scale, int wq, int ring) {                                        \
    attention_ring<T, kWide>(q, k, v, mask, out, N, S, H, D, ldq, ldk, ldv, qbs, prefix, scale, wq, ring);          \
  }
PAELLA_ATTENTION_KERNEL(attention_ring_kernel)
PAELLA_ATTENTION_KERNEL(block_attention_kernel)
#undef PAELLA_ATTENTION_KERNEL

template <typename T, bool kBlock, bool kWide>
constexpr auto attention_kernel() {
  if constexpr (kBlock) return &block_attention_kernel<T, kWide>;
  else return &attention_ring_kernel<T, kWide>;
}

// The launch policy, shared by K5 and K6 (kBlock: under K6's kernel name):
// about four query blocks per (batch, head), 16-row warps, at most 4; the
// key tiles split among up to 8 / wq groups (one for a wide head), so that
// every SM has more than one warp per scheduler to hide latency. K and V
// stay resident in shared memory up to kResidentBytes, else stream through a
// ring of 3 rounds (fewer groups, or 2 rounds, or fewer query warps, if
// shared memory is short). Nothing here depends on B.
template <typename T, bool kBlock, bool kWide>
cudaError_t launch_attention_at(const T* q, const T* k, const T* v, const uint8_t* mask, T* out, int B, int N, int S,
                                int H, int D, int ldq, int ldk, int ldv, size_t qbs, int prefix, float scale,
                                cudaStream_t st) {
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
  constexpr auto kernel = attention_kernel<T, kBlock, kWide>();
  cudaError_t err = sm90::reserve_smem<kernel>(bytes());
  if (err != cudaSuccess) return err;
  const int rows = 16 * wq;
  kernel<<<dim3((N + rows - 1) / rows * chunks, H, B), 32 * wq * wk, bytes(), st>>>(q, k, v, mask, out, N, S, H, D, ldq,
                                                                                   ldk, ldv, qbs, prefix, scale, wq,
                                                                                   ring);
  return cudaGetLastError();
}

template <typename T, bool kBlock>
cudaError_t launch_attention(const T* q, const T* k, const T* v, const uint8_t* mask, T* out, int B, int N, int S,
                             int H, int D, int ldq, int ldk, int ldv, size_t qbs, int prefix, float scale,
                             cudaStream_t st) {
  if (D % 8) return cudaErrorInvalidValue;
  if (padded_head<T>(D) > kAttnMaxD)
    return launch_attention_at<T, kBlock, true>(q, k, v, mask, out, B, N, S, H, D, ldq, ldk, ldv, qbs, prefix, scale,
                                                st);
  return launch_attention_at<T, kBlock, false>(q, k, v, mask, out, B, N, S, H, D, ldq, ldk, ldv, qbs, prefix, scale,
                                               st);
}

}  // namespace paella
