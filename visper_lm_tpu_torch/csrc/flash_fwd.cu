// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel visper_lm_tpu/ops/flash_attention.py `_fwd_kernel`
// (:97), launched by `_fwd`'s pl.pallas_call (:234). Same function:
//   * causal or non-causal attention, GQA (query head h reads kv head h / G,
//     never repeated);
//   * column masks cols >= kv_lengths[b] and cols < kv_starts[b];
//   * f32 online softmax and accumulators, the scale applied to the f32 scores;
//   * out in the input dtype, lse as (B, Nq, T) f32 (no 128-lane broadcast);
//   * a fully masked row gives out = 0 and lse = NEG_INF, as in Pallas.
// Inputs are read in the framework's BTNH layout through their strides.
//
// Bound on an H100 SXM at the serving prefill shape (B8, T768, 32/32 heads,
// H96, bf16, causal): the bytes it must move (q, k, v read once, out written
// once: ~151 MB, ~45 us at 3.35 TB/s) exceed its ~2.9e10 causal FLOPs
// (~29 us at 989 TFLOP/s), so the ideal kernel is bound by memory; a real one
// re-reads K and V once per 128-row query tile (from L2, when the tiles of a
// head run together) and is held back by how well the tensor cores are fed.
//
// Three kernels; ops/flash_attention.py `flash_fwd_kernel_for` names the one
// a call takes and passes its number here.
//
// 1. `flash_fwd_wgmma_kernel` (bf16, every supported shape): built around
//    wgmma, the only way to the card's tensor-core rate, and a copy engine
//    that keeps it fed.
//    - A CTA owns 128 query rows of one (batch, head): two consumer
//      warpgroups of 64 rows each and one producer warp. The Q tile and a ring
//      of kStages K/V tiles of 128 keys live in shared memory; one producer
//      thread fills them with TMA box copies through 4-D tensor maps
//      (H, N, T, B with the tensor's own strides, so BTNH views need no copy),
//      encoded per call (activations move) by cuTensorMapEncodeTiled, taken
//      through cudaGetDriverEntryPoint. mbarriers pass the stages back and
//      forth (K and V of a stage have a barrier each, so Q K^T starts before
//      V has landed); rows beyond T or S arrive as zeros, masking still
//      comes from [kv_start, kv_len) and the diagonal.
//    - A tile is cut into column blocks of one swizzle span: 64 columns in
//      the 128-byte swizzle at H 64 and 128, 32 columns in the 64-byte
//      swizzle at H 96 (192-byte rows fit no 128-byte atom). S = Q K^T takes
//      both operands from shared memory (K-major descriptors); O += P V takes
//      P from registers (the S accumulators of two neighbouring 8-column
//      blocks are one A fragment, rounded to bf16 as the Pallas kernel
//      rounds it) and V through the transposing (MN-major) descriptor, so V
//      is never transposed in memory.
//    - f32 online softmax in the log2 domain on the accumulator registers,
//      cut to few instructions, because with two warps on each scheduler
//      they, not the tensor cores, set the pace: the row max is taken on the
//      raw scores (the scale must be positive), each probability is one
//      fused multiply-add and one ex2.approx, O is rescaled only when a
//      row's max moved, and a mask is one unsigned compare per score, on
//      tiles that cross a bound or the diagonal only. The kv loop runs from
//      the tile of kv_starts[b] to the diagonal / kv length.
//    - O leaves through shared memory (the warpgroup's own rows of the Q
//      tile, free by then) and a TMA store: whole row pieces instead of
//      4-byte stores from the accumulator layout.
//    - The grid is one-dimensional: the tiles of one (batch, head) are
//      neighbours (their K/V re-reads meet in L2) and the late (long) causal
//      tiles of each come first.
// 2. `flash_fwd_bf16_kernel` (the kernel before it: it keeps the calls whose
//    scale is not positive, and is timed beside the other): mma.sync
//    m16n8k16, one CTA of 4 warps per 64 query rows, K and V tiles of 64 keys
//    copied by the compute warps into padded shared memory.
// 3. `flash_fwd_f32_kernel` (f32, for checking): SIMT, one thread per query
//    row, per-key online softmax in full f32.

#include <math.h>

#include "mma_bf16.cuh"
#include "tma_sm90.cuh"
#include "wgmma_bf16.cuh"

namespace {

using visper::kLn2;
using visper::kLog2e;
using visper::kNegInf;
using visper::ex2;
using visper::fence_proxy_async;
using visper::ld32;
using visper::mbar_arrive;
using visper::mbar_expect_tx;
using visper::mbar_init;
using visper::mbar_wait;
using visper::mma_bf16;
using visper::pack_bf16;
using visper::pack_f32;
using visper::smem_desc;
using visper::smem_u32;
using visper::tensor_map;
using visper::tma_load_4d;
using visper::tma_store_4d;
using visper::tma_store_drain;
using visper::wgmma_commit;
using visper::wgmma_fence;
using visper::wgmma_rs;
using visper::wgmma_ss;
using visper::wgmma_wait;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* kv_len;    // (B,) or null: every column < S is valid
  const int* kv_start;  // (B,) or null: every column >= 0 is valid
  long long q_sb, q_st, q_sn;
  long long k_sb, k_st, k_sn;
  long long v_sb, v_st, v_sn;
  long long o_sb, o_st, o_sn;
  int B, T, S, Nq, Nkv, group;
  float scale;
  int causal;
};

// Valid columns of batch row b are [lo, len); a q tile whose last row is
// q_last needs no column past min(len, q_last + 1) when causal.
__device__ __forceinline__ void kv_bounds(const Params& p, int b, int q_last,
                                          int& lo, int& len, int& hi) {
  len = p.kv_len ? min(p.kv_len[b], p.S) : p.S;
  lo = p.kv_start ? max(p.kv_start[b], 0) : 0;
  hi = p.causal ? min(len, q_last + 1) : len;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kBM = 64;  // query rows per CTA (16 per warp)
constexpr int kBN = 64;  // keys per kv tile
constexpr int kWarps = 4;

template <int H, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int nrows) {
  visper::load_tile<kBM, H, LD, kWarps * 32>(smem, base, row_stride, row0, nrows);
}

template <int H>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_bf16_kernel(const Params p) {
  constexpr int LD = H + 8;  // padded row stride (elements)
  constexpr int KS = H / 16; // k-steps of S = Q K^T
  constexpr int NT = H / 8;  // n-tiles of O
  constexpr int SN = kBN / 8;  // n-tiles of S
  __shared__ __align__(16) __nv_bfloat16 ks[kBN * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kBN * LD];

  const int q0 = blockIdx.x * kBM;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / p.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row group
  const int tq = lane % 4;  // thread in group

  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + head * p.q_sn;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sn;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sn;

  // Q tile -> A fragments in registers, staged through the K buffer.
  load_tile<H, LD>(ks, qb, p.q_st, q0, p.T);
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const __nv_bfloat16* lo_row = ks + r0 * LD + kk * 16 + tq * 2;
    const __nv_bfloat16* hi_row = lo_row + 8 * LD;
    qa[kk][0] = ld32(lo_row);
    qa[kk][1] = ld32(hi_row);
    qa[kk][2] = ld32(lo_row + 8);
    qa[kk][3] = ld32(hi_row + 8);
  }
  __syncthreads();

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  const int row_a = q0 + r0;
  const int rows[2] = {row_a, row_a + 8};
  const float scale_log2 = p.scale * kLog2e;

  int lo, len, hi;
  kv_bounds(p, b, q0 + kBM - 1, lo, len, hi);

  for (int k0 = (lo / kBN) * kBN; k0 < hi; k0 += kBN) {
    load_tile<H, LD>(ks, kb, p.k_st, k0, p.S);
    load_tile<H, LD>(vs, vb, p.v_st, k0, p.S);
    __syncthreads();

    float s[SN][4];
#pragma unroll
    for (int nt = 0; nt < SN; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int nt = 0; nt < SN; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + g) * LD + kk * 16 + tq * 2;
        mma_bf16(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale in f32 (log2 domain), mask, row max over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < SN; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + tq * 2 + (e & 1);
        const int row = rows[e >> 1];
        const bool ok = col >= lo && col < len && (!p.causal || col <= row);
        const float x = ok ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with no valid column yet keeps exp() arguments at -inf
      base[r] = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = (m[r] == -INFINITY) ? 0.f : exp2f(m[r] - base[r]);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        o[nt][2 * r] *= alpha;
        o[nt][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < SN; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - base[e >> 1]);
        s[nt][e] = pe;
        l[e >> 1] += pe;
      }
    }

    // O += P V: the S accumulators of two n-tiles are the A fragment of a
    // 16-key chunk of P.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]),
          pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* v0 = vs + (kk * 16 + tq * 2) * LD + nt * 8 + g;
        const uint32_t b0 = pack_bf16(v0[0], v0[LD]);
        const uint32_t b1 = pack_bf16(v0[8 * LD], v0[9 * LD]);
        mma_bf16(o[nt], pa, b0, b1);
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + head * p.o_sn;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = rows[r];
    if (row >= p.T) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* orow = ob + row * p.o_st;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + tq * 2) =
          pack_f32(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
    }
    if (tq == 0) {
      p.lse[(static_cast<long long>(b) * p.Nq + head) * p.T + row] =
          l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kNegInf;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA ring + wgmma, two consumer warpgroups and a producer warp
// ---------------------------------------------------------------------------

constexpr int kWgBM = 128;           // query rows per CTA: 64 per consumer warpgroup
constexpr int kWgBN = 128;           // keys per kv tile
constexpr int kWgConsumers = 256;    // two warpgroups
constexpr int kWgThreads = kWgConsumers + 32;  // and the producer's warp

// Shared-memory geometry of the wgmma kernel at head dim H.
template <int H>
struct WgCfg {
  static constexpr int kCB = (H % 64 == 0) ? 64 : 32;  // columns per swizzled block
  static constexpr int kNB = H / kCB;                  // column blocks per tile
  static constexpr int kSwz = kCB * 2;                 // bytes per block row: the swizzle span
  static constexpr int kStages = (H <= 96) ? 3 : 2;
  static constexpr int kQBlock = kWgBM * kSwz;         // bytes of one column block of Q
  static constexpr int kKvBlock = kWgBN * kSwz;        // ... of a K or V tile
  static constexpr int kQBytes = kNB * kQBlock;
  static constexpr int kTileBytes = kNB * kKvBlock;
  static constexpr int kBarriers = 1 + 3 * kStages;    // q; k full, v full, empty per stage
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 8 * kBarriers + 1024;
};

template <int H>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap o_map, const Params p) {
  using C = WgCfg<H>;
  constexpr int kSN = kWgBN / 8;  // 8-column blocks of S
  constexpr int kON = H / 8;      // 8-column blocks of O
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;                                   // [kNB][128][kCB]
  const uint32_t ks = qs + C::kQBytes;                        // [kStages][kNB][128][kCB]
  const uint32_t vs = ks + C::kStages * C::kTileBytes;        // likewise
  const uint32_t q_full = vs + C::kStages * C::kTileBytes;    // mbarriers
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * C::kStages;
  const uint32_t empty = v_full + 8 * C::kStages;

  // the tiles of one (batch, head) are neighbours in the grid, the last first
  const int ntiles = (p.T + kWgBM - 1) / kWgBM;
  const int tile = ntiles - 1 - static_cast<int>(blockIdx.x % ntiles);
  const int bh = blockIdx.x / ntiles;
  const int head = bh % p.Nq;
  const int b = bh / p.Nq;
  const int kvh = head / p.group;
  const int q0 = tile * kWgBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);                // the producer's expect_tx arrival
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWgConsumers / 32);  // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int lo, len, hi;
  kv_bounds(p, b, q0 + kWgBM - 1, lo, len, hi);
  const int k_begin = (lo / kWgBN) * kWgBN;
  const int ntk = hi > k_begin ? (hi - k_begin + kWgBN - 1) / kWgBN : 0;

  if (threadIdx.x >= kWgConsumers) {
    // ---- producer: one thread asks the copy engine for Q, then each stage's K and V
    if (lane == 0 && ntk > 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int nb = 0; nb < C::kNB; ++nb) {
        tma_load_4d(qs + nb * C::kQBlock, &q_map, nb * C::kCB, head, q0, b, q_full);
      }
      for (int it = 0; it < ntk; ++it) {
        const int s = it % C::kStages;
        const int k0 = k_begin + it * kWgBN;
        mbar_wait(empty + 8 * s, ((it / C::kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, C::kTileBytes);
#pragma unroll
        for (int nb = 0; nb < C::kNB; ++nb) {
          tma_load_4d(ks + s * C::kTileBytes + nb * C::kKvBlock, &k_map, nb * C::kCB, kvh, k0, b,
                      k_full + 8 * s);
        }
        mbar_expect_tx(v_full + 8 * s, C::kTileBytes);
#pragma unroll
        for (int nb = 0; nb < C::kNB; ++nb) {
          tma_load_4d(vs + s * C::kTileBytes + nb * C::kKvBlock, &v_map, nb * C::kCB, kvh, k0, b,
                      v_full + 8 * s);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: thread (w, g, tq) holds rows 16 w + g and + 8 of
  // its warpgroup's 64
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, tq = lane % 4;
  const int wg_row0 = q0 + 64 * wg;
  const int rows[2] = {wg_row0 + 16 * w + g, wg_row0 + 16 * w + g + 8};
  const float scale_log2 = p.scale * kLog2e;

  float o[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum

  if (ntk > 0) {
    mbar_wait(q_full, 0);
    __syncwarp();  // wgmma is warp-aligned: reconverge after the spin
  }
  for (int it = 0; it < ntk; ++it) {
    const int s = it % C::kStages;
    const uint32_t phase = (it / C::kStages) & 1;
    const int k0 = k_begin + it * kWgBN;
    const uint32_t kt = ks + s * C::kTileBytes;
    const uint32_t vt = vs + s * C::kTileBytes;

    // S = Q K^T: a k-step is 32 bytes along a swizzled block row
    mbar_wait(k_full + 8 * s, phase);
    __syncwarp();
    float sa[kWgBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const int nb = (kk * 16) / C::kCB, within = ((kk * 16) % C::kCB) * 2;
      const uint64_t da = smem_desc<C::kSwz>(
          qs + nb * C::kQBlock + wg * 64 * C::kSwz + within, 16, 8 * C::kSwz);
      const uint64_t db = smem_desc<C::kSwz>(kt + nb * C::kKvBlock + within, 16, 8 * C::kSwz);
      wgmma_ss<kWgBN>(sa, da, db, kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<0>();

    // Mask where the tile crosses a bound or the diagonal: seen from this
    // thread's first column, row r's valid columns are [c_lo, c_lo + width[r])
    const bool need_mask = k0 < lo || k0 + kWgBN > len || (p.causal && k0 + kWgBN - 1 > wg_row0);
    if (need_mask) {
      const int first = k0 + 2 * tq;
      const int c_lo = lo - first;
      unsigned width[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int c_hi = (p.causal ? min(len, rows[r] + 1) : len) - first;
        width[r] = static_cast<unsigned>(max(c_hi - c_lo, 0));
      }
#pragma unroll
      for (int i = 0; i < kWgBN / 2; ++i) {
        const int c = 8 * (i >> 2) + (i & 1);
        if (static_cast<unsigned>(c - c_lo) >= width[(i >> 1) & 1]) sa[i] = -INFINITY;
      }
    }
    // Row max of the raw scores (the scale is positive, so it commutes with
    // the max), two chains per row; then one fused multiply-add and one
    // ex2 per score: p = 2^(s * scale_log2 - max)
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
    for (int nt = 0; nt < kSN; ++nt) {
      mx[0][nt & 1] = fmaxf(mx[0][nt & 1], fmaxf(sa[4 * nt], sa[4 * nt + 1]));
      mx[1][nt & 1] = fmaxf(mx[1][nt & 1], fmaxf(sa[4 * nt + 2], sa[4 * nt + 3]));
    }
    float rowbase[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mr = fmaxf(mx[r][0], mx[r][1]);
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 1));
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
      const float m_new = fmaxf(m[r], mr * scale_log2);
      // a row with no valid column yet keeps ex2's arguments at -inf
      rowbase[r] = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = ex2(m[r] - rowbase[r]);
      m[r] = m_new;
      if (alpha != 1.f) {  // the max moves in the first tiles of a row and seldom later
        l[r] *= alpha;
#pragma unroll
        for (int nt = 0; nt < kON; ++nt) {
          o[4 * nt + 2 * r] *= alpha;
          o[4 * nt + 2 * r + 1] *= alpha;
        }
      }
    }
    // P rounded to bf16 for the second product: the accumulators of blocks
    // 2 kk and 2 kk + 1 are the A fragment of k-step kk
    uint32_t pa[kWgBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWgBN / 16; ++kk) {
      float pe[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        pe[i] = ex2(fmaf(sa[8 * kk + i], scale_log2, -rowbase[(i >> 1) & 1]));
      }
      l[0] += (pe[0] + pe[1]) + (pe[4] + pe[5]);
      l[1] += (pe[2] + pe[3]) + (pe[6] + pe[7]);
      pa[kk][0] = pack_f32(pe[0], pe[1]);
      pa[kk][1] = pack_f32(pe[2], pe[3]);
      pa[kk][2] = pack_f32(pe[4], pe[5]);
      pa[kk][3] = pack_f32(pe[6], pe[7]);
    }

    // O += P V: V rows are keys (k), its columns the output's (n): MN-major
    mbar_wait(v_full + 8 * s, phase);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgBN / 16; ++kk) {
      const uint64_t db = smem_desc<C::kSwz>(vt + kk * 16 * C::kSwz, C::kKvBlock, 8 * C::kSwz);
      wgmma_rs<H>(o, pa[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // O / l leaves through this warpgroup's own rows of the Q tile (its last
  // Q K^T is done), written in the tile's swizzled layout (a warp's eight rows
  // land on distinct banks), and from there as one TMA box per column block:
  // whole 128- or 64-byte row pieces, rows beyond T clipped by the copy engine.
  uint8_t* const stage = smem_raw + (qs - smem_u32(smem_raw)) + wg * 64 * C::kSwz;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int lrow = 16 * w + g + 8 * r;  // row within the warpgroup's 64
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    // the 16-byte chunk c of row i sits at chunk c ^ (i & 7) in the 128-byte
    // swizzle, at c ^ ((i >> 1) & 3) in the 64-byte one
    const int sw = C::kSwz == 128 ? (lrow & 7) : ((lrow >> 1) & 3);
#pragma unroll
    for (int nt = 0; nt < kON; ++nt) {
      const int nb = (nt * 8) / C::kCB, chunk = ((nt * 8) % C::kCB) / 8;
      *reinterpret_cast<uint32_t*>(stage + nb * C::kQBlock + lrow * C::kSwz +
                                   ((chunk ^ sw) << 4) + 4 * tq) =
          pack_f32(o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
    }
    const int row = rows[r];
    if (tq == 0 && row < p.T) {
      p.lse[(static_cast<long long>(b) * p.Nq + head) * p.T + row] =
          l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kNegInf;
    }
  }
  // the copy engine reads what the warpgroup's threads wrote
  fence_proxy_async();
  if (wg == 0) {
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  } else {
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  }
  if (w == 0 && lane == 0) {
#pragma unroll
    for (int nb = 0; nb < C::kNB; ++nb) {
      tma_store_4d(&o_map, qs + nb * C::kQBlock + wg * 64 * C::kSwz, nb * C::kCB, head, wg_row0, b);
    }
    tma_store_drain();  // before the CTA's memory goes
  }
}

template <int H>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  using C = WgCfg<H>;
  if (!(p.scale > 0.f)) return cudaErrorInvalidValue;
  static bool attr_set = false;  // shared memory above 48 KB is opted into once
  if (!attr_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (rc != cudaSuccess) return rc;
    attr_set = true;
  }
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!tensor_map(p.o, H, p.Nq, p.T, p.B, p.o_sb, p.o_st, p.o_sn, C::kCB, kWgBM / 2, &o_map) ||
      !tensor_map(p.q, H, p.Nq, p.T, p.B, p.q_sb, p.q_st, p.q_sn, C::kCB, kWgBM, &q_map) ||
      !tensor_map(p.k, H, p.Nkv, p.S, p.B, p.k_sb, p.k_st, p.k_sn, C::kCB, kWgBN, &k_map) ||
      !tensor_map(p.v, H, p.Nkv, p.S, p.B, p.v_sb, p.v_st, p.v_sn, C::kCB, kWgBN, &v_map)) {
    return cudaErrorInvalidValue;
  }
  const long long ctas = static_cast<long long>((p.T + kWgBM - 1) / kWgBM) * p.Nq * p.B;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_wgmma_kernel<H><<<static_cast<unsigned>(ctas), kWgThreads, C::kSmem, stream>>>(
      q_map, k_map, v_map, o_map, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: SIMT, one thread per query row
// ---------------------------------------------------------------------------

constexpr int kSimtRows = 32;
constexpr int kSimtKeys = 16;

template <int H>
__global__ void __launch_bounds__(kSimtRows) flash_fwd_f32_kernel(const Params p) {
  __shared__ float qs[kSimtRows][H + 1];  // +1: rows on distinct banks
  __shared__ float ks[kSimtKeys][H];
  __shared__ float vs[kSimtKeys][H];

  const int q0 = blockIdx.x * kSimtRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / p.group;
  const int t = threadIdx.x;
  const int row = q0 + t;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + head * p.q_sn;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sn;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sn;

  for (int i = t; i < kSimtRows * H; i += kSimtRows) {
    const int r = i / H, c = i % H;
    qs[r][c] = (q0 + r < p.T) ? qb[(q0 + r) * p.q_st + c] : 0.f;
  }

  float acc[H];
#pragma unroll
  for (int c = 0; c < H; ++c) acc[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  int lo, len, hi;
  kv_bounds(p, b, q0 + kSimtRows - 1, lo, len, hi);

  for (int k0 = (lo / kSimtKeys) * kSimtKeys; k0 < hi; k0 += kSimtKeys) {
    __syncthreads();
    for (int i = t; i < kSimtKeys * H; i += kSimtRows) {
      const int r = i / H, c = i % H;
      const bool in = k0 + r < p.S;
      ks[r][c] = in ? kb[(k0 + r) * p.k_st + c] : 0.f;
      vs[r][c] = in ? vb[(k0 + r) * p.v_st + c] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kSimtKeys; ++j) {
      const int col = k0 + j;
      if (col < lo || col >= len || (p.causal && col > row)) continue;
      float sc = 0.f;
#pragma unroll
      for (int c = 0; c < H; ++c) sc = fmaf(qs[t][c], ks[j][c], sc);
      sc *= p.scale;
      const float m_new = fmaxf(m, sc);
      const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
      const float pr = expf(sc - m_new);
      l = l * alpha + pr;
#pragma unroll
      for (int c = 0; c < H; ++c) acc[c] = fmaf(acc[c], alpha, pr * vs[j][c]);
      m = m_new;
    }
  }

  if (row < p.T) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* orow = static_cast<float*>(p.o) + b * p.o_sb + head * p.o_sn + row * p.o_st;
#pragma unroll
    for (int c = 0; c < H; ++c) orow[c] = acc[c] * inv;
    p.lse[(static_cast<long long>(b) * p.Nq + head) * p.T + row] =
        l > 0.f ? m + logf(l) : kNegInf;
  }
}

// kernel: 0 the f32 SIMT kernel, 1 wgmma (bf16), 2 mma.sync (bf16)
template <int H>
cudaError_t launch(const Params& p, int kernel, cudaStream_t stream) {
  if (kernel == 1) return launch_wgmma<H>(p, stream);
  if (kernel == 0) {
    const dim3 grid((p.T + kSimtRows - 1) / kSimtRows, p.Nq, p.B);
    flash_fwd_f32_kernel<H><<<grid, kSimtRows, 0, stream>>>(p);
  } else if (kernel == 2) {
    const dim3 grid((p.T + kBM - 1) / kBM, p.Nq, p.B);
    flash_fwd_bf16_kernel<H><<<grid, kWarps * 32, 0, stream>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). Strides are in
// elements; the last (head-dim) stride must be 1. kernel: 0 the f32 SIMT kernel
// (f32 inputs), 1 wgmma, 2 mma.sync (bf16 inputs; wgmma also needs 16-byte
// aligned rows and a positive scale). kv_len / kv_start may be null.
extern "C" int visper_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* kv_len, const void* kv_start,
    long long q_sb, long long q_st, long long q_sn,
    long long k_sb, long long k_st, long long k_sn,
    long long v_sb, long long v_st, long long v_sn,
    long long o_sb, long long o_st, long long o_sn,
    int B, int T, int S, int Nq, int Nkv, int H, float scale, int causal,
    int kernel, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_start = static_cast<const int*>(kv_start);
  p.q_sb = q_sb; p.q_st = q_st; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sn = o_sn;
  p.B = B; p.T = T; p.S = S; p.Nq = Nq; p.Nkv = Nkv;
  p.group = Nq / Nkv;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64: return static_cast<int>(launch<64>(p, kernel, st));
    case 96: return static_cast<int>(launch<96>(p, kernel, st));
    case 128: return static_cast<int>(launch<128>(p, kernel, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Geometry of the wgmma kernel at head dim H, for reports: dynamic shared
// memory in bytes, keys per kv tile, ring stages. Returns 0, or 1 for an H it
// does not take.
extern "C" int visper_flash_fwd_wgmma_info(int H, int* smem_bytes, int* kv_tile, int* stages) {
  switch (H) {
    case 64: *smem_bytes = WgCfg<64>::kSmem; *stages = WgCfg<64>::kStages; break;
    case 96: *smem_bytes = WgCfg<96>::kSmem; *stages = WgCfg<96>::kStages; break;
    case 128: *smem_bytes = WgCfg<128>::kSmem; *stages = WgCfg<128>::kStages; break;
    default: return 1;
  }
  *kv_tile = kWgBN;
  return 0;
}
