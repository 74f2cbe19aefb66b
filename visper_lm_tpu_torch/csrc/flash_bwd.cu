// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two TPU kernels of visper_lm_tpu/ops/flash_attention.py `_bwd`:
//   * B2, `_bwd_dq_kernel` (:321, pl.pallas_call :497):
//       dq = scale * (P o (dP - delta)) K,  dP = dO V^T;
//   * B3, `_bwd_dkv_kernel` (:373, pl.pallas_call :562, kv-major order of
//     `_kv_major_group_pairs` :287):
//       dv = P^T dO,  dk = scale * (P o (dP - delta))^T Q,
//     summed over the G query heads of each kv head and written once.
// P is recomputed from q, k and the forward's lse exactly as `_recompute_p`
// (:273): p = exp(s * scale - lse) on unmasked pairs, 0 on masked pairs and on
// rows whose lse is NEG_INF (rows with no valid key). delta = rowsum(dO o O)
// comes in from the caller (the JAX package computes it in XLA, :457).
// Masks, GQA and layouts are those of the forward (flash_fwd.cu): causal or
// not, columns >= kv_lengths[b] and < kv_starts[b] masked, BTNH tensors read
// through their strides, lse/delta (B, Nq, T) f32. bf16 only: the training
// path is bf16, and the plain version in f32 is the oracle.
//
// Bound on an H100 SXM at the training shape (B4, T1024, 32/32 heads, H96,
// bf16, causal, right padding): dq does 3 products of 2 * H FLOPs per
// unmasked (row, key) pair (S, dP, dS K), dk/dv 4 (S, dP, P^T dO, dS^T Q):
// 3.4e10 and 4.5e10 FLOPs, 0.034 / 0.045 ms at 989 TFLOP/s, against
// ~0.13 GB of inputs and outputs each (~0.038 ms at 3.35 TB/s). So the pair
// is bound by the tensor cores, and by how well they are fed.
//
// Design "wgmma" (`flash_bwd_kernel_for` in ops/flash_attention.py names it
//    for every call). Both kernels are built like the forward's wgmma
//    kernel: the copy engine (TMA, 4-D tensor maps over the tensors' own
//    strides, shared with flash_fwd.cu in tma_sm90.cuh) fills a ring of
//    kStages stages, mbarriers pass the stages between it and two
//    warpgroups, and each warpgroup owns 64 rows of every product. A tile is
//    cut into column blocks of one swizzle span (64 columns in the 128-byte
//    swizzle at H 64 / 128, 32 columns in the 64-byte swizzle at H 96). The
//    two products that recompute a tile (S and dP) take both operands from
//    shared memory (K-major); the two that accumulate a gradient take their
//    A operand from the registers of those products (rounded to bf16 as the
//    Pallas kernel rounds it) and their B operand through the transposing
//    (MN-major) descriptor, so no tile is ever transposed in memory. The dP
//    product runs while P is formed from S. Gradients leave through shared
//    memory and a TMA store. No atomics: every output element is written
//    once by one CTA, so a launch is bit-identical when repeated.
//
//    Registers set the shape. The dk/dv warpgroup holds S^T and dP^T (32
//    each for 64 keys x 64 rows) and dk and dv (H / 2 each): 160 at H 96,
//    192 at H 128, before addresses. A CTA of nine or twelve warps (a
//    producer warp or warpgroup beside the two warpgroups) puts three warps
//    on a scheduler and caps every thread at 168 registers; `setmaxnreg`
//    does not lift that cap for ptxas (nvcc 12.9: the consumers of a
//    twelve-warp build still spilled 80 / 460 bytes at H 96 / 128 and had
//    their products serialised, C7512). So a CTA is the two warpgroups alone
//    (eight warps, up to 255 registers), and warp 0 keeps the ring filled
//    between its own products: its thread 0 asks for the first kStages
//    tiles at the start and, at the top of iteration it, for tile
//    it - 1 + kStages once every warp has released tile it - 1's stage.
//
//    * dq (`flash_bwd_dq_wgmma_kernel`): a CTA owns 128 query rows of one
//      (batch, q head); Q and dO are loaded once, K and V tiles of 64 keys
//      stream through the ring from the tile of kv_starts[b] to the
//      diagonal / kv length. Per tile and warpgroup: S = Q K^T and
//      dP = dO V^T; P = 2^(s * scale * log2e - lse * log2e) (a dead row's
//      lse is +inf there: P = 0); dS = P o (dP - delta) rounded to bf16;
//      dq += dS K. A warpgroup skips the products of a tile above its own
//      diagonal. dq leaves once, times the scale, in bf16. The grid is one
//      dimension, the tiles of a (batch, head) neighbours, the late (long)
//      causal tiles first (`flash_bwd_tile_order("dq", T)`).
//    * dk/dv (`flash_bwd_dkv_wgmma_kernel`): a CTA owns 128 keys of one
//      (batch, kv head); K and V are loaded once, and for each of the G
//      query heads of the group, q tiles of 64 rows from the causal diagonal
//      on stream through the ring with their rows' lse (log2 domain) and
//      delta, which warp 0 reads into the stage (in the transposed products
//      a thread needs 16 rows' values). Per tile and
//      warpgroup: S^T = K Q^T, dP^T = V dO^T, P^T and dS^T in registers,
//      dv += P^T dO, dk += dS^T Q. A warpgroup whose keys all lie outside
//      [kv_starts, kv_lengths) and tiles wholly above its keys' diagonal
//      skip the products; every key < S is written (zeros where it has no
//      valid pair: the wrapper allocates with torch.empty). The early
//      (under causal masking the longest) key tiles come first
//      (`flash_bwd_tile_order("dkv", S)`).
//    The visits of both loops are `flash_bwd_dq_visits` /
//    `flash_bwd_dkv_visits` in ops/flash_attention.py, which the CPU tests
//    hold to cover every unmasked (head, row, key) once.

#include <math.h>

#include "mma_bf16.cuh"
#include "tma_sm90.cuh"
#include "wgmma_bf16.cuh"

namespace {

using visper::ex2;
using visper::fence_proxy_async;
using visper::kLog2e;
using visper::kNegInf;
using visper::mbar_arrive;
using visper::mbar_expect_tx;
using visper::mbar_init;
using visper::mbar_wait;
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
  const void* dout;
  const float* lse;     // (B, Nq, T)
  const float* delta;   // (B, Nq, T)
  void* dq;
  void* dk;
  void* dv;
  const int* kv_len;    // (B,) or null
  const int* kv_start;  // (B,) or null
  long long q_sb, q_st, q_sn;
  long long k_sb, k_st, k_sn;
  long long v_sb, v_st, v_sn;
  long long do_sb, do_st, do_sn;
  long long dq_sb, dq_st, dq_sn;
  long long dk_sb, dk_st, dk_sn;
  long long dv_sb, dv_st, dv_sn;
  int B, T, S, Nq, Nkv, group;
  float scale;
  int causal;
};

__device__ __forceinline__ void col_bounds(const Params& p, int b, int& lo, int& len) {
  len = p.kv_len ? min(p.kv_len[b], p.S) : p.S;
  lo = p.kv_start ? max(p.kv_start[b], 0) : 0;
}

// ---------------------------------------------------------------------------
// bf16: TMA ring + wgmma, two warpgroups
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 256;  // two warpgroups; warp 0 also keeps the ring filled
constexpr int kStages = 4;       // ring depth of both kernels
constexpr int kDqRows = 128;   // dq: query rows per CTA (64 per warpgroup)
constexpr int kDqKeys = 64;    // dq: keys per streamed K/V tile
constexpr int kDkvKeys = 128;  // dk/dv: keys per CTA (64 per warpgroup)
constexpr int kDkvRows = 64;   // dk/dv: query rows per streamed Q/dO tile

// A warpgroup's named barrier (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0) {
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  } else {
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  }
}

// Column blocks of one swizzle span: 64 columns in the 128-byte swizzle at
// H 64 and 128, 32 in the 64-byte swizzle at H 96 (192-byte rows fit no
// 128-byte atom).
template <int H>
struct Swz {
  static constexpr int kCB = (H % 64 == 0) ? 64 : 32;  // columns per block
  static constexpr int kNB = H / kCB;                  // blocks per tile
  static constexpr int kSwz = kCB * 2;                 // bytes per block row
};

template <int H>
struct DqCfg {
  static constexpr int kRowBlock = kDqRows * Swz<H>::kSwz;  // a column block of Q or dO
  static constexpr int kRowBytes = Swz<H>::kNB * kRowBlock;
  static constexpr int kKeyBlock = kDqKeys * Swz<H>::kSwz;  // ... of a K or V tile
  static constexpr int kKeyBytes = Swz<H>::kNB * kKeyBlock;
  static constexpr int kBarriers = 1 + 2 * kStages;         // Q + dO; full, empty per stage
  static constexpr int kSmem = 2 * kRowBytes + 2 * kStages * kKeyBytes + 8 * kBarriers + 1024;
};

template <int H>
struct DkvCfg {
  static constexpr int kKeyBlock = kDkvKeys * Swz<H>::kSwz;  // a column block of K or V
  static constexpr int kKeyBytes = Swz<H>::kNB * kKeyBlock;
  static constexpr int kRowBlock = kDkvRows * Swz<H>::kSwz;  // ... of a Q or dO tile
  static constexpr int kRowBytes = Swz<H>::kNB * kRowBlock;
  static constexpr int kStatBytes = 2 * kDkvRows * 4;        // a tile's lse (log2) and delta
  static constexpr int kBarriers = 1 + 2 * kStages;          // K + V; full, empty per stage
  static constexpr int kSmem = 2 * kKeyBytes + 2 * kStages * kRowBytes + kStages * kStatBytes +
                               8 * kBarriers + 1024;
};

// A warpgroup's 64 x H accumulator -> bf16, times `f`, into its 64 rows of a
// swizzled tile (column blocks `block_bytes` apart): the 16-byte chunk c of
// row i sits at chunk c ^ (i & 7) in the 128-byte swizzle, c ^ ((i >> 1) & 3)
// in the 64-byte one, so a warp's eight rows land on distinct banks.
template <int H>
__device__ __forceinline__ void stage_rows(uint8_t* rows64, const float (&acc)[H / 2], float f,
                                           int block_bytes, int w, int g, int tq) {
  using Z = Swz<H>;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lrow = 16 * w + g + 8 * r;
    const int sw = Z::kSwz == 128 ? (lrow & 7) : ((lrow >> 1) & 3);
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) {
      const int nb = (nt * 8) / Z::kCB, chunk = ((nt * 8) % Z::kCB) / 8;
      *reinterpret_cast<uint32_t*>(rows64 + nb * block_bytes + lrow * Z::kSwz +
                                   ((chunk ^ sw) << 4) + 4 * tq) =
          pack_f32(acc[4 * nt + 2 * r] * f, acc[4 * nt + 2 * r + 1] * f);
    }
  }
}

// The A fragments of k-step kk of a register-A product from the accumulator
// of a 64 x 64 product: its 8-column blocks 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float* x) {
  a[0] = pack_f32(x[0], x[1]);
  a[1] = pack_f32(x[2], x[3]);
  a[2] = pack_f32(x[4], x[5]);
  a[3] = pack_f32(x[6], x[7]);
}

template <int H>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap dq_map, const Params p) {
  using Z = Swz<H>;
  using C = DqCfg<H>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles need 1024-byte alignment
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base;                                // [kNB][128][kCB]
  const uint32_t dos = qs + C::kRowBytes;                  // likewise
  const uint32_t ks = dos + C::kRowBytes;                  // [kStages][kNB][64][kCB]
  const uint32_t vs = ks + kStages * C::kKeyBytes;         // likewise
  const uint32_t q_full = vs + kStages * C::kKeyBytes;     // mbarriers
  const uint32_t full = q_full + 8;
  const uint32_t empty = full + 8 * kStages;

  // the tiles of one (batch, head) are neighbours in the grid, the last first
  const int ntiles = (p.T + kDqRows - 1) / kDqRows;
  const int tile = ntiles - 1 - static_cast<int>(blockIdx.x % ntiles);
  const int bh = blockIdx.x / ntiles;
  const int head = bh % p.Nq;
  const int b = bh / p.Nq;
  const int kvh = head / p.group;
  const int q0 = tile * kDqRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);                  // thread 0's expect_tx arrival
      mbar_init(empty + 8 * s, kWgThreads / 32);   // one lane of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // kv tiles [k_begin, hi) in steps of kDqKeys: `flash_bwd_dq_visits`
  int lo, len;
  col_bounds(p, b, lo, len);
  const int hi = p.causal ? min(len, q0 + kDqRows) : len;
  const int k_begin = (lo / kDqKeys) * kDqKeys;
  const int ntk = hi > k_begin ? (hi - k_begin + kDqKeys - 1) / kDqKeys : 0;

  // Thread 0 asks the copy engine for Q and dO and the first kStages K/V
  // tiles; later, at the top of iteration it, for tile it - 1 + kStages into
  // the stage that tile it - 1 used, once every warp has released it.
  auto load_kv = [&](int j) {
    const int s = j % kStages;
    const int k0 = k_begin + j * kDqKeys;
    mbar_expect_tx(full + 8 * s, 2 * C::kKeyBytes);
#pragma unroll
    for (int nb = 0; nb < Z::kNB; ++nb) {
      tma_load_4d(ks + s * C::kKeyBytes + nb * C::kKeyBlock, &k_map, nb * Z::kCB, kvh, k0, b,
                  full + 8 * s);
      tma_load_4d(vs + s * C::kKeyBytes + nb * C::kKeyBlock, &v_map, nb * Z::kCB, kvh, k0, b,
                  full + 8 * s);
    }
  };
  if (threadIdx.x == 0 && ntk > 0) {
    mbar_expect_tx(q_full, 2 * C::kRowBytes);
#pragma unroll
    for (int nb = 0; nb < Z::kNB; ++nb) {
      tma_load_4d(qs + nb * C::kRowBlock, &q_map, nb * Z::kCB, head, q0, b, q_full);
      tma_load_4d(dos + nb * C::kRowBlock, &do_map, nb * Z::kCB, head, q0, b, q_full);
    }
    for (int j = 0; j < min(ntk, kStages); ++j) load_kv(j);
  }

  // thread (w, g, tq) of warpgroup wg holds rows 16 w + g and + 8 of its 64
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, tq = lane % 4;
  const int wg_row0 = q0 + 64 * wg;
  const int rows[2] = {wg_row0 + 16 * w + g, wg_row0 + 16 * w + g + 8};
  // keys at or past wg_hi are above every row of this warpgroup
  const int wg_hi = p.causal ? min(len, wg_row0 + 64) : len;
  const float scale_log2 = p.scale * kLog2e;
  // lse in the log2 domain (+inf on a dead row or past T: P = 2^-inf = 0) and delta
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long idx = (static_cast<long long>(b) * p.Nq + head) * p.T + rows[r];
    const float l = rows[r] < p.T ? p.lse[idx] : kNegInf;
    lse2[r] = l == kNegInf ? INFINITY : l * kLog2e;
    dlt[r] = rows[r] < p.T ? p.delta[idx] : 0.f;
  }

  float dq[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) dq[i] = 0.f;

  if (ntk > 0) {
    mbar_wait(q_full, 0);
    __syncwarp();  // wgmma is warp-aligned: reconverge after the spin
  }
  for (int it = 0; it < ntk; ++it) {
    const int s = it % kStages;
    const int k0 = k_begin + it * kDqKeys;
    const uint32_t kt = ks + s * C::kKeyBytes;
    const uint32_t vt = vs + s * C::kKeyBytes;
    if (threadIdx.x == 0 && it > 0 && it - 1 + kStages < ntk) {
      mbar_wait(empty + 8 * ((it - 1) % kStages), ((it - 1) / kStages) & 1);
      load_kv(it - 1 + kStages);
    }
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    __syncwarp();  // wgmma is warp-aligned: reconverge after the spins
    if (k0 >= wg_hi) {  // above this warpgroup's diagonal: nothing to add
      if (lane == 0) mbar_arrive(empty + 8 * s);
      continue;
    }

    // S = Q K^T and dP = dO V^T (a k-step is 32 bytes along a swizzled block
    // row); P is formed while dP runs
    float sa[kDqKeys / 2], dp[kDqKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const int nb = (kk * 16) / Z::kCB, within = ((kk * 16) % Z::kCB) * 2;
      const uint32_t a = qs + nb * C::kRowBlock + wg * 64 * Z::kSwz + within;
      wgmma_ss<kDqKeys>(sa, smem_desc<Z::kSwz>(a, 16, 8 * Z::kSwz),
                        smem_desc<Z::kSwz>(kt + nb * C::kKeyBlock + within, 16, 8 * Z::kSwz),
                        kk > 0 ? 1 : 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const int nb = (kk * 16) / Z::kCB, within = ((kk * 16) % Z::kCB) * 2;
      const uint32_t a = dos + nb * C::kRowBlock + wg * 64 * Z::kSwz + within;
      wgmma_ss<kDqKeys>(dp, smem_desc<Z::kSwz>(a, 16, 8 * Z::kSwz),
                        smem_desc<Z::kSwz>(vt + nb * C::kKeyBlock + within, 16, 8 * Z::kSwz),
                        kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<1>();

    // P = 2^(s * scale_log2 - lse2), masked where the tile crosses a bound or
    // the diagonal: seen from this thread's first column, row r's valid
    // columns are [c_lo, c_lo + width[r])
#pragma unroll
    for (int i = 0; i < kDqKeys / 2; ++i) sa[i] = fmaf(sa[i], scale_log2, -lse2[(i >> 1) & 1]);
    if (k0 < lo || k0 + kDqKeys > len || (p.causal && k0 + kDqKeys - 1 > wg_row0)) {
      const int first = k0 + 2 * tq;
      const int c_lo = lo - first;
      unsigned width[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int c_hi = (p.causal ? min(len, rows[r] + 1) : len) - first;
        width[r] = static_cast<unsigned>(max(c_hi - c_lo, 0));
      }
#pragma unroll
      for (int i = 0; i < kDqKeys / 2; ++i) {
        const int c = 8 * (i >> 2) + (i & 1);
        if (static_cast<unsigned>(c - c_lo) >= width[(i >> 1) & 1]) sa[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < kDqKeys / 2; ++i) sa[i] = ex2(sa[i]);

    // dS = P o (dP - delta), rounded to bf16: the A fragments of dq += dS K
    wgmma_wait<0>();
    uint32_t da[kDqKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk) {
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = sa[8 * kk + i] * (dp[8 * kk + i] - dlt[(i >> 1) & 1]);
      pack_a(da[kk], x);
    }
    // K rows are keys (k), its columns dq's (n): MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqKeys / 16; ++kk) {
      wgmma_rs<H>(dq, da[kk],
                  smem_desc<Z::kSwz>(kt + kk * 16 * Z::kSwz, C::kKeyBlock, 8 * Z::kSwz), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // dq * scale leaves through this warpgroup's own rows of the Q tile (its
  // last product is done), then as one TMA box per column block: rows beyond
  // T are clipped by the copy engine.
  stage_rows<H>(smem_raw + (qs - smem_u32(smem_raw)) + wg * 64 * Z::kSwz, dq, p.scale,
                C::kRowBlock, w, g, tq);
  fence_proxy_async();
  warpgroup_sync(wg);
  if (w == 0 && lane == 0) {
#pragma unroll
    for (int nb = 0; nb < Z::kNB; ++nb) {
      tma_store_4d(&dq_map, qs + nb * C::kRowBlock + wg * 64 * Z::kSwz, nb * Z::kCB, head,
                   wg_row0, b);
    }
    tma_store_drain();  // before the CTA's memory goes
  }
}

template <int H>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const __grid_constant__ CUtensorMap dk_map,
                               const __grid_constant__ CUtensorMap dv_map, const Params p) {
  using Z = Swz<H>;
  using C = DkvCfg<H>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = base;                                 // [kNB][128][kCB]
  const uint32_t vs = ks + C::kKeyBytes;                    // likewise
  const uint32_t qs = vs + C::kKeyBytes;                    // [kStages][kNB][64][kCB]
  const uint32_t dos = qs + kStages * C::kRowBytes;         // likewise
  const uint32_t stats = dos + kStages * C::kRowBytes;      // [kStages][lse2 64, delta 64] f32
  const uint32_t kv_full = stats + kStages * C::kStatBytes;  // mbarriers
  const uint32_t full = kv_full + 8;
  const uint32_t empty = full + 8 * kStages;
  float* const stats_gen = reinterpret_cast<float*>(smem_raw + (stats - smem_u32(smem_raw)));

  // the key tiles of one (batch, kv head) are neighbours in the grid, the
  // first (under causal masking the longest) first
  const int ntiles = (p.S + kDkvKeys - 1) / kDkvKeys;
  const int tile = static_cast<int>(blockIdx.x % ntiles);
  const int bh = blockIdx.x / ntiles;
  const int kvh = bh % p.Nkv;
  const int b = bh / p.Nkv;
  const int k0 = tile * kDkvKeys;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1 + 32);             // expect_tx, then warp 0's lanes
      mbar_init(empty + 8 * s, kWgThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // For each query head gi of the group, q tiles [q_first, T) in steps of
  // kDkvRows (`flash_bwd_dkv_visits`); none when the CTA holds no valid key.
  int lo, len;
  col_bounds(p, b, lo, len);
  const bool active = k0 < len && k0 + kDkvKeys > lo;
  const int q_first = p.causal ? (max(k0, lo) / kDkvRows) * kDkvRows : 0;
  const int nqt = q_first < p.T ? (p.T - q_first + kDkvRows - 1) / kDkvRows : 0;
  const int total = active ? p.group * nqt : 0;

  // Warp 0 keeps the ring filled: thread 0 asks the copy engine for K and V
  // once and for each stage's Q and dO tiles, the warp's lanes read the
  // rows' lse (log2 domain; +inf on a dead row or past T, so P = 0) and delta
  // into the stage. The first kStages tiles go out now; later, at the top of
  // iteration it, tile it - 1 + kStages into the stage tile it - 1 used, once
  // every warp has released it (its lse/delta loads are in flight during the
  // products and land in the stage at the bottom of the iteration).
  auto load_tile = [&](int j) {
    const int s = j % kStages;
    if (lane == 0) {
      const int head = kvh * p.group + j / nqt;
      const int q0 = q_first + (j % nqt) * kDkvRows;
      mbar_expect_tx(full + 8 * s, 2 * C::kRowBytes);
#pragma unroll
      for (int nb = 0; nb < Z::kNB; ++nb) {
        tma_load_4d(qs + s * C::kRowBytes + nb * C::kRowBlock, &q_map, nb * Z::kCB, head, q0, b,
                    full + 8 * s);
        tma_load_4d(dos + s * C::kRowBytes + nb * C::kRowBlock, &do_map, nb * Z::kCB, head, q0,
                    b, full + 8 * s);
      }
    }
  };
  float stat_lse[kDkvRows / 32], stat_delta[kDkvRows / 32];
  auto read_stats = [&](int j) {
    const int head = kvh * p.group + j / nqt;
    const int q0 = q_first + (j % nqt) * kDkvRows;
    const long long stat0 = (static_cast<long long>(b) * p.Nq + head) * p.T;
#pragma unroll
    for (int i = 0; i < kDkvRows / 32; ++i) {
      const int row = q0 + lane + 32 * i;
      stat_lse[i] = row < p.T ? p.lse[stat0 + row] : kNegInf;
      stat_delta[i] = row < p.T ? p.delta[stat0 + row] : 0.f;
    }
  };
  auto write_stats = [&](int j) {
    const int s = j % kStages;
    float* const st = stats_gen + s * 2 * kDkvRows;
#pragma unroll
    for (int i = 0; i < kDkvRows / 32; ++i) {
      st[lane + 32 * i] = stat_lse[i] == kNegInf ? INFINITY : stat_lse[i] * kLog2e;
      st[kDkvRows + lane + 32 * i] = stat_delta[i];
    }
    mbar_arrive(full + 8 * s);
  };
  if (warp == 0 && total > 0) {
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * C::kKeyBytes);
#pragma unroll
      for (int nb = 0; nb < Z::kNB; ++nb) {
        tma_load_4d(ks + nb * C::kKeyBlock, &k_map, nb * Z::kCB, kvh, k0, b, kv_full);
        tma_load_4d(vs + nb * C::kKeyBlock, &v_map, nb * Z::kCB, kvh, k0, b, kv_full);
      }
    }
    for (int j = 0; j < min(total, kStages); ++j) {
      load_tile(j);
      read_stats(j);
      write_stats(j);
    }
  }

  // thread (w, g, tq) of warpgroup wg holds keys 16 w + g and + 8 of its 64,
  // and q-tile columns 8 j + 2 tq (+ 1)
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, tq = lane % 4;
  const int wg_key0 = k0 + 64 * wg;
  const bool wg_active = wg_key0 < len && wg_key0 + 64 > lo;
  const bool wg_inside = wg_key0 >= lo && wg_key0 + 64 <= len;
  const int wg_first_key = max(wg_key0, lo);
  const int keys[2] = {wg_key0 + 16 * w + g, wg_key0 + 16 * w + g + 8};
  const bool key_ok[2] = {keys[0] >= lo && keys[0] < len, keys[1] >= lo && keys[1] < len};
  const float scale_log2 = p.scale * kLog2e;

  float dk[H / 2], dv[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) dk[i] = dv[i] = 0.f;

  if (total > 0) {
    mbar_wait(kv_full, 0);
    __syncwarp();
  }
  for (int it = 0; it < total; ++it) {
    const int s = it % kStages;
    const int q0 = q_first + (it % nqt) * kDkvRows;
    const uint32_t qt = qs + s * C::kRowBytes;
    const uint32_t dt = dos + s * C::kRowBytes;
    const int refill = it - 1 + kStages;   // the tile warp 0 asks for in this iteration
    const bool refills = warp == 0 && it > 0 && refill < total;
    if (refills) {
      mbar_wait(empty + 8 * ((it - 1) % kStages), ((it - 1) / kStages) & 1);
      load_tile(refill);
      read_stats(refill);
    }
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    __syncwarp();  // wgmma is warp-aligned: reconverge after the spins
    if (!wg_active || (p.causal && q0 + kDkvRows - 1 < wg_first_key)) {
      // no valid key here, or every row of the tile lies before them
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (refills) write_stats(refill);
      continue;
    }

    // S^T = K Q^T and dP^T = V dO^T, both operands K-major; P^T is formed
    // while dP^T runs
    float st[kDkvRows / 2], dpt[kDkvRows / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const int nb = (kk * 16) / Z::kCB, within = ((kk * 16) % Z::kCB) * 2;
      const uint32_t a = ks + nb * C::kKeyBlock + wg * 64 * Z::kSwz + within;
      wgmma_ss<kDkvRows>(st, smem_desc<Z::kSwz>(a, 16, 8 * Z::kSwz),
                         smem_desc<Z::kSwz>(qt + nb * C::kRowBlock + within, 16, 8 * Z::kSwz),
                         kk > 0 ? 1 : 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const int nb = (kk * 16) / Z::kCB, within = ((kk * 16) % Z::kCB) * 2;
      const uint32_t a = vs + nb * C::kKeyBlock + wg * 64 * Z::kSwz + within;
      wgmma_ss<kDkvRows>(dpt, smem_desc<Z::kSwz>(a, 16, 8 * Z::kSwz),
                         smem_desc<Z::kSwz>(dt + nb * C::kRowBlock + within, 16, 8 * Z::kSwz),
                         kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait<1>();

    // P^T = 2^(s * scale_log2 - lse2[row]); lse2 and delta of this thread's
    // 16 columns come from the stage, two neighbours per 8-byte load
    const float* const sl = stats_gen + s * 2 * kDkvRows + 2 * tq;
#pragma unroll
    for (int j = 0; j < kDkvRows / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(sl + 8 * j);
      st[4 * j] = fmaf(st[4 * j], scale_log2, -l.x);
      st[4 * j + 1] = fmaf(st[4 * j + 1], scale_log2, -l.y);
      st[4 * j + 2] = fmaf(st[4 * j + 2], scale_log2, -l.x);
      st[4 * j + 3] = fmaf(st[4 * j + 3], scale_log2, -l.y);
    }
    // Mask where a key lies outside [lo, len) or above a row: key r's valid
    // columns, seen from this thread's first, start at c_min[r]
    if (!wg_inside || (p.causal && q0 < wg_key0 + 63)) {
      int c_min[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        c_min[r] = !key_ok[r] ? kDkvRows : (p.causal ? keys[r] - q0 - 2 * tq : -kDkvRows);
      }
#pragma unroll
      for (int i = 0; i < kDkvRows / 2; ++i) {
        if (8 * (i >> 2) + (i & 1) < c_min[(i >> 1) & 1]) st[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < kDkvRows / 2; ++i) st[i] = ex2(st[i]);

    // dS^T = P^T o (dP^T - delta[row]); then both rounded to bf16 as the A
    // fragments of the next two products (packed only now: S^T, dP^T, dk and
    // dv are the most registers a thread holds at once)
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kDkvRows / 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(sl + kDkvRows + 8 * j);
      dpt[4 * j] = st[4 * j] * (dpt[4 * j] - d.x);
      dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - d.y);
      dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - d.x);
      dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - d.y);
    }
    uint32_t pa[kDkvRows / 16][4], sa[kDkvRows / 16][4];
#pragma unroll
    for (int kk = 0; kk < kDkvRows / 16; ++kk) {
      pack_a(pa[kk], st + 8 * kk);
      pack_a(sa[kk], dpt + 8 * kk);
    }

    // dv += P^T dO and dk += dS^T Q: dO and Q rows are the k dimension, their
    // columns the gradients' n: MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDkvRows / 16; ++kk) {
      wgmma_rs<H>(dv, pa[kk],
                  smem_desc<Z::kSwz>(dt + kk * 16 * Z::kSwz, C::kRowBlock, 8 * Z::kSwz), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kDkvRows / 16; ++kk) {
      wgmma_rs<H>(dk, sa[kk],
                  smem_desc<Z::kSwz>(qt + kk * 16 * Z::kSwz, C::kRowBlock, 8 * Z::kSwz), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (refills) write_stats(refill);
  }

  // dk * scale and dv leave through this warpgroup's own rows of the K and V
  // tiles (its last products are done), then as TMA boxes: keys beyond S are
  // clipped by the copy engine; keys without a valid pair are written as 0.
  const int off = wg * 64 * Z::kSwz;
  stage_rows<H>(smem_raw + (ks - smem_u32(smem_raw)) + off, dk, p.scale, C::kKeyBlock, w, g, tq);
  stage_rows<H>(smem_raw + (vs - smem_u32(smem_raw)) + off, dv, 1.f, C::kKeyBlock, w, g, tq);
  fence_proxy_async();
  warpgroup_sync(wg);
  if (w == 0 && lane == 0) {
#pragma unroll
    for (int nb = 0; nb < Z::kNB; ++nb) {
      tma_store_4d(&dk_map, ks + nb * C::kKeyBlock + off, nb * Z::kCB, kvh, wg_key0, b);
      tma_store_4d(&dv_map, vs + nb * C::kKeyBlock + off, nb * Z::kCB, kvh, wg_key0, b);
    }
    tma_store_drain();
  }
}

template <int H>
cudaError_t launch_dq_wgmma(const Params& p, cudaStream_t stream) {
  using C = DqCfg<H>;
  constexpr int cb = Swz<H>::kCB;
  static bool attr_set = false;  // shared memory above 48 KB is opted into once
  if (!attr_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        flash_bwd_dq_wgmma_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (rc != cudaSuccess) return rc;
    attr_set = true;
  }
  CUtensorMap q_map, do_map, k_map, v_map, dq_map;
  if (!tensor_map(p.q, H, p.Nq, p.T, p.B, p.q_sb, p.q_st, p.q_sn, cb, kDqRows, &q_map) ||
      !tensor_map(p.dout, H, p.Nq, p.T, p.B, p.do_sb, p.do_st, p.do_sn, cb, kDqRows, &do_map) ||
      !tensor_map(p.k, H, p.Nkv, p.S, p.B, p.k_sb, p.k_st, p.k_sn, cb, kDqKeys, &k_map) ||
      !tensor_map(p.v, H, p.Nkv, p.S, p.B, p.v_sb, p.v_st, p.v_sn, cb, kDqKeys, &v_map) ||
      !tensor_map(p.dq, H, p.Nq, p.T, p.B, p.dq_sb, p.dq_st, p.dq_sn, cb, kDqRows / 2, &dq_map)) {
    return cudaErrorInvalidValue;
  }
  const long long ctas = static_cast<long long>((p.T + kDqRows - 1) / kDqRows) * p.Nq * p.B;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dq_wgmma_kernel<H><<<static_cast<unsigned>(ctas), kWgThreads, C::kSmem, stream>>>(
      q_map, do_map, k_map, v_map, dq_map, p);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_dkv_wgmma(const Params& p, cudaStream_t stream) {
  using C = DkvCfg<H>;
  constexpr int cb = Swz<H>::kCB;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        flash_bwd_dkv_wgmma_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (rc != cudaSuccess) return rc;
    attr_set = true;
  }
  CUtensorMap k_map, v_map, q_map, do_map, dk_map, dv_map;
  if (!tensor_map(p.k, H, p.Nkv, p.S, p.B, p.k_sb, p.k_st, p.k_sn, cb, kDkvKeys, &k_map) ||
      !tensor_map(p.v, H, p.Nkv, p.S, p.B, p.v_sb, p.v_st, p.v_sn, cb, kDkvKeys, &v_map) ||
      !tensor_map(p.q, H, p.Nq, p.T, p.B, p.q_sb, p.q_st, p.q_sn, cb, kDkvRows, &q_map) ||
      !tensor_map(p.dout, H, p.Nq, p.T, p.B, p.do_sb, p.do_st, p.do_sn, cb, kDkvRows, &do_map) ||
      !tensor_map(p.dk, H, p.Nkv, p.S, p.B, p.dk_sb, p.dk_st, p.dk_sn, cb, kDkvKeys / 2, &dk_map) ||
      !tensor_map(p.dv, H, p.Nkv, p.S, p.B, p.dv_sb, p.dv_st, p.dv_sn, cb, kDkvKeys / 2, &dv_map)) {
    return cudaErrorInvalidValue;
  }
  const long long ctas = static_cast<long long>((p.S + kDkvKeys - 1) / kDkvKeys) * p.Nkv * p.B;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dkv_wgmma_kernel<H><<<static_cast<unsigned>(ctas), kWgThreads, C::kSmem, stream>>>(
      k_map, v_map, q_map, do_map, dk_map, dv_map, p);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch(const Params& p, bool dq, cudaStream_t stream) {
  return dq ? launch_dq_wgmma<H>(p, stream) : launch_dkv_wgmma<H>(p, stream);
}

int launch_h(const Params& p, bool dq, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64: return static_cast<int>(launch<64>(p, dq, st));
    case 96: return static_cast<int>(launch<96>(p, dq, st));
    case 128: return static_cast<int>(launch<128>(p, dq, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, void* dk, void* dv,
                   const void* kv_len, const void* kv_start, const long long* st,
                   int B, int T, int S, int Nq, int Nkv, float scale, int causal) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_start = static_cast<const int*>(kv_start);
  p.q_sb = st[0]; p.q_st = st[1]; p.q_sn = st[2];
  p.k_sb = st[3]; p.k_st = st[4]; p.k_sn = st[5];
  p.v_sb = st[6]; p.v_st = st[7]; p.v_sn = st[8];
  p.do_sb = st[9]; p.do_st = st[10]; p.do_sn = st[11];
  p.dq_sb = st[12]; p.dq_st = st[13]; p.dq_sn = st[14];
  p.dk_sb = st[15]; p.dk_st = st[16]; p.dk_sn = st[17];
  p.dv_sb = st[18]; p.dv_st = st[19]; p.dv_sn = st[20];
  p.B = B; p.T = T; p.S = S; p.Nq = Nq; p.Nkv = Nkv;
  p.group = Nq / Nkv;
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

// Launch on `stream`; each returns cudaGetLastError() (0 on success).
// `strides` holds 21 element strides (batch, token, head) of q, k, v, dout,
// dq, dk, dv in that order; the head-dim stride of each must be 1. All
// tensors are bf16 with 16-byte aligned rows (TMA). kv_len / kv_start may be
// null.
// visper_flash_bwd_dq writes dq (reads dk/dv as unused); visper_flash_bwd_dkv
// writes dk and dv.
extern "C" int visper_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, const void* kv_len,
    const void* kv_start, const long long* strides, int B, int T, int S, int Nq,
    int Nkv, int H, float scale, int causal, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, dk, dv, kv_len, kv_start,
                               strides, B, T, S, Nq, Nkv, scale, causal);
  return launch_h(p, true, H, stream);
}

extern "C" int visper_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, const void* kv_len,
    const void* kv_start, const long long* strides, int B, int T, int S, int Nq,
    int Nkv, int H, float scale, int causal, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, dk, dv, kv_len, kv_start,
                               strides, B, T, S, Nq, Nkv, scale, causal);
  return launch_h(p, false, H, stream);
}

// Geometry of the wgmma kernels at head dim H, for reports: dynamic shared
// memory of the dq and the dk/dv kernel in bytes, ring stages, threads per
// CTA. Returns 0, or 1 for an H they do not take.
extern "C" int visper_flash_bwd_wgmma_info(int H, int* dq_smem, int* dkv_smem, int* stages,
                                           int* threads) {
  switch (H) {
    case 64: *dq_smem = DqCfg<64>::kSmem; *dkv_smem = DkvCfg<64>::kSmem; break;
    case 96: *dq_smem = DqCfg<96>::kSmem; *dkv_smem = DkvCfg<96>::kSmem; break;
    case 128: *dq_smem = DqCfg<128>::kSmem; *dkv_smem = DkvCfg<128>::kSmem; break;
    default: return 1;
  }
  *stages = kStages;
  *threads = kWgThreads;
  return 0;
}
