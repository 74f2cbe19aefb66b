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
// (~29 us at 989 TFLOP/s), so the ideal kernel is bound by memory.
//
// Design (correct and simple first; wgmma/TMA/warp specialisation later):
//   * bf16: one CTA of 4 warps per (q tile of 64 rows, q head, batch). Each
//     warp owns 16 query rows held as mma.sync m16n8k16 A fragments. K and V
//     tiles of 64 keys are staged in padded shared memory (row stride H + 8,
//     so the fragment loads hit 32 distinct banks). S = Q K^T and O += P V run
//     on the tensor cores with f32 accumulation; P is rounded to bf16 for the
//     second product, as the Pallas kernel does. The kv loop starts at the
//     tile holding kv_starts[b] and stops at the causal diagonal / kv length,
//     which replaces the TPU grid squashing of `_causal_pairs`.
//   * f32 (for checking): a SIMT kernel, one thread per query row, per-key
//     online softmax in full f32.

#include <math.h>

#include "mma_bf16.cuh"

namespace {

using visper::kLn2;
using visper::kLog2e;
using visper::kNegInf;
using visper::ld32;
using visper::mma_bf16;
using visper::pack_bf16;
using visper::pack_f32;

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

template <int H>
cudaError_t launch(const Params& p, int is_f32, cudaStream_t stream) {
  if (is_f32) {
    const dim3 grid((p.T + kSimtRows - 1) / kSimtRows, p.Nq, p.B);
    flash_fwd_f32_kernel<H><<<grid, kSimtRows, 0, stream>>>(p);
  } else {
    const dim3 grid((p.T + kBM - 1) / kBM, p.Nq, p.B);
    flash_fwd_bf16_kernel<H><<<grid, kWarps * 32, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). Strides are in
// elements; the last (head-dim) stride must be 1. is_f32 selects f32 inputs,
// otherwise bf16. kv_len / kv_start may be null.
extern "C" int visper_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* kv_len, const void* kv_start,
    long long q_sb, long long q_st, long long q_sn,
    long long k_sb, long long k_st, long long k_sn,
    long long v_sb, long long v_st, long long v_sn,
    long long o_sb, long long o_st, long long o_sn,
    int B, int T, int S, int Nq, int Nkv, int H, float scale, int causal,
    int is_f32, void* stream) {
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
    case 64: return static_cast<int>(launch<64>(p, is_f32, st));
    case 96: return static_cast<int>(launch<96>(p, is_f32, st));
    case 128: return static_cast<int>(launch<128>(p, is_f32, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
