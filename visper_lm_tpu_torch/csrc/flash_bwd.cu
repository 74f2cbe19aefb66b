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
// through their strides, lse/delta (B, Nq, T) f32.
//
// Bound on an H100 SXM at the training shape (B4, T1024, 32/32 heads, H96,
// bf16, causal, right padding): both kernels together do 7 products of
// 2 * H FLOPs per unmasked (row, key) pair (S and dP in each kernel, dq, dk,
// dv), ~9e10 FLOPs, ~0.09 ms at 989 TFLOP/s, against ~0.13 GB of inputs and
// outputs (~0.04 ms at 3.35 TB/s): the ideal pair of kernels is bound by
// operations.
//
// Design (correct and simple first; wgmma/TMA later). 4 warps per CTA,
// mma.sync m16n8k16 with f32 accumulation, tiles of 64 rows staged in padded
// shared memory (row stride H + 8) and fragments read from there:
//   * dq: one CTA per (q tile of 64 rows, q head, batch); each warp owns 16
//     rows. A loop over kv tiles of 64 keys from the tile holding kv_starts up
//     to the causal diagonal / kv length (the loop bound replaces the grid
//     squashing of `_causal_pairs`) computes S = Q K^T and dP = dO V^T, forms
//     dS = P o (dP - delta) in registers, rounds it to bf16 (as the Pallas
//     kernel does) and accumulates dq += dS K in f32 registers; dq is written
//     once, times the scale, in the input dtype.
//   * dk/dv: one CTA per (kv tile of 64 keys, kv head, batch); each warp owns
//     16 keys. The CTA loops over the G query heads of the group and, for each,
//     over the q tiles from the causal diagonal down (the kv-major order of
//     `_kv_major_group_pairs`), computing the transposed scores S^T = K Q^T and
//     dP^T = V dO^T, then dv += P^T dO and dk += dS^T Q in f32 registers. dk and
//     dv are written once per kv head in the input dtype: no atomics, no f32
//     buffer of G copies.
// bf16 only: the training path is bf16, and the plain version in f32 is the
// oracle the kernels are held to.

#include <math.h>

#include "mma_bf16.cuh"

namespace {

using visper::kLog2e;
using visper::kNegInf;
using visper::mma_bf16;
using visper::pack_f32;

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

__device__ __forceinline__ bool pair_ok(const Params& p, int row, int col, int lo,
                                        int len) {
  return col >= lo && col < len && (!p.causal || col <= row);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync
// ---------------------------------------------------------------------------

constexpr int kTile = 64;  // rows of every shared tile (q rows or keys)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int H>
constexpr int smem_bytes() {
  return 4 * kTile * (H + 8) * 2 + 2 * kTile * 4;
}

template <int H>
__device__ __forceinline__ void load(__nv_bfloat16* smem, const __nv_bfloat16* base,
                                     long long row_stride, int row0, int nrows) {
  visper::load_tile<kTile, H, H + 8, kThreads>(smem, base, row_stride, row0, nrows);
}

template <int H>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16_kernel(const Params p) {
  constexpr int LD = H + 8;
  constexpr int KS = H / 16;    // k-steps over the head dim
  constexpr int NT = H / 8;     // n-tiles of dq
  constexpr int SN = kTile / 8; // n-tiles of S / dP
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + kTile * LD;
  __nv_bfloat16* ks = dos + kTile * LD;
  __nv_bfloat16* vs = ks + kTile * LD;

  const int q0 = blockIdx.x * kTile;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / p.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int r0 = warp * 16;

  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + head * p.q_sn;
  const __nv_bfloat16* dob =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + head * p.do_sn;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sn;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sn;

  load<H>(qs, qb, p.q_st, q0, p.T);
  load<H>(dos, dob, p.do_st, q0, p.T);

  // this thread's two rows: lse in the log2 domain, delta, and whether the
  // row is dead (no valid key: lse == NEG_INF, or past T)
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float lse2[2], dlt[2];
  bool live[2];
  for (int r = 0; r < 2; ++r) {
    const long long idx = (static_cast<long long>(b) * p.Nq + head) * p.T + rows[r];
    const float l = rows[r] < p.T ? p.lse[idx] : kNegInf;
    live[r] = l != kNegInf;
    lse2[r] = live[r] ? l * kLog2e : 0.f;
    dlt[r] = rows[r] < p.T ? p.delta[idx] : 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  int lo, len;
  col_bounds(p, b, lo, len);
  const int hi = p.causal ? min(len, q0 + kTile) : len;

  for (int k0 = (lo / kTile) * kTile; k0 < hi; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load<H>(ks, kb, p.k_st, k0, p.S);
    load<H>(vs, vb, p.v_st, k0, p.S);
    __syncthreads();

    float s[SN][4], dp[SN][4];
#pragma unroll
    for (int nt = 0; nt < SN; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], da[4];
      visper::load_a<LD>(qa, qs, r0, kk * 16, g, tq);
      visper::load_a<LD>(da, dos, r0, kk * 16, g, tq);
#pragma unroll
      for (int nt = 0; nt < SN; ++nt) {
        uint32_t b0, b1;
        visper::load_b_t<LD>(b0, b1, ks, nt * 8, kk * 16, g, tq);
        mma_bf16(s[nt], qa, b0, b1);
        visper::load_b_t<LD>(b0, b1, vs, nt * 8, kk * 16, g, tq);
        mma_bf16(dp[nt], da, b0, b1);
      }
    }

    // dS = P o (dP - delta), P recomputed from lse; kept in s
#pragma unroll
    for (int nt = 0; nt < SN; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + nt * 8 + tq * 2 + (e & 1);
        const bool ok = live[r] && pair_ok(p, rows[r], col, lo, len);
        const float pe = ok ? exp2f(s[nt][e] * scale_log2 - lse2[r]) : 0.f;
        s[nt][e] = pe * (dp[nt][e] - dlt[r]);
      }
    }

    // dq += dS K: two n-tiles of dS are the A fragment of a 16-key chunk
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]),
          pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        visper::load_b<LD>(b0, b1, ks, kk * 16, nt * 8, g, tq);
        mma_bf16(acc[nt], a, b0, b1);
      }
    }
  }

  __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_sb + head * p.dq_sn;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.T) continue;
    __nv_bfloat16* out = dqb + rows[r] * p.dq_st;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<uint32_t*>(out + nt * 8 + tq * 2) =
          pack_f32(acc[nt][2 * r] * p.scale, acc[nt][2 * r + 1] * p.scale);
    }
  }
}

template <int H>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16_kernel(const Params p) {
  constexpr int LD = H + 8;
  constexpr int KS = H / 16;
  constexpr int NT = H / 8;
  constexpr int SN = kTile / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kTile * LD;
  __nv_bfloat16* qs = vs + kTile * LD;
  __nv_bfloat16* dos = qs + kTile * LD;
  float* lse_s = reinterpret_cast<float*>(dos + kTile * LD);  // log2 domain, 0 if dead
  float* dlt_s = lse_s + kTile;
  __shared__ bool live_s[kTile];

  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int r0 = warp * 16;
  const int keys[2] = {k0 + r0 + g, k0 + r0 + g + 8};

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    dk[nt][0] = dk[nt][1] = dk[nt][2] = dk[nt][3] = 0.f;
    dv[nt][0] = dv[nt][1] = dv[nt][2] = dv[nt][3] = 0.f;
  }

  int lo, len;
  col_bounds(p, b, lo, len);
  // a tile wholly outside [lo, len) gets zero gradients
  if (k0 < len && k0 + kTile > lo) {
    const __nv_bfloat16* kb =
        static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sn;
    const __nv_bfloat16* vb =
        static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sn;
    load<H>(ks, kb, p.k_st, k0, p.S);
    load<H>(vs, vb, p.v_st, k0, p.S);
    const float scale_log2 = p.scale * kLog2e;
    const int q_first = p.causal ? (k0 / kTile) * kTile : 0;

    for (int gi = 0; gi < p.group; ++gi) {
      const int head = kvh * p.group + gi;
      const __nv_bfloat16* qb =
          static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + head * p.q_sn;
      const __nv_bfloat16* dob =
          static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + head * p.do_sn;
      const long long stat0 = (static_cast<long long>(b) * p.Nq + head) * p.T;
      for (int q0 = q_first; q0 < p.T; q0 += kTile) {
        __syncthreads();  // the previous q tile's readers are done
        load<H>(qs, qb, p.q_st, q0, p.T);
        load<H>(dos, dob, p.do_st, q0, p.T);
        for (int i = threadIdx.x; i < kTile; i += kThreads) {
          const int row = q0 + i;
          const float l = row < p.T ? p.lse[stat0 + row] : kNegInf;
          live_s[i] = l != kNegInf;
          lse_s[i] = live_s[i] ? l * kLog2e : 0.f;
          dlt_s[i] = row < p.T ? p.delta[stat0 + row] : 0.f;
        }
        __syncthreads();

        // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 64 rows
        float st[SN][4], dpt[SN][4];
#pragma unroll
        for (int nt = 0; nt < SN; ++nt) {
          st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
          dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t ka[4], va[4];
          visper::load_a<LD>(ka, ks, r0, kk * 16, g, tq);
          visper::load_a<LD>(va, vs, r0, kk * 16, g, tq);
#pragma unroll
          for (int nt = 0; nt < SN; ++nt) {
            uint32_t b0, b1;
            visper::load_b_t<LD>(b0, b1, qs, nt * 8, kk * 16, g, tq);
            mma_bf16(st[nt], ka, b0, b1);
            visper::load_b_t<LD>(b0, b1, dos, nt * 8, kk * 16, g, tq);
            mma_bf16(dpt[nt], va, b0, b1);
          }
        }

        // P^T (kept in st) and dS^T (kept in dpt)
#pragma unroll
        for (int nt = 0; nt < SN; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = nt * 8 + tq * 2 + (e & 1);
            const int key = keys[e >> 1];
            const bool ok = live_s[qi] && pair_ok(p, q0 + qi, key, lo, len);
            const float pe = ok ? exp2f(st[nt][e] * scale_log2 - lse_s[qi]) : 0.f;
            st[nt][e] = pe;
            dpt[nt][e] = pe * (dpt[nt][e] - dlt_s[qi]);
          }
        }

        // dv += P^T dO, dk += dS^T Q (16-row chunks of the q tile)
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const uint32_t pa[4] = {
              pack_f32(st[2 * kk][0], st[2 * kk][1]),
              pack_f32(st[2 * kk][2], st[2 * kk][3]),
              pack_f32(st[2 * kk + 1][0], st[2 * kk + 1][1]),
              pack_f32(st[2 * kk + 1][2], st[2 * kk + 1][3]),
          };
          const uint32_t sa[4] = {
              pack_f32(dpt[2 * kk][0], dpt[2 * kk][1]),
              pack_f32(dpt[2 * kk][2], dpt[2 * kk][3]),
              pack_f32(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
              pack_f32(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]),
          };
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t b0, b1;
            visper::load_b<LD>(b0, b1, dos, kk * 16, nt * 8, g, tq);
            mma_bf16(dv[nt], pa, b0, b1);
            visper::load_b<LD>(b0, b1, qs, kk * 16, nt * 8, g, tq);
            mma_bf16(dk[nt], sa, b0, b1);
          }
        }
      }
    }
  }

  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_sb + kvh * p.dk_sn;
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_sb + kvh * p.dv_sn;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= p.S) continue;
    __nv_bfloat16* ok_ = dkb + keys[r] * p.dk_st;
    __nv_bfloat16* ov_ = dvb + keys[r] * p.dv_st;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      *reinterpret_cast<uint32_t*>(ok_ + nt * 8 + tq * 2) =
          pack_f32(dk[nt][2 * r] * p.scale, dk[nt][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(ov_ + nt * 8 + tq * 2) =
          pack_f32(dv[nt][2 * r], dv[nt][2 * r + 1]);
    }
  }
}

template <int H>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<H>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kTile - 1) / kTile, p.Nq, p.B);
  flash_bwd_dq_bf16_kernel<H><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<H>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kTile - 1) / kTile, p.Nkv, p.B);
  flash_bwd_dkv_bf16_kernel<H><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
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
// tensors are bf16. kv_len / kv_start may be null.
// visper_flash_bwd_dq writes dq (reads dk/dv as unused); visper_flash_bwd_dkv
// writes dk and dv.
extern "C" int visper_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, const void* kv_len,
    const void* kv_start, const long long* strides, int B, int T, int S, int Nq,
    int Nkv, int H, float scale, int causal, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, dk, dv, kv_len, kv_start,
                               strides, B, T, S, Nq, Nkv, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64: return static_cast<int>(launch_dq<64>(p, st));
    case 96: return static_cast<int>(launch_dq<96>(p, st));
    case 128: return static_cast<int>(launch_dq<128>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int visper_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv, const void* kv_len,
    const void* kv_start, const long long* strides, int B, int T, int S, int Nq,
    int Nkv, int H, float scale, int causal, void* stream) {
  const Params p = make_params(q, k, v, dout, lse, delta, dq, dk, dv, kv_len, kv_start,
                               strides, B, T, S, Nq, Nkv, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64: return static_cast<int>(launch_dkv<64>(p, st));
    case 96: return static_cast<int>(launch_dkv<96>(p, st));
    case 128: return static_cast<int>(launch_dkv<128>(p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
