// Fused Swin window attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel visper_lm_tpu/ops/window_attention.py
// `window_attention_pallas` (:82, kernel `_kernel` :57, pl.pallas_call :112):
// for every (window w, head h), non-causal, forward only,
//   out = softmax(q k^T * scale + bias[h] + mask[w % nW]) v
// with q, k, v, out (W, heads, N, D) read and written through their strides,
// bias (heads, N, N) f32, the optional shift mask (nW, N, N) f32 tiled over W
// with period nW (the `i % period` index map of :104-106). The scale is applied
// to the f32 scores, the softmax is taken in f32 and normalised before P is
// rounded to bf16 for the second product, as the Pallas kernel does.
//
// Bound on an H100 SXM at Swin-L's stage-1 shape (768 px, micro-batch 2:
// W = 512 windows, 6 heads, N = 144, D = 32, bf16): q, k, v read once and the
// output written once are ~113 MB (~34 us at 3.35 TB/s) against ~8 GFLOP
// (~8 us at 989 TFLOP/s), so the ideal kernel is bound by memory. A window's
// problem is tiny (144 x 32), so what matters is touching q, k, v, out once
// and keeping the 144 x 144 scores out of device memory.
//
// Design (correct and simple first): one CTA per (window, head) with N / 16
// warps (9 for N = 144); each warp owns 16 query rows. q, k and v of the window
// are staged in padded shared memory (row stride D + 8). S = Q K^T runs on the
// tensor cores (mma.sync m16n8k16, f32 accumulation) and stays in registers
// (16 x 144 per warp); bias and mask are added from global memory (L2-resident:
// they are shared by all windows), the row softmax is reduced across each quad
// with shuffles, and O = P V runs on the tensor cores again. The output is
// written once. Supported (N, D): (144, 32) for Swin-L, (64, 16) for tests.

#include <math.h>

#include "mma_bf16.cuh"

namespace {

using visper::mma_bf16;
using visper::pack_f32;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* bias;  // (heads, N, N)
  const float* mask;  // (nW, N, N) or null
  long long q_sw, q_sh, q_sn;
  long long k_sw, k_sh, k_sn;
  long long v_sw, v_sh, v_sn;
  long long o_sw, o_sh, o_sn;
  int W, heads, nW;
  float scale;
};

template <int N, int D>
__global__ void __launch_bounds__(N * 2) window_attn_bf16_kernel(const Params p) {
  constexpr int LD = D + 8;
  constexpr int THREADS = N * 2;  // N / 16 warps
  constexpr int KS = D / 16;      // k-steps of S
  constexpr int SN = N / 8;       // n-tiles of S
  constexpr int PK = N / 16;      // k-steps of O = P V
  constexpr int ON = D / 8;       // n-tiles of O
  __shared__ __align__(16) __nv_bfloat16 qs[N * LD];
  __shared__ __align__(16) __nv_bfloat16 ks[N * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[N * LD];

  const int w = blockIdx.x;
  const int head = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int r0 = warp * 16;

  visper::load_tile<N, D, LD, THREADS>(
      qs, static_cast<const __nv_bfloat16*>(p.q) + w * p.q_sw + head * p.q_sh, p.q_sn, 0, N);
  visper::load_tile<N, D, LD, THREADS>(
      ks, static_cast<const __nv_bfloat16*>(p.k) + w * p.k_sw + head * p.k_sh, p.k_sn, 0, N);
  visper::load_tile<N, D, LD, THREADS>(
      vs, static_cast<const __nv_bfloat16*>(p.v) + w * p.v_sw + head * p.v_sh, p.v_sn, 0, N);
  __syncthreads();

  float s[SN][4];
#pragma unroll
  for (int nt = 0; nt < SN; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t qa[4];
    visper::load_a<LD>(qa, qs, r0, kk * 16, g, tq);
#pragma unroll
    for (int nt = 0; nt < SN; ++nt) {
      uint32_t b0, b1;
      visper::load_b_t<LD>(b0, b1, ks, nt * 8, kk * 16, g, tq);
      mma_bf16(s[nt], qa, b0, b1);
    }
  }

  // scores in f32: scale, + bias, + mask; row max over the quad
  const float* bias = p.bias + static_cast<long long>(head) * N * N;
  const float* mask =
      p.mask ? p.mask + static_cast<long long>(w % p.nW) * N * N : nullptr;
  const int rows[2] = {r0 + g, r0 + g + 8};
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < SN; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int off = rows[r] * N + nt * 8 + tq * 2;
      const float2 bv = *reinterpret_cast<const float2*>(bias + off);
      float x0 = s[nt][2 * r] * p.scale + bv.x;
      float x1 = s[nt][2 * r + 1] * p.scale + bv.y;
      if (mask) {
        const float2 mv = *reinterpret_cast<const float2*>(mask + off);
        x0 += mv.x;
        x1 += mv.y;
      }
      s[nt][2 * r] = x0;
      s[nt][2 * r + 1] = x1;
      mx[r] = fmaxf(mx[r], fmaxf(x0, x1));
    }
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < SN; ++nt) {
      s[nt][2 * r] = expf(s[nt][2 * r] - mx[r]);
      s[nt][2 * r + 1] = expf(s[nt][2 * r + 1] - mx[r]);
      sum += s[nt][2 * r] + s[nt][2 * r + 1];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[r] = 1.f / sum;
  }

  // O = P V with P normalised, then rounded to bf16
  float o[ON][4];
#pragma unroll
  for (int nt = 0; nt < ON; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < PK; ++kk) {
    const uint32_t pa[4] = {
        pack_f32(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0]),
        pack_f32(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1]),
        pack_f32(s[2 * kk + 1][0] * inv[0], s[2 * kk + 1][1] * inv[0]),
        pack_f32(s[2 * kk + 1][2] * inv[1], s[2 * kk + 1][3] * inv[1]),
    };
#pragma unroll
    for (int nt = 0; nt < ON; ++nt) {
      uint32_t b0, b1;
      visper::load_b<LD>(b0, b1, vs, kk * 16, nt * 8, g, tq);
      mma_bf16(o[nt], pa, b0, b1);
    }
  }

  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + w * p.o_sw + head * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    __nv_bfloat16* orow = ob + rows[r] * p.o_sn;
#pragma unroll
    for (int nt = 0; nt < ON; ++nt) {
      *reinterpret_cast<uint32_t*>(orow + nt * 8 + tq * 2) =
          pack_f32(o[nt][2 * r], o[nt][2 * r + 1]);
    }
  }
}

template <int N, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.W, p.heads);
  window_attn_bf16_kernel<N, D><<<grid, N * 2, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). Strides are in
// elements (window, head, row); the D stride must be 1. mask may be null
// (nW is then ignored). Only bf16 tensors and the (N, D) pairs above.
extern "C" int visper_window_attn(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    const void* mask, long long q_sw, long long q_sh, long long q_sn, long long k_sw,
    long long k_sh, long long k_sn, long long v_sw, long long v_sh, long long v_sn,
    long long o_sw, long long o_sh, long long o_sn, int W, int heads, int N, int D,
    int nW, float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.q_sw = q_sw; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sw = k_sw; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sw = v_sw; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sw = o_sw; p.o_sh = o_sh; p.o_sn = o_sn;
  p.W = W; p.heads = heads; p.nW = nW > 0 ? nW : 1;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 144 && D == 32) return static_cast<int>(launch<144, 32>(p, st));
  if (N == 64 && D == 16) return static_cast<int>(launch<64, 16>(p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
