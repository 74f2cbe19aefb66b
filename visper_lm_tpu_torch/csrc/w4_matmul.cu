// w4a16 matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel visper_lm_tpu/ops/quant_matmul.py `_w4_kernel`
// (:46), launched by `w4_matmul`'s pl.pallas_call (:125). Same function:
//   out (M, dout) = sum_g (x[:, group g] @ q[group g, :]) * scales[g, :]
// with x (M, din) bf16, q the int4 weight nibble-packed two rows per byte
// (packed (din/2, dout) int8: row 2r in the low, row 2r + 1 in the high
// nibble, both sign-extended), scales (din / group, dout) f32. Each group's
// partial product is accumulated in f32, scaled in f32 by its group's scale
// row and added to an f32 accumulator; the result is rounded to bf16 once.
// The x even/odd split and the block sizes of the TPU kernel (lane layout,
// VMEM budget) are not carried over.
//
// Bound on an H100 SXM at the serving shapes (Phi3-mini, group 128):
// prefill (M = 6144 rows, B8 x T768) gate_proj (3072 -> 8192) is 309 GFLOP,
// ~0.31 ms at 989 TFLOP/s, so bound by operations; decode (M = 8) gate_proj
// reads 13.55 MB of packed weights, scales, x and out, ~4.0 us at 3.35 TB/s,
// so bound by memory.
//
// Design (correct and simple first): mma.sync m16n8k16 bf16 tiles with f32
// accumulation. A CTA computes a BM x BN output tile and walks K in steps of
// BK (a divisor of the group, <= 64): the x tile is staged in padded shared
// memory (row stride BK + 8) and read as A fragments; the packed tile
// (BK/2 x BN bytes, row stride BN + 16) is copied once to shared memory and
// each thread unpacks its B fragment from two bytes: one byte holds the two
// consecutive k values of one column that a fragment register needs, and
// int4 values are exact in bf16. A per-group accumulator takes the group's
// k-steps; at each group's end it is scaled by the scale row and added to
// the output accumulator. Two tile shapes: 128 x 128 with 8 warps (64 x 32
// each) for prefill-sized M, 16 x 64 with 4 warps for M <= 16 (decode), so
// that small M does not pay for 128 rows. Ragged M and dout are masked.

#include <math.h>

#include "mma_bf16.cuh"

namespace {

using visper::load_a;
using visper::mma_bf16;
using visper::pack_f32;

struct Params {
  const __nv_bfloat16* x;  // (M, din)
  const int8_t* packed;    // (din / 2, dout)
  const float* scales;     // (din / group, dout)
  __nv_bfloat16* out;      // (M, dout)
  int M, din, dout, group;
};

// One packed byte -> the bf16x2 of its two sign-extended nibbles, the low
// nibble (the even row) in the low half.
__device__ __forceinline__ uint32_t unpack_pair(int8_t byte) {
  const int v = byte;
  return pack_f32(static_cast<float>((v << 28) >> 28), static_cast<float>(v >> 4));
}

template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32) w4_matmul_kernel(const Params p) {
  constexpr int THREADS = WM * WN * 32;
  constexpr int WTM = BM / WM;   // warp tile rows
  constexpr int WTN = BN / WN;   // warp tile columns
  constexpr int MT = WTM / 16;   // m16 tiles per warp
  constexpr int NT = WTN / 8;    // n8 tiles per warp
  constexpr int LDX = BK + 8;    // x tile row stride (elements)
  constexpr int LDP = BN + 16;   // packed tile row stride (bytes)
  constexpr int PCH = BN / 16;   // 16-byte chunks per packed row
  __shared__ __align__(16) __nv_bfloat16 xs[BM * LDX];
  __shared__ __align__(16) int8_t ps[(BK / 2) * LDP];

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane / 4;   // fragment row group
  const int tq = lane % 4;  // thread in group
  const bool vec = (p.dout % 16) == 0;

  float acc[MT][NT][4];
  float part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = part[mt][nt][e] = 0.f;
    }
  }

  for (int k0 = 0; k0 < p.din; k0 += BK) {
    visper::load_tile<BM, BK, LDX, THREADS>(xs, p.x + k0, p.din, m0, p.M);
    const int8_t* pk = p.packed + static_cast<long long>(k0 / 2) * p.dout + n0;
    for (int i = threadIdx.x; i < (BK / 2) * PCH; i += THREADS) {
      const int r = i / PCH, c = (i % PCH) * 16;
      int8_t* dst = ps + r * LDP + c;
      const int8_t* src = pk + static_cast<long long>(r) * p.dout + c;
      if (vec && n0 + c + 16 <= p.dout) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) dst[e] = (n0 + c + e < p.dout) ? src[e] : 0;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) load_a<LDX>(a[mt], xs, wm * WTM + mt * 16, kk * 16, g, tq);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int8_t* pc = ps + (kk * 8 + tq) * LDP + wn * WTN + nt * 8 + g;
        const uint32_t b0 = unpack_pair(pc[0]);        // k = 2tq, 2tq + 1
        const uint32_t b1 = unpack_pair(pc[4 * LDP]);  // k = 2tq + 8, 2tq + 9
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(part[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();

    if ((k0 + BK) % p.group == 0) {  // the group ends: scale and fold in
      const float* sc = p.scales + static_cast<long long>((k0 + BK) / p.group - 1) * p.dout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn * WTN + nt * 8 + 2 * tq;
        const float s0 = col < p.dout ? sc[col] : 0.f;
        const float s1 = col + 1 < p.dout ? sc[col + 1] : 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][nt][0] += part[mt][nt][0] * s0;
          acc[mt][nt][1] += part[mt][nt][1] * s1;
          acc[mt][nt][2] += part[mt][nt][2] * s0;
          acc[mt][nt][3] += part[mt][nt][3] * s1;
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int row = m0 + wm * WTM + mt * 16 + g;
      const int col = n0 + wn * WTN + nt * 8 + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + (e >> 1) * 8, c = col + (e & 1);
        if (r < p.M && c < p.dout) {
          p.out[static_cast<long long>(r) * p.dout + c] = __float2bfloat16(acc[mt][nt][e]);
        }
      }
    }
  }
}

template <int BK>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.M <= 16) {
    const dim3 grid((p.dout + 63) / 64, (p.M + 15) / 16);
    w4_matmul_kernel<16, 64, BK, 1, 4><<<grid, 128, 0, stream>>>(p);
  } else {
    const dim3 grid((p.dout + 127) / 128, (p.M + 127) / 128);
    w4_matmul_kernel<128, 128, BK, 2, 4><<<grid, 256, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). x, packed,
// scales and out are contiguous; group must be a multiple of 16 dividing din.
extern "C" int visper_w4_matmul(const void* x, const void* packed, const void* scales,
                                void* out, int M, int din, int dout, int group,
                                void* stream) {
  if (M <= 0 || dout <= 0 || group <= 0 || group % 16 || din % group) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.packed = static_cast<const int8_t*>(packed);
  p.scales = static_cast<const float*>(scales);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.M = M;
  p.din = din;
  p.dout = dout;
  p.group = group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group % 64 == 0) return static_cast<int>(launch<64>(p, st));
  if (group % 32 == 0) return static_cast<int>(launch<32>(p, st));
  return static_cast<int>(launch<16>(p, st));
}
