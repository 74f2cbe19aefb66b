// Shared pieces of the port's tensor-core kernels (flash_fwd.cu, flash_bwd.cu,
// window_attn.cu, w4_matmul.cu): the mma.sync m16n8k16 bf16 product with f32
// accumulation, bf16 packing, and tile loads into padded shared memory.
//
// Fragment layout of m16n8k16 (lane = 4 * g + tq):
//   A (16 x 16, row-major): a0 = A[g][2tq..], a1 = A[g+8][2tq..],
//                           a2 = A[g][2tq+8..], a3 = A[g+8][2tq+8..]
//   B (16 x 8, column):     b0 = B[2tq..2tq+1][g], b1 = B[2tq+8..2tq+9][g]
//   C (16 x 8):             c0,c1 = C[g][2tq..], c2,c3 = C[g+8][2tq..]
// Shared-memory tiles use a row stride of (width + 8) elements, so the 32-bit
// fragment loads of a warp hit 32 distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace visper {

constexpr float kNegInf = -2.3819763e38f;  // NEG_INF of the JAX kernels
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the special-function unit alone (2^-inf = 0; about 2 ulp).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory (lane i gives the address of
// row i % 8 of matrix i / 8; register j holds matrix j in the fragment layout:
// row g, columns 2 tq and 2 tq + 1), and the same transposed (register j holds
// columns g of rows 2 tq and 2 tq + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two floats -> packed bf16x2, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows [r0, r0 + 16) x cols [c0, c0 + 16) of a row-major
// shared tile with row stride LD (r0 = 16-row block start, lane-independent).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* tile,
                                       int r0, int c0, int g, int tq) {
  const __nv_bfloat16* lo_row = tile + (r0 + g) * LD + c0 + tq * 2;
  const __nv_bfloat16* hi_row = lo_row + 8 * LD;
  a[0] = ld32(lo_row);
  a[1] = ld32(hi_row);
  a[2] = ld32(lo_row + 8);
  a[3] = ld32(hi_row + 8);
}

// B fragment where B[k][n] = T[n][k] (T row-major, e.g. K for S = Q K^T):
// n-tile rows [n0, n0 + 8), k-step cols [k0, k0 + 16). Contiguous 32-bit loads.
template <int LD>
__device__ __forceinline__ void load_b_t(uint32_t& b0, uint32_t& b1,
                                         const __nv_bfloat16* tile, int n0,
                                         int k0, int g, int tq) {
  const __nv_bfloat16* r = tile + (n0 + g) * LD + k0 + tq * 2;
  b0 = ld32(r);
  b1 = ld32(r + 8);
}

// B fragment where B[k][n] = T[k][n] (T row-major, e.g. V for O = P V):
// k-step rows [k0, k0 + 16), n-tile cols [n0, n0 + 8). Two bf16 per register.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const __nv_bfloat16* tile, int k0,
                                       int n0, int g, int tq) {
  const __nv_bfloat16* r = tile + (k0 + tq * 2) * LD + n0 + g;
  b0 = pack_bf16(r[0], r[LD]);
  b1 = pack_bf16(r[8 * LD], r[9 * LD]);
}

// Rows [row0, row0 + ROWS) of one head of a strided tensor (unit stride along
// the W-wide row) -> shared memory with row stride LD, 16 bytes per thread
// per step; rows >= nrows are zero.
template <int ROWS, int W, int LD, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int row0,
                                          int nrows) {
  constexpr int kChunks = W / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) {
      val = *reinterpret_cast<const uint4*>(base + (row0 + r) * row_stride + c * 8);
    }
    *reinterpret_cast<uint4*>(smem + r * LD + c * 8) = val;
  }
}

}  // namespace visper
