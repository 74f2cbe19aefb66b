// Hopper copy-engine pieces shared by the port's TMA-fed kernels
// (flash_fwd.cu, flash_bwd.cu, window_attn.cu; w4_matmul.cu takes the ones its
// copies matched): mbarriers, 4-D tensor-map box copies in both directions,
// 3-D f32 box loads, and
// cuTensorMapEncodeTiled, found through the runtime's entry-point query (the
// libraries link no libcuda).
//
// A 4-D map views a (B, rows, N, H) tensor with element strides (sb, st, sn, 1)
// as (H, N, rows, B), so the framework's BTNH views (a head of a packed qkv, a
// slice of a wider tensor) are read and written in place, without a copy.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_runtime.h>
#include <stdint.h>

namespace visper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The barrier expects `bytes` more from bulk copies, and this thread arrives.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase `parity` completes. A wait that outlasts
// millions of polls is a protocol fault (a copy that was never started): it
// traps, so a deadlock surfaces as a launch error, not as a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 22)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map (column, head, row, batch), global -> shared,
// by the copy engine; its bytes count towards `bar`. Rows outside the tensor
// arrive as 0.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int col,
                                            int head, int row, int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// One box of a 3-D tensor map (column, row, index), global -> shared, by the
// copy engine; its bytes count towards `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int col, int row,
                                            int index, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(index)
      : "memory");
}

// One box of a 4-D tensor map, shared -> global, by the copy engine, in this
// thread's bulk group; rows outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int col,
                                             int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// Shared memory written by threads, read next by the copy engine (a TMA store).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Commit this thread's TMA stores and wait until their shared memory has been
// read (the CTA's shared memory must outlive them).
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess || found != cudaDriverEntryPointSuccess) {
      fn = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(fn);
  }();
  return encode;
}

// The map of a bf16 (B, rows, N, H) tensor with element strides (sb, st, sn, 1),
// as the 4-D tensor (H, N, rows, B), cut in boxes of box_rows x cb columns of
// one head in the swizzle of cb * 2 bytes (cb 64: 128-byte swizzle, cb 32:
// 64-byte, cb 16: 32-byte). The stride of a dimension of size 1 is never used; a valid one
// stands in for whatever the tensor carries.
inline bool tensor_map(const void* ptr, int H, int N, int rows, int B, long long sb,
                       long long st, long long sn, int cb, int box_rows, CUtensorMap* out) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(H) * 2;
  const cuuint64_t strides[3] = {N > 1 ? static_cast<cuuint64_t>(sn) * 2 : row_bytes,
                                 rows > 1 ? static_cast<cuuint64_t>(st) * 2 : row_bytes,
                                 B > 1 ? static_cast<cuuint64_t>(sb) * 2 : row_bytes};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cb), 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                cb * 2 == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                : cb * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// The map of a contiguous f32 (count, rows, cols) tensor as the 3-D tensor
// (cols, rows, count), cut in boxes of box_rows x 16 columns (64 bytes) in the
// 64-byte swizzle.
inline bool tensor_map_f32(const void* ptr, int cols, int rows, int count, int box_rows,
                           CUtensorMap* out) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(count)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 4,
                                 static_cast<cuuint64_t>(cols) * rows * 4};
  const cuuint32_t box[3] = {16, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace visper
