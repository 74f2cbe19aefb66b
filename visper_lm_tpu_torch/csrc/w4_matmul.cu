// w4a16 matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel visper_lm_tpu/ops/quant_matmul.py `_w4_kernel`
// (:46), launched by `w4_matmul`'s pl.pallas_call (:125). Same function:
//   out (M, dout) = sum_g (x[:, group g] @ q[group g, :]) * scales[g, :]
// with x (M, din) bf16, q the int4 weight nibble-packed two rows per byte
// (packed (din/2, dout) int8: row 2r in the low, row 2r + 1 in the high
// nibble, both sign-extended), scales (din / group, dout) f32. Each group's
// partial product is accumulated in f32, scaled in f32 by its group's scale
// row, and the scaled partials are summed in f32; the result is rounded to
// bf16 once. The x even/odd split and the block sizes of the TPU kernel
// (lane layout, VMEM budget) are not carried over.
//
// Three kernels; ops/quant_matmul.py `w4_kernel_for` names the one a shape
// takes and passes its number here.
//
// 1. `w4_wgmma_kernel` (M > 16, group a multiple of 64, dout a multiple of
//    16): bound by operations (Phi3-mini's gate_proj at M = 6144 is 309
//    GFLOP, 0.31 ms at 989 TFLOP/s), so it is built around wgmma, the only
//    way to the card's tensor-core rate, and around keeping it fed.
//    - The transposed problem out^T = W^T x^T. The unpacked weight is the A
//      operand in registers: an A fragment register holds two consecutive k
//      of one dout row, which is exactly one packed byte, so no dequantized
//      copy of the weight is ever written to shared memory (writing one
//      would cost a quarter of the shared-memory bandwidth that wgmma's own
//      operand reads need). x is row-major (M, din), which is the K-major B
//      operand as it stands: its tiles go to shared memory untransformed,
//      in the 128-byte swizzle the wgmma descriptor names.
//    - A CTA computes 128 dout x 128 rows of x with two consumer warpgroups
//      (64 dout each: one m64n128k16 per k-step) and one producer thread
//      that keeps a ring of kStages shared-memory stages (64 k each: a 16 KB
//      x tile and 4 KB of packed bytes) full with two TMA box copies a
//      stage, both in the 128-byte swizzle; rows of x beyond M and columns
//      of the weight beyond dout arrive as zeros. mbarriers pass the stages
//      back and forth (full: the bytes landed; empty: the consumers are
//      done). The tensor maps come from cuTensorMapEncodeTiled, taken
//      through cudaGetDriverEntryPoint and kept per (pointer, shape).
//    - The fragment rows are permuted over dout (rows i and i + 8 of a warp
//      are columns 2i and 2i + 1), so a thread's two rows are one 16-bit
//      shared load and, at the end, one bf16x2 store: the accumulator needs
//      no transposition through shared memory, every warp store fills whole
//      32-byte sectors. Nibbles are unpacked without a conversion: v + 8
//      or-ed into the mantissa of bf16 128.0 is 136 + v, and one bf16x2
//      subtraction of 136 leaves v (exact): 3.5 integer or bf16 ops a
//      register, and the kernel is still bound by them, not by the tensor
//      cores (a weight layout with the nibbles of a register 16 bits apart
//      would save the shifts). The next block's bytes are unpacked into a
//      second register set while this block's wgmmas run.
//    - A group's k-steps accumulate into a partial accumulator (the first
//      with scale-d = 0); only a block that ends its group is waited for
//      before the next goes out; then acc += part * s, two scale values per
//      thread (its two dout columns).
// 2. `w4_splitk_kernel` (M <= 16): bound by bytes (gate_proj at M = 8 reads
//    12.6 MB of packed weights, ~4 us at 3.35 TB/s), so the work is in
//    keeping bytes in flight and the unpack short: K is split on group
//    boundaries across the CTAs of a thread block cluster until the grid is
//    several CTAs per SM (ops/quant_matmul.py `w4_split_plan`); each CTA
//    issues a whole slab (at most 512 k of 64 columns: 16 KB of a 25 KB CTA
//    at M <= 8) as 16-byte cp.async copies at once and multiplies chunk by
//    chunk as they land (mma.sync m16n8k16; the n8 tiles' columns are
//    permuted so that a thread's two tiles are one 16-bit shared load). Each
//    split's f32 result, a sum of whole scaled groups, stays in its CTA's
//    shared memory; after a cluster barrier every CTA sums a share of the
//    tile over the splits through distributed shared memory, always in split
//    order, and rounds to bf16. No float atomics, no scratch in device
//    memory: the result is the same bits run after run.
// 3. `w4_matmul_kernel` (what the two above do not take: M > 16 with a group
//    that is not a multiple of 64 or a dout that is not a multiple of 16;
//    M <= 16 with a group of more than eight chunks: above 512, or nine
//    chunks of 16 like 144): mma.sync
//    tiles with one shared-memory buffer, a BM x BN output tile per CTA
//    walking K in steps of BK (a divisor of the group, <= 64), a per-group
//    accumulator scaled and folded in at each group's end.
// Ragged M and dout are masked in all three.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the entry point comes from the runtime
#include <math.h>

#include <map>
#include <mutex>
#include <tuple>

#include "mma_bf16.cuh"
#include "tma_sm90.cuh"

namespace {

namespace cg = cooperative_groups;
using visper::load_a;
using visper::mbar_arrive;
using visper::mbar_expect_tx;
using visper::mbar_init;
using visper::mma_bf16;
using visper::pack_f32;
using visper::smem_u32;

struct Params {
  const __nv_bfloat16* x;  // (M, din)
  const int8_t* packed;    // (din / 2, dout)
  const float* scales;     // (din / group, dout)
  __nv_bfloat16* out;      // (M, dout)
  int M, din, dout, group;
  int gps;                 // split-K: groups per split
  // 0x43004300, bf16x2 (128.0, 128.0). Passed in so that it sits in a
  // register: a literal would be a second immediate and split the unpack's
  // (y & mask) | magic into two LOP3s.
  uint32_t magic;
};

// ---------------------------------------------------------------- helpers


// 16 bytes global -> shared, asynchronously; `bytes` (16 or 0) are read and
// the rest of the 16 is written as zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n (0..7) of this thread's committed groups are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
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

// Packed bytes -> bf16x2 registers (v_low, v_high), the low nibble (the even
// row) in the low half, without a conversion: 0x4300 is bf16 128.0 with an
// empty 7-bit mantissa, so or-ing u = v + 8 < 16 in gives 136 + v, and
// subtracting 136 (0x4308) is exact. `t` holds byte 0 in bits 0-7 and
// byte 1 in bits 8-15: y spreads each byte's two nibbles 16 bits apart and
// adds the 8 (flips each nibble's sign bit); then one and-or with `magic`
// (0x43004300 in a register, Params::magic) and one subtraction per register.
__device__ __forceinline__ uint32_t minus_136(uint32_t r) {
  asm("sub.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(r), "r"(0x43084308u));
  return r;
}

// (y & 0x000F000F) | magic as one LOP3.
__device__ __forceinline__ uint32_t nibbles_into(uint32_t y, uint32_t magic) {
  uint32_t r;
  asm("lop3.b32 %0, %1, 0x000F000F, %2, 0xEA;\n" : "=r"(r) : "r"(y), "r"(magic));
  return r;
}

__device__ __forceinline__ void unpack_bytes(uint32_t t, uint32_t magic, uint32_t& r0,
                                             uint32_t& r1) {
  const uint32_t y = ((t << 12) | t) ^ 0x08080808u;
  r0 = minus_136(nibbles_into(y, magic));
  r1 = minus_136(nibbles_into(y >> 8, magic));
}

// ------------------------------------------------------------ 1. wgmma

constexpr int kStages = 6;
constexpr int kBM = 128;                 // rows of x per CTA (the wgmma N)
constexpr int kBN = 128;                 // dout per CTA: 64 per consumer warpgroup
constexpr int kBK = 64;                  // k per stage: one 128-byte swizzled row of x
constexpr int kXTile = kBM * kBK * 2;    // 16384 bytes
constexpr int kPTile = (kBK / 2) * kBN;  // 4096 bytes: 32 packed rows of 128, swizzled like x
constexpr int kStageBytes = kXTile + kPTile;
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kWgmmaThreads = kConsumers + 32;  // and the producer's warp
constexpr int kWgmmaSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;

// One box of a 2-D tensor map, global -> shared, by the copy engine; its
// bytes count towards `bar`. Rows and columns outside the tensor arrive as 0.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory descriptor of a K-major operand tile with 128-byte rows in
// the 128-byte swizzle: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc_128b(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (64 x 128 f32, 64 registers a thread) = A (64 x 16 bf16, registers) x
// B (16 x 128 bf16, shared memory, K-major) + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__global__ void __launch_bounds__(kWgmmaThreads, 1)
w4_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap packed_map, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled x tiles need 1024-byte alignment
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gen_base = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t xs = base;                                   // [kStages][kXTile]
  const uint32_t ps = base + kStages * kXTile;                // [kStages][kPTile]
  const uint8_t* const ps_gen = gen_base + kStages * kXTile;
  const uint32_t full = ps + kStages * kPTile;                // [kStages] mbarriers
  const uint32_t empty = full + kStages * 8;

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nblk = p.din / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);                 // the producer's expect_tx arrival
      mbar_init(empty + 8 * s, kConsumers / 32);  // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread asks the copy engine for each stage's two boxes
    if (lane == 0) {
      for (int it = 0; it < nblk; ++it) {
        const int s = it % kStages;
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, kStageBytes);
        tma_load_2d(xs + s * kXTile, &x_map, it * kBK, m0, full + 8 * s);
        tma_load_2d(ps + s * kPTile, &packed_map, n0, it * (kBK / 2), full + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroups: fragment row i of warp w (i < 8: register rows
  // g and g + 8) is dout column n0 + 64 wg + 16 w + 2 g (+ 1)
  const int wg = warp / 4, w = warp % 4;
  const int g = lane / 4, tq = lane % 4;
  const int ncol = 64 * wg + 16 * w + 2 * g;   // within the CTA's 128 columns
  const bool nvalid = n0 + ncol < p.dout;      // dout is even: both columns or neither
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  // Wait for block `it`'s stage and unpack this thread's 16 A registers
  // (4 k-steps x 4) from its packed bytes.
  auto unpack = [&](int it, uint32_t (&a)[kBK / 16][4]) {
    const int s = it % kStages;
    mbar_wait(full + 8 * s, (it / kStages) & 1);
    __syncwarp();  // wgmma is warp-aligned: reconverge after the spin
    // packed rows 8 kk + tq (k = 16 kk + 2 tq, + 1) and + 4 (k + 8, + 9); the
    // 16-byte chunk c of row r sits at chunk c ^ (r & 7), and r & 7 is tq, tq + 4
    const uint8_t* pb = ps_gen + s * kPTile + tq * kBN + 2 * g;
    const int lo_off = ((ncol >> 4) ^ tq) << 4, hi_off = 4 * kBN + (((ncol >> 4) ^ (tq + 4)) << 4);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // a[0], a[1]: rows g, g + 8 at the k-step's low half; a[2], a[3]: its high half
      unpack_bytes(*reinterpret_cast<const uint16_t*>(pb + 8 * kk * kBN + lo_off), p.magic, a[kk][0], a[kk][1]);
      unpack_bytes(*reinterpret_cast<const uint16_t*>(pb + 8 * kk * kBN + hi_off), p.magic, a[kk][2], a[kk][3]);
    }
  };

  // Block `it`: its four wgmmas go out on `cur`; while they run, the next
  // block's bytes are unpacked into `nxt`. A block that ends its group is
  // waited for, releases its stage and folds; one that does not is waited
  // for after the next block's wgmmas have gone out behind it.
  auto block = [&](int it, uint32_t (&cur)[kBK / 16][4], uint32_t (&nxt)[kBK / 16][4]) {
    const int s = it % kStages;
    const int k0 = it * kBK;
    const bool first = (k0 % p.group) == 0;
    const bool last = ((k0 + kBK) % p.group) == 0;
    const uint64_t desc = kmajor_desc_128b(xs + s * kXTile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // a k-step is 32 bytes along the swizzled 128-byte row
      wgmma_m64n128k16(part, cur[kk], desc + 2 * kk, (kk > 0 || !first) ? 1 : 0);
    }
    wgmma_commit();
    float2 sc = make_float2(0.f, 0.f);
    if (last && nvalid) {
      sc = *reinterpret_cast<const float2*>(
          p.scales + static_cast<long long>(k0 / p.group) * p.dout + n0 + ncol);
    }
    if (!first) {  // the block before did not end its group: done once only this one is pending
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    if (it + 1 < nblk) unpack(it + 1, nxt);  // nxt: the registers of the block before
    if (last) {
      wgmma_wait_all();
      if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        acc[4 * j + 0] += part[4 * j + 0] * sc.x;
        acc[4 * j + 1] += part[4 * j + 1] * sc.x;
        acc[4 * j + 2] += part[4 * j + 2] * sc.y;
        acc[4 * j + 3] += part[4 * j + 3] * sc.y;
      }
    }
  };

  uint32_t a0[kBK / 16][4], a1[kBK / 16][4];
  unpack(0, a0);
  for (int it = 0; it < nblk; it += 2) {
    block(it, a0, a1);
    if (it + 1 < nblk) block(it + 1, a1, a0);
  }

  // accumulator (row g | g + 8, col 8 j + 2 tq | + 1) = out[m0 + col][n | n + 1]
  if (nvalid) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * tq + e;
        if (m < p.M) {
          *reinterpret_cast<uint32_t*>(p.out + static_cast<long long>(m) * p.dout + n0 + ncol) =
              pack_f32(acc[4 * j + e], acc[4 * j + 2 + e]);
        }
      }
    }
  }
}

// ----------------------------------------------------------- 2. split-K

constexpr int kSkBN = 64;        // columns per CTA: 16 per warp
constexpr int kSkThreads = 128;
constexpr int kSkMaxChunks = 8;  // chunks of a round: cp.async groups waited on one by one
constexpr int kSkMaxSplits = 8;  // the portable cluster size

// CH: k per chunk (a divisor of the group: 64, 32 or 16). The CTA takes groups
// [split * gps, min(G, (split + 1) * gps)) in rounds of at most kSkMaxChunks
// chunks; a round's whole slab is in flight before its first product. The
// CTAs of one output tile (gridDim.y splits) are one thread block cluster.
template <int CH>
__global__ void __launch_bounds__(kSkThreads) w4_splitk_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ float ss[kSkMaxChunks * kSkBN];        // the round's scale rows (at most 8 groups)
  __shared__ __align__(16) float red[16 * kSkBN];  // this split's result, read by the cluster
  const int n0 = blockIdx.x * kSkBN;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int ngroups = p.din / p.group;
  const int g_begin = split * p.gps;
  const int g_end = min(ngroups, g_begin + p.gps);
  const int round_groups = min(p.gps, kSkMaxChunks * CH / p.group);
  const int ldx = round_groups * p.group + 8;  // x slab row stride (elements)
  const int xrows = p.M <= 8 ? 8 : 16;         // rows 8..15 of the m16 tile are zero registers
  __nv_bfloat16* const xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [xrows][ldx]
  // [k / 2][64]: the 16-byte chunk c of row r sits at chunk c ^ ((r >> 1) & 3),
  // so the four rows a warp reads at once hit distinct banks without padding
  uint8_t* const ps = smem_raw + xrows * ldx * 2;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const bool vec = (p.dout % 16) == 0;

  for (int i = tid; i < (xrows - p.M) * (ldx / 8); i += kSkThreads) {  // rows >= M stay zero
    const int r = p.M + i / (ldx / 8), col = (i % (ldx / 8)) * 8;
    *reinterpret_cast<uint4*>(xs + r * ldx + col) = make_uint4(0u, 0u, 0u, 0u);
  }

  // this thread's bytes in a packed row block: row tq (k = 2tq, 2tq + 1) and
  // row tq + 4 (k = 2tq + 8, + 9), columns 2 g, 2 g + 1 of the warp's chunk
  const int off0 = tq * kSkBN + ((warp ^ (tq >> 1)) << 4) + 2 * g;
  const int off1 = (tq + 4) * kSkBN + ((warp ^ (tq >> 1) ^ 2) << 4) + 2 * g;
  float acc[2][4], part[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = part[nt][e] = 0.f;
  }

  for (int gr = g_begin; gr < g_end; gr += round_groups) {
    const int ng = min(round_groups, g_end - gr);
    const int kbeg = gr * p.group;
    const int nch = ng * p.group / CH;
    if (gr > g_begin) __syncthreads();  // the round before has been read

    // every copy of the round is issued before its first product: one commit
    // group per chunk
    for (int c = 0; c < nch; ++c) {
      constexpr int XCH = CH / 8;  // 16-byte chunks of x per row and chunk
      for (int i = tid; i < p.M * XCH; i += kSkThreads) {
        const int r = i / XCH, col = c * CH + (i % XCH) * 8;
        cp_async16(smem_u32(xs + r * ldx + col),
                   p.x + static_cast<long long>(r) * p.din + kbeg + col, 16);
      }
      const int8_t* pk = p.packed + static_cast<long long>((kbeg + c * CH) / 2) * p.dout + n0;
      for (int i = tid; i < (CH / 2) * (kSkBN / 16); i += kSkThreads) {
        const int r = i / (kSkBN / 16), ch = i % (kSkBN / 16), col = ch * 16;
        const int row = c * CH / 2 + r;
        const int8_t* src = pk + static_cast<long long>(r) * p.dout + col;
        uint8_t* dst = ps + row * kSkBN + ((ch ^ ((row >> 1) & 3)) << 4);
        if (vec) {
          const bool valid = n0 + col < p.dout;
          cp_async16(smem_u32(dst), valid ? src : pk, valid ? 16 : 0);
        } else {  // rows of packed are not 16-byte aligned
#pragma unroll
          for (int e = 0; e < 16; ++e) dst[e] = (n0 + col + e < p.dout) ? src[e] : 0;
        }
      }
      cp_async_commit();
    }
    // the round's scales, while the copies are in flight
    for (int i = tid; i < ng * kSkBN; i += kSkThreads) {
      const int col = n0 + i % kSkBN;
      ss[i] = col < p.dout ? p.scales[static_cast<long long>(gr + i / kSkBN) * p.dout + col] : 0.f;
    }

    for (int c = 0; c < nch; ++c) {
      cp_async_wait(nch - 1 - c);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk) {
        const int k = c * CH + kk * 16;
        uint32_t a[4];
        const __nv_bfloat16* lo_row = xs + g * ldx + k + tq * 2;
        const __nv_bfloat16* hi_row = lo_row + 8 * ldx;
        a[0] = visper::ld32(lo_row);
        a[1] = xrows == 16 ? visper::ld32(hi_row) : 0u;
        a[2] = visper::ld32(lo_row + 8);
        a[3] = xrows == 16 ? visper::ld32(hi_row + 8) : 0u;
        // Column i of n8-tile nt is column 2 i + nt of the warp's 16, so a
        // thread's two tiles are one 16-bit load per packed row.
        // rows k / 2 + tq and + 4; k / 2 is a multiple of 8, so (row >> 1) & 3
        // is tq >> 1 and (tq >> 1) ^ 2 whatever k: the offsets are per thread
        const uint8_t* pr = ps + (k / 2) * kSkBN;
        uint32_t b0[2], b1[2];
        unpack_bytes(*reinterpret_cast<const uint16_t*>(pr + off0), p.magic, b0[0], b0[1]);
        unpack_bytes(*reinterpret_cast<const uint16_t*>(pr + off1), p.magic, b1[0], b1[1]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_bf16(part[nt], a, b0[nt], b1[nt]);
      }
      if ((c + 1) * CH % p.group == 0) {  // the group ends: scale and fold in
        const float* sc = ss + ((c + 1) * CH / p.group - 1) * kSkBN + warp * 16 + 4 * tq;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float s0 = sc[nt], s1 = sc[2 + nt];  // columns 2 (2 tq) + nt and 2 (2 tq + 1) + nt
          acc[nt][0] += part[nt][0] * s0;
          acc[nt][1] += part[nt][1] * s1;
          acc[nt][2] += part[nt][2] * s0;
          acc[nt][3] += part[nt][3] * s1;
#pragma unroll
          for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
        }
      }
    }
  }

  // this split's result (a sum of whole scaled groups) to its shared memory
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[(g + (e >> 1) * 8) * kSkBN + warp * 16 + 4 * tq + 2 * (e & 1) + nt] = acc[nt][e];
    }
  }
  // The cluster sums its splits through distributed shared memory, always in
  // split order; each CTA takes a share of the tile's M x 16 column quads.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float* parts[kSkMaxSplits];
#pragma unroll
  for (int s = 0; s < kSkMaxSplits; ++s) {
    parts[s] = s < splits ? cluster.map_shared_rank(red, s) : red;
  }
  const int rank = cluster.block_rank();
  for (int i = rank * kSkThreads + tid; i < p.M * (kSkBN / 4); i += splits * kSkThreads) {
    const int r = i / (kSkBN / 4), c4 = (i % (kSkBN / 4)) * 4;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kSkMaxSplits; ++s) {
      if (s < splits) {
        const float4 v = *reinterpret_cast<const float4*>(parts[s] + r * kSkBN + c4);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    }
    const float o[4] = {sum.x, sum.y, sum.z, sum.w};
    __nv_bfloat16* dst = p.out + static_cast<long long>(r) * p.dout + n0 + c4;
    if (p.dout % 4 == 0) {
      if (n0 + c4 < p.dout) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(pack_f32(o[0], o[1]), pack_f32(o[2], o[3]));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n0 + c4 + e < p.dout) dst[e] = __float2bfloat16(o[e]);
      }
    }
  }
  cluster.sync();  // no CTA leaves while another still reads its result
}

template <int CH>
cudaError_t launch_splitk(const Params& p, cudaStream_t stream) {
  const int ngroups = p.din / p.group;
  const int max_round_groups = kSkMaxChunks * CH / p.group;
  if (p.group % CH || p.gps <= 0 || max_round_groups == 0) return cudaErrorInvalidValue;
  const int splits = (ngroups + p.gps - 1) / p.gps;
  if (splits > kSkMaxSplits) return cudaErrorInvalidValue;
  const int round_k = (p.gps < max_round_groups ? p.gps : max_round_groups) * p.group;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.dout + kSkBN - 1) / kSkBN, splits);
  cfg.blockDim = dim3(kSkThreads);
  cfg.dynamicSmemBytes = (p.M <= 8 ? 8 : 16) * (round_k + 8) * 2 + (round_k / 2) * kSkBN;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, w4_splitk_kernel<CH>, p);
}

// ---------------------------------------------------------- 3. mma.sync

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
cudaError_t launch_mma_sync(const Params& p, cudaStream_t stream) {
  if (p.M <= 16) {
    const dim3 grid((p.dout + 63) / 64, (p.M + 15) / 16);
    w4_matmul_kernel<16, 64, BK, 1, 4><<<grid, 128, 0, stream>>>(p);
  } else {
    const dim3 grid((p.dout + 127) / 128, (p.M + 127) / 128);
    w4_matmul_kernel<128, 128, BK, 2, 4><<<grid, 256, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

// The map of a row-major (rows, cols) tensor of 1- or 2-byte elements, cut in
// boxes of box_rows x 128 bytes in the 128-byte swizzle. Built once per
// (pointer, shape) and kept; false when the encoding is refused.
bool tensor_map(const void* ptr, int elem_bytes, long long rows, long long cols, int box_rows,
                CUtensorMap* out) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, long long, long long, int>, CUtensorMap> maps;
  std::lock_guard<std::mutex> lock(mu);
  const visper::EncodeTiled encode = visper::encode_tiled();
  if (encode == nullptr) return false;
  const auto key = std::make_tuple(ptr, elem_bytes, rows, cols, box_rows);
  auto it = maps.find(key);
  if (it != maps.end()) {
    *out = it->second;
    return true;
  }
  if (maps.size() >= 4096) maps.clear();  // activations come and go; weights come back
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult rc = encode(
      out, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
      const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return false;
  maps.emplace(key, *out);
  return true;
}

cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  if (p.M <= 16 || p.group % kBK || p.dout % 16) return cudaErrorInvalidValue;
  static bool attr_set = false;  // shared memory above 48 KB is opted into once
  if (!attr_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        w4_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgmmaSmem);
    if (rc != cudaSuccess) return rc;
    attr_set = true;
  }
  CUtensorMap x_map, packed_map;
  if (!tensor_map(p.x, 2, p.M, p.din, kBM, &x_map) ||
      !tensor_map(p.packed, 1, p.din / 2, p.dout, kBK / 2, &packed_map)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((p.dout + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  w4_wgmma_kernel<<<grid, kWgmmaThreads, kWgmmaSmem, stream>>>(x_map, packed_map, p);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). x, packed,
// scales and out are contiguous; group must be a multiple of 16 dividing din.
// kernel: 0 mma.sync, 1 wgmma (M > 16, group % 64 == 0, dout % 16 == 0),
// 2 split-K (M <= 16; gps groups per split, at most 8 splits, a group of at
// most eight chunks of its largest divisor among 64, 32, 16).
extern "C" int visper_w4_matmul(const void* x, const void* packed, const void* scales,
                                void* out, int M, int din, int dout, int group, int kernel,
                                int gps, void* stream) {
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
  p.gps = gps;
  p.magic = 0x43004300u;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel == 1) return static_cast<int>(launch_wgmma(p, st));
  if (kernel == 2) {
    if (M > 16) return static_cast<int>(cudaErrorInvalidValue);
    if (group % 64 == 0) return static_cast<int>(launch_splitk<64>(p, st));
    if (group % 32 == 0) return static_cast<int>(launch_splitk<32>(p, st));
    return static_cast<int>(launch_splitk<16>(p, st));
  }
  if (kernel != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (group % 64 == 0) return static_cast<int>(launch_mma_sync<64>(p, st));
  if (group % 32 == 0) return static_cast<int>(launch_mma_sync<32>(p, st));
  return static_cast<int>(launch_mma_sync<16>(p, st));
}
