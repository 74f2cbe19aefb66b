// Fused Swin window attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel visper_lm_tpu/ops/window_attention.py
// `window_attention_pallas` (:82, kernel `_kernel` :57, pl.pallas_call :112):
// for every (window w, head h), non-causal, forward only,
//   out = softmax(q k^T * scale + bias[h] + mask[w % nW]) v
// with q, k, v, out (W, heads, N, D) read and written through their strides,
// bias (heads, N, N) f32, the optional shift mask (nW, N, N) f32 tiled over W
// with period nW (the `i % period` index map of :104-106). The scale is applied
// to the f32 scores, bias is added before the mask, the softmax is taken in
// f32 and normalised before P is rounded to bf16 for the second product, as
// the Pallas kernel does. Supported (N, D): (144, 32) for Swin-L, (64, 16) for
// tests.
//
// Bound on an H100 SXM at Swin-L's stage-1 shape (768 px, micro-batch 2:
// W = 512 windows, 6 heads, N = 144, D = 32, bf16): q, k, v read once and the
// output written once are ~113 MB (~34 us at 3.35 TB/s; the shift mask adds
// 21 MB) against ~8 GFLOP (~8 us at 989 TFLOP/s), so the ideal kernel is bound
// by memory. A window's problem is tiny (144 x 32); the f32 bias of a head and
// the mask of a window position (83 KB each) are larger than a window's own
// q, k, v and output (37 KB).
//
// One kernel, "streamed" (ops/window_attention.py `window_attn_kernel_for`
// names it, `window_attn_plan` sets its grid): a CTA of N / 16 warps (9 for
// N = 144) takes a
//    run of windows that share their bias and mask: one head and, in a
//    shifted launch, one mask index m, so windows m, m + nW, ... across the
//    batch's images; in an unshifted launch a run of consecutive windows. The
//    copy engine brings the head's bias and the mask once per CTA into shared
//    memory, N / 16 boxes of 16 columns each in the 64-byte swizzle (a warp's
//    8-byte reads of 8 rows take the two wavefronts 256 bytes need), and each
//    window's q, k and v (one 4-D tensor-map box each, in the 64- or 32-byte
//    swizzle of a D-wide row) through a ring of `stages` stages (up to 5),
//    refilled by warp 0 at the top of each window; mbarriers pass the stages.
//    Each warp owns 16 query rows of every window: S = Q K^T by mma.sync
//    m16n8k16 (f32) with Q and K fragments from ldmatrix, + bias + mask from
//    shared memory, the row max and sum over the quad by shuffles,
//    P = 2^(x log2 e - max log2 e) by ex2.approx, P normalised in f32 and
//    rounded to bf16 as the A operand of O = P V (V through ldmatrix.trans).
//    O goes back into the warp's own q rows of the stage and out as 16-byte
//    rows through the output's strides. Every output element is written once
//    by one CTA: a launch is bit-identical when repeated. Bias and mask take
//    most of the shared memory, so a CTA fills its SM (one CTA, 9 warps).

#include <math.h>

#include "mma_bf16.cuh"
#include "tma_sm90.cuh"

namespace {

using visper::ex2;
using visper::fence_proxy_async;
using visper::kLog2e;
using visper::ldsm_x4;
using visper::ldsm_x4_t;
using visper::mbar_arrive;
using visper::mbar_expect_tx;
using visper::mbar_init;
using visper::mbar_wait;
using visper::mma_bf16;
using visper::pack_f32;
using visper::smem_u32;
using visper::tensor_map;
using visper::tensor_map_f32;
using visper::tma_load_3d;
using visper::tma_load_4d;

constexpr int kSmemLimit = 232448;  // dynamic shared memory a CTA may ask for (227 KB)

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
  int windows_per_cta, stages;  // streamed: the plan
  float scale;
};

// streamed: one CTA of N / 16 warps for a run of windows that share bias and mask

template <int N, int D>
struct StreamCfg {
  static constexpr int kWarps = N / 16;
  static constexpr int kThreads = N * 2;
  static constexpr int kArrayBytes = N * N * 4;     // bias or mask: N / 16 blocks of 16 columns
  static constexpr int kBlockBytes = N * 64;
  static constexpr int kRowBytes = D * 2;
  static constexpr int kTileBytes = N * kRowBytes;  // one of q, k, v
  static constexpr int kStageBytes = 3 * kTileBytes;
  // the ring, bias (and mask), the mbarriers, and the slack that aligns the
  // swizzled tiles to 1024 bytes
  static int smem(bool masked, int stages) {
    return stages * kStageBytes + (masked ? 2 : 1) * kArrayBytes + 8 * (1 + 2 * stages) + 1024;
  }
};

// Byte offset of the 16-byte chunk `chunk` of row `row` of a tile with D-wide
// bf16 rows, in the copy engine's swizzle of that width (64 bytes at D 32, 32
// at D 16): the chunk index is XORed with the row's bits above the 128-byte
// line, so a warp's ldmatrix rows land on distinct banks. Rows 16 apart (and
// 8 apart) share their swizzle: tile_off(row + 16 i, c) = 16 i x row bytes +
// tile_off(row, c).
template <int D>
__device__ __forceinline__ uint32_t tile_off(int row, int chunk) {
  constexpr uint32_t kSpan = D * 2;
  const uint32_t off = row * kSpan + chunk * 16;
  return off ^ (((off >> 7) & (kSpan / 16 - 1)) << 4);
}

template <int N, int D>
__global__ void __launch_bounds__(StreamCfg<N, D>::kThreads, 1)
    window_attn_stream_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap bias_map,
                              const __grid_constant__ CUtensorMap mask_map, const Params p) {
  using C = StreamCfg<N, D>;
  constexpr int KS = D / 16;  // k-steps of S
  constexpr int SN = N / 8;   // n-tiles of S
  constexpr int PK = N / 16;  // k-steps of O = P V
  constexpr int ON = D / 8;   // n-tiles of O, and 16-byte chunks of a row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const bool masked = p.mask != nullptr;
  const int stages = p.stages;
  // [stages][q, k, v] | bias | mask | bm_full, full[stages], empty[stages]
  const uint32_t bias_s = base + stages * C::kStageBytes;
  const uint32_t mask_s = bias_s + C::kArrayBytes;
  const uint32_t bm_full = bias_s + (masked ? 2 : 1) * C::kArrayBytes;
  const uint32_t full = bm_full + 8;
  const uint32_t empty = full + 8 * stages;
  const float* bias = reinterpret_cast<const float*>(smem_raw + (bias_s - raw));
  const float* mask = masked ? bias + N * N : nullptr;

  // this CTA: head blockIdx.y, mask index m, windows j of the run at
  // m + (first + j) * period
  const int period = masked ? p.nW : 1;
  const int group = p.W / period;
  const int runs = (group + p.windows_per_cta - 1) / p.windows_per_cta;
  const int m = blockIdx.x / runs;
  const int first = (blockIdx.x % runs) * p.windows_per_cta;
  const int count = min(p.windows_per_cta, group - first);
  const int head = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int r0 = warp * 16;  // the warp's query rows: r0 .. r0 + 15

  if (threadIdx.x == 0) {
    mbar_init(bm_full, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);            // the producer's expect_tx arrival
      mbar_init(empty + 8 * s, C::kWarps);   // one lane of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // window j of the run into stage s: q, k, v of (window, head), a box each
  auto load_window = [&](int j, int s) {
    const int w = m + (first + j) * period;
    const uint32_t dst = base + s * C::kStageBytes;
    mbar_expect_tx(full + 8 * s, C::kStageBytes);
    tma_load_4d(dst, &q_map, 0, head, 0, w, full + 8 * s);
    tma_load_4d(dst + C::kTileBytes, &k_map, 0, head, 0, w, full + 8 * s);
    tma_load_4d(dst + 2 * C::kTileBytes, &v_map, 0, head, 0, w, full + 8 * s);
  };
  if (threadIdx.x == 0) {
    // the head's bias and the mask once, boxes of 16 columns, and the first stages
    mbar_expect_tx(bm_full, (masked ? 2 : 1) * C::kArrayBytes);
#pragma unroll
    for (int b = 0; b < N / 16; ++b) {
      tma_load_3d(bias_s + b * C::kBlockBytes, &bias_map, 16 * b, 0, head, bm_full);
      if (masked) tma_load_3d(mask_s + b * C::kBlockBytes, &mask_map, 16 * b, 0, m, bm_full);
    }
    for (int j = 0; j < min(stages, count); ++j) load_window(j, j);
  }

  // this thread's shared-memory offsets, fixed for the whole run: ldmatrix
  // rows of Q, K and V (lane i gives row i % 8 of matrix i / 8), its two
  // column pairs of a 16-column bias / mask block in row r0 + g (row + 8
  // is 128 floats on: the swizzle repeats), and its O chunks
  uint32_t qoff[KS], koff[KS];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    qoff[kk] = tile_off<D>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * kk + (lane >> 4));
    koff[kk] = tile_off<D>((lane & 7) + (lane >> 4) * 8, 2 * kk + ((lane >> 3) & 1));
  }
  uint32_t voff[ON / 2];
#pragma unroll
  for (int np = 0; np < ON / 2; ++np) {
    voff[np] = tile_off<D>((lane & 7) + ((lane >> 3) & 1) * 8, 2 * np + (lane >> 4));
  }
  const int row = r0 + g;
  const int bswz = (row >> 1) & 3;
  const int boff0 = row * 16 + (((tq >> 1) ^ bswz) << 2) + (tq & 1) * 2;
  const int boff1 = row * 16 + (((2 + (tq >> 1)) ^ bswz) << 2) + (tq & 1) * 2;
  const uint32_t orow = row * C::kRowBytes + tq * 4;
  const int oswz = (tile_off<D>(row, 0) >> 4) & (ON - 1);  // the row's chunk XOR

  for (int j = 0; j < count; ++j) {
    const int st = j % stages;
    // warp 0 refills the stage window j - 1 left with window j - 1 + stages
    if (warp == 0 && j > 0 && j - 1 + stages < count) {
      if (lane == 0) {
        const int prev = (j - 1) % stages;
        mbar_wait(empty + 8 * prev, ((j - 1) / stages) & 1);
        load_window(j - 1 + stages, prev);
      }
      __syncwarp();
    }
    const uint32_t qt = base + st * C::kStageBytes;
    const uint32_t kt = qt + C::kTileBytes;
    const uint32_t vt = kt + C::kTileBytes;
    mbar_wait(full + 8 * st, (j / stages) & 1);

    // S = Q K^T
    float s[SN][4];
#pragma unroll
    for (int nt = 0; nt < SN; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, qt + qoff[kk]);
#pragma unroll
      for (int np = 0; np < SN / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, kt + np * 16 * C::kRowBytes + koff[kk]);
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }
    if (j == 0) mbar_wait(bm_full, 0);

    // scores in f32: scale, + bias, + mask; row max over the quad
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < SN; ++nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = (nt >> 1) * N * 16 + r * 128 + ((nt & 1) ? boff1 : boff0);
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
      const float ml = mx[r] * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < SN; ++nt) {
#pragma unroll
        for (int i = 2 * r; i < 2 * r + 2; ++i) s[nt][i] = ex2(fmaf(s[nt][i], kLog2e, -ml));
        sum += s[nt][2 * r] + s[nt][2 * r + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[r] = 1.f / sum;
    }

    // O = P V with P normalised, then rounded to bf16 (V through ldmatrix.trans)
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
      for (int np = 0; np < ON / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vt + kk * 16 * C::kRowBytes + voff[np]);
        mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }

    // O into the warp's own q rows (no other warp reads them), then out as
    // 16-byte row chunks through the output's strides
    uint8_t* const q_rows = smem_raw + (qt - raw);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int nt = 0; nt < ON; ++nt) {
        *reinterpret_cast<uint32_t*>(q_rows + orow + r * 8 * C::kRowBytes + ((nt ^ oswz) << 4)) =
            pack_f32(o[nt][2 * r], o[nt][2 * r + 1]);
      }
    }
    __syncwarp();
    const int w = m + (first + j) * period;
    __nv_bfloat16* const ob = static_cast<__nv_bfloat16*>(p.o) + w * p.o_sw + head * p.o_sh;
#pragma unroll
    for (int i = lane; i < 16 * ON; i += 32) {
      const int orow_i = r0 + i / ON, chunk = i % ON;
      *reinterpret_cast<uint4*>(ob + orow_i * p.o_sn + chunk * 8) =
          *reinterpret_cast<const uint4*>(q_rows + tile_off<D>(orow_i, chunk));
    }
    // the copy engine refills this stage next: order these accesses before it
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }
}

template <int N, int D>
cudaError_t allow_smem() {
  static bool set = false;  // shared memory above 48 KB is opted into once
  if (!set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        window_attn_stream_kernel<N, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (rc != cudaSuccess) return rc;
    set = true;
  }
  return cudaSuccess;
}

template <int N, int D>
cudaError_t launch_streamed(const Params& p, cudaStream_t stream) {
  using C = StreamCfg<N, D>;
  const int smem = C::smem(p.mask != nullptr, p.stages);
  const int period = p.mask ? p.nW : 1;
  if (p.windows_per_cta < 1 || p.stages < 1 || smem > kSmemLimit || p.W % period) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t rc = allow_smem<N, D>();
  if (rc != cudaSuccess) return rc;
  CUtensorMap q_map, k_map, v_map, bias_map, mask_map;
  if (!tensor_map(p.q, D, p.heads, N, p.W, p.q_sw, p.q_sn, p.q_sh, D, N, &q_map) ||
      !tensor_map(p.k, D, p.heads, N, p.W, p.k_sw, p.k_sn, p.k_sh, D, N, &k_map) ||
      !tensor_map(p.v, D, p.heads, N, p.W, p.v_sw, p.v_sn, p.v_sh, D, N, &v_map) ||
      !tensor_map_f32(p.bias, N, N, p.heads, N, &bias_map) ||
      !tensor_map_f32(p.mask ? p.mask : p.bias, N, N, p.mask ? p.nW : p.heads, N, &mask_map)) {
    return cudaErrorInvalidValue;
  }
  const int runs = (p.W / period + p.windows_per_cta - 1) / p.windows_per_cta;
  const dim3 grid(period * runs, p.heads);
  window_attn_stream_kernel<N, D><<<grid, C::kThreads, smem, stream>>>(q_map, k_map, v_map,
                                                                       bias_map, mask_map, p);
  return cudaGetLastError();
}

template <int N, int D>
int info(bool masked, int stages, int* threads, int* smem, int* ctas_per_sm) {
  if (stages < 1) return static_cast<int>(cudaErrorInvalidValue);
  *threads = StreamCfg<N, D>::kThreads;
  *smem = StreamCfg<N, D>::smem(masked, stages);
  const cudaError_t rc = allow_smem<N, D>();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, window_attn_stream_kernel<N, D>, *threads, *smem));
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). Strides are in
// elements (window, head, row); the D stride must be 1 and the others multiples
// of 8 (16-byte rows for the copy engine). mask may be null (nW is then
// ignored). Only bf16 tensors and the (N, D) pairs above. windows_per_cta
// and stages come from `window_attn_plan`.
extern "C" int visper_window_attn(
    const void* q, const void* k, const void* v, void* o, const void* bias,
    const void* mask, long long q_sw, long long q_sh, long long q_sn, long long k_sw,
    long long k_sh, long long k_sn, long long v_sw, long long v_sh, long long v_sn,
    long long o_sw, long long o_sh, long long o_sn, int W, int heads, int N, int D,
    int nW, float scale, int windows_per_cta, int stages, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.bias = static_cast<const float*>(bias);
  p.mask = static_cast<const float*>(mask);
  p.q_sw = q_sw; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sw = k_sw; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sw = v_sw; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sw = o_sw; p.o_sh = o_sh; p.o_sn = o_sn;
  p.W = W; p.heads = heads; p.nW = nW > 0 ? nW : 1;
  p.windows_per_cta = windows_per_cta; p.stages = stages;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 144 && D == 32) return static_cast<int>(launch_streamed<144, 32>(p, st));
  if (N == 64 && D == 16) return static_cast<int>(launch_streamed<64, 16>(p, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Geometry of the kernel at (N, D), for reports: threads and dynamic shared
// memory of a CTA (with or without the mask, `stages` stages), and how many
// CTAs the occupancy calculator fits on one SM. Returns 0, or a CUDA error for
// what the kernel does not take.
extern "C" int visper_window_attn_info(int N, int D, int masked, int stages,
                                       int* threads, int* smem, int* ctas_per_sm) {
  if (N == 144 && D == 32) return info<144, 32>(masked, stages, threads, smem, ctas_per_sm);
  if (N == 64 && D == 16) return info<64, 16>(masked, stages, threads, smem, ctas_per_sm);
  return static_cast<int>(cudaErrorInvalidValue);
}
