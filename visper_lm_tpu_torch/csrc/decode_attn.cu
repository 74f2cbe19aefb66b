// Single-token decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel visper_lm_tpu/ops/decode_attention.py
// `_decode_kernel` (:67), launched by `decode_attention`'s pl.pallas_call
// (:188). Same function:
//   * q (B, 1, Nq, H) is the newest token; the cache (B, Nkv, S, H) is
//     head-major, bf16 or int8 with per-vector f32 scales (B, Nkv, S);
//   * scores s = (q . k) * scale, times the k scale for an int8 cache, in f32;
//     positions outside [kv_starts[b], kv_lengths[b]) are masked;
//   * a softmax over S; the v scale multiplies the probability before the
//     p . v product, so the int8 cache is never dequantized;
//   * a row with no valid position gives 0; query head h reads kv head h / G.
//
// Bound on an H100 SXM at the serving decode shape (B8, 32/32 heads, H96,
// S = 896): the cache must be read once: 88.1 MB in bf16 (~26 us at
// 3.35 TB/s), 45.9 MB in int8 with its scales (~14 us); the FLOPs are
// negligible, so the ideal kernel is bound by memory, and the work is in
// keeping enough bytes in flight and the per-element instructions few.
//
// Two kernels; the wrapper passes the number of the one a call takes.
//
// 1. `decode_split_kernel` (every supported shape): flash-decoding over a
//    thread block cluster.
//    - S is cut into `splits` (at most 8) spans of `span` positions, a pure
//      function of the shapes (ops/decode_attention.py `decode_split_plan`),
//      so that several CTAs of 128 threads sit on each SM. The CTAs of one
//      (batch, kv head) are one cluster. Each clips its span to
//      [kv_start, kv_len) on the device: the host never reads the lengths.
//    - A CTA asks for its whole K slab, its V slab and both scale rows at
//      once (at most `round` positions: tens of KB in flight per CTA) with
//      16-byte cp.async copies; rows of the head-major cache are contiguous,
//      so the slab is one contiguous run. It scores K while V is still
//      landing. A span longer than `round` takes several rounds with an
//      online softmax between them; the next round's K is asked for as soon
//      as this round's scores are done.
//    - Eight threads share a position: each owns H / 8 columns in pieces of
//      4, 8 or 16 bytes laid out so that a warp's loads of four neighbouring
//      rows hit distinct banks, for K and V alike. Scores are summed over the
//      eight by shuffles; the CTA's max of the round is taken once, so the
//      p . v pass needs no rescaling per position. Up to 4 query heads of
//      one kv head (G) share each K/V read.
//    - int8 is unpacked without a conversion: a byte-permute puts b ^ 0x80
//      into the mantissa of 2^23, and one subtraction of 2^23 + 128 leaves
//      b (exact); bf16 is a shift or a mask.
//    - Each split's (max, sum, acc) stays in its CTA's shared memory; after a
//      cluster barrier the CTAs merge a share of the G x H outputs each,
//      reading every split through distributed shared memory in split order:
//      no scratch, no atomics, the same bits run after run. A split with no
//      valid position contributes nothing.
// 2. `decode_attn_kernel` (the kernel before it, kept to be timed beside it;
//    no shape is dispatched to it): one CTA of 4 warps per (batch, kv head)
//    walking S serially in tiles of 32 positions, one lane per position for
//    K, V read row by row from global memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;  // positions per warp step: one per lane
constexpr int kMaxG = 4;   // query heads per kv head

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // (B, Nkv, S) or null (bf16 cache)
  const float* v_scale;
  void* o;
  const int* kv_len;     // (B,)
  const int* kv_start;   // (B,) or null
  int B, Nq, Nkv, S, group;
  float scale;
  int span, splits, round;  // the split kernel's plan
};

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int H, typename KV>
__global__ void __launch_bounds__(kWarps * 32) decode_attn_kernel(const Params p) {
  constexpr int kRowBytes = H * static_cast<int>(sizeof(KV));
  constexpr int kLd = kRowBytes + 16;           // padded row stride (bytes)
  constexpr int kChunks = kRowBytes / 16;       // 16-byte chunks per row
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(KV));
  constexpr int kPerLane = H / 32;              // output elements per lane
  __shared__ float qs[kMaxG][H];
  __shared__ __align__(16) unsigned char ks[kWarps][kTile * kLd];
  __shared__ float red_m[kWarps][kMaxG];
  __shared__ float red_l[kWarps][kMaxG];
  __shared__ float red_acc[kWarps][kMaxG][H];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = p.group;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool quant = p.k_scale != nullptr;

  const long long head_row = static_cast<long long>(b) * p.Nkv + kvh;  // (b, kvh)
  const KV* kb = static_cast<const KV*>(p.k) + head_row * p.S * H;
  const KV* vb = static_cast<const KV*>(p.v) + head_row * p.S * H;
  const float* ksc = quant ? p.k_scale + head_row * p.S : nullptr;
  const float* vsc = quant ? p.v_scale + head_row * p.S : nullptr;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + (static_cast<long long>(b) * p.Nq + kvh * G) * H;

  for (int i = threadIdx.x; i < G * H; i += kWarps * 32) qs[i / H][i % H] = to_f(qb[i]);
  __syncthreads();

  const int len = min(p.kv_len[b], p.S);
  const int lo = p.kv_start ? max(p.kv_start[b], 0) : 0;

  float m[kMaxG], l[kMaxG], acc[kMaxG][kPerLane];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[g][j] = 0.f;
  }

  unsigned char* tile = ks[warp];
  for (int t0 = (lo / kTile) * kTile + warp * kTile; t0 < len; t0 += kWarps * kTile) {
    // K tile -> shared memory: 32 contiguous rows, coalesced 16-byte loads
    for (int i = lane; i < kTile * kChunks; i += 32) {
      const int r = i / kChunks, c = i % kChunks;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (t0 + r < p.S) {
        val = *reinterpret_cast<const uint4*>(kb + static_cast<long long>(t0 + r) * H + c * kPerChunk);
      }
      *reinterpret_cast<uint4*>(tile + r * kLd + c * 16) = val;
    }
    __syncwarp();

    // lane i: scores of position t0 + i for the G query heads
    const int pos = t0 + lane;
    const bool ok = pos >= lo && pos < len;
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    const unsigned char* row = tile + lane * kLd;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint4 val = *reinterpret_cast<const uint4*>(row + c * 16);
      const KV* e = reinterpret_cast<const KV*>(&val);
#pragma unroll
      for (int x = 0; x < kPerChunk; ++x) {
        const float kv = to_f(e[x]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) s[g] = fmaf(qs[g][c * kPerChunk + x], kv, s[g]);
        }
      }
    }
    const float k_s = (quant && ok) ? ksc[pos] : 1.f;
    const float v_s = (quant && ok) ? vsc[pos] : 1.f;

    // online softmax; pv = p [* v scale] is what multiplies v
    float pv[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      pv[g] = 0.f;
      if (g >= G) continue;
      float x = s[g] * p.scale;
      if (quant) x *= k_s;
      x = ok ? x : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(x));
      const float base = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = (m[g] == -INFINITY) ? 0.f : expf(m[g] - base);
      const float pr = ok ? expf(x - base) : 0.f;
      l[g] = l[g] * alpha + pr;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) acc[g][j] *= alpha;
      m[g] = m_new;
      pv[g] = pr * v_s;
    }

    // acc += pv . V over the tile's valid rows (uniform bounds across the warp)
    const int r_lo = max(lo - t0, 0), r_hi = min(kTile, len - t0);
    for (int r = r_lo; r < r_hi; ++r) {
      const KV* vrow = vb + static_cast<long long>(t0 + r) * H;
      float vv[kPerLane];
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) vv[j] = to_f(vrow[lane + 32 * j]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) continue;
        const float pr = __shfl_sync(0xffffffffu, pv[g], r);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) acc[g][j] = fmaf(pr, vv[j], acc[g][j]);
      }
    }
    __syncwarp();
  }

  // combine the warps
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) continue;
    const float lw = warp_sum(l[g]);
    if (lane == 0) {
      red_m[warp][g] = m[g];
      red_l[warp][g] = lw;
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) red_acc[warp][g][lane + 32 * j] = acc[g][j];
  }
  __syncthreads();
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + (static_cast<long long>(b) * p.Nq + kvh * G) * H;
  for (int i = threadIdx.x; i < G * H; i += kWarps * 32) {
    const int g = i / H, c = i % H;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][g]);
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (red_m[w][g] == -INFINITY) continue;
        const float f = expf(red_m[w][g] - mx);
        lsum += red_l[w][g] * f;
        a += red_acc[w][g][c] * f;
      }
    }
    ob[i] = __float2bfloat16(lsum > 0.f ? a / lsum : 0.f);
  }
}

// ------------------------------------------------------- the split kernel

namespace cg = cooperative_groups;

constexpr int kSplitThreads = 128;
constexpr int kPosLanes = 8;                               // threads that share a position
constexpr int kPosPerStep = kSplitThreads / kPosLanes;     // positions a CTA handles per step
constexpr int kMaxSplits = 8;                              // the portable cluster size
constexpr int kMaxSplitSmem = 160 * 1024;                  // dynamic shared memory a plan may ask for

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one of this thread's committed groups is pending.
__device__ __forceinline__ void cp_async_wait_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// How the eight threads of a position cut a row of H elements of KV: thread j
// owns pieces i = 0 .. kNP - 1, piece i being the kW bytes at (8 i + j) * kW.
// Neighbouring threads read neighbouring pieces, so every load of a warp
// (four rows, contiguous in the slab) is one contiguous run of 32 * kW bytes.
template <int H, typename KV>
struct Pieces {
  static constexpr int kRowBytes = H * static_cast<int>(sizeof(KV));
  static constexpr int kPerThread = kRowBytes / kPosLanes;  // 8, 12, 16, 24 or 32 bytes
  static constexpr int kW = kPerThread % 16 == 0 ? 16 : kPerThread % 8 == 0 ? 8 : 4;
  static constexpr int kNP = kPerThread / kW;
  static constexpr int kEl = kW / static_cast<int>(sizeof(KV));  // elements per piece
  static constexpr int kCols = kNP * kEl;                        // H / 8
};

// One 32-bit word of the cache -> floats.
__device__ __forceinline__ void word_to_f(uint32_t w, float (&f)[4], int8_t) {
  // b ^ 0x80 = b + 128 into the low mantissa byte of 2^23, minus (2^23 + 128)
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

__device__ __forceinline__ void word_to_f(uint32_t w, float (&f)[2], __nv_bfloat16) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xFFFF0000u);
}

// This thread's kCols elements of the row at `row` (shared memory) as floats,
// piece by piece.
template <int H, typename KV>
__device__ __forceinline__ void load_row(const uint8_t* row, int j,
                                         float (&f)[Pieces<H, KV>::kCols]) {
  using L = Pieces<H, KV>;
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(KV));
  constexpr int kWords = L::kW / 4;
#pragma unroll
  for (int i = 0; i < L::kNP; ++i) {
    const uint8_t* src = row + (8 * i + j) * L::kW;
    uint32_t w[kWords];
    if constexpr (L::kW == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (L::kW == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(src);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(src);
    }
#pragma unroll
    for (int x = 0; x < kWords; ++x) {
      float f1[kPerWord];
      word_to_f(w[x], f1, KV());
#pragma unroll
      for (int e = 0; e < kPerWord; ++e) f[i * L::kEl + x * kPerWord + e] = f1[e];
    }
  }
}

// G: query heads per kv head the registers hold (p.group <= G). The CTAs of
// one (batch, kv head), gridDim.x = p.splits of them, are one cluster.
template <int H, typename KV, int G>
__global__ void __launch_bounds__(kSplitThreads) decode_split_kernel(const Params p) {
  using L = Pieces<H, KV>;
  constexpr int kWarpsS = kSplitThreads / 32;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ float red[kWarpsS][G][H];       // the warps' partial outputs
  __shared__ float red_l[kWarpsS][G];
  __shared__ float wmax[kWarpsS][G];
  __shared__ float part[G][H];               // this split's result, read by the cluster
  __shared__ float part_m[G], part_l[G];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int j = lane % kPosLanes;            // this thread's share of a row
  const int grp = tid / kPosLanes;           // the position of a step it works on
  const bool quant = p.k_scale != nullptr;
  const bool vec_scales = (p.S % 4) == 0;    // scale rows are 16-byte aligned

  uint8_t* const ks = smem_raw;                                    // [round][row bytes]
  uint8_t* const vs = ks + p.round * L::kRowBytes;
  float* const ksc = reinterpret_cast<float*>(vs + p.round * L::kRowBytes);  // [round]
  float* const vsc = ksc + p.round;
  float* const sc = vsc + p.round;                                 // [G][round] scores

  const long long head_row = static_cast<long long>(b) * p.Nkv + kvh;
  const uint8_t* kb = static_cast<const uint8_t*>(p.k) + head_row * p.S * L::kRowBytes;
  const uint8_t* vb = static_cast<const uint8_t*>(p.v) + head_row * p.S * L::kRowBytes;
  const float* ksg = quant ? p.k_scale + head_row * p.S : nullptr;
  const float* vsg = quant ? p.v_scale + head_row * p.S : nullptr;

  // this split's share of [lo, len); rounds start on a multiple of 4 positions
  const int len = min(p.kv_len[b], p.S);
  const int lo = p.kv_start ? max(p.kv_start[b], 0) : 0;
  const int p_begin = max(split * p.span, lo);
  const int p_end = min((split + 1) * p.span, len);
  const int r_begin = p_begin & ~3;
  const int nrounds = p_end > p_begin ? (p_end - r_begin + p.round - 1) / p.round : 0;

  auto copy_rows = [&](uint8_t* dst, const uint8_t* src, int r) {  // round r's rows
    const int r0 = r_begin + r * p.round;
    const int n16 = min(p.round, p_end - r0) * (L::kRowBytes / 16);
    const uint8_t* from = src + static_cast<long long>(r0) * L::kRowBytes;
    for (int i = tid; i < n16; i += kSplitThreads) cp_async16(dst + i * 16, from + i * 16);
  };
  auto copy_scales = [&](float* dst, const float* src, int r) {
    if (!quant) return;
    const int r0 = r_begin + r * p.round;
    const int n = min(p.round, p_end - r0);
    if (vec_scales) {
      for (int i = tid; i < (n + 3) / 4; i += kSplitThreads) cp_async16(dst + 4 * i, src + r0 + 4 * i);
    } else {
      for (int i = tid; i < n; i += kSplitThreads) cp_async4(dst + i, src + r0 + i);
    }
  };

  // the first round is asked for before anything else is read
  if (nrounds > 0) {
    copy_rows(ks, kb, 0);
    copy_scales(ksc, ksg, 0);
    cp_async_commit();
    copy_rows(vs, vb, 0);
    copy_scales(vsc, vsg, 0);
    cp_async_commit();
  }

  // q of the G heads, this thread's columns, with scale * log2(e) folded in
  const float scale_log2 = p.scale * 1.4426950408889634f;
  float qr[G][L::kCols];
  {
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) +
                              (static_cast<long long>(b) * p.Nq + kvh * p.group) * H;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < L::kNP; ++i) {
#pragma unroll
        for (int e = 0; e < L::kEl; ++e) {
          const int col = (8 * i + j) * L::kEl + e;
          qr[g][i * L::kEl + e] = g < p.group ? __bfloat162float(qb[g * H + col]) * scale_log2 : 0.f;
        }
      }
    }
  }

  float m_run[G], l_run[G], acc[G][L::kCols];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc[g][c] = 0.f;
  }

  for (int r = 0; r < nrounds; ++r) {
    const int r0 = r_begin + r * p.round;
    const int n = min(p.round, p_end - r0);

    // ---- scores of the round, as K lands (V may still be in flight)
    cp_async_wait_but_one();
    __syncthreads();
    float lmax[G];
#pragma unroll
    for (int g = 0; g < G; ++g) lmax[g] = -INFINITY;
#pragma unroll 2
    for (int base = 0; base < n; base += kPosPerStep) {
      const int pi = base + grp;             // < round: a multiple of kPosPerStep
      const bool ok = pi < n && r0 + pi >= p_begin;
      float kf[L::kCols];
      load_row<H, KV>(ks + pi * L::kRowBytes, j, kf);
      const float k_s = (quant && ok) ? ksc[pi] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) s = fmaf(qr[g][c], kf[c], s);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        const float x = ok ? s * k_s : -INFINITY;
        if (j == 0) sc[g * p.round + pi] = x;
        lmax[g] = fmaxf(lmax[g], x);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      lmax[g] = fmaxf(lmax[g], __shfl_xor_sync(0xffffffffu, lmax[g], 8));
      lmax[g] = fmaxf(lmax[g], __shfl_xor_sync(0xffffffffu, lmax[g], 16));
      if (lane == 0) wmax[warp][g] = lmax[g];
    }
    __syncthreads();                         // the scores are written; the K slab is free
    if (r + 1 < nrounds) {
      copy_rows(ks, kb, r + 1);
      copy_scales(ksc, ksg, r + 1);
    }
    cp_async_commit();

    // the round's max joins the running one: one rescale per round
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mr = wmax[0][g];
#pragma unroll
      for (int w = 1; w < kWarpsS; ++w) mr = fmaxf(mr, wmax[w][g]);
      const float m_new = fmaxf(m_run[g], mr);
      const float alpha = (m_run[g] == -INFINITY) ? 0.f : exp2f(m_run[g] - m_new);
      m_run[g] = m_new;
      l_run[g] *= alpha;
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) acc[g][c] *= alpha;
    }

    // ---- acc += p [* v scale] . V
    cp_async_wait_but_one();
    __syncthreads();
#pragma unroll 2
    for (int base = 0; base < n; base += kPosPerStep) {
      const int pi = base + grp;
      if (pi >= n || r0 + pi < p_begin) continue;   // unloaded rows may hold anything
      float vf[L::kCols];
      load_row<H, KV>(vs + pi * L::kRowBytes, j, vf);
      const float v_s = quant ? vsc[pi] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pr = exp2f(sc[g * p.round + pi] - m_run[g]);
        l_run[g] += pr;
        const float pv = pr * v_s;
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) acc[g][c] = fmaf(pv, vf[c], acc[g][c]);
      }
    }
    __syncthreads();                         // the V slab and the scores are free
    if (r + 1 < nrounds) {
      copy_rows(vs, vb, r + 1);
      copy_scales(vsc, vsg, r + 1);
    }
    cp_async_commit();
  }

  // ---- the CTA's result: the four positions of a warp by shuffles, the warps
  // through shared memory, always in the same order
#pragma unroll
  for (int g = 0; g < G; ++g) {
    l_run[g] += __shfl_xor_sync(0xffffffffu, l_run[g], 8);
    l_run[g] += __shfl_xor_sync(0xffffffffu, l_run[g], 16);
    if (lane == 0) red_l[warp][g] = l_run[g];
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) {
      float a = acc[g][c];
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      if (lane < kPosLanes) {
        const int i = c / L::kEl, e = c % L::kEl;
        red[warp][g][(8 * i + j) * L::kEl + e] = a;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * H; i += kSplitThreads) {
    const int g = i / H, c = i % H;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsS; ++w) a += red[w][g][c];
    part[g][c] = a;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (tid == g) {
      float lsum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsS; ++w) lsum += red_l[w][g];
      part_l[g] = lsum;
      part_m[g] = m_run[g];
    }
  }

  // ---- merge the splits through distributed shared memory, in split order;
  // each CTA takes a share of the outputs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = cluster.block_rank();
  const int splits = p.splits;
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) +
                      (static_cast<long long>(b) * p.Nq + kvh * p.group) * H;
  for (int i = rank * kSplitThreads + tid; i < p.group * H; i += splits * kSplitThreads) {
    const int g = i / H, c = i % H;
    float ms[kMaxSplits];
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      ms[s] = s < splits ? *cluster.map_shared_rank(&part_m[g], s) : -INFINITY;
      mx = fmaxf(mx, ms[s]);
    }
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s < splits && ms[s] != -INFINITY) {
        const float f = exp2f(ms[s] - mx);
        lsum += *cluster.map_shared_rank(&part_l[g], s) * f;
        a += *cluster.map_shared_rank(&part[g][c], s) * f;
      }
    }
    ob[i] = __float2bfloat16(lsum > 0.f ? a / lsum : 0.f);
  }
  cluster.sync();  // no CTA leaves while another still reads its result
}

template <int H, typename KV, int G>
cudaError_t launch_split_g(const Params& p, cudaStream_t stream) {
  const int smem = 2 * p.round * Pieces<H, KV>::kRowBytes + (2 + G) * p.round * 4;
  if (smem > kMaxSplitSmem) return cudaErrorInvalidValue;
  static bool attr_set = false;  // shared memory above 48 KB is opted into once
  if (!attr_set) {
    const cudaError_t rc = cudaFuncSetAttribute(
        decode_split_kernel<H, KV, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSplitSmem);
    if (rc != cudaSuccess) return rc;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.Nkv, p.B);
  cfg.blockDim = dim3(kSplitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_split_kernel<H, KV, G>, p);
}

template <int H, typename KV>
cudaError_t launch_split(const Params& p, cudaStream_t stream) {
  if (p.splits < 1 || p.splits > kMaxSplits || p.span <= 0 || p.span % kPosPerStep ||
      p.round <= 0 || p.round % kPosPerStep || p.round > p.span ||
      static_cast<long long>(p.splits) * p.span < p.S) {
    return cudaErrorInvalidValue;
  }
  if (p.group == 1) return launch_split_g<H, KV, 1>(p, stream);
  if (p.group == 2) return launch_split_g<H, KV, 2>(p, stream);
  return launch_split_g<H, KV, 4>(p, stream);
}

template <int H, typename KV>
cudaError_t launch_kv(const Params& p, cudaStream_t stream) {
  decode_attn_kernel<H, KV><<<dim3(p.Nkv, p.B), kWarps * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

// kernel: 1 the split kernel, 0 the serial one
template <int H>
cudaError_t launch(const Params& p, int quant, int kernel, cudaStream_t stream) {
  if (kernel == 1) {
    return quant ? launch_split<H, int8_t>(p, stream) : launch_split<H, __nv_bfloat16>(p, stream);
  }
  if (kernel != 0) return cudaErrorInvalidValue;
  return quant ? launch_kv<H, int8_t>(p, stream) : launch_kv<H, __nv_bfloat16>(p, stream);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). q (B, 1, Nq,
// H), k/v (B, Nkv, S, H), scales (B, Nkv, S) and out (B, 1, Nq, H) are
// contiguous and 16-byte aligned, q and out bf16; quant selects an int8 cache
// (scales given), otherwise bf16. kv_start may be null. kernel: 1 the split
// kernel with its plan (splits <= 8 spans of `span` positions covering S, at
// most `round` <= span positions in shared memory at once, both multiples of
// 16), 0 the serial kernel (the plan is ignored).
extern "C" int visper_decode_attn(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* o, const void* kv_len, const void* kv_start,
    int B, int Nq, int Nkv, int S, int H, float scale, int quant,
    int kernel, int span, int splits, int round, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = quant ? static_cast<const float*>(k_scale) : nullptr;
  p.v_scale = quant ? static_cast<const float*>(v_scale) : nullptr;
  p.o = o;
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_start = static_cast<const int*>(kv_start);
  p.B = B; p.Nq = Nq; p.Nkv = Nkv; p.S = S;
  p.group = Nq / Nkv;
  p.scale = scale;
  p.span = span; p.splits = splits; p.round = round;
  if (p.group < 1 || p.group > kMaxG || Nq % Nkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64: return static_cast<int>(launch<64>(p, quant, kernel, st));
    case 96: return static_cast<int>(launch<96>(p, quant, kernel, st));
    case 128: return static_cast<int>(launch<128>(p, quant, kernel, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
