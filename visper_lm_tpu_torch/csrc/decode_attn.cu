// Single-token decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel visper_lm_tpu/ops/decode_attention.py
// `_decode_kernel` (:67), launched by `decode_attention`'s pl.pallas_call
// (:188). Same function:
//   * q (B, 1, Nq, H) is the newest token; the cache (B, Nkv, S, H) is
//     head-major, bf16 or int8 with per-vector f32 scales (B, Nkv, S);
//   * scores s = (q . k) * scale, times the k scale for an int8 cache, in f32;
//     positions outside [kv_starts[b], kv_lengths[b]) are masked;
//   * an online softmax over S; the v scale multiplies the probability before
//     the p . v product, so the int8 cache is never dequantized;
//   * a row with no valid position gives 0; query head h reads kv head h / G.
//
// Bound on an H100 SXM at the serving decode shape (B8, 32/32 heads, H96,
// S = 896): the cache must be read once: 88.1 MB in bf16 (~26 us at
// 3.35 TB/s), 45.9 MB in int8 with its scales (~14 us); the FLOPs are
// negligible, so the ideal kernel is bound by memory.
//
// Design (correct and simple first): one CTA of 4 warps per (batch, kv head)
// (256 CTAs at the decode shape). The warps split S into tiles of 32
// positions, striding by 4 tiles; each warp copies its K tile to shared
// memory with coalesced 16-byte loads (row stride H * size + 16 bytes, so the
// lanes' 16-byte reads of 32 different rows hit distinct banks), then lane i
// computes position i's scores for the G query heads against q kept in
// shared memory as f32. Each warp keeps an online softmax (max over the warp
// by shuffles, per-lane partial sums) and its output rows in registers,
// lanes splitting H; V is read straight from global memory, one row per step,
// each lane its H / 32 elements. The four warps' (max, sum, acc) are combined
// in shared memory at the end.

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

template <int H, typename KV>
cudaError_t launch_kv(const Params& p, cudaStream_t stream) {
  decode_attn_kernel<H, KV><<<dim3(p.Nkv, p.B), kWarps * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch(const Params& p, int quant, cudaStream_t stream) {
  return quant ? launch_kv<H, int8_t>(p, stream) : launch_kv<H, __nv_bfloat16>(p, stream);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). q (B, 1, Nq,
// H), k/v (B, Nkv, S, H), scales (B, Nkv, S) and out (B, 1, Nq, H) are
// contiguous, q and out bf16; quant selects an int8 cache (scales given),
// otherwise bf16. kv_start may be null.
extern "C" int visper_decode_attn(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* o, const void* kv_len, const void* kv_start,
    int B, int Nq, int Nkv, int S, int H, float scale, int quant,
    void* stream) {
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
  if (p.group < 1 || p.group > kMaxG || Nq % Nkv) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 64: return static_cast<int>(launch<64>(p, quant, st));
    case 96: return static_cast<int>(launch<96>(p, quant, st));
    case 128: return static_cast<int>(launch<128>(p, quant, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
