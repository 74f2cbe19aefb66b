// Native image preprocessing: PIL-compatible antialiased resize + fused normalize.
//
// One PT sample needs four pixel pipelines (CLIP@336 for the tower, DAv2@336,
// CLIP-H@224 and OneFormer@768 for the teachers). This library implements PIL's
// separable antialiased resampling (triangle/bilinear and bicubic with PIL's
// a=-0.5 kernel, support widened by the downscale factor) in float32 with the
// normalize fused into the vertical pass. OpenMP-parallel. The functions are
// those of visper_lm_tpu/native/preprocess.cc, unchanged, so the two builds
// give the same bytes.
//
// Exposed via ctypes (visper_lm_tpu_torch/native/__init__.py), which builds it
// with g++ at first use into visper_lm_tpu_torch/_build/<hash>/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline float bilinear_filter(float x) {
  x = std::fabs(x);
  return x < 1.f ? 1.f - x : 0.f;
}

inline float bicubic_filter(float x) {
  // PIL's bicubic kernel (a = -0.5)
  const float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.f) return ((a + 2.f) * x - (a + 3.f)) * x * x + 1.f;
  if (x < 2.f) return (((x - 5.f) * x + 8.f) * x - 4.f) * a;
  return 0.f;
}

struct Weights {
  int ksize;                    // taps per output element
  std::vector<int> bounds;     // first source index per output element
  std::vector<float> values;   // ksize weights per output element (normalized)
};

// PIL ImagingResampleHorizontal coefficient computation.
Weights precompute(int in_size, int out_size, int mode) {
  const float support_base = (mode == 0) ? 1.f : 2.f;
  const float scale = static_cast<float>(in_size) / out_size;
  const float filterscale = std::max(scale, 1.f);
  const float support = support_base * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  Weights w;
  w.ksize = ksize;
  w.bounds.resize(out_size);
  w.values.assign(static_cast<size_t>(out_size) * ksize, 0.f);

  for (int i = 0; i < out_size; ++i) {
    const float center = (i + 0.5f) * scale;
    int xmin = static_cast<int>(center - support + 0.5f);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5f);
    if (xmax > in_size) xmax = in_size;
    float total = 0.f;
    float* row = &w.values[static_cast<size_t>(i) * ksize];
    for (int x = xmin; x < xmax; ++x) {
      const float arg = (x - center + 0.5f) / filterscale;
      const float v = (mode == 0) ? bilinear_filter(arg) : bicubic_filter(arg);
      row[x - xmin] = v;
      total += v;
    }
    if (total != 0.f)
      for (int k = 0; k < xmax - xmin; ++k) row[k] /= total;
    w.bounds[i] = xmin;
  }
  return w;
}

}  // namespace

extern "C" {

// Resize uint8 HWC RGB -> float32 HWC, fused per-channel normalization.
// mode: 0 = bilinear, 1 = bicubic (both PIL-antialiased).
void visper_resize_normalize(const uint8_t* src, int sh, int sw, int channels,
                             float* dst, int dh, int dw,
                             const float* mean, const float* std_dev, int mode) {
  const Weights wx = precompute(sw, dw, mode);
  const Weights wy = precompute(sh, dh, mode);

  // horizontal pass: (sh, sw, c) -> (sh, dw, c)
  std::vector<float> tmp(static_cast<size_t>(sh) * dw * channels);
#pragma omp parallel for schedule(static)
  for (int y = 0; y < sh; ++y) {
    const uint8_t* srow = src + static_cast<int64_t>(y) * sw * channels;
    float* trow = &tmp[static_cast<size_t>(y) * dw * channels];
    for (int ox = 0; ox < dw; ++ox) {
      const float* wv = &wx.values[static_cast<size_t>(ox) * wx.ksize];
      const int x0 = wx.bounds[ox];
      float acc[8] = {0};
      const int kmax = std::min(wx.ksize, sw - x0);
      for (int k = 0; k < kmax; ++k) {
        const float wgt = wv[k];
        if (wgt == 0.f) continue;
        const uint8_t* px = srow + static_cast<int64_t>(x0 + k) * channels;
        for (int ch = 0; ch < channels; ++ch) acc[ch] += wgt * px[ch];
      }
      for (int ch = 0; ch < channels; ++ch)
        trow[static_cast<int64_t>(ox) * channels + ch] = acc[ch];
    }
  }

  float inv_std[8], mu[8];
  for (int ch = 0; ch < channels && ch < 8; ++ch) {
    inv_std[ch] = 1.f / std_dev[ch];
    mu[ch] = mean[ch];
  }

  // vertical pass + normalize: (sh, dw, c) -> (dh, dw, c)
#pragma omp parallel for schedule(static)
  for (int oy = 0; oy < dh; ++oy) {
    const float* wv = &wy.values[static_cast<size_t>(oy) * wy.ksize];
    const int y0 = wy.bounds[oy];
    float* drow = dst + static_cast<int64_t>(oy) * dw * channels;
    std::memset(drow, 0, static_cast<size_t>(dw) * channels * sizeof(float));
    const int kmax = std::min(wy.ksize, sh - y0);
    for (int k = 0; k < kmax; ++k) {
      const float wgt = wv[k];
      if (wgt == 0.f) continue;
      const float* trow = &tmp[static_cast<size_t>(y0 + k) * dw * channels];
      for (int i = 0; i < dw * channels; ++i) drow[i] += wgt * trow[i];
    }
    for (int ox = 0; ox < dw; ++ox)
      for (int ch = 0; ch < channels; ++ch) {
        float v = drow[static_cast<int64_t>(ox) * channels + ch];
        v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
        drow[static_cast<int64_t>(ox) * channels + ch] =
            (v / 255.f - mu[ch]) * inv_std[ch];
      }
  }
}

// Center-pad an image to square with a fill color (expand2square, uint8 HWC).
void visper_expand2square(const uint8_t* src, int sh, int sw, int channels,
                          uint8_t* dst, const uint8_t* fill) {
  const int side = std::max(sh, sw);
  const int off_y = (side - sh) / 2;
  const int off_x = (side - sw) / 2;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < side; ++y) {
    uint8_t* row = dst + static_cast<int64_t>(y) * side * channels;
    if (y < off_y || y >= off_y + sh) {
      for (int x = 0; x < side; ++x)
        std::memcpy(row + x * channels, fill, channels);
      continue;
    }
    for (int x = 0; x < off_x; ++x) std::memcpy(row + x * channels, fill, channels);
    std::memcpy(row + off_x * channels,
                src + static_cast<int64_t>(y - off_y) * sw * channels,
                static_cast<size_t>(sw) * channels);
    for (int x = off_x + sw; x < side; ++x)
      std::memcpy(row + x * channels, fill, channels);
  }
}

}  // extern "C"
