// Host-side image preprocessing, C ABI (the PyTorch port's copy of
// crnn_ocr_tpu/native/src/imgproc.cc).
//
// The reference resizes with OpenCV (INTER_LINEAR). The port preprocesses
// batches on the device (ops/preprocess.py); this is the host version of
// one line: bilinear resize to height out_h with cv2's half-pixel
// sampling, white pad and optional per-image standardization, with no
// threads and no allocation.

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

// src: (h, w) uint8; dst: (out_h, out_w) float32, already allocated.
// Resizes src to (out_h, w_new) with bilinear half-pixel sampling where
// w_new = min(round(w * out_h / h), out_w), pads the remainder with 255,
// scales to [0,1] and (optionally) standardizes. Returns w_new.
int32_t preprocess_line_u8(const uint8_t* src, int64_t h, int64_t w,
                           float* dst, int64_t out_h, int64_t out_w,
                           int normalize) {
  const int64_t w_new = std::min<int64_t>(
      std::max<int64_t>(1, std::llround(w * static_cast<double>(out_h) / h)),
      out_w);
  const double sy = static_cast<double>(h) / out_h;
  const double sx = static_cast<double>(w) / w_new;

  for (int64_t oy = 0; oy < out_h; ++oy) {
    const double fy = (oy + 0.5) * sy - 0.5;
    const int64_t y0 = std::clamp<int64_t>(
        static_cast<int64_t>(std::floor(fy)), 0, h - 1);
    const int64_t y1 = std::min<int64_t>(y0 + 1, h - 1);
    const float wy1 = static_cast<float>(
        std::clamp(fy - std::floor(fy), 0.0, 1.0) * (fy >= 0 ? 1.0 : 0.0));
    const float wy0 = 1.0f - wy1;
    float* row = dst + oy * out_w;
    const uint8_t* r0 = src + y0 * w;
    const uint8_t* r1 = src + y1 * w;
    for (int64_t ox = 0; ox < w_new; ++ox) {
      const double fx = (ox + 0.5) * sx - 0.5;
      const int64_t x0 = std::clamp<int64_t>(
          static_cast<int64_t>(std::floor(fx)), 0, w - 1);
      const int64_t x1 = std::min<int64_t>(x0 + 1, w - 1);
      const float wx1 = static_cast<float>(
          std::clamp(fx - std::floor(fx), 0.0, 1.0) * (fx >= 0 ? 1.0 : 0.0));
      const float wx0 = 1.0f - wx1;
      row[ox] = wy0 * (wx0 * r0[x0] + wx1 * r0[x1]) +
                wy1 * (wx0 * r1[x0] + wx1 * r1[x1]);
    }
    for (int64_t ox = w_new; ox < out_w; ++ox) row[ox] = 255.0f;
  }

  const int64_t n = out_h * out_w;
  for (int64_t i = 0; i < n; ++i) dst[i] /= 255.0f;
  if (normalize) {
    double mean = 0.0;
    for (int64_t i = 0; i < n; ++i) mean += dst[i];
    mean /= n;
    double var = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      const double d = dst[i] - mean;
      var += d * d;
    }
    const float std = static_cast<float>(std::sqrt(var / n)) + 1e-7f;
    const float m = static_cast<float>(mean);
    for (int64_t i = 0; i < n; ++i) dst[i] = (dst[i] - m) / std;
  }
  return static_cast<int32_t>(w_new);
}

}  // extern "C"
