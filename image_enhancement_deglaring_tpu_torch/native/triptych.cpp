// Native host-side preprocessing for the SD1 triptych pipeline.
//
// The reference delegates this work to OpenCV's C++ kernels and torch
// DataLoader worker processes (reference: src/optimized_dataset.py:56-79,
// :264-286). Here the same hot path — split thirds, BT.601 luminance,
// half-pixel bilinear resize, [0,1] float conversion — is a small C++
// library driven from Python via ctypes, with a std::thread pool for
// batch decoding. PNG/JPEG entropy decode stays in the port's numpy codecs
// (data/png.py, data/jpeg.py); this handles every
// per-pixel transform after it.
//
// Semantics:
//   gray  = clip(rint(0.299 R + 0.587 G + 0.114 B), 0, 255)  (uint8)
//   resize: bilinear, half-pixel centers (cv2.INTER_LINEAR convention),
//           float accumulation, rint back to uint8
//   out   = gray / 255.0f
//
// Built by native/__init__.py: g++ -O3 -std=c++17 -shared -fPIC -pthread

#include <atomic>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

inline uint8_t luma(uint8_t r, uint8_t g, uint8_t b) {
  float y = 0.299f * r + 0.587f * g + 0.114f * b;
  y = std::nearbyintf(y);
  return static_cast<uint8_t>(std::min(std::max(y, 0.0f), 255.0f));
}

// Grayscale a sub-rectangle [x0, x0+w) of an interleaved image.
void gray_rect(const uint8_t* img, int src_w, int channels, int x0, int h,
               int w, uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = img + (static_cast<int64_t>(y) * src_w + x0) * channels;
    uint8_t* orow = out + static_cast<int64_t>(y) * w;
    if (channels >= 3) {
      for (int x = 0; x < w; ++x) {
        const uint8_t* p = row + static_cast<int64_t>(x) * channels;
        orow[x] = luma(p[0], p[1], p[2]);
      }
    } else {
      for (int x = 0; x < w; ++x) orow[x] = row[x * channels];
    }
  }
}

// Half-pixel-center bilinear resize, uint8 -> float32 in [0, 1].
void resize_norm(const uint8_t* src, int sh, int sw, float* dst, int dh, int dw) {
  if (sh < 1 || sw < 1) {
    // defense in depth (Python validates too): a 0-extent source would
    // clamp sample coordinates to -1 and read out of bounds
    std::memset(dst, 0, static_cast<size_t>(dh) * dw * sizeof(float));
    return;
  }
  if (sh == dh && sw == dw) {
    for (int64_t i = 0; i < static_cast<int64_t>(dh) * dw; ++i)
      dst[i] = static_cast<float>(src[i]) / 255.0f;
    return;
  }
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  std::vector<int> x0s(dw), x1s(dw);
  std::vector<float> fxs(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    fx = std::min(std::max(fx, 0.0f), static_cast<float>(sw - 1));
    int x0 = static_cast<int>(fx);
    x0s[x] = x0;
    x1s[x] = std::min(x0 + 1, sw - 1);
    fxs[x] = fx - x0;
  }
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::min(std::max(fy, 0.0f), static_cast<float>(sh - 1));
    int y0 = static_cast<int>(fy);
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - y0;
    const uint8_t* r0 = src + static_cast<int64_t>(y0) * sw;
    const uint8_t* r1 = src + static_cast<int64_t>(y1) * sw;
    float* orow = dst + static_cast<int64_t>(y) * dw;
    for (int x = 0; x < dw; ++x) {
      float wx = fxs[x];
      float top = r0[x0s[x]] * (1.0f - wx) + r0[x1s[x]] * wx;
      float bot = r1[x0s[x]] * (1.0f - wx) + r1[x1s[x]] * wx;
      // quantize through uint8 as cv2.resize on uint8 does (it rounds each
      // output pixel). Identity size equals the numpy path bit for bit; real
      // resizes agree with cv2 to within one uint8 step (cv2 evaluates the
      // same taps in 11-bit fixed point)
      float v = std::nearbyintf(top * (1.0f - wy) + bot * wy);
      orow[x] = std::min(std::max(v, 0.0f), 255.0f) / 255.0f;
    }
  }
}

void one_triptych(const uint8_t* rgba, int h, int w, int channels, int out_size,
                  float* glared_out, float* gt_out) {
  const int third = w / 3;
  std::vector<uint8_t> gt(static_cast<size_t>(h) * third);
  std::vector<uint8_t> glared(static_cast<size_t>(h) * third);
  gray_rect(rgba, w, channels, 0, h, third, gt.data());
  gray_rect(rgba, w, channels, third, h, third, glared.data());
  resize_norm(glared.data(), h, third, glared_out, out_size, out_size);
  resize_norm(gt.data(), h, third, gt_out, out_size, out_size);
}

}  // namespace

extern "C" {

// Single triptych: RGBA/RGB/gray (h, w, channels) -> two (out, out) float maps.
void triptych_preprocess(const uint8_t* img, int h, int w, int channels,
                         int out_size, float* glared_out, float* gt_out) {
  one_triptych(img, h, w, channels, out_size, glared_out, gt_out);
}

// Batch of n same-shape triptychs, decoded across a thread pool.
void triptych_preprocess_batch(const uint8_t* imgs, int n, int h, int w,
                               int channels, int out_size, float* glared_out,
                               float* gt_out, int n_threads) {
  const int64_t in_stride = static_cast<int64_t>(h) * w * channels;
  const int64_t out_stride = static_cast<int64_t>(out_size) * out_size;
  if (n_threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i)
      one_triptych(imgs + i * in_stride, h, w, channels, out_size,
                   glared_out + i * out_stride, gt_out + i * out_stride);
    return;
  }
  std::vector<std::thread> pool;
  std::atomic<int> counter{0};  // outlives the pool: all threads join below
  int workers = std::min(n_threads, n);
  for (int t = 0; t < workers; ++t) {
    pool.emplace_back([&] {
      while (true) {
        int i = counter.fetch_add(1);
        if (i >= n) break;
        one_triptych(imgs + i * in_stride, h, w, channels, out_size,
                     glared_out + i * out_stride, gt_out + i * out_stride);
      }
    });
  }
  for (auto& th : pool) th.join();
}

// Single-image inference preprocessing: gray + resize + normalize.
void inference_preprocess(const uint8_t* img, int h, int w, int channels,
                          int out_size, float* out) {
  std::vector<uint8_t> gray(static_cast<size_t>(h) * w);
  gray_rect(img, w, channels, 0, h, w, gray.data());
  resize_norm(gray.data(), h, w, out, out_size, out_size);
}

}  // extern "C"
