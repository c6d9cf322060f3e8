// Element conversions shared by every source, and the GroupNorm passes of
// the float32 conv's epilogue (conv_gn_silu.cu). K1/K2 (gn_silu.cu) have
// their own one-launch kernel.
//
// Layout: NHWC, one image is a (P = H*W, C) row-major slab. A block owns a
// chunk of pixels of one image and C * rows threads: thread t always holds
// channel t % C and walks the pixels r, r + rows, ... of its chunk, so a
// block reads rows * C contiguous elements per step (coalesced) and each
// thread accumulates one channel only.
//
// Determinism: cross-block sums are never float atomics. Each block writes
// per-channel partials; a finalize kernel folds them per (image, group) in
// a fixed order (strided lane sums, then an xor-shuffle tree), so a result
// is bit-identical from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gnk {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// What a finalize pass derives per (image, group) into stats[n][g] =
// (mean, rstd).
enum FinalizeMode { kMeanOnly = 1, kRstdCentred = 2 };

// part[n][chunk][c] = (sum (x - mean_g)^2, 0) over the chunk's pixels, with
// mean_g read from stats.
// blockDim.x == rows * C; dynamic shared memory blockDim.x floats.
__global__ void centred_partials_kernel(const float* __restrict__ x,
                                        const float* __restrict__ stats,
                                        float* __restrict__ part, int P, int C,
                                        int G, int chunk_pix, int chunks) {
  extern __shared__ float sh[];
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int t = threadIdx.x;
  const int rows = blockDim.x / C, c = t % C, r = t / C;
  const float mean = stats[((size_t)n * G + c / (C / G)) * 2];
  float s = 0.f;
  const int p0 = chunk * chunk_pix;
  const int p1 = min(P, p0 + chunk_pix);
  const float* xn = x + (size_t)n * P * C;
  for (int p = p0 + r; p < p1; p += rows) {
    const float v = xn[(size_t)p * C + c] - mean;
    s += v * v;
  }
  sh[t] = s;
  __syncthreads();
  if (t < C) {
    float a = 0.f;
    for (int k = 0; k < rows; ++k) a += sh[k * C + t];
    float* q = part + (((size_t)n * chunks + chunk) * C + t) * 2;
    q[0] = a;
    q[1] = 0.f;
  }
}

// One block per image, one warp per group (looping if G > warps).
__global__ void gn_finalize_kernel(const float* __restrict__ part,
                                   float* __restrict__ stats, int chunks,
                                   int C, int G, float denom, float eps,
                                   int mode) {
  const int n = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int cg = C / G;
  const int m = chunks * cg;
  for (int g = warp; g < G; g += nwarps) {
    float a = 0.f;
    for (int i = lane; i < m; i += 32) {
      const int k = i / cg, c = g * cg + i % cg;
      a += part[(((size_t)n * chunks + k) * C + c) * 2];
    }
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) {
      float* st = stats + ((size_t)n * G + g) * 2;
      if (mode == kMeanOnly)
        st[0] = a / denom;
      else
        st[1] = rsqrtf(a / denom + eps);
    }
  }
}

// y = x * a + b with a = rstd * gamma, b = beta - mean * a; out = y * sigmoid(y).
// Same grid and thread layout as centred_partials_kernel.
__global__ void gn_apply_silu_kernel(const float* __restrict__ x,
                                     const float* __restrict__ stats,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     float* __restrict__ y, int P, int C, int G,
                                     int chunk_pix) {
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int t = threadIdx.x, rows = blockDim.x / C;
  const int c = t % C, r = t / C;
  const float* st = stats + ((size_t)n * G + c / (C / G)) * 2;
  const float a = st[1] * gamma[c];
  const float b = beta[c] - st[0] * a;
  const int p0 = chunk * chunk_pix;
  const int p1 = min(P, p0 + chunk_pix);
  const size_t base = (size_t)n * P * C;
  for (int p = p0 + r; p < p1; p += rows) {
    const size_t i = base + (size_t)p * C + c;
    const float z = x[i] * a + b;
    y[i] = z / (1.f + expf(-z));
  }
}

inline int finalize_threads(int G) { return 32 * (G < 16 ? G : 16); }

}  // namespace gnk
