// GroupNorm statistics and the fused normalize+affine+SiLU apply pass,
// shared by gn_silu.cu (K1/K2) and the epilogue of conv_gn_silu.cu (K3).
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

// What a partials pass accumulates per channel.
enum PartialsMode { kRaw = 0, kCentred = 1 };
// What a finalize pass derives per (image, group) into stats[n][g] =
// (mean, rstd).
enum FinalizeMode { kMeanRstdSinglePass = 0, kMeanOnly = 1, kRstdCentred = 2 };

// part[n][chunk][c] = (sum x, sum x^2) over the chunk's pixels (kRaw), or
// (sum (x - mean_g)^2, 0) with mean_g read from stats (kCentred).
// blockDim.x == rows * C; dynamic shared memory 2 * blockDim.x floats.
template <typename T, int MODE>
__global__ void channel_partials_kernel(const T* __restrict__ x,
                                        const float* __restrict__ stats,
                                        float* __restrict__ part, int P, int C,
                                        int G, int chunk_pix, int chunks) {
  extern __shared__ float sh[];
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int t = threadIdx.x, nt = blockDim.x;
  const int rows = nt / C, c = t % C, r = t / C;
  float mean = 0.f;
  if (MODE == kCentred) mean = stats[((size_t)n * G + c / (C / G)) * 2];
  float s = 0.f, s2 = 0.f;
  const int p0 = chunk * chunk_pix;
  const int p1 = min(P, p0 + chunk_pix);
  const T* xn = x + (size_t)n * P * C;
  for (int p = p0 + r; p < p1; p += rows) {
    float v = to_f32(xn[(size_t)p * C + c]);
    if (MODE == kCentred) {
      v -= mean;
      s += v * v;
    } else {
      s += v;
      s2 += v * v;
    }
  }
  sh[t] = s;
  sh[nt + t] = s2;
  __syncthreads();
  if (t < C) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < rows; ++k) {
      a += sh[k * C + t];
      b += sh[nt + k * C + t];
    }
    float* q = part + (((size_t)n * chunks + chunk) * C + t) * 2;
    q[0] = a;
    q[1] = b;
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
    float a = 0.f, b = 0.f;
    for (int i = lane; i < m; i += 32) {
      const int k = i / cg, c = g * cg + i % cg;
      const float* q = part + (((size_t)n * chunks + k) * C + c) * 2;
      a += q[0];
      b += q[1];
    }
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      float* st = stats + ((size_t)n * G + g) * 2;
      if (mode == kMeanRstdSinglePass) {
        const float mean = a / denom;
        const float var = b / denom - mean * mean;
        st[0] = mean;
        st[1] = rsqrtf(var + eps);
      } else if (mode == kMeanOnly) {
        st[0] = a / denom;
      } else {
        st[1] = rsqrtf(a / denom + eps);
      }
    }
  }
}

// y = x * a + b with a = rstd * gamma, b = beta - mean * a; out = y * sigmoid(y).
// Same grid and thread layout as channel_partials_kernel.
template <typename Tin, typename Tout>
__global__ void gn_apply_silu_kernel(const Tin* __restrict__ x,
                                     const float* __restrict__ stats,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     Tout* __restrict__ y, int P, int C, int G,
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
    const float z = to_f32(x[i]) * a + b;
    y[i] = from_f32<Tout>(z / (1.f + expf(-z)));
  }
}

inline int finalize_threads(int G) { return 32 * (G < 16 ? G : 16); }

// Statistics of K1/K2: single-pass E[x^2] - mean^2, as the TPU kernels do.
template <typename T>
cudaError_t launch_gn_silu(const T* x, const float* gamma, const float* beta,
                           T* y, float* part, float* stats, int n, int P, int C,
                           int G, int chunk_pix, int chunks, int threads,
                           float eps, cudaStream_t st) {
  const dim3 grid(chunks, n);
  const size_t smem = 2 * (size_t)threads * sizeof(float);
  const float denom = (float)((double)P * (C / G));
  channel_partials_kernel<T, kRaw><<<grid, threads, smem, st>>>(
      x, nullptr, part, P, C, G, chunk_pix, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_finalize_kernel<<<n, finalize_threads(G), 0, st>>>(
      part, stats, chunks, C, G, denom, eps, kMeanRstdSinglePass);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_silu_kernel<T, T><<<grid, threads, 0, st>>>(x, stats, gamma, beta, y,
                                                       P, C, G, chunk_pix);
  return cudaGetLastError();
}

}  // namespace gnk
