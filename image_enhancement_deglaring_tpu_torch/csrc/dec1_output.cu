// The dec1 decoder tail and the 1x1 output conv on NHWC, C = 8, for Hopper
// (sm_90a):
//
//   h1  = conv3x3(x_up, Wa) + conv3x3(x_skip, Wb)
//   a1  = silu(group_norm(h1))          8 groups of one channel
//   h2  = conv3x3(a1, W2)
//   a2  = silu(group_norm(h2))
//   out = conv1x1(a2, Wout) + bout      (B, H, W) float32
//
// Replaces _dec1_out_kernel via fused_dec1_output (K5) of
// image_enhancement_deglaring_tpu/ops/pallas_dec1.py, with its rounding:
// GroupNorm statistics are sums of the unrounded f32 conv accumulators with
// the single-pass variance E[x^2] - mean^2; h1 and h2 are stored in the
// input dtype and the affine is applied to the stored values; a1 is rounded
// to the input dtype before conv2; a2 stays f32; the 1x1 conv runs in f32.
//
// Bound on the H100: every input read once and the output written once is
// (2 * 8 * 2 + 4) bytes per pixel in bf16, 75.5 MB at B = 8, 512^2, or
// 0.0225 ms at 3.35 TB/s; the 3,472 operations per pixel would take 0.0074
// ms at the bf16 tensor-core rate. So the function is bound by bytes.
//
// Design. The TPU kept one image's h1 and h2 in VMEM (4 MB each at 512^2
// in bf16); a block has 227 KB of shared memory, so here h1 and h2 go
// through L2/HBM and the tail runs as five launches on one stream:
//   p0   the dual conv: h1 in the input dtype, per-block per-channel f32
//        (sum, sum of squares) of the unrounded accumulators;
//   fin  per (image, channel), the partials folded in a fixed order into
//        the affine a = rstd * gamma, b = beta - mean * a;
//   p1   affine + SiLU of h1 (halo rows included), rounded to the input
//        dtype, conv2 -> h2 and its partials; then fin again;
//   p2   affine + SiLU of h2 in f32, the 1x1 conv and the bias.
// p0 and p1 share one block shape: 8 x 32 output pixels per step, one pixel
// and its 8 channels per thread; a block walks the rows of one row tile
// (tile_h rows, the TPU kernel's tile) for a 32-column strip, staging each
// step's (8 + 2) x (32 + 2) x 8 input window with its 1-pixel halo in
// shared memory (zero outside the image), widened to f32. Halo rows come
// from the neighbouring tiles' rows in device memory, which the previous
// launch has finished. The 3 x (9 x 8 x 8) weights sit in shared memory and
// every thread reads the same one at a time (a broadcast); the convs are
// f32 FMA on the CUDA cores. The h1/h2 round trips cost about 2.8x the
// bound's bytes (100 of 36 bytes per pixel in bf16); keeping h1/h2 on chip
// and tensor cores are later work. No float atomics: every sum is taken in
// a fixed order, so the output is bit-stable from run to run.
#include "gn_common.cuh"

namespace {

constexpr int kC = 8;                   // channels == GroupNorm groups
constexpr int kRows = 8, kCols = 32;    // output pixels per block step
constexpr int kThreads = kRows * kCols;
constexpr int kWinH = kRows + 2, kWinW = kCols + 2;

using gnk::from_f32;
using gnk::to_f32;

// The 8 channels of one pixel, widened to f32.
__device__ __forceinline__ void load8(const float* p, float v[kC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);  // one 16-byte load
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[kC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float silu(float z) { return z / (1.f + expf(-z)); }

// Stage the window of rows y0-1 .. y0+kRows, columns x0-1 .. x0+kCols of one
// NHWC image into s (zero outside the image). ACT applies the GroupNorm
// affine (coef = a[8], b[8]) and SiLU, and rounds to T, as a1 is in the TPU
// kernel; zero padding stays zero.
template <typename T, bool ACT>
__device__ void stage(const T* __restrict__ img, float (*s)[kWinW][kC], int H,
                      int W, int y0, int x0, const float* coef) {
  for (int i = threadIdx.x; i < kWinH * kWinW; i += kThreads) {
    const int py = i / kWinW, px = i % kWinW;
    const int gy = y0 + py - 1, gx = x0 + px - 1;
    float v[kC];
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      load8(img + ((size_t)gy * W + gx) * kC, v);
      if (ACT) {
#pragma unroll
        for (int c = 0; c < kC; ++c)
          v[c] = to_f32(from_f32<T>(silu(v[c] * coef[c] + coef[kC + c])));
      }
    } else {
#pragma unroll
      for (int c = 0; c < kC; ++c) v[c] = 0.f;
    }
    *reinterpret_cast<float4*>(&s[py][px][0]) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(&s[py][px][4]) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// acc[co] += sum over taps and ci of win[ty+dy][tx+dx][ci] * w[tap][ci][co],
// taps in row-major order, ci ascending.
__device__ __forceinline__ void conv9(const float (*s)[kWinW][kC],
                                      const float (*w)[kC][kC], int ty, int tx,
                                      float acc[kC]) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const float* px = s[ty + tap / 3][tx + tap % 3];
    const float4 lo = *reinterpret_cast<const float4*>(px);
    const float4 hi = *reinterpret_cast<const float4*>(px + 4);
    const float v[kC] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int ci = 0; ci < kC; ++ci) {
      const float4 w0 = *reinterpret_cast<const float4*>(&w[tap][ci][0]);
      const float4 w1 = *reinterpret_cast<const float4*>(&w[tap][ci][4]);
      acc[0] += v[ci] * w0.x;
      acc[1] += v[ci] * w0.y;
      acc[2] += v[ci] * w0.z;
      acc[3] += v[ci] * w0.w;
      acc[4] += v[ci] * w1.x;
      acc[5] += v[ci] * w1.y;
      acc[6] += v[ci] * w1.z;
      acc[7] += v[ci] * w1.w;
    }
  }
}

// Per-channel (sum, sum of squares) of the block's pixels, reduced in a
// fixed order (xor-shuffle tree per warp, then warps in order) and written
// to part[blk][c][2].
__device__ void write_partials(const float s1[kC], const float s2[kC],
                               float (*s_red)[2 * kC], float* __restrict__ part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float v[2 * kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    v[2 * c] = s1[c];
    v[2 * c + 1] = s2[c];
  }
#pragma unroll
  for (int i = 0; i < 2 * kC; ++i)
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 2 * kC; ++i) s_red[warp][i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kC) {
    float a = 0.f;
    for (int r = 0; r < kThreads / 32; ++r) a += s_red[r][threadIdx.x];
    part[threadIdx.x] = a;
  }
}

// p0 (DUAL) and p1: grid (ceil(W / 32), H / tile_h, B). p0 convolves x_up
// with w[0] plus x_skip with w[1]; p1 convolves act(x) with w[0], the affine
// from coef[b]. Writes h (input dtype) and part[b][tile][strip][c][2].
template <typename T, bool DUAL>
__global__ void __launch_bounds__(kThreads)
dec1_conv_kernel(const T* __restrict__ xa, const T* __restrict__ xb,
                 const T* __restrict__ wts, const float* __restrict__ coef,
                 T* __restrict__ h, float* __restrict__ part, int H, int W,
                 int tile_h) {
  __shared__ __align__(16) float s_win[DUAL ? 2 : 1][kWinH][kWinW][kC];
  __shared__ __align__(16) float s_w[DUAL ? 2 : 1][9][kC][kC];
  __shared__ float s_coef[2 * kC];
  __shared__ float s_red[kThreads / 32][2 * kC];

  const int b = blockIdx.z, tile = blockIdx.y, strip = blockIdx.x;
  const int t = threadIdx.x, ty = t / kCols, tx = t % kCols;
  const int x0 = strip * kCols;
  const int r0 = tile * tile_h, r1 = min(H, r0 + tile_h);
  const size_t img = (size_t)b * H * W * kC;

  for (int i = t; i < (DUAL ? 2 : 1) * 9 * kC * kC; i += kThreads)
    (&s_w[0][0][0][0])[i] = to_f32(wts[i]);
  if (!DUAL && t < 2 * kC) s_coef[t] = coef[(size_t)b * 2 * kC + t];

  float s1[kC], s2[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) s1[c] = s2[c] = 0.f;

  for (int y0 = r0; y0 < r1; y0 += kRows) {
    __syncthreads();  // the previous step is done with the windows
    stage<T, !DUAL>(xa + img, s_win[0], H, W, y0, x0, s_coef);
    if (DUAL) stage<T, false>(xb + img, s_win[DUAL ? 1 : 0], H, W, y0, x0, s_coef);
    __syncthreads();

    float acc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = 0.f;
    conv9(s_win[0], s_w[0], ty, tx, acc);
    if (DUAL) {
      float acc_b[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) acc_b[c] = 0.f;
      conv9(s_win[DUAL ? 1 : 0], s_w[DUAL ? 1 : 0], ty, tx, acc_b);
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] += acc_b[c];
    }

    const int oy = y0 + ty, ox = x0 + tx;
    if (oy < r1 && ox < W) {
      float hv[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        hv[c] = acc[c];
        s1[c] += acc[c];
        s2[c] += acc[c] * acc[c];
      }
      store8(h + img + ((size_t)oy * W + ox) * kC, hv);
    }
  }
  const size_t blk = ((size_t)b * gridDim.y + tile) * gridDim.x + strip;
  write_partials(s1, s2, s_red, part + blk * 2 * kC);
}

// One block per image, thread c < 8: the partials of channel c folded in
// order, then coef[b] = (a[0..7], b[0..7]).
__global__ void dec1_finalize_kernel(const float* __restrict__ part,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta,
                                     float* __restrict__ coef, int nblk,
                                     float denom, float eps) {
  const int b = blockIdx.x, c = threadIdx.x;
  if (c >= kC) return;
  const float* p = part + (size_t)b * nblk * 2 * kC;
  float s = 0.f, s2 = 0.f;
  for (int k = 0; k < nblk; ++k) {
    s += p[k * 2 * kC + 2 * c];
    s2 += p[k * 2 * kC + 2 * c + 1];
  }
  const float mean = s / denom;
  const float var = s2 / denom - mean * mean;
  const float a = rsqrtf(var + eps) * gamma[c];
  coef[(size_t)b * 2 * kC + c] = a;
  coef[(size_t)b * 2 * kC + kC + c] = beta[c] - mean * a;
}

// p2: one pixel per thread. out = sum_c wo[c] * silu(h2[c] * a[c] + b[c]) + wo[8],
// wo[8] being the bias.
template <typename T>
__global__ void dec1_out_kernel(const T* __restrict__ h2, const float* __restrict__ coef,
                                const float* __restrict__ wo, float* __restrict__ out,
                                long long pixels, int P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pixels) return;
  const float* cf = coef + (size_t)(i / P) * 2 * kC;
  float v[kC];
  load8(h2 + (size_t)i * kC, v);
  float o = 0.f;
#pragma unroll
  for (int c = 0; c < kC; ++c) o += wo[c] * silu(v[c] * cf[c] + cf[kC + c]);
  out[i] = o + wo[kC];
}

template <typename T>
cudaError_t launch(const T* x_up, const T* x_skip, const T* wts, const float* prm,
                   T* h1, T* h2, float* part, float* coef, float* out, int B,
                   int H, int W, int tile_h, float eps, cudaStream_t st) {
  const dim3 grid((W + kCols - 1) / kCols, H / tile_h, B);
  const int nblk = grid.x * grid.y;
  const float denom = (float)((double)H * W);
  const float* g1s = prm;
  const float* g1b = prm + kC;
  const float* g2s = prm + 2 * kC;
  const float* g2b = prm + 3 * kC;
  const float* wo = prm + 4 * kC;  // and the bias after it

  dec1_conv_kernel<T, true><<<grid, kThreads, 0, st>>>(x_up, x_skip, wts, nullptr, h1,
                                                       part, H, W, tile_h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dec1_finalize_kernel<<<B, 32, 0, st>>>(part, g1s, g1b, coef, nblk, denom, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dec1_conv_kernel<T, false><<<grid, kThreads, 0, st>>>(h1, nullptr, wts + 2 * 9 * kC * kC,
                                                        coef, h2, part, H, W, tile_h);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dec1_finalize_kernel<<<B, 32, 0, st>>>(part, g2s, g2b, coef, nblk, denom, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long pixels = (long long)B * H * W;
  dec1_out_kernel<T><<<(unsigned)((pixels + 255) / 256), 256, 0, st>>>(
      h2, coef, wo, out, pixels, H * W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_up, x_skip: (B, H, W, 8) NHWC; wts: wa, wb, w2, each (3, 3, 8, 8) HWIO,
// back to back; h1, h2: (B, H, W, 8) scratch; all of one dtype (0 = float32,
// 1 = bfloat16), contiguous, 16-byte aligned. prm: float32 g1_scale,
// g1_bias, g2_scale, g2_bias, w_out (8 each), b_out (1). part: float32
// scratch of B * (H / tile_h) * ceil(W / 32) * 16; coef: float32 scratch of
// B * 16. out: (B, H, W) float32. H % tile_h == 0. Returns cudaGetLastError().
int dec1_output(const void* x_up, const void* x_skip, const void* wts,
                const void* prm, void* h1, void* h2, void* part, void* coef,
                void* out, int B, int H, int W, int tile_h, float eps, int dtype,
                void* stream) {
  if (B < 1 || H < 1 || W < 1 || tile_h < 1 || H % tile_h != 0)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float*>(prm);
  auto* pt = static_cast<float*>(part);
  auto* cf = static_cast<float*>(coef);
  auto* o = static_cast<float*>(out);
  if (dtype == 0)
    return (int)launch(static_cast<const float*>(x_up), static_cast<const float*>(x_skip),
                       static_cast<const float*>(wts), p, static_cast<float*>(h1),
                       static_cast<float*>(h2), pt, cf, o, B, H, W, tile_h, eps, st);
  if (dtype == 1)
    return (int)launch(static_cast<const __nv_bfloat16*>(x_up),
                       static_cast<const __nv_bfloat16*>(x_skip),
                       static_cast<const __nv_bfloat16*>(wts), p,
                       static_cast<__nv_bfloat16*>(h1), static_cast<__nv_bfloat16*>(h2),
                       pt, cf, o, B, H, W, tile_h, eps, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
