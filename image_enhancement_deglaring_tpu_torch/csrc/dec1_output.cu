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
// the conv weights in the input dtype; GroupNorm statistics are sums of the
// unrounded f32 conv accumulators with the single-pass variance E[x^2] -
// mean^2; h1 and h2 are stored in the input dtype and the affine is applied
// to the stored values; a1 is rounded to the input dtype before conv2; a2
// stays f32; the 1x1 conv runs in f32.
//
// Bound on the H100: every input read once and the output written once is
// (2 * 8 * 2 + 4) bytes per pixel in bf16, 75.5 MB at B = 8, 512^2, or
// 0.0225 ms at 3.35 TB/s; the 3,472 operations per pixel would take 0.0074
// ms at the bf16 tensor-core rate. So the function is bound by bytes.
//
// Design. The TPU kept one image's h1 and h2 in VMEM (4 MB each at 512^2
// in bf16); a block has 227 KB of shared memory, so here h1 and h2 go
// through L2/HBM (100 bytes per pixel in bf16 against the bound's 36) in
// three launches on one stream:
//   p0  the dual conv: h1 in the input dtype, and per block the per-channel
//       f32 (sum, sum of squares) of the unrounded accumulators;
//   p1  every block first folds its image's p0 partials into the affine
//       a = rstd * gamma, b = beta - mean * a; then affine + SiLU of h1
//       (halo included), rounded to the input dtype, conv2 -> h2 and its
//       partials;
//   p2  every block folds its image's p1 partials the same way, then the
//       affine + SiLU of h2 in f32, the 1x1 conv and the bias: h2 read as
//       16-byte pixels, out written as float4s.
// p0 and p1 share one block shape, 8 warps over a 32-column strip: a block
// walks the rows of one row tile (tile_h rows, the TPU kernel's tile), 8
// output rows per step (16 in the bf16 p1). Each step's input window, with
// its 1-pixel halo, zero outside the image, lands in shared memory in the
// input dtype by 16-byte cp.async copies (a zero source size writes the
// padding), double-buffered: step s + 1's window is in flight while step s
// computes. Halo rows come from the neighbouring tiles' rows in
// device memory, which the previous launch has finished. In p1 each thread
// applies the affine + SiLU to the window pixels it copied once they land.
// bf16: the convs are implicit GEMMs on the tensor cores (mma.sync, bf16 in,
// f32 accumulate): M = 16 output pixels of one row per warp tile, N = the 8
// output channels, K = taps x 8 input channels. The dual conv pairs tap t of
// x_up (k 0..7) with tap t of x_skip (k 8..15) in one m16n8k16 step, so
// h1 = conv(x_up) + conv(x_skip) comes out of one accumulator in 9 steps;
// conv2 takes two taps per k16 step and the ninth tap as one m16n8k8 step.
// A fragments come from ldmatrix on the window, each row address one
// pixel's 16 bytes (conflict-free); the weights stay in registers as B
// fragments for the block's life (18 registers in p0, 9 in p1).
// float32: the same launches and staging, but the convs are f32 FMAs on the
// CUDA cores, one pixel per thread with the weights in shared memory: it is
// the parity path against Precision.HIGHEST, which tensor cores (TF32)
// would break.
// No float atomics: every sum is taken in a fixed order (per thread, an
// xor-shuffle tree per warp, the warps in order; the partials folded in one
// order that every block of an image repeats), so the output is bit-stable
// from run to run.
#include <cstdint>
#include <type_traits>

#include "gn_common.cuh"

namespace {

constexpr int kC = 8;                   // channels == GroupNorm groups
constexpr int kRows = 8, kCols = 32;    // output pixels per block step
constexpr int kThreads = kRows * kCols;
constexpr int kWarps = kThreads / 32;
constexpr int kWinW = kCols + 2;      // window columns: the strip and its halo
constexpr int kFoldSubs = 8;            // partial slots folded by 8 threads each, then in order
constexpr int kOutPix = 4096;           // p2: pixels per block

// SiLU with the fast exponential and division, as K1 and K3 have it: a
// few float32 ulps, where expf and an IEEE division made p1 and p2 bound by
// their arithmetic
__device__ __forceinline__ float silu(float z) { return __fdividef(z, 1.f + __expf(-z)); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 16 bytes at p as floats: 8 bf16 or 4 float32 channels.
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store16(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Issue the copies of the window of rows y0-1 .. y0+ROWS, columns x0-1 ..
// x0+kCols of one NHWC image into s: 16-byte piece i of the window goes to
// thread i % kThreads. Zero outside the image. cp.async.ca keeps the pieces
// in L1 too: the next step of the block reads its halo rows again (measured
// faster than .cg).
template <int ROWS, typename T>
__device__ __forceinline__ void issue_window(const T* __restrict__ img, T (*s)[kC], int H,
                                             int W, int y0, int x0) {
  constexpr int kPieces = sizeof(T) / 2;  // 16-byte pieces per pixel
  for (int i = threadIdx.x; i < (ROWS + 2) * kWinW * kPieces; i += kThreads) {
    const int p = i / kPieces, piece = i % kPieces;
    const int gy = y0 + p / kWinW - 1, gx = x0 + p % kWinW - 1;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const T* src = in ? img + ((size_t)gy * W + gx) * kC + piece * (kC / kPieces) : img;
    cp_async16(smem_addr(&s[p][piece * (kC / kPieces)]), src, in ? 16 : 0);
  }
}

// After the copies of issue_window have landed: the calling thread's own
// pieces become silu(v * a[c] + b[c]) rounded to T (coef = a[8], b[8]), as
// a1 is in the TPU kernel; zero padding stays zero.
template <int ROWS, typename T>
__device__ __forceinline__ void activate_window(T (*s)[kC], const float* coef, int H, int W,
                                                int y0, int x0) {
  constexpr int kPieces = sizeof(T) / 2, kPer = kC / kPieces;
  for (int i = threadIdx.x; i < (ROWS + 2) * kWinW * kPieces; i += kThreads) {
    const int p = i / kPieces, piece = i % kPieces;
    const int gy = y0 + p / kWinW - 1, gx = x0 + p % kWinW - 1;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
    T* e = &s[p][piece * kPer];
    float v[kPer];
    load16(e, v);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = piece * kPer + j;
      v[j] = silu(v[j] * coef[c] + coef[kC + c]);
    }
    store16(e, v);
  }
}

// ------------------------------------------------ tensor-core conv (bf16)

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// Two bf16 of the weights w (HWIO, float32, rounded here as the TPU kernel
// rounds them): (w[tap][ci][co], w[tap][ci + 1][co]), the first in the low half.
__device__ __forceinline__ uint32_t wpair(const float* __restrict__ w, int tap, int ci,
                                          int co) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(w[(tap * kC + ci) * kC + co],
                                                 w[(tap * kC + ci + 1) * kC + co]);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc[j] (j = 0, 1: columns 16j .. 16j+15 of output row `row`) of one step:
// the m16n8 tiles of warp `row`, from the window(s) at win (bytes between
// the two input windows: in_stride). b holds the weights as B fragments:
// for lane (g = lane / 4, q = lane % 4), output channel g and input
// channels 2q, 2q + 1. DUAL: step t is tap t, x_up's weights (k 0..7) then
// x_skip's (k 8..15). Conv2: step s < 4 is taps 2s, 2s + 1; b[8][0] is tap
// 8 for the final k8 step.
template <bool DUAL>
__device__ __forceinline__ void conv_tc(uint32_t win, uint32_t in_stride, int row,
                                        const uint32_t (&b)[9][2], float (&acc)[2][4]) {
  const int lane = threadIdx.x % 32, mat = lane / 8;
  const int m = (mat & 1) * 8 + lane % 8;  // the pixel whose 16 bytes this lane addresses
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    const uint32_t px0 = win + (uint32_t)((row * kWinW + 16 * j + m) * 16);
    if (DUAL) {
      const uint32_t base = px0 + (mat >> 1) * in_stride;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        uint32_t a[4];
        ldsm_x4(base + (uint32_t)(((tap / 3) * kWinW + tap % 3) * 16), a);
        mma_k16(acc[j], a, b[tap][0], b[tap][1]);
      }
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int tap = 2 * s + (mat >> 1);
        uint32_t a[4];
        ldsm_x4(px0 + (uint32_t)(((tap / 3) * kWinW + tap % 3) * 16), a);
        mma_k16(acc[j], a, b[s][0], b[s][1]);
      }
      uint32_t a[2];
      ldsm_x2(px0 + (uint32_t)((2 * kWinW + 2) * 16), a);
      mma_k8(acc[j], a, b[8][0]);
    }
  }
}

// ------------------------------------------------ CUDA-core conv (float32)

// acc[co] += sum over taps and ci of win[ty+dy][tx+dx][ci] * w[tap][ci][co],
// taps in row-major order, ci ascending.
__device__ __forceinline__ void conv9(const float (*s)[kWinW][kC], const float (*w)[kC][kC],
                                      int ty, int tx, float acc[kC]) {
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

// ------------------------------------------------ statistics

// Per-channel (sum, sum of squares) of the block's pixels, v[2c], v[2c + 1]
// per thread, reduced in a fixed order (xor-shuffle tree per warp, then the
// warps in order) and written to part[c][2].
__device__ void write_partials(float v[2 * kC], float* s_red, float* __restrict__ part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < 2 * kC; ++i)
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
  __syncthreads();  // s_red may still be read by the fold
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 2 * kC; ++i) s_red[warp * 2 * kC + i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kC) {
    float a = 0.f;
    for (int r = 0; r < kWarps; ++r) a += s_red[r * 2 * kC + threadIdx.x];
    part[threadIdx.x] = a;
  }
}

// coef = (a[0..7], b[0..7]) of one image from its nblk partial slots
// part[k][c][2], folded in one fixed order (slot k by sub k % kFoldSubs,
// the subs in order) that every block of the image repeats: the same bits
// in every block.
__device__ void fold_coef(const float* __restrict__ part, int nblk,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          float denom, float eps, float* s_red, float* s_coef) {
  const int t = threadIdx.x;
  if (t < kFoldSubs * 2 * kC) {
    const int q = t % (2 * kC), sub = t / (2 * kC);
    float a = 0.f;
#pragma unroll 4
    for (int k = sub; k < nblk; k += kFoldSubs) a += part[(size_t)k * 2 * kC + q];
    s_red[t] = a;
  }
  __syncthreads();
  if (t < kC) {
    float s = 0.f, s2 = 0.f;
    for (int r = 0; r < kFoldSubs; ++r) {
      s += s_red[r * 2 * kC + 2 * t];
      s2 += s_red[r * 2 * kC + 2 * t + 1];
    }
    const float mean = s / denom;
    const float var = s2 / denom - mean * mean;
    const float a = rsqrtf(var + eps) * gamma[t];
    s_coef[t] = a;
    s_coef[kC + t] = beta[t] - mean * a;
  }
  __syncthreads();
}

// ------------------------------------------------ p0 and p1

// grid (ceil(W / 32), H / tile_h, B). p0 (DUAL) convolves x_up with wa plus
// x_skip with wb; p1 convolves act(xa) with wa, the affine folded from
// part_in with gamma, beta. Writes h (input dtype) and part_out[b][tile][strip][c][2].
template <typename T, bool DUAL>
__global__ void __launch_bounds__(kThreads)
dec1_conv_kernel(const T* __restrict__ xa, const T* __restrict__ xb,
                 const float* __restrict__ wa, const float* __restrict__ wb,
                 const float* __restrict__ part_in, const float* __restrict__ gamma,
                 const float* __restrict__ beta, T* __restrict__ h,
                 float* __restrict__ part_out, int H, int W, int tile_h, float denom,
                 float eps) {
  constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kIn = DUAL ? 2 : 1;
  // output rows per step: 16 in the bf16 conv2 pass (two per warp: fewer
  // steps and halo rows, measured faster), else one per warp or thread row.
  // Two windows: one in use, one in flight (a third measured slower).
  constexpr int kR = kTC && !DUAL ? 2 * kRows : kRows;
  __shared__ __align__(16) T s_win[2][kIn][(kR + 2) * kWinW][kC];
  __shared__ __align__(16) float s_w[kTC ? 1 : kIn][9][kC][kC];
  __shared__ float s_coef[2 * kC];
  __shared__ float s_red[kFoldSubs * 2 * kC];
  static_assert(kFoldSubs >= kWarps, "s_red holds one row per warp");

  const int b = blockIdx.z, tile = blockIdx.y, strip = blockIdx.x;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int x0 = strip * kCols;
  const int r0 = tile * tile_h, r1 = min(H, r0 + tile_h);
  const int steps = (r1 - r0 + kR - 1) / kR;
  const size_t img = (size_t)b * H * W * kC;
  const T* ina = xa + img;
  const T* inb = DUAL ? xb + img : nullptr;

  issue_window<kR>(ina, s_win[0][0], H, W, r0, x0);
  if (DUAL) issue_window<kR>(inb, s_win[0][kIn - 1], H, W, r0, x0);
  cp_async_commit();

  uint32_t bfr[9][2];  // kTC: the weights as B fragments
  if constexpr (kTC) {
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      if (DUAL) {
        bfr[s][0] = wpair(wa, s, 2 * q, g);
        bfr[s][1] = wpair(wb, s, 2 * q, g);
      } else if (s < 4) {
        bfr[s][0] = wpair(wa, 2 * s, 2 * q, g);
        bfr[s][1] = wpair(wa, 2 * s + 1, 2 * q, g);
      } else {
        bfr[s][0] = s == 8 ? wpair(wa, 8, 2 * q, g) : 0u;
        bfr[s][1] = 0u;
      }
    }
  } else {
    for (int i = t; i < 9 * kC * kC; i += kThreads) {
      (&s_w[0][0][0][0])[i] = wa[i];
      if (DUAL) (&s_w[kIn - 1][0][0][0])[i] = wb[i];
    }
  }
  if (!DUAL)
    fold_coef(part_in + (size_t)b * gridDim.x * gridDim.y * 2 * kC, gridDim.x * gridDim.y,
              gamma, beta, denom, eps, s_red, s_coef);

  // per thread: kTC (sum, sum of squares) of channels 2q, 2q + 1 (q = lane % 4);
  // else of all 8 channels
  float st[2 * kC];
#pragma unroll
  for (int i = 0; i < 2 * kC; ++i) st[i] = 0.f;

  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1, y0 = r0 + s * kR;
    if (s + 1 < steps) {  // into the window that step s - 1 used
      issue_window<kR>(ina, s_win[buf ^ 1][0], H, W, y0 + kR, x0);
      if (DUAL) issue_window<kR>(inb, s_win[buf ^ 1][kIn - 1], H, W, y0 + kR, x0);
    }
    cp_async_commit();
    cp_async_wait<1>();  // step s's window has landed (this thread's pieces)
    if (!DUAL) activate_window<kR>(s_win[buf][0], s_coef, H, W, y0, x0);
    __syncthreads();

    if constexpr (kTC) {
      // one output row per warp at a time (unrolled, p1 spills registers)
#pragma unroll 1
      for (int rr = 0; rr < kR / kRows; ++rr) {
        const int row = warp + kRows * rr;
        float acc[2][4];
        conv_tc<DUAL>(smem_addr(s_win[buf][0]), (uint32_t)sizeof(s_win[0][0]), row, bfr, acc);
        const int oy = y0 + row, g = lane / 4, q = lane % 4;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {  // pixels g and g + 8 of the m-tile
            const int ox = x0 + 16 * j + 8 * half + g;
            if (oy < r1 && ox < W) {
              const float c0 = acc[j][2 * half], c1 = acc[j][2 * half + 1];
              *reinterpret_cast<__nv_bfloat162*>(h + img + ((size_t)oy * W + ox) * kC + 2 * q) =
                  __floats2bfloat162_rn(c0, c1);
              st[0] += c0;
              st[1] += c0 * c0;
              st[2] += c1;
              st[3] += c1 * c1;
            }
          }
        }
      }
    } else {
      const int ty = t / kCols, tx = t % kCols;
      const auto* win = reinterpret_cast<const float(*)[kWinW][kC]>(s_win[buf][0]);
      float acc[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] = 0.f;
      conv9(win, s_w[0], ty, tx, acc);
      if (DUAL) {
        const auto* winb = reinterpret_cast<const float(*)[kWinW][kC]>(s_win[buf][kIn - 1]);
        float acc_b[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c) acc_b[c] = 0.f;
        conv9(winb, s_w[kIn - 1], ty, tx, acc_b);
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[c] += acc_b[c];
      }
      const int oy = y0 + ty, ox = x0 + tx;
      if (oy < r1 && ox < W) {
        store16(reinterpret_cast<float*>(h + img + ((size_t)oy * W + ox) * kC), acc);
        store16(reinterpret_cast<float*>(h + img + ((size_t)oy * W + ox) * kC) + 4, acc + 4);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          st[2 * c] += acc[c];
          st[2 * c + 1] += acc[c] * acc[c];
        }
      }
    }
    __syncthreads();  // every warp is done with s_win[buf] before it is refilled
  }

  if constexpr (kTC) {  // place channels 2q, 2q + 1 at their slots, zeros elsewhere
    const int q = lane % 4;
    const float s0 = st[0], q0 = st[1], s1 = st[2], q1 = st[3];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      st[2 * c] = c == 2 * q ? s0 : c == 2 * q + 1 ? s1 : 0.f;
      st[2 * c + 1] = c == 2 * q ? q0 : c == 2 * q + 1 ? q1 : 0.f;
    }
  }
  const size_t blk = ((size_t)b * gridDim.y + tile) * gridDim.x + strip;
  write_partials(st, s_red, part_out + blk * 2 * kC);
}

// ------------------------------------------------ p2

// grid (ceil(P / kOutPix), B): out = sum_c wo[c] * silu(h2[c] * a[c] + b[c])
// + bo, four pixels per thread step (float4 stores where P % 4 == 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dec1_out_kernel(const T* __restrict__ h2, const float* __restrict__ part, int nblk,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const float* __restrict__ wo, const float* __restrict__ bo,
                float* __restrict__ out, int P, float denom, float eps) {
  __shared__ float s_coef[2 * kC];
  __shared__ float s_red[kFoldSubs * 2 * kC];
  const int b = blockIdx.y;
  fold_coef(part + (size_t)b * nblk * 2 * kC, nblk, gamma, beta, denom, eps, s_red, s_coef);
  float a[kC], c[kC], w[kC];
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    a[i] = s_coef[i];
    c[i] = s_coef[kC + i];
    w[i] = wo[i];
  }
  const float bias = bo[0];
  const T* src = h2 + (size_t)b * P * kC;
  float* dst = out + (size_t)b * P;
  const int p0 = blockIdx.x * kOutPix, p1 = min(P, p0 + kOutPix);
  for (int p = p0 + 4 * threadIdx.x; p < p1; p += 4 * kThreads) {
    float o[4];
    const int n = min(4, p1 - p);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= n) break;
      float v[kC];
      load16(src + (size_t)(p + k) * kC, v);
      if constexpr (!std::is_same<T, __nv_bfloat16>::value)
        load16(src + (size_t)(p + k) * kC + 4, v + 4);  // float32: two 16-byte loads
      float r = 0.f;
#pragma unroll
      for (int i = 0; i < kC; ++i) r += w[i] * silu(v[i] * a[i] + c[i]);
      o[k] = r + bias;
    }
    if (n == 4 && (P & 3) == 0) {
      *reinterpret_cast<float4*>(dst + p) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < n) dst[p + k] = o[k];
    }
  }
}

struct Params {
  const float *wa, *wb, *w2, *g1s, *g1b, *g2s, *g2b, *wo, *bo;
};

template <typename T>
cudaError_t launch(const T* x_up, const T* x_skip, const Params& w, T* h1, T* h2,
                   float* part, float* out, int B, int H, int W, int tile_h, float eps,
                   cudaStream_t st) {
  const dim3 grid((W + kCols - 1) / kCols, H / tile_h, B);
  const int nblk = grid.x * grid.y;
  const float denom = (float)((double)H * W);
  float* part1 = part;
  float* part2 = part + (size_t)B * nblk * 2 * kC;
  dec1_conv_kernel<T, true><<<grid, kThreads, 0, st>>>(
      x_up, x_skip, w.wa, w.wb, nullptr, nullptr, nullptr, h1, part1, H, W, tile_h, denom, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dec1_conv_kernel<T, false><<<grid, kThreads, 0, st>>>(
      h1, nullptr, w.w2, nullptr, part1, w.g1s, w.g1b, h2, part2, H, W, tile_h, denom, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int P = H * W;
  const dim3 out_grid((P + kOutPix - 1) / kOutPix, B);
  dec1_out_kernel<T><<<out_grid, kThreads, 0, st>>>(h2, part2, nblk, w.g2s, w.g2b, w.wo, w.bo,
                                                    out, P, denom, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x_up, x_skip: (B, H, W, 8) NHWC; h1, h2: (B, H, W, 8) scratch; all of one
// dtype (0 = float32, 1 = bfloat16), contiguous, 16-byte aligned. wa, wb, w2:
// (3, 3, 8, 8) HWIO float32 (the bf16 instance rounds them to bf16);
// g1s, g1b, g2s, g2b, wo: 8 float32 each; bo: 1 float32. part: float32
// scratch of 2 * B * (H / tile_h) * ceil(W / 32) * 16. out: (B, H, W)
// float32. H % tile_h == 0. Three launches on `stream`; returns
// cudaGetLastError().
int dec1_output(const void* x_up, const void* x_skip, const void* wa, const void* wb,
                const void* w2, const void* g1s, const void* g1b, const void* g2s,
                const void* g2b, const void* wo, const void* bo, void* h1, void* h2,
                void* part, void* out, int B, int H, int W, int tile_h, float eps, int dtype,
                void* stream) {
  if (B < 1 || H < 1 || W < 1 || tile_h < 1 || H % tile_h != 0 || H / tile_h > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const Params w{static_cast<const float*>(wa),  static_cast<const float*>(wb),
                 static_cast<const float*>(w2),  static_cast<const float*>(g1s),
                 static_cast<const float*>(g1b), static_cast<const float*>(g2s),
                 static_cast<const float*>(g2b), static_cast<const float*>(wo),
                 static_cast<const float*>(bo)};
  auto* pt = static_cast<float*>(part);
  auto* o = static_cast<float*>(out);
  if (dtype == 0)
    return (int)launch(static_cast<const float*>(x_up), static_cast<const float*>(x_skip), w,
                       static_cast<float*>(h1), static_cast<float*>(h2), pt, o, B, H, W,
                       tile_h, eps, st);
  if (dtype == 1)
    return (int)launch(static_cast<const __nv_bfloat16*>(x_up),
                       static_cast<const __nv_bfloat16*>(x_skip), w,
                       static_cast<__nv_bfloat16*>(h1), static_cast<__nv_bfloat16*>(h2), pt,
                       o, B, H, W, tile_h, eps, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
