// Channel LayerNorm on NHWC activations, for Hopper (sm_90a): K6, one launch
// per call, the activation read once from device memory and written once.
//
// Replaces no TPU kernel: Restormer, its only caller, exists only in the
// port, and the JAX package has no LayerNorm kernel. It replaces the port's
// float32 composition (ops/conv_blocks.channel_layer_norm: widen, a variance
// reduction, rsqrt, two broadcast products, narrow), five passes and about
// 32 bytes of traffic an element in bf16, at Restormer's 88 LayerNorm sites
// a forward.
//
// Function, per pixel over its C channels, in float32 whatever the input
// dtype: mean = sum x / C; var = sum (x - mean)^2 / C, the biased variance
// taken about the mean (not E[x^2] - mean^2: the BiasFree input's mean lies
// far from 0, where the shortcut loses digits); r = rsqrt(var + eps); then
//   BiasFree (no bias):  y = (x * r) * w            (x is NOT centred)
//   WithBias:            y = ((x - mean) * r) * w + b
// rounded once to the input dtype. The products and the sum of y are rounded
// one by one (no contraction), in the composition's order. One kernel, with
// the bias a compile-time flag chosen by whether b is null.
//
// Bound on the H100: bytes. About ten float32 operations an element against
// 4 bytes in bf16 (one 2-byte read, one 2-byte write) or 8 in float32. At
// 3.35 TB/s a bucket of 16 pages of 512^2 x 96 in bf16 takes 0.48 ms.
//
// Design:
//   - The rows (pixels) are contiguous, so consecutive pixels are one
//     contiguous span. A group of W lanes of a warp holds one pixel, W the
//     power of two at or above the pixel's C / E vectors of 16 bytes (E = 8
//     bf16 or 4 float32), at most 32: lane l of the group loads vectors
//     l, l + W, ... of the pixel (VEC of them, masked past C / E). The
//     warp's 32 / W groups hold consecutive pixels, so each load or store
//     instruction of the warp covers one contiguous span: coalesced, with
//     no shared memory.
//   - Each lane keeps ROWS pixels' vectors in registers, bf16 packed
//     (rows_per_lane: ROWS * VEC = 8 where a bf16 pixel is one vector a
//     lane, else 4 where VEC <= 4), every load issued before the first sum,
//     so that enough bytes are in flight to cover the memory's latency.
//   - The sums: each lane's own in float32, then a butterfly of xor shuffles
//     inside the group, after which every lane holds the same bits; the
//     centred second pass runs over the registers, with no second read.
//   - A persistent grid of as many blocks as fit on the card at once, each
//     warp striding over tiles of 32 / W * ROWS pixels.
//   - C a multiple of 8 up to 1024; x and y 16-byte aligned; w and b read
//     once per thread as scalars. It allocates nothing, launches on the
//     given stream and returns cudaGetLastError().
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lnk {

constexpr int kThreads = 256;
constexpr int kMaxC = 1024;

// Pixels a lane holds at once: 16-byte vectors it loads before its first sum,
// 8 where a bf16 pixel takes one vector a lane, else 4 (on the H100 at the
// bucket-16 shapes of Restormer's sites: 8 moved the one-vector bf16 cases
// from 74-79 % of the bytes bound to 77-83 %, and the float32 and two-vector
// ones from 74-83 % down to 62-68 %).
template <typename T, int VEC>
__host__ __device__ constexpr int rows_per_lane() {
  constexpr int in_flight = sizeof(T) == 2 && VEC == 1 ? 8 : 4;
  return VEC >= in_flight ? 1 : in_flight / VEC;
}

// 16 bytes of T: loaded and stored whole (Raw), read as E float32.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int E = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void unpack(const Raw& q, float (&o)[E]) {
    o[0] = q.x;
    o[1] = q.y;
    o[2] = q.z;
    o[3] = q.w;
  }
  __device__ static void store(float* p, const float (&o)[E]) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int E = 8;
  using Raw = uint4;  // kept packed in registers: half the registers of 8 floats
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void unpack(const Raw& q, float (&o)[E]) {
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(u[i] << 16);
      o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&o)[E]) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// Lanes a pixel: the power of two at or above its vectors, at most 32.
__host__ __device__ inline int group_width(int nv) {
  int w = 1;
  while (w < nv && w < 32) w *= 2;
  return w;
}

// The sum of v over the W lanes of each aligned group, in every lane.
__device__ __forceinline__ float group_sum(float v, int W) {
  for (int o = W / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* x;
  const float* w;
  const float* b;  // null: BiasFree
  void* y;
  long long rows;
  int C;
  int W;  // lanes a pixel
  float eps;
};

template <typename T, int VEC, bool BIAS>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(Args a) {
  using V = Vec16<T>;
  constexpr int E = V::E;
  constexpr int ROWS = rows_per_lane<T, VEC>();
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);
  const int C = a.C, W = a.W, nv = C / E;
  const int lane = threadIdx.x & 31, sub = lane & (W - 1), group = lane / W;
  const int per_step = 32 / W;
  const long long tile = (long long)per_step * ROWS;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32;
  const long long warps = (long long)gridDim.x * kThreads / 32;

  bool has[VEC];
  float w[VEC][E];
  float b[BIAS ? VEC : 1][E];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int k = v * W + sub;
    has[v] = k < nv;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      w[v][e] = has[v] ? a.w[k * E + e] : 0.f;
      if constexpr (BIAS) b[v][e] = has[v] ? a.b[k * E + e] : 0.f;
    }
  }

  for (long long base = warp * tile; base < a.rows; base += warps * tile) {
    typename V::Raw raw[ROWS][VEC];
    bool live[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long row = base + (long long)r * per_step + group;
      live[r] = row < a.rows;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        raw[r][v] = live[r] && has[v] ? V::load(x + row * C + (long long)(v * W + sub) * E)
                                      : V::zero();
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        float xv[E];
        V::unpack(raw[r][v], xv);
#pragma unroll
        for (int e = 0; e < E; ++e) s += xv[e];
      }
      const float mean = __fdiv_rn(group_sum(s, W), (float)C);
      float q = 0.f;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        if (!has[v]) continue;
        float xv[E];
        V::unpack(raw[r][v], xv);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float d = __fsub_rn(xv[e], mean);
          q = __fmaf_rn(d, d, q);
        }
      }
      const float var = __fdiv_rn(group_sum(q, W), (float)C);
      const float rstd = rsqrtf(__fadd_rn(var, a.eps));
      const long long row = base + (long long)r * per_step + group;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        if (!live[r] || !has[v]) continue;
        float xv[E], o[E];
        V::unpack(raw[r][v], xv);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if constexpr (BIAS) {
            o[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xv[e], mean), rstd), w[v][e]),
                             b[v][e]);
          } else {
            o[e] = __fmul_rn(__fmul_rn(xv[e], rstd), w[v][e]);
          }
        }
        V::store(y + row * C + (long long)(v * W + sub) * E, o);
      }
    }
  }
}

// Launches layer_norm_kernel<T, VEC, BIAS> on a persistent grid: as many
// blocks as fit on `sms` SMs at once (the occupancy, asked once per
// instantiation), at most one a tile of 8 warps.
template <typename T, int VEC, bool BIAS>
int launch(const Args& a, int sms, cudaStream_t st) {
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layer_norm_kernel<T, VEC, BIAS>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
  }
  const long long block_rows =
      (long long)(32 / a.W) * rows_per_lane<T, VEC>() * (kThreads / 32);
  const long long tiles = (a.rows + block_rows - 1) / block_rows;
  const long long cap = (long long)sms * per_sm;
  const int grid = (int)(tiles < cap ? tiles : cap);
  layer_norm_kernel<T, VEC, BIAS><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool BIAS>
int by_vec(const Args& a, int vec, int sms, cudaStream_t st) {
  switch (vec) {
    case 1: return launch<T, 1, BIAS>(a, sms, st);
    case 2: return launch<T, 2, BIAS>(a, sms, st);
    case 3:
    case 4: return launch<T, 4, BIAS>(a, sms, st);
    default: return launch<T, 8, BIAS>(a, sms, st);
  }
}

}  // namespace lnk

extern "C" {

// K6. x, y: (rows, C) NHWC contiguous, 16-byte aligned, dtype 0 = float32,
// 1 = bfloat16; w: (C,) float32; b: (C,) float32, or null for BiasFree.
// C a multiple of 8, at most 1024. sms: the card's SM count. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.
int channel_layer_norm(const void* x, const void* w, const void* b, void* y, long long rows,
                       int C, float eps, int sms, int dtype, void* stream) {
  if (rows < 1 || C < 8 || C > lnk::kMaxC || C % 8 != 0 || sms < 1 || w == nullptr ||
      (dtype != 0 && dtype != 1) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int nv = C / (dtype == 0 ? 4 : 8);
  const int W = lnk::group_width(nv);
  const int vec = (nv + W - 1) / W;
  const lnk::Args a{x, static_cast<const float*>(w), static_cast<const float*>(b), y, rows,
                    C, W, eps};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return b ? lnk::by_vec<float, true>(a, vec, sms, st)
             : lnk::by_vec<float, false>(a, vec, sms, st);
  }
  return b ? lnk::by_vec<__nv_bfloat16, true>(a, vec, sms, st)
           : lnk::by_vec<__nv_bfloat16, false>(a, vec, sms, st);
}

}  // extern "C"
