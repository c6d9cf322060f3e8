// BatchNorm + ReLU training pair on NHWC activations, for Hopper (sm_90a):
// four launches, two forward and two backward, each one pass over the
// activation.
//
// Replaces no TPU kernel: the JAX model trained through XLA's fusion of
// flax's BatchNorm and the ReLU after it. The port's float32 composition of
// the same function (moments, affine, ReLU, and autograd's backward of each
// op, with float32 intermediates saved for it) took half of EnhancedUNet's
// training step.
//
// Function (flax's BatchNorm, momentum 0.9, epsilon 1e-5, in training):
// per channel over every row of the (rows, C) slab, mean = sum x / n and the
// biased variance var = max(E[x^2] - mean^2, 0); rstd = 1 / sqrt(var + eps);
// a = rstd * gamma, b = beta - mean * a; z = x * a + b in float32 whatever
// the input dtype; then one epilogue: none, ReLU, or ReLU(z + r) with r a
// second float32 tensor (a residual block's shortcut, an attention gate's
// other branch). The running statistics move to 0.9 * old + 0.1 * batch.
//
// Bound on the H100: bytes. A few float32 operations per element against 4
// to 20 bytes; the least traffic is a statistics read of x, an apply pass
// that reads x (and r) and writes y; in the backward a sums pass over x and
// dy (and the saved output where the epilogue added r), and an apply pass
// over the same that writes dx (and dz for r).
//
// Design:
//   - Each launch walks the slab as one flat array of 16-byte vectors (4
//     float32 or 4 bf16 of 8 bytes), grid-stride in steps of one block's
//     threads. A block's threads are a multiple of the vectors after which
//     the channel pattern repeats (C / gcd(C, 4)), so lane j of thread t
//     always holds channel (4t + j) % C: per-channel constants live in
//     registers, per-channel sums in registers too, and C = 1 (an attention
//     gate's psi) reads four rows per vector like any other C. A slab that
//     is not 16-byte aligned, or whose size is not a multiple of 4, takes
//     the same kernels one element at a time.
//   - B1 (bn_train_stats) sums x and x^2 per thread slot in float32, folds
//     the block's slots per channel in a fixed tree, and writes the block's
//     partial; the last block to arrive (one counter, left at 0) folds the
//     partials in block order in float64 into sums[2C]. The counter's order
//     only picks which block folds, so sums are the same bits every call.
//   - B2 (bn_train_apply) derives (a, b) per channel in each block's
//     prologue from the sums (already summed over the ranks under a mesh),
//     block 0 also saving (mean, rstd) and moving the running statistics;
//     then one read of x (and r) and one write of y.
//   - B3 (bn_train_bwd_sums): dz = dy masked where the output is 0 (ReLU:
//     z recomputed from x and the saved statistics, no extra read; add+ReLU:
//     the saved output read), x^ = (x - mean) * rstd; per-channel sums of dz
//     and dz x^ folded as B1's: dbeta and dgamma of this rank's rows.
//   - B4 (bn_train_bwd_apply): dx = rstd gamma (dz - S_dz / n - x^ S_dzx / n)
//     from the sums over every rank's rows, in x's dtype; with add+ReLU also
//     dz, the gradient of r.
// The statistics and the apply are separate launches so that the mesh adds
// B1's and B3's sums over the ranks between them (an all-reduce of 2C
// floats) and keeps its global-batch statistics with no second path.
// (a, b), the mask's z, the variance and dx are computed with explicitly
// rounded operations (no contraction), so that the plain versions in
// ops/fused_kernels.py give the same bits from the same sums.
//
// ops/fused_kernels.py's _bn_plan computes the launch plan (vector width,
// threads, grids) and mirrors block_threads and period below: change both
// together.
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bnk {

constexpr int kThreadTarget = 1024;  // threads per block, rounded to the channel period
constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 4;           // vectors in flight per thread in the one-input passes
constexpr int kUnrollBwd = 2;        // ... in the backward passes (two or three inputs)

enum Act { kNone = 0, kRelu = 1, kAddRelu = 2 };

__host__ __device__ inline int gcd_int(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Vectors of `vec` elements after which the channel pattern of the flat walk repeats.
__host__ __device__ inline int period(int C, int vec) { return C / gcd_int(C, vec); }

// Threads per block: a multiple of the period, so thread t's channels never change.
__host__ __device__ inline int block_threads(int C, int vec) {
  const int p = period(C, vec);
  return p * (kThreadTarget / p > 1 ? kThreadTarget / p : 1);
}

// VEC elements of a tensor as float32, and back. VEC 4: one 16-byte float32
// or 8-byte bf16 access (the caller checked the alignment); VEC 1: one element.
template <int VEC>
__device__ __forceinline__ void load(const float* p, long long v, float (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = reinterpret_cast<const float4*>(p)[v];
    o[0] = q.x;
    o[1] = q.y;
    o[2] = q.z;
    o[3] = q.w;
  } else {
    o[0] = p[v];
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, long long v, float (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 q = reinterpret_cast<const uint2*>(p)[v];
    o[0] = __uint_as_float(q.x << 16);
    o[1] = __uint_as_float(q.x & 0xffff0000u);
    o[2] = __uint_as_float(q.y << 16);
    o[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
    o[0] = __bfloat162float(p[v]);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, long long v, const float (&o)[VEC]) {
  if constexpr (VEC == 4) {
    reinterpret_cast<float4*>(p)[v] = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    p[v] = o[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, long long v, const float (&o)[VEC]) {
  if constexpr (VEC == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
    uint2 q;
    q.x = *reinterpret_cast<const uint32_t*>(&lo);
    q.y = *reinterpret_cast<const uint32_t*>(&hi);
    reinterpret_cast<uint2*>(p)[v] = q;
  } else {
    p[v] = __float2bfloat16(o[0]);
  }
}

// Channel statistics from the sums (sum x at c, sum x^2 at C + c) over n rows.
struct ChannelStats {
  float mean, var, rstd;
};

__device__ __forceinline__ ChannelStats channel_stats(const float* sums, int c, int C, double n,
                                                      float eps) {
  ChannelStats s;
  s.mean = (float)((double)sums[c] / n);
  const float ex2 = (float)((double)sums[C + c] / n);
  s.var = fmaxf(__fsub_rn(ex2, __fmul_rn(s.mean, s.mean)), 0.f);
  s.rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(s.var, eps)));
  return s;
}

// The forward's affine z = x * a + b, rounded after each operation.
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// The block's per-channel sums of two per-thread accumulators (slot (t, j)
// holds channel (t * VEC + j) % C), in a fixed order: a halving tree over the
// slots while both halves hold the same channels, then each channel's
// remaining slots in order. Writes out[c] and out[C + c]. sh: 2 * blockDim.x
// * VEC floats.
template <int VEC>
__device__ void block_channel_sums(float* sh, const float (&a0)[VEC], const float (&a1)[VEC],
                                   int C, float* out) {
  const int t = threadIdx.x, nt = blockDim.x;
  int len = nt * VEC;  // a multiple of C
  float* r0 = sh;
  float* r1 = sh + len;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    r0[t * VEC + j] = a0[j];
    r1[t * VEC + j] = a1[j];
  }
  __syncthreads();
  while ((len / C) % 2 == 0) {
    const int half = len / 2;
    for (int i = t; i < half; i += nt) {
      r0[i] += r0[i + half];
      r1[i] += r1[i + half];
    }
    __syncthreads();
    len = half;
  }
  for (int c = t; c < C; c += nt) {
    float u0 = 0.f, u1 = 0.f;
    for (int k = c; k < len; k += C) {
      u0 += r0[k];
      u1 += r1[k];
    }
    out[c] = u0;
    out[C + c] = u1;
  }
}

// Called by every block after it wrote its partial (2C floats at part +
// block * 2C): the last block to arrive folds all partials in block order,
// in float64, into sums (2C float32) and sets the counter back to 0. sh:
// blockDim.x doubles.
__device__ void fold_partials(const float* part, int* count, float* sums, int C, double* sh) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(count, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n = 2 * C, nb = gridDim.x, t = threadIdx.x, nt = blockDim.x;
  if (n >= nt / 2) {  // one thread per value
    for (int i = t; i < n; i += nt) {
      double a = 0.0;
      for (int b = 0; b < nb; ++b) a += (double)__ldcg(part + (size_t)b * n + i);
      sums[i] = (float)a;
    }
  } else {  // `lanes` threads per value, each over every lanes-th partial, then a tree
    int lanes = nt / n;
    if (t < lanes * n) {
      const int i = t % n, l = t / n;
      double a = 0.0;
      for (int b = l; b < nb; b += lanes) a += (double)__ldcg(part + (size_t)b * n + i);
      sh[t] = a;
    }
    __syncthreads();
    while (lanes % 2 == 0) {
      const int half = lanes / 2;
      if (t < half * n) sh[t] += sh[t + half * n];
      __syncthreads();
      lanes = half;
    }
    if (t < n) {
      double a = 0.0;
      for (int l = 0; l < lanes; ++l) a += sh[l * n + t];
      sums[t] = (float)a;
    }
  }
  if (t == 0) *count = 0;
}

struct StatsArgs {
  const void* x;
  float* sums;   // (2C,): sum x, sum x^2
  int* count;    // one arrival counter, 0 between calls
  float* part;   // (grid, 2C) block partials
  long long nvec;
  int C;
};

// B1: per-channel sum x and sum x^2.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads) stats_kernel(StatsArgs a) {
  extern __shared__ __align__(16) float sh[];
  const T* x = static_cast<const T*>(a.x);
  float s0[VEC], s1[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s0[j] = s1[j] = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; v + (kUnroll - 1) * stride < a.nvec; v += kUnroll * stride) {
    float e[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load<VEC>(x, v + u * stride, e[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s0[j] += e[u][j];
        s1[j] += e[u][j] * e[u][j];
      }
  }
  for (; v < a.nvec; v += stride) {
    float e[VEC];
    load<VEC>(x, v, e);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s0[j] += e[j];
      s1[j] += e[j] * e[j];
    }
  }
  block_channel_sums<VEC>(sh, s0, s1, a.C, a.part + (size_t)blockIdx.x * 2 * a.C);
  fold_partials(a.part, a.count, a.sums, a.C, reinterpret_cast<double*>(sh));
}

struct ApplyArgs {
  const void* x;
  const float* sums;      // (2C,) over every rank's rows
  const float* gamma;
  const float* beta;
  const float* residual;  // kAddRelu: float32, x's shape
  float* y;               // float32
  float* stats;           // (C, 2): mean, rstd
  float* running_mean;    // (C,) or null
  float* running_var;
  long long nvec;
  int C;
  double count;           // rows over every rank
  float eps, momentum, one_minus_momentum;
};

// B2: y = epilogue(x * a + b); block 0 saves (mean, rstd) and moves the running statistics.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kMaxThreads) apply_kernel(ApplyArgs a) {
  extern __shared__ __align__(16) float sh[];  // a[C], b[C]
  const int t = threadIdx.x, C = a.C;
  for (int c = t; c < C; c += blockDim.x) {
    const ChannelStats s = channel_stats(a.sums, c, C, a.count, a.eps);
    const float ka = __fmul_rn(s.rstd, a.gamma[c]);
    sh[c] = ka;
    sh[C + c] = __fsub_rn(a.beta[c], __fmul_rn(s.mean, ka));
    if (blockIdx.x == 0) {
      a.stats[2 * c] = s.mean;
      a.stats[2 * c + 1] = s.rstd;
      if (a.running_mean != nullptr) {
        a.running_mean[c] = __fadd_rn(__fmul_rn(a.momentum, a.running_mean[c]),
                                      __fmul_rn(a.one_minus_momentum, s.mean));
        a.running_var[c] = __fadd_rn(__fmul_rn(a.momentum, a.running_var[c]),
                                     __fmul_rn(a.one_minus_momentum, s.var));
      }
    }
  }
  __syncthreads();
  float ka[VEC], kb[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = (t * VEC + j) % C;
    ka[j] = sh[c];
    kb[j] = sh[C + c];
  }
  const T* x = static_cast<const T*>(a.x);
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long v = (long long)blockIdx.x * blockDim.x + t;
  auto one = [&](long long w, float (&e)[VEC], const float (&r)[VEC]) {
    float o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float z = affine(e[j], ka[j], kb[j]);
      if constexpr (ACT == kAddRelu) z = __fadd_rn(z, r[j]);
      if constexpr (ACT != kNone) z = z > 0.f ? z : 0.f;
      o[j] = z;
    }
    store<VEC>(a.y, w, o);
  };
  for (; v + (kUnroll - 1) * stride < a.nvec; v += kUnroll * stride) {
    float e[kUnroll][VEC], r[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load<VEC>(x, v + u * stride, e[u]);
      if constexpr (ACT == kAddRelu) load<VEC>(a.residual, v + u * stride, r[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) one(v + u * stride, e[u], r[u]);
  }
  for (; v < a.nvec; v += stride) {
    float e[VEC], r[VEC];
    load<VEC>(x, v, e);
    if constexpr (ACT == kAddRelu) load<VEC>(a.residual, v, r);
    one(v, e, r);
  }
}

struct BwdArgs {
  const void* x;
  const float* dy;
  const float* out;    // kAddRelu: the forward's output, for the mask
  const float* stats;  // (C, 2): mean, rstd
  const float* gamma;
  const float* beta;
  long long nvec;
  int C;
};

// Per-thread constants of the backward: the channel's mean and rstd, and
// for kRelu the forward's (a, b) to recompute z.
template <int VEC>
struct BwdConsts {
  float mean[VEC], rstd[VEC], za[VEC], zb[VEC];
};

template <int VEC, int ACT>
__device__ __forceinline__ BwdConsts<VEC> bwd_consts(const BwdArgs& a, float* sh) {
  const int t = threadIdx.x, C = a.C;
  for (int c = t; c < C; c += blockDim.x) {
    const float mean = a.stats[2 * c], rstd = a.stats[2 * c + 1];
    const float ka = __fmul_rn(rstd, a.gamma[c]);
    sh[c] = mean;
    sh[C + c] = rstd;
    sh[2 * C + c] = ka;
    sh[3 * C + c] = __fsub_rn(a.beta[c], __fmul_rn(mean, ka));
  }
  __syncthreads();
  BwdConsts<VEC> k;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = (t * VEC + j) % C;
    k.mean[j] = sh[c];
    k.rstd[j] = sh[C + c];
    k.za[j] = ACT == kRelu ? sh[2 * C + c] : 0.f;
    k.zb[j] = ACT == kRelu ? sh[3 * C + c] : 0.f;
  }
  __syncthreads();
  return k;
}

// dz of one element: dy where the forward's output is positive (ReLU
// epilogues), dy itself without an epilogue.
template <int ACT>
__device__ __forceinline__ float masked(float dy, float x, float o, float za, float zb) {
  if constexpr (ACT == kRelu) return affine(x, za, zb) > 0.f ? dy : 0.f;
  if constexpr (ACT == kAddRelu) return o > 0.f ? dy : 0.f;
  return dy;
}

struct BwdSumsArgs {
  BwdArgs b;
  float* sums;  // (2C,): sum dz, sum dz x^ (this rank's rows)
  int* count;
  float* part;
};

// B3: per-channel sum dz and sum dz x^.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kMaxThreads) bwd_sums_kernel(BwdSumsArgs s) {
  extern __shared__ __align__(16) float sh[];
  const BwdArgs& a = s.b;
  const BwdConsts<VEC> k = bwd_consts<VEC, ACT>(a, sh);
  const T* x = static_cast<const T*>(a.x);
  float s0[VEC], s1[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s0[j] = s1[j] = 0.f;
  auto one = [&](const float (&e)[VEC], const float (&d)[VEC], const float (&o)[VEC]) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float dz = masked<ACT>(d[j], e[j], o[j], k.za[j], k.zb[j]);
      s0[j] += dz;
      s1[j] += dz * ((e[j] - k.mean[j]) * k.rstd[j]);
    }
  };
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; v + (kUnrollBwd - 1) * stride < a.nvec; v += kUnrollBwd * stride) {
    float e[kUnrollBwd][VEC], d[kUnrollBwd][VEC], o[kUnrollBwd][VEC];
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      load<VEC>(x, v + u * stride, e[u]);
      load<VEC>(a.dy, v + u * stride, d[u]);
      if constexpr (ACT == kAddRelu) load<VEC>(a.out, v + u * stride, o[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) one(e[u], d[u], o[u]);
  }
  for (; v < a.nvec; v += stride) {
    float e[VEC], d[VEC], o[VEC];
    load<VEC>(x, v, e);
    load<VEC>(a.dy, v, d);
    if constexpr (ACT == kAddRelu) load<VEC>(a.out, v, o);
    one(e, d, o);
  }
  block_channel_sums<VEC>(sh, s0, s1, a.C, s.part + (size_t)blockIdx.x * 2 * a.C);
  fold_partials(s.part, s.count, s.sums, a.C, reinterpret_cast<double*>(sh));
}

struct BwdApplyArgs {
  BwdArgs b;
  const float* sums;  // (2C,): sum dz, sum dz x^ over every rank's rows
  void* dx;           // x's dtype
  float* dres;        // kAddRelu: dz, the gradient of the residual
  double count;       // rows over every rank
};

// B4: dx = rstd gamma (dz - S_dz / n - x^ S_dzx / n), and dz for the residual.
template <typename T, int VEC, int ACT>
__global__ void __launch_bounds__(kMaxThreads) bwd_apply_kernel(BwdApplyArgs s) {
  extern __shared__ __align__(16) float sh[];
  const BwdArgs& a = s.b;
  const int t = threadIdx.x, C = a.C;
  const BwdConsts<VEC> k = bwd_consts<VEC, ACT>(a, sh);
  for (int c = t; c < C; c += blockDim.x) {
    sh[c] = __fmul_rn(a.stats[2 * c + 1], a.gamma[c]);
    sh[C + c] = (float)((double)s.sums[c] / s.count);
    sh[2 * C + c] = (float)((double)s.sums[C + c] / s.count);
  }
  __syncthreads();
  float kg[VEC], m1[VEC], m2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int c = (t * VEC + j) % C;
    kg[j] = sh[c];
    m1[j] = sh[C + c];
    m2[j] = sh[2 * C + c];
  }
  const T* x = static_cast<const T*>(a.x);
  T* dx = static_cast<T*>(s.dx);
  auto one = [&](long long w, const float (&e)[VEC], const float (&d)[VEC],
                 const float (&o)[VEC]) {
    float g[VEC], dz[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      dz[j] = masked<ACT>(d[j], e[j], o[j], k.za[j], k.zb[j]);
      const float xh = __fmul_rn(__fsub_rn(e[j], k.mean[j]), k.rstd[j]);
      g[j] = __fmul_rn(kg[j], __fsub_rn(__fsub_rn(dz[j], m1[j]), __fmul_rn(xh, m2[j])));
    }
    store<VEC>(dx, w, g);
    if constexpr (ACT == kAddRelu) store<VEC>(s.dres, w, dz);
  };
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long v = (long long)blockIdx.x * blockDim.x + t;
  for (; v + (kUnrollBwd - 1) * stride < a.nvec; v += kUnrollBwd * stride) {
    float e[kUnrollBwd][VEC], d[kUnrollBwd][VEC], o[kUnrollBwd][VEC];
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      load<VEC>(x, v + u * stride, e[u]);
      load<VEC>(a.dy, v + u * stride, d[u]);
      if constexpr (ACT == kAddRelu) load<VEC>(a.out, v + u * stride, o[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) one(v + u * stride, e[u], d[u], o[u]);
  }
  for (; v < a.nvec; v += stride) {
    float e[VEC], d[VEC], o[VEC];
    load<VEC>(x, v, e);
    load<VEC>(a.dy, v, d);
    if constexpr (ACT == kAddRelu) load<VEC>(a.out, v, o);
    one(v, e, d, o);
  }
}

// Dynamic shared memory of each launch, in bytes.
inline size_t sums_smem(int threads, int vec) { return 2 * (size_t)threads * vec * 4; }
inline size_t table_smem(int C, int tables) { return (size_t)tables * C * 4; }

// What every launch needs of its plan: threads a multiple of the period
// and within a block, a grid, a slab of whole vectors.
inline bool plan_ok(long long rows, int C, int vec, int threads, int grid) {
  return rows >= 1 && C >= 1 && (vec == 1 || vec == 4) && rows * C % vec == 0 && threads >= 1 &&
         threads <= kMaxThreads && threads % period(C, vec) == 0 && grid >= 1;
}

// f(T{}, VEC{}) for the input dtype (0 float32, 1 bfloat16) and vector width.
template <typename F>
int by_type(int dtype, int vec, F f) {
  using V4 = std::integral_constant<int, 4>;
  using V1 = std::integral_constant<int, 1>;
  if (dtype == 0 && vec == 4) f(float{}, V4{});
  else if (dtype == 0 && vec == 1) f(float{}, V1{});
  else if (dtype == 1 && vec == 4) f(__nv_bfloat16{}, V4{});
  else if (dtype == 1 && vec == 1) f(__nv_bfloat16{}, V1{});
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// f(ACT{}) for the epilogue code.
template <typename F>
void by_act(int act, F f) {
  if (act == kNone) f(std::integral_constant<int, kNone>{});
  else if (act == kRelu) f(std::integral_constant<int, kRelu>{});
  else f(std::integral_constant<int, kAddRelu>{});
}

}  // namespace bnk

extern "C" {

// B1. x: (rows, C) NHWC contiguous, dtype 0 = float32, 1 = bfloat16. sums:
// (2C,) float32 output. count: one int32 counter, 0 before the call and
// after it, never shared with a call that may run at the same time. part:
// grid * 2C float32 scratch. vec, threads and grid come from _bn_plan (its
// sums_grid). Returns cudaGetLastError().
int bn_train_stats(const void* x, void* sums, void* count, void* part, long long rows, int C,
                   int vec, int threads, int grid, int dtype, void* stream) {
  if (!bnk::plan_ok(rows, C, vec, threads, grid)) return (int)cudaErrorInvalidValue;
  const bnk::StatsArgs a{x, static_cast<float*>(sums), static_cast<int*>(count),
                         static_cast<float*>(part), rows * C / vec, C};
  const auto st = static_cast<cudaStream_t>(stream);
  return bnk::by_type(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    bnk::stats_kernel<T, V><<<grid, threads, bnk::sums_smem(threads, V), st>>>(a);
  });
}

// B2. x: (rows, C) NHWC contiguous (dtype as B1); sums: (2C,) over every
// rank's rows, `count` of them; gamma, beta: (C,) float32; residual: float32
// of x's shape for act 2, else null; y: float32 of x's shape; stats: (C, 2)
// float32 output (mean, rstd); running_mean, running_var: (C,) float32
// updated in place, or both null. act: 0 none, 1 ReLU, 2 add then ReLU.
// vec, threads and grid: _bn_plan's (its grid).
int bn_train_apply(const void* x, const void* sums, const void* gamma, const void* beta,
                   const void* residual, void* y, void* stats, void* running_mean,
                   void* running_var, long long rows, int C, int vec, int threads, int grid,
                   double count, float eps, float momentum, float one_minus_momentum, int act,
                   int dtype, void* stream) {
  if (!bnk::plan_ok(rows, C, vec, threads, grid) || act < 0 || act > 2 ||
      (act == bnk::kAddRelu) != (residual != nullptr) ||
      (running_mean == nullptr) != (running_var == nullptr) || !(count >= 1.0))
    return (int)cudaErrorInvalidValue;
  const bnk::ApplyArgs a{x, static_cast<const float*>(sums), static_cast<const float*>(gamma),
                         static_cast<const float*>(beta), static_cast<const float*>(residual),
                         static_cast<float*>(y), static_cast<float*>(stats),
                         static_cast<float*>(running_mean), static_cast<float*>(running_var),
                         rows * C / vec, C, count, eps, momentum, one_minus_momentum};
  const auto st = static_cast<cudaStream_t>(stream);
  return bnk::by_type(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    bnk::by_act(act, [&](auto e) {
      bnk::apply_kernel<T, V, decltype(e)::value>
          <<<grid, threads, bnk::table_smem(C, 2), st>>>(a);
    });
  });
}

// B3. x as B2; dy: float32 of x's shape; out: B2's output for act 2, else
// null; stats: B2's (C, 2); gamma, beta as B2. sums: (2C,) float32 output
// (sum dz, sum dz x^ over these rows); count and part as B1's, and so is the
// plan.
int bn_train_bwd_sums(const void* x, const void* dy, const void* out, const void* stats,
                      const void* gamma, const void* beta, void* sums, void* count, void* part,
                      long long rows, int C, int vec, int threads, int grid, int act, int dtype,
                      void* stream) {
  if (!bnk::plan_ok(rows, C, vec, threads, grid) || act < 0 || act > 2 ||
      (act == bnk::kAddRelu) != (out != nullptr))
    return (int)cudaErrorInvalidValue;
  const bnk::BwdSumsArgs a{
      {x, static_cast<const float*>(dy), static_cast<const float*>(out),
       static_cast<const float*>(stats), static_cast<const float*>(gamma),
       static_cast<const float*>(beta), rows * C / vec, C},
      static_cast<float*>(sums), static_cast<int*>(count), static_cast<float*>(part)};
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = std::max(bnk::sums_smem(threads, vec), bnk::table_smem(C, 4));
  return bnk::by_type(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    bnk::by_act(act, [&](auto e) {
      bnk::bwd_sums_kernel<T, V, decltype(e)::value><<<grid, threads, smem, st>>>(a);
    });
  });
}

// B4. x, dy, out, stats, gamma, beta as B3; sums: B3's sums over every
// rank's rows, `count` of them. dx: x's dtype and shape; dres: float32 of
// x's shape for act 2 (the residual's gradient), else null. The plan as B2's.
int bn_train_bwd_apply(const void* x, const void* dy, const void* out, const void* stats,
                       const void* gamma, const void* beta, const void* sums, void* dx,
                       void* dres, long long rows, int C, int vec, int threads, int grid,
                       double count, int act, int dtype, void* stream) {
  if (!bnk::plan_ok(rows, C, vec, threads, grid) || act < 0 || act > 2 ||
      (act == bnk::kAddRelu) != (out != nullptr) ||
      (act == bnk::kAddRelu) != (dres != nullptr) || !(count >= 1.0))
    return (int)cudaErrorInvalidValue;
  const bnk::BwdApplyArgs a{
      {x, static_cast<const float*>(dy), static_cast<const float*>(out),
       static_cast<const float*>(stats), static_cast<const float*>(gamma),
       static_cast<const float*>(beta), rows * C / vec, C},
      static_cast<const float*>(sums), dx, static_cast<float*>(dres), count};
  const auto st = static_cast<cudaStream_t>(stream);
  return bnk::by_type(dtype, vec, [&](auto t, auto v) {
    using T = decltype(t);
    constexpr int V = decltype(v)::value;
    bnk::by_act(act, [&](auto e) {
      bnk::bwd_apply_kernel<T, V, decltype(e)::value>
          <<<grid, threads, bnk::table_smem(C, 4), st>>>(a);
    });
  });
}

}  // extern "C"
