// GroupNorm + SiLU on NHWC activations, for Hopper (sm_90a): one launch per
// call, the activation read once from device memory and written once.
//
// Replaces two TPU kernels of image_enhancement_deglaring_tpu/ops/pallas_kernels.py:
//   gn_silu_flat  <- _gn_silu_flat_kernel via _fused_gn_silu_flat (K1), the
//                    (N, H, W*C) row-tiled form used at every U-Net level;
//   gn_silu_nhwc  <- _gn_silu_kernel via _fused_gn_silu_pallas (K2), the
//                    (1, TH, W, C) block form used where K1 is not eligible.
// Both compute the same function on the same NHWC memory: per (image, group)
// f32 sum and sum of squares, var = E[x^2] - mean^2, then y = x*a + b with
// a = rstd*gamma, b = beta - mean*a, out = y * sigmoid(y), rounded once to
// the input dtype. So they share one kernel and keep their own entry points,
// as the two TPU functions do.
//
// Bound on the H100: bytes. About ten float32 operations per element against
// 2 or 4 bytes, far below the card's operations-per-byte balance; the least
// traffic is one read and one write of the activation.
//
// Design. The TPU kernel carried its sums across a sequential grid with the
// image in VMEM. Here every block of the grid is resident at once (a
// cooperative launch, which the runtime refuses instead of starting a grid
// that cannot all be resident) and the blocks walk the batch in waves of
// whole images: in a wave, block b owns chunk b % chunks of image b / chunks.
//   1. Its chunk comes into shared memory once, in 16-byte cp.async copies.
//   2. Per channel it sums x and x^2 in float32 from shared memory (16-byte
//      reads: 8 bf16 or 4 float32 channels of one pixel per thread), folds
//      its threads in a fixed order and writes the sums to the chunk's own
//      (image, chunk, channel) slot.
//   3. It arrives on the image's counter (release) and waits until every
//      chunk of the image has (acquire).
//   4. It folds the image's slots per group in a fixed order, so every block
//      of the image derives the same (mean, rstd) bits and a call gives the
//      same result every time (no float atomics).
//   5. It applies the affine and SiLU to the chunk still in shared memory
//      and writes it with 16-byte stores, in four segments: as each is
//      written out, the block's chunk of the next wave streams into it, so
//      one wave's writes overlap the next one's reads.
// The last block to leave an image's counter sets it back to 0, so counters
// read 0 at every launch without a memset. An image that is one chunk needs
// no counter, and such calls launch without the cooperative guarantee.
//
// A slab larger than one wave's shared memory (e.g. one 2048x2048x8 bf16
// image) takes the same path with one image per wave and chunks larger than
// a block's shared memory: the part of a chunk beyond its resident part is
// read from device memory for the sums and again for the apply. Channels
// that do not fill 16-byte vectors (C % 8 != 0 in bf16), or a slab that is
// not 16-byte aligned, take the same kernel one element at a time.
//
// ops/fused_kernels.py's _gn_plan computes the launch plan (chunk size,
// chunks per image, images per wave, resident pixels, threads, shared
// memory) and mirrors block_threads and smem_bytes below: change both
// together.
#include <cstdint>

#include "gn_common.cuh"

namespace gnk {

constexpr int kThreadTarget = 512;  // threads per block, rounded to the channel units
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSegments = 4;  // apply steps after which the next wave's chunk streams in

// Threads per block for C channels read `vec` at a time: a multiple of the
// C / vec channel units, so every thread keeps one unit for a whole chunk.
__host__ __device__ inline int block_threads(int C, int vec) {
  const int unit = C / vec;
  return unit * (kThreadTarget / unit > 1 ? kThreadTarget / unit : 1);
}

// Floats of a block's reduction scratch for x and x^2: per warp and channel
// after a warp shuffle (vectors), or per thread (elements). It holds the
// per-channel affine (2 * C floats) afterwards.
__host__ __device__ inline int red_floats(int C, int vec, int threads) {
  return 2 * (vec > 1 ? C * (threads / 32) : threads);
}

// Dynamic shared memory: a chunk's resident part, 16-byte aligned, then the
// reduction scratch.
__host__ __device__ inline size_t smem_bytes(int C, int elem, int vec, int threads,
                                             int resident_pix) {
  return ((size_t)resident_pix * C * elem + 15) / 16 * 16 + 4 * (size_t)red_floats(C, vec, threads);
}

struct Args {
  const void* x;
  const float* gamma;
  const float* beta;
  void* y;
  int* count;   // (n,) arrival counters, 0 between calls
  float* part;  // (n, chunks, C) of (sum x, sum x^2)
  int n, P, C, G;
  int chunk_pix, chunks, images, resident_pix;
  float denom, eps;
};

// 16 bytes <-> float32 values: 4 float32 or 8 bf16 (a bf16 is the high half
// of its float32).
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

// Vector j (VW elements) of p, from shared memory or, read-only, from
// device memory.
template <typename T, int VW>
__device__ __forceinline__ void load_shared(const T* p, int j, float (&f)[VW]) {
  if constexpr (VW == 1)
    f[0] = to_f32(p[j]);
  else
    unpack(reinterpret_cast<const uint4*>(p)[j], f);
}
template <typename T, int VW>
__device__ __forceinline__ void load_global(const T* __restrict__ p, int j, float (&f)[VW]) {
  if constexpr (VW == 1)
    f[0] = to_f32(p[j]);
  else
    unpack(__ldg(reinterpret_cast<const uint4*>(p) + j), f);
}
template <typename T, int VW>
__device__ __forceinline__ void store_global(T* p, int j, const float (&f)[VW]) {
  if constexpr (VW == 1)
    p[j] = from_f32<T>(f[0]);
  else
    reinterpret_cast<uint4*>(p)[j] = pack(f);
}

template <int VW>
__device__ __forceinline__ void add_sums(const float (&f)[VW], float (&s)[VW], float (&q)[VW]) {
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    s[k] += f[k];
    q[k] += f[k] * f[k];
  }
}
// z = x*a + b, z * sigmoid(z) with the SFU's exp2 and reciprocal (a few
// float32 ulps; expf and an IEEE division made the apply compute-bound).
// Where exp(-z) overflows (z < -88) the reciprocal is 0, and so is the result.
template <int VW>
__device__ __forceinline__ void affine_silu(float (&f)[VW], const float (&a)[VW],
                                            const float (&b)[VW]) {
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    const float z = f[k] * a[k] + b[k];
    f[k] = __fdividef(z, 1.f + __expf(-z));
  }
}

// `elems` elements from device memory into shared memory: 16-byte cp.async
// copies where source and length are 16-byte aligned (wait with
// cp.async.wait_all), else one element per thread step.
template <typename T>
__device__ __forceinline__ void copy_in(T* dst, const T* src, int elems) {
  const size_t bytes = (size_t)elems * sizeof(T);
  if (((reinterpret_cast<uintptr_t>(src) | bytes) & 15) == 0) {
    const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const char* g = reinterpret_cast<const char*>(src);
    for (int i = threadIdx.x; i < (int)(bytes / 16); i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s0 + 16u * i),
                   "l"(g + 16 * (size_t)i)
                   : "memory");
  } else {
    for (int i = threadIdx.x; i < elems; i += blockDim.x) dst[i] = src[i];
  }
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t clock_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Adds one to *cnt, ordered after the block's earlier writes (the caller
// has passed __syncthreads), as CUTLASS's GenericBarrier arrives.
__device__ __forceinline__ void arrive_release(int* cnt) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(cnt) : "memory");
}

// Until every chunk of the image has arrived on *cnt. Peers are resident,
// so the wait is short; one longer than kWaitLimitNs traps, which fails the
// launch with an error instead of hanging the card.
constexpr uint64_t kWaitLimitNs = 10000000000ull;
__device__ __forceinline__ void wait_for(const int* cnt, int chunks) {
  const uint64_t t0 = clock_ns();
  while (load_acquire(cnt) < chunks)
    if (clock_ns() - t0 > kWaitLimitNs) __trap();
}

// VW = 16 / sizeof(T) (16-byte vectors; C % VW == 0, C / VW divides 32,
// slab and pointers 16-byte aligned) or 1 (any shape).
template <typename T, int VW>
__global__ void __launch_bounds__(VW == 1 ? kMaxThreads : kThreadTarget, 1)
    gn_silu_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, t = threadIdx.x, nt = blockDim.x;
  const int unit = C / VW;  // VW-channel units per pixel
  const int u = t % unit;   // this thread's unit, the same in every step
  const int lane = t % 32, warp = t / 32;
  T* xs = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(
      smem + ((size_t)a.resident_pix * C * sizeof(T) + 15) / 16 * 16);
  const int rows = VW > 1 ? nt / 32 : nt / C;  // rows of the reduction scratch
  float* red_q = red + rows * C;
  const int member = blockIdx.x / a.chunks, chunk = blockIdx.x % a.chunks;
  const int p0 = chunk * a.chunk_pix;
  const int p1 = min(a.P, p0 + a.chunk_pix);
  const int pr = min(p1, p0 + a.resident_pix);  // [p0, pr) resident, [pr, p1) read twice
  const int n_res = (pr - p0) * unit, n_str = (p1 - pr) * unit;  // vectors of each part
  const size_t slab = (size_t)a.P * C;

  // the apply's segments of the resident part, whole thread steps
  const int seg = (n_res + kSegments * nt - 1) / (kSegments * nt) * nt;

  for (int img = member; img < a.n; img += a.images) {  // one image per wave
    const T* xg = static_cast<const T*>(a.x) + img * slab + (size_t)p0 * C;
    T* yg = static_cast<T*>(a.y) + img * slab + (size_t)p0 * C;
    const T* xstr = xg + (size_t)(pr - p0) * C;
    T* ystr = yg + (size_t)(pr - p0) * C;
    const int next = img + a.images;  // this block's image in the next wave

    // 1-2. the resident part into shared memory (in the first wave; later
    // ones were copied during the previous apply); sums, first of the part
    // read twice, then of the resident part
    if (img == member) copy_in(xs, xg, (pr - p0) * C);
    float s[VW], q[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) s[k] = q[k] = 0.f;
    for (int j = t; j < n_str; j += nt) {
      float f[VW];
      load_global<T, VW>(xstr, j, f);
      add_sums(f, s, q);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int j = t; j < n_res; j += nt) {
      float f[VW];
      load_shared<T, VW>(xs, j, f);
      add_sums(f, s, q);
    }
    if constexpr (VW > 1) {
      // lanes with equal lane % unit hold the same channels (unit | 32)
      for (int off = 16; off >= unit; off >>= 1) {
#pragma unroll
        for (int k = 0; k < VW; ++k) {
          s[k] += __shfl_xor_sync(kFull, s[k], off);
          q[k] += __shfl_xor_sync(kFull, q[k], off);
        }
      }
      if (lane < unit) {
#pragma unroll
        for (int k = 0; k < VW; ++k) {
          red[warp * C + lane * VW + k] = s[k];
          red_q[warp * C + lane * VW + k] = q[k];
        }
      }
    } else {
      red[t] = s[0];  // row t / C, channel t % C
      red_q[t] = q[0];
    }
    __syncthreads();
    float2* slots = reinterpret_cast<float2*>(a.part) + (size_t)img * a.chunks * C;
    for (int c = t; c < C; c += nt) {
      float sa = 0.f, sb = 0.f;
      for (int r = 0; r < rows; ++r) {
        sa += red[r * C + c];
        sb += red_q[r * C + c];
      }
      slots[(size_t)chunk * C + c] = make_float2(sa, sb);
    }
    __syncthreads();

    // 3. every chunk of the image has written its slot
    if (a.chunks > 1) {
      if (t == 0) {
        int* cnt = a.count + img;
        arrive_release(cnt);
        wait_for(cnt, a.chunks);
        if (atomicAdd(cnt, 1) == 2 * a.chunks - 1) atomicExch(cnt, 0);  // the last to leave
      }
      __syncthreads();
    }

    // 4. (mean, rstd) per group, the same fold in every block of the image;
    // the per-channel affine goes where the reduction scratch was
    float* coef = red;
    const int cg = C / a.G, full_warps = nt / 32;
    if (warp < full_warps) {
      for (int g = warp; g < a.G; g += full_warps) {
        float sa = 0.f, sb = 0.f;
        for (int i = lane; i < a.chunks * cg; i += 32) {
          const float2 v = __ldcg(slots + (size_t)(i / cg) * C + g * cg + i % cg);
          sa += v.x;
          sb += v.y;
        }
        for (int off = 16; off > 0; off >>= 1) {
          sa += __shfl_xor_sync(kFull, sa, off);
          sb += __shfl_xor_sync(kFull, sb, off);
        }
        const float mean = sa / a.denom;
        const float rstd = rsqrtf(sb / a.denom - mean * mean + a.eps);
        for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
          const float ac = rstd * a.gamma[c];
          coef[c] = ac;
          coef[C + c] = a.beta[c] - mean * ac;
        }
      }
    }
    __syncthreads();

    // 5. affine + SiLU: the resident part from shared memory, then the part
    // read twice from device memory
    float ca[VW], cb[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      ca[k] = coef[u * VW + k];
      cb[k] = coef[C + u * VW + k];
    }
    // segment by segment; once a segment is written out, the next wave's
    // chunk of the block streams into it while the rest is applied
    for (int j0 = 0; j0 < n_res; j0 += seg) {
      const int j1 = min(n_res, j0 + seg);
      for (int j = j0 + t; j < j1; j += nt) {
        float f[VW];
        load_shared<T, VW>(xs, j, f);
        affine_silu(f, ca, cb);
        store_global<T, VW>(yg, j, f);
      }
      if (next < a.n) {
        __syncthreads();
        copy_in(xs + (size_t)j0 * VW, xg + (size_t)a.images * slab + (size_t)j0 * VW,
                (j1 - j0) * VW);
      }
    }
    for (int j = t; j < n_str; j += nt) {
      float f[VW];
      load_global<T, VW>(xstr, j, f);
      affine_silu(f, ca, cb);
      store_global<T, VW>(ystr, j, f);
    }
    __syncthreads();  // the chunk and the affine are free for the next wave
  }
}

template <typename T, int VW>
cudaError_t launch_instance(const Args& a, int threads, int smem, cudaStream_t st) {
  auto* kernel = gn_silu_kernel<T, VW>;
  // the shared-memory limit, raised once per device and instance
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem)) != cudaSuccess)
      return err;
    smem_set[dev] = smem;
  }
  const int grid = a.images * a.chunks;
  if (a.chunks == 1) {  // no block waits for another
    kernel<<<grid, threads, smem, st>>>(a);
    return cudaGetLastError();
  }
  void* args[] = {const_cast<Args*>(&a)};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                     dim3(threads), args, (size_t)smem, st);
}

// Checks the plan against the shape, then launches. Anything else is
// cudaErrorInvalidValue and nothing is launched.
template <typename T>
cudaError_t launch(const Args& a, int vec, int threads, int smem, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (a.n < 1 || a.P < 1 || a.images < 1 || a.chunks < 1 || a.chunk_pix < 1 ||
      a.resident_pix < 1 || a.resident_pix > a.chunk_pix ||
      (long long)a.chunks * a.chunk_pix < a.P || (long long)(a.chunks - 1) * a.chunk_pix >= a.P)
    return cudaErrorInvalidValue;
  if (vec == kVec) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.y);
    if (a.C % kVec != 0 || 32 % (a.C / kVec) != 0 || ((size_t)a.P * a.C * sizeof(T)) % 16 != 0 ||
        ptrs % 16 != 0)
      return cudaErrorInvalidValue;
  } else if (vec != 1) {
    return cudaErrorInvalidValue;
  }
  if (threads != block_threads(a.C, vec) || threads > kMaxThreads ||
      (size_t)smem < smem_bytes(a.C, sizeof(T), vec, threads, a.resident_pix))
    return cudaErrorInvalidValue;
  return vec == 1 ? launch_instance<T, 1>(a, threads, smem, st)
                  : launch_instance<T, kVec>(a, threads, smem, st);
}

}  // namespace gnk

namespace {

int dispatch(const void* x, const void* gamma, const void* beta, void* y, void* count,
             void* part, int n, int P, int C, int G, int vec, int threads, int chunk_pix,
             int chunks, int images, int resident_pix, int smem, float eps, int dtype,
             void* stream) {
  if (C < 1 || G < 1 || C % G != 0) return (int)cudaErrorInvalidValue;  // before C / G
  const gnk::Args a{x, static_cast<const float*>(gamma), static_cast<const float*>(beta), y,
                    static_cast<int*>(count), static_cast<float*>(part), n, P, C, G, chunk_pix,
                    chunks, images, resident_pix, (float)((double)P * (C / G)), eps};
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)gnk::launch<float>(a, vec, threads, smem, st);
  if (dtype == 1) return (int)gnk::launch<__nv_bfloat16>(a, vec, threads, smem, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, y: (n, P, C) NHWC contiguous, dtype 0 = float32, 1 = bfloat16.
// gamma, beta: (C,) float32. count: n int32 arrival counters, 0 before the
// call and after it, never shared with a call that may run at the same
// time. part: n * chunks * C * 2 float32 scratch, 8-byte aligned.
// vec, threads, chunk_pix, chunks, images (per wave), resident_pix and smem
// come from the wrapper's _gn_plan. Returns cudaGetLastError() or the
// cooperative launch's error (a grid that cannot all be resident is refused).
int gn_silu_flat(const void* x, const void* gamma, const void* beta, void* y, void* count,
                 void* part, int n, int P, int C, int G, int vec, int threads, int chunk_pix,
                 int chunks, int images, int resident_pix, int smem, float eps, int dtype,
                 void* stream) {
  return dispatch(x, gamma, beta, y, count, part, n, P, C, G, vec, threads, chunk_pix, chunks,
                  images, resident_pix, smem, eps, dtype, stream);
}

int gn_silu_nhwc(const void* x, const void* gamma, const void* beta, void* y, void* count,
                 void* part, int n, int P, int C, int G, int vec, int threads, int chunk_pix,
                 int chunks, int images, int resident_pix, int smem, float eps, int dtype,
                 void* stream) {
  return dispatch(x, gamma, beta, y, count, part, n, P, C, G, vec, threads, chunk_pix, chunks,
                  images, resident_pix, smem, eps, dtype, stream);
}

}  // extern "C"
