// Conv3x3 (same, no bias) -> GroupNorm -> SiLU on NHWC, for Hopper (sm_90a).
//
// Replaces, in image_enhancement_deglaring_tpu/ops/pallas_kernels.py,
// _conv_gn_silu_kernel via _fused_conv_gn_silu_pallas (K3, one image per
// grid step; entry conv3x3_gn_silu) and _conv_gn_silu_batched_kernel via
// _fused_conv_gn_silu_batched (K4, K images per grid step; entry
// conv3x3_gn_silu_batched): per image, a 3x3 same conv accumulated in f32,
// then two-pass GroupNorm (mean, then the centred variance), the affine and
// SiLU.
//
// Bound on the H100: at the U-Net's enc4 and bottleneck shapes the conv does
// 2 * 9 * Cin * Cout operations per output pixel, 0.6-2.4 GFLOP per batch of
// 8, against a few MB of input and output: 1.2-2.5 us on the bf16 tensor
// cores (989 TFLOP/s) or at 3.35 TB/s, whichever is larger.
//
// bfloat16 (namespace tc): the conv is an implicit GEMM on the tensor cores.
// One work item is an 8x8 output tile (M = 64 pixels) of one image for 64
// output channels (N = 64); its reduction runs over 9 taps x Cin in steps
// of 16 channels, one wgmma.mma_async m64n64k16 (bf16 x bf16 -> f32) each.
// Both operands come from shared memory through descriptors, in no-swizzle
// layouts (core matrices of 8 rows x 16 bytes), A K-major and B N-major:
//  - A is the item's (10, 10, Cin) input halo, stored per 8-channel octet as
//    [octet][10 x 10 pixels][8 channels]. The 8 pixels of an output row are
//    8 consecutive 16-byte rows, so each tap's shifted window is the same
//    buffer at another start address (rows 160 bytes apart, octets 1600):
//    no im2col copy and no A registers.
//  - B is the block's weight slice, 9 x Cin x 64, stored N-major per
//    16-channel step as [8 output octets][2 input octets][8 inputs][8
//    outputs]: each 16-byte row is a piece of one HWIO row, copied as is.
// Products of bf16 values are exact in f32 and the sums are f32, as in the
// TPU kernel's Precision.DEFAULT dot. Against the CUDA-core form of PR 1
// and PR 3 the design changes four things:
//  1. the conv runs on the tensor cores (it ran f32 FMAs on the CUDA cores);
//  2. the weight slice stays resident: a block stages 9 x Cin x 64 once
//     (36.9 KB at Cin 32, 73.7 KB at 64, 147 KB at 128) and keeps it while
//     it walks its items; above 128 input channels it streams 128 at a time;
//  3. K no longer cuts the grid: blocks are persistent, the grid is
//     min(items, SMs x blocks per SM) (the wrapper's _conv_plan), and K only
//     orders a block's items (the K images of one tile in a row). One set
//     of accumulators is live at a time, so registers do not grow with K;
//  4. no f32 pre-norm scratch and 3 launches instead of 5: pass 1 is the
//     conv plus, per item and channel, the sum over the tile's in-image
//     pixels and the centred sum of squares about the tile's own mean; a
//     finalize folds them per (image, group) with Chan's formula
//     (M2 = sum M2_t + sum n_t (mean_t - mean)^2, no E[x^2] - mean^2
//     cancellation); pass 2 recomputes the conv with the same instructions
//     (the same bits) and applies the affine and SiLU, storing once in bf16.
// Weights and halo tiles stream in through 16-byte cp.async copies
// (zero-filled at the image edge and outside Cin and Cout; the weights
// through L1, which the blocks on one SM share); halo tiles are
// double-buffered so the next item's tile loads during this item's MMAs.
// Pass 2 stages its output tile in shared memory and stores it in 16-byte
// pieces. Partials go to fixed (image, tile, channel) slots and are folded
// in a fixed order, and an item's arithmetic does not depend on the block
// that runs it, so K4 equals K3 bit for bit at every K.
// What remains: TMA loads and swizzled layouts (the no-swizzle layout costs
// shared-memory bank conflicts), clusters sharing the weight slice,
// overlapping one item's epilogue with the next item's MMAs.
//
// float32 (below tc): the CUDA-core conv of PR 1 and PR 3, kept as it was.
// It is the parity path against the JAX package's Precision.HIGHEST (the
// tensor cores would mean TF32), and its f32 weight slice (295 KB at Cin
// 128) does not fit shared memory. A block computes an 8x8 pixel tile for 64
// output channels across `images` images (KR sets of accumulators; K3 is the
// KR = 1 instance, so K4 equals K3 bit for bit); input channels stream
// through shared memory in chunks of 16. The pre-norm tensor goes to an f32
// scratch, and the GroupNorm runs as four more launches: tile sums, a mean
// finalize, a centred pass, an rstd finalize and the apply pass.
#include <cstdint>

#include "gn_common.cuh"

namespace {

// ============================================================ bf16, tensor cores

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kTile = 8;                      // output tile kTile x kTile = wgmma M
constexpr int kHalo = kTile + 2;              // input tile with its 1-pixel halo
constexpr int kN = 64;                        // output channels per item = wgmma N
constexpr int kThreads = 128;                 // one warpgroup
constexpr int kMinBlocks = 4;                 // blocks per SM the registers allow
constexpr int kOctetBytes = kHalo * kHalo * 16;  // one 8-channel octet of a halo
constexpr int kBStepBytes = kN * 16 * 2;         // B of one 16-channel step
constexpr int kAuxFloats = 4 * kN + 3 * kN;      // reductions + per-channel values
constexpr int kOutRow = 2 * kN + 16;             // bytes per pixel of the staged output tile
constexpr int kFinThreads = 256;

// Dynamic shared memory of a block: the weight slice, two halo buffers, the
// epilogue's scratch and the staged output tile. ops/fused_kernels.py's
// _conv_plan mirrors this.
__host__ __device__ constexpr int weight_bytes(int kc) { return 9 * kc * kBStepBytes; }
__host__ __device__ constexpr int halo_bytes(int kc) { return 2 * kc * kOctetBytes; }
__host__ __device__ constexpr int smem_bytes(int kc) {
  return weight_bytes(kc) + 2 * halo_bytes(kc) + kAuxFloats * 4 + kTile * kTile * kOutRow;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor, no swizzle: start address, leading byte offset
// (between the two core matrices along K), stride byte offset (between
// 8-row groups along M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t desc_strides(uint32_t lbo, uint32_t sbo) {
  return (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}
__device__ __forceinline__ uint64_t desc_at(uint32_t saddr, uint64_t strides) {
  return strides | static_cast<uint64_t>((saddr & 0x3FFFF) >> 4);
}

// 16-byte global -> shared copies, zero-filled past src_bytes: through L2
// only (cg), or also through L1 (ca), where the blocks on one SM share the
// weight slice they all read.
__device__ __forceinline__ void cp_async16_cg(uint32_t saddr, const void* g, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(g),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16_ca(uint32_t saddr, const void* g, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr), "l"(g),
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
// Shared-memory writes of the generic proxy (stores, cp.async) made visible
// to the async proxy that wgmma reads its operands through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence or wait.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, descriptor, K-major) * B (16 x 64, descriptor, N-major).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  const int scale_d = 1;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The weight window (input channels cb .. cb + 16 KC - 1, output channels
// co0 .. co0 + 63) into B's layout, zero outside (Cin, Cout): per 16-channel
// step of a tap, [8 output octets][2 input octets][8 inputs][8 outputs],
// so each 16-byte row is 8 consecutive outputs of one HWIO row. The fast
// form issues one 16-byte cp.async per row, which the caller commits and
// waits for. (On the H100, synchronous loads with a transpose into a
// K-major B were no faster, and copies through L2 only were slower.)
template <int KC>
__device__ void stage_weights(unsigned char* s_w, const bf16* __restrict__ w, int co0, int cb,
                              int Cin, int Cout, bool vec) {
  const auto* wr = reinterpret_cast<const unsigned short*>(w);
  if (vec) {
    const uint32_t base = smem_u32(s_w);
    for (int q = threadIdx.x; q < 9 * KC * 128; q += kThreads) {
      const int g = q % 8, k = (q / 8) % 16, step = q / 128;
      const int ci = cb + (step % KC) * 16 + k, co = co0 + 8 * g;
      const bool in = ci < Cin && co < Cout;
      const unsigned short* src = in ? wr + ((size_t)(step / KC) * Cin + ci) * Cout + co : wr;
      cp_async16_ca(base + step * kBStepBytes + g * 256 + (k / 8) * 128 + (k % 8) * 16, src,
                    in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < 9 * KC * 16 * kN; e += kThreads) {
      const int nn = e % kN, k = (e / kN) % 16, step = e / (kN * 16);
      const int ci = cb + (step % KC) * 16 + k, co = co0 + nn;
      unsigned short v = 0;
      if (ci < Cin && co < Cout) v = wr[((size_t)(step / KC) * Cin + ci) * Cout + co];
      *reinterpret_cast<unsigned short*>(s_w + step * kBStepBytes + (nn / 8) * 256 +
                                         (k / 8) * 128 + (k % 8) * 16 + (nn % 8) * 2) = v;
    }
  }
}

// One item's (10, 10, 16 KC) input halo at channels cb.., zero outside the
// image and above Cin. The fast form issues 16-byte cp.async copies (one
// octet of one pixel each), which the caller commits and waits for.
template <int KC>
__device__ void load_halo(unsigned char* s_h, const bf16* __restrict__ x, int img, int ty0,
                          int tx0, int cb, int H, int W, int Cin, bool vec) {
  constexpr int kOct = 2 * KC;
  const auto* xr = reinterpret_cast<const unsigned short*>(x);
  if (vec) {
    const uint32_t base = smem_u32(s_h);
    for (int q = threadIdx.x; q < kHalo * kHalo * kOct; q += kThreads) {
      const int o = q % kOct, pix = q / kOct;
      const int gy = ty0 + pix / kHalo - 1, gx = tx0 + pix % kHalo - 1, c = cb + 8 * o;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin;
      const unsigned short* src = in ? xr + (((size_t)img * H + gy) * W + gx) * Cin + c : xr;
      cp_async16_cg(base + o * kOctetBytes + pix * 16, src, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kHalo * kHalo * kOct * 8; e += kThreads) {
      const int ci = e % (kOct * 8), pix = e / (kOct * 8);
      const int gy = ty0 + pix / kHalo - 1, gx = tx0 + pix % kHalo - 1, c = cb + ci;
      unsigned short v = 0;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < Cin)
        v = xr[(((size_t)img * H + gy) * W + gx) * Cin + c];
      *reinterpret_cast<unsigned short*>(s_h + (ci / 8) * kOctetBytes + pix * 16 + (ci % 8) * 2) =
          v;
    }
  }
}

// Sum over the 8 lanes that share lane % 4 (the 8 rows of a warp's half).
__device__ __forceinline__ void row_sums(float (&v)[16]) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
}

__device__ __forceinline__ float silu(float z) { return __fdividef(z, 1.f + __expf(-z)); }

// Pass 1 (APPLY = false): the conv, then per item and output channel the
// sum over the tile's in-image pixels and the centred sum of squares about
// the tile's mean, into part[image][tile][channel] = (sum, M2).
// Pass 2 (APPLY = true): the same conv, then (y - mean) * rstd * gamma +
// beta and SiLU from stats[image][group] = (mean, rstd), stored in bf16.
// Block b walks the items [b * items / grid, (b + 1) * items / grid) in
// item order: output-channel tile, then groups of `images` images, then
// tile, then the image within the group.
template <int KC, bool APPLY>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
conv3x3_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  const float* __restrict__ stats, float* __restrict__ part,
                  bf16* __restrict__ out, int n, int H, int W, int Cin, int Cout, int G,
                  int tiles_x, int tiles, int images, int windows, long long items) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_w = smem;
  unsigned char* s_halo = smem + weight_bytes(KC);
  float* s_red = reinterpret_cast<float*>(s_halo + 2 * halo_bytes(KC));  // [4][kN]
  float* s_aux = s_red + 4 * kN;                                         // [3][kN]
  unsigned char* s_out = reinterpret_cast<unsigned char*>(s_aux + 3 * kN);  // [64][kOutRow]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long first = (long long)blockIdx.x * items / gridDim.x;
  const long long last = ((long long)blockIdx.x + 1) * items / gridDim.x;
  const int steps = (int)(last - first) * windows;
  const long long per_ct = (long long)n * tiles, per_group = (long long)tiles * images;
  const bool xvec = Cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool wvec = Cout % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const bool ovec = Cout % 8 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const uint32_t w_addr = smem_u32(s_w), halo_addr = smem_u32(s_halo);
  const uint64_t a_strides = desc_strides(kOctetBytes, kHalo * 16);
  const uint64_t b_strides = desc_strides(128, 256);

  // step s = (item first + s / windows, input-channel window s % windows)
  auto decode = [&](int s, int& img, int& tile, int& ct, int& win) {
    const long long i = first + s / windows;
    win = s % windows;
    ct = (int)(i / per_ct);
    const long long r = i % per_ct;
    const int r2 = (int)(r % per_group);
    tile = r2 / images;
    img = (int)(r / per_group) * images + r2 % images;
  };
  auto fetch = [&](int s) {
    int img, tile, ct, win;
    decode(s, img, tile, ct, win);
    load_halo<KC>(s_halo + (s & 1) * halo_bytes(KC), x, img, (tile / tiles_x) * kTile,
                  (tile % tiles_x) * kTile, win * KC * 16, H, W, Cin, xvec);
  };

  float acc[32];
  int staged_ct = -1, staged_win = -1;
  for (int s = 0; s < steps; ++s) {
    int img, tile, ct, win;
    decode(s, img, tile, ct, win);
    if (ct != staged_ct || win != staged_win) {  // no wgmma reads the slice now
      stage_weights<KC>(s_w, w, ct * kN, win * KC * 16, Cin, Cout, wvec);
      staged_ct = ct;
      staged_win = win;
    }
    if (s == 0) fetch(0);
    cp_async_commit();
    if (s + 1 < steps) fetch(s + 1);  // into the other buffer, read by step s - 1
    cp_async_commit();
    cp_async_wait<1>();  // this step's weights and halo have landed
    fence_proxy_async();
    __syncthreads();

    if (win == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    }
    fence_operands(acc);
    wgmma_fence();
    // Each operand's descriptor is its base descriptor plus the operand's
    // offset in 16-byte units (the address field does not overflow below
    // 256 KB). The bases are opaque to the compiler, which would otherwise
    // hoist all 9 KC loop-invariant B descriptors into registers.
    uint64_t da = desc_at(halo_addr + (s & 1) * halo_bytes(KC), a_strides);
    uint64_t db = desc_at(w_addr, b_strides);
    asm volatile("" : "+l"(da), "+l"(db));
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const int a_off = kc * 2 * kOctetBytes + ((tap / 3) * kHalo + tap % 3) * 16;
        const int b_off = (tap * KC + kc) * kBStepBytes;
        wgmma_m64n64k16(acc, da + (a_off >> 4), db + (b_off >> 4));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
    if (win != windows - 1) continue;

    // Epilogue. Thread (warp, lane) holds tile rows 2 warp and 2 warp + 1
    // at column lane / 4, channels 8 j + 2 (lane % 4) + {0, 1}:
    // acc[4 j + e] (first row) and acc[4 j + 2 + e] (second row).
    const int ty0 = (tile / tiles_x) * kTile, tx0 = (tile % tiles_x) * kTile;
    const int r0 = 2 * warp, pc = lane >> 2, q = lane & 3, co0 = ct * kN;
    const bool in0 = ty0 + r0 < H && tx0 + pc < W;
    const bool in1 = ty0 + r0 + 1 < H && tx0 + pc < W;
    if (!APPLY) {
      float v[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[2 * j + e] = (in0 ? acc[4 * j + e] : 0.f) + (in1 ? acc[4 * j + 2 + e] : 0.f);
      row_sums(v);
      if (lane < 4)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) s_red[warp * kN + 8 * j + 2 * lane + e] = v[2 * j + e];
      __syncthreads();
      const float cnt = (float)(min(kTile, H - ty0) * min(kTile, W - tx0));
      float sum = 0.f;
      if (t < kN) {
        sum = ((s_red[t] + s_red[kN + t]) + s_red[2 * kN + t]) + s_red[3 * kN + t];
        s_aux[t] = sum / cnt;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float m = s_aux[8 * j + 2 * q + e];
          const float d0 = in0 ? acc[4 * j + e] - m : 0.f;
          const float d1 = in1 ? acc[4 * j + 2 + e] - m : 0.f;
          v[2 * j + e] = d0 * d0 + d1 * d1;
        }
      row_sums(v);
      if (lane < 4)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) s_red[warp * kN + 8 * j + 2 * lane + e] = v[2 * j + e];
      __syncthreads();
      if (t < kN && co0 + t < Cout) {
        const float m2 = ((s_red[t] + s_red[kN + t]) + s_red[2 * kN + t]) + s_red[3 * kN + t];
        reinterpret_cast<float2*>(part)[((size_t)img * tiles + tile) * Cout + co0 + t] =
            make_float2(sum, m2);
      }
    } else {
      if (t < kN) {
        const int co = co0 + t;
        float m = 0.f, a = 0.f, b = 0.f;
        if (co < Cout) {
          const float* st = stats + ((size_t)img * G + co / (Cout / G)) * 2;
          m = st[0];
          a = st[1] * gamma[co];
          b = beta[co];
        }
        s_aux[t] = m;
        s_aux[kN + t] = a;
        s_aux[2 * kN + t] = b;
      }
      __syncthreads();
      const size_t p0 = ((size_t)img * H + ty0 + r0) * W + tx0 + pc;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = 8 * j + 2 * q, co = co0 + cl;
        float y[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float m = s_aux[cl + e], a = s_aux[kN + cl + e], b = s_aux[2 * kN + cl + e];
          y[e] = silu((acc[4 * j + e] - m) * a + b);
          y[2 + e] = silu((acc[4 * j + 2 + e] - m) * a + b);
        }
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          if (ovec) {  // tile pixel 8 (r0 + row) + pc
            *reinterpret_cast<__nv_bfloat162*>(s_out + (8 * (r0 + row) + pc) * kOutRow + 2 * cl) =
                __floats2bfloat162_rn(y[2 * row], y[2 * row + 1]);
            continue;
          }
          if (!(row == 0 ? in0 : in1) || co >= Cout) continue;
          bf16* o = out + (p0 + row * W) * Cout + co;
          o[0] = __float2bfloat16(y[2 * row]);
          if (co + 1 < Cout) o[1] = __float2bfloat16(y[2 * row + 1]);
        }
      }
      if (ovec) {
        __syncthreads();
        for (int c = t; c < kTile * kTile * (kN / 8); c += kThreads) {
          const int m = c / (kN / 8), g = c % (kN / 8);
          const int py = ty0 + m / kTile, px = tx0 + m % kTile, co = co0 + 8 * g;
          if (py < H && px < W && co < Cout)
            *reinterpret_cast<uint4*>(out + (((size_t)img * H + py) * W + px) * Cout + co) =
                *reinterpret_cast<const uint4*>(s_out + m * kOutRow + 16 * g);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Sum over the block, the same value in every thread: warp trees, then the
// warp sums in order.
__device__ __forceinline__ float block_sum(float v, float* s_warp) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) s_warp[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < kFinThreads / 32; ++i) total += s_warp[i];
  __syncthreads();
  return total;
}

// One block per (image, group): the group mean from the tile sums, then
// M2 = sum over (tile, channel) of M2_t + n_t (mean_t - mean)^2, each in a
// fixed order; stats[image][group] = (mean, rstd).
__global__ void __launch_bounds__(kFinThreads)
conv_gn_finalize_kernel(const float* __restrict__ part, float* __restrict__ stats, int H,
                        int W, int tiles_x, int tiles, int Cout, int G, float eps) {
  __shared__ float s_warp[kFinThreads / 32];
  const int n = blockIdx.x / G, g = blockIdx.x % G, cg = Cout / G, m = tiles * cg;
  const float denom = (float)((double)H * W * cg);
  const float2* p = reinterpret_cast<const float2*>(part) + (size_t)n * tiles * Cout + g * cg;
  float s = 0.f;
  for (int i = threadIdx.x; i < m; i += kFinThreads) s += p[(size_t)(i / cg) * Cout + i % cg].x;
  const float mean = block_sum(s, s_warp) / denom;
  float m2 = 0.f;
  for (int i = threadIdx.x; i < m; i += kFinThreads) {
    const int k = i / cg;
    const float2 v = p[(size_t)k * Cout + i % cg];
    const int ty0 = (k / tiles_x) * kTile, tx0 = (k % tiles_x) * kTile;
    const float cnt = (float)(min(kTile, H - ty0) * min(kTile, W - tx0));
    const float d = v.x / cnt - mean;
    m2 += v.y + cnt * d * d;
  }
  m2 = block_sum(m2, s_warp);
  if (threadIdx.x == 0) {
    float* st = stats + ((size_t)n * G + g) * 2;
    st[0] = mean;
    st[1] = rsqrtf(m2 / denom + eps);
  }
}

template <int KC>
cudaError_t launch(const bf16* x, const bf16* w, const float* gamma, const float* beta,
                   bf16* out, float* part, float* stats, int n, int H, int W, int Cin,
                   int Cout, int G, int images, int grid, int smem, float eps,
                   cudaStream_t st) {
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles = tiles_x * ((H + kTile - 1) / kTile);
  const int windows = (Cin + 16 * KC - 1) / (16 * KC);
  const long long items = (long long)n * tiles * ((Cout + kN - 1) / kN);
  if (smem < smem_bytes(KC) || grid < 1 || grid > items) return cudaErrorInvalidValue;
  auto* pass1 = conv3x3_tc_kernel<KC, false>;
  auto* pass2 = conv3x3_tc_kernel<KC, true>;
  // the shared-memory limit, raised once per device and instance
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    if ((err = cudaFuncSetAttribute(pass1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(pass2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem)) != cudaSuccess)
      return err;
    smem_set[dev] = smem;
  }
  pass1<<<grid, kThreads, smem, st>>>(x, w, gamma, beta, stats, part, out, n, H, W, Cin, Cout,
                                      G, tiles_x, tiles, images, windows, items);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  conv_gn_finalize_kernel<<<n * G, kFinThreads, 0, st>>>(part, stats, H, W, tiles_x, tiles,
                                                          Cout, G, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pass2<<<grid, kThreads, smem, st>>>(x, w, gamma, beta, stats, part, out, n, H, W, Cin, Cout,
                                      G, tiles_x, tiles, images, windows, items);
  return cudaGetLastError();
}

}  // namespace tc

// ============================================================ float32, CUDA cores

constexpr int kTile = 8;     // output tile is kTile x kTile pixels
constexpr int kTco = 64;     // output channels per block
constexpr int kCk = 16;      // input channels per shared-memory chunk
constexpr int kThreads = 256;

// Grid (tiles, Cout / 64, n / images); each block runs its tile for the
// images n0 .. n0 + images - 1, KR at a time. For K3 (KR = 1) the bounds ask
// for two blocks per SM: without them ptxas gives it 80 registers and
// spills; with them it takes 96-99 and spills nothing.
template <int KR>
__global__ void __launch_bounds__(kThreads, KR == 1 ? 2 : 1)
conv3x3_partials_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        float* __restrict__ y, float* __restrict__ part, int H,
                        int W, int Cin, int Cout, int tiles_x, int tiles,
                        int images) {
  __shared__ float s_in[kTile + 2][kTile + 2][kCk];
  __shared__ __align__(16) float s_w[9][kCk][kTco];
  __shared__ float s_red[kThreads / 16][kTco];

  const int n0 = blockIdx.z * images, tile = blockIdx.x;
  const int ty0 = (tile / tiles_x) * kTile, tx0 = (tile % tiles_x) * kTile;
  const int co0 = blockIdx.y * kTco;
  const int t = threadIdx.x;
  const int cq = t % 16;        // channels co0 + 4*cq .. +3
  const int pg = t / 16;        // pixel row pg/2, columns (pg%2)*4 .. +3
  const int pr = pg >> 1, pc0 = (pg & 1) * 4;

  // K3 (KR = 1) takes one image per block: constant bounds drop the image loop
  const int nimg = KR == 1 ? 1 : images;
  for (int k0 = 0; k0 < nimg; k0 += KR) {
    const int kr = KR == 1 ? 1 : min(KR, images - k0);  // images of this pass, uniform
    float acc[KR][4][4];
#pragma unroll
    for (int k = 0; k < KR; ++k)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[k][p][j] = 0.f;

    for (int ci0 = 0; ci0 < Cin; ci0 += kCk) {
      // the weight chunk, once for the pass's images
      for (int i = t; i < 9 * kCk * kTco; i += kThreads) {
        const int co = i % kTco, r = i / kTco;
        const int c = r % kCk, k = r / kCk;
        const int gco = co0 + co, gc = ci0 + c;
        float v = 0.f;
        if (gco < Cout && gc < Cin) v = w[((size_t)k * Cin + gc) * Cout + gco];
        s_w[k][c][co] = v;
      }
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        if (k < kr) {
          const float* xn = x + (size_t)(n0 + k0 + k) * H * W * Cin;
          for (int i = t; i < (kTile + 2) * (kTile + 2) * kCk; i += kThreads) {
            const int c = i % kCk, pix = i / kCk;
            const int px = pix % (kTile + 2), py = pix / (kTile + 2);
            const int gy = ty0 + py - 1, gx = tx0 + px - 1, gc = ci0 + c;
            float v = 0.f;
            if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < Cin)
              v = xn[((size_t)gy * W + gx) * Cin + gc];
            s_in[py][px][c] = v;
          }
          __syncthreads();
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int ky = tap / 3, kx = tap % 3;
#pragma unroll 4
            for (int c = 0; c < kCk; ++c) {
              const float4 wv = *reinterpret_cast<const float4*>(&s_w[tap][c][cq * 4]);
#pragma unroll
              for (int p = 0; p < 4; ++p) {
                const float xv = s_in[pr + ky][pc0 + p + kx][c];
                acc[k][p][0] += xv * wv.x;
                acc[k][p][1] += xv * wv.y;
                acc[k][p][2] += xv * wv.z;
                acc[k][p][3] += xv * wv.w;
              }
            }
          }
          __syncthreads();
        }
      }
    }

    // Epilogue, per image: store the pre-norm tile, and per-channel sums
    // over the tile's in-image pixels for the group mean.
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      if (k < kr) {
        const int n = n0 + k0 + k;
        const int oy = ty0 + pr;
        float csum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int ox = tx0 + pc0 + p;
          if (oy < H && ox < W) {
            float* yo = y + (((size_t)n * H + oy) * W + ox) * Cout;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int co = co0 + cq * 4 + j;
              if (co < Cout) yo[co] = acc[k][p][j];
              csum[j] += acc[k][p][j];
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) s_red[pg][cq * 4 + j] = csum[j];
        __syncthreads();
        if (t < kTco && co0 + t < Cout) {
          float s = 0.f;
          for (int r = 0; r < kThreads / 16; ++r) s += s_red[r][t];
          float* q = part + (((size_t)n * tiles + tile) * Cout + co0 + t) * 2;
          q[0] = s;
          q[1] = 0.f;
        }
        __syncthreads();
      }
    }
  }
}

template <int KR>
cudaError_t launch_conv_f32(const float* x, const float* w, float* yscr, float* part, int n,
                            int H, int W, int Cin, int Cout, int tiles_x, int tiles,
                            int images, cudaStream_t st) {
  const dim3 grid(tiles, (Cout + kTco - 1) / kTco, n / images);
  conv3x3_partials_kernel<KR><<<grid, kThreads, 0, st>>>(
      x, w, yscr, part, H, W, Cin, Cout, tiles_x, tiles, images);
  return cudaGetLastError();
}

cudaError_t launch_f32(const float* x, const float* w, const float* gamma, const float* beta,
                       float* out, float* yscr, float* part, float* stats, int n, int H,
                       int W, int Cin, int Cout, int G, int chunk_pix, int chunks,
                       int threads, int images, float eps, cudaStream_t st) {
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles = tiles_x * ((H + kTile - 1) / kTile);
  const int P = H * W;
  const float denom = (float)((double)P * (Cout / G));
  const int fin = gnk::finalize_threads(G);

  // images per block: K3 runs one; K4 holds up to 8 sets of accumulators
  cudaError_t err;
  if (images <= 1)
    err = launch_conv_f32<1>(x, w, yscr, part, n, H, W, Cin, Cout, tiles_x, tiles, 1, st);
  else if (images == 2)
    err = launch_conv_f32<2>(x, w, yscr, part, n, H, W, Cin, Cout, tiles_x, tiles, 2, st);
  else if (images <= 4)
    err = launch_conv_f32<4>(x, w, yscr, part, n, H, W, Cin, Cout, tiles_x, tiles, images, st);
  else
    err = launch_conv_f32<8>(x, w, yscr, part, n, H, W, Cin, Cout, tiles_x, tiles, images, st);
  if (err != cudaSuccess) return err;
  gnk::gn_finalize_kernel<<<n, fin, 0, st>>>(part, stats, tiles, Cout, G, denom,
                                             eps, gnk::kMeanOnly);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 grid(chunks, n);
  const size_t smem = 2 * (size_t)threads * sizeof(float);
  gnk::centred_partials_kernel<<<grid, threads, smem, st>>>(
      yscr, stats, part, P, Cout, G, chunk_pix, chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gnk::gn_finalize_kernel<<<n, fin, 0, st>>>(part, stats, chunks, Cout, G, denom,
                                             eps, gnk::kRstdCentred);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gnk::gn_apply_silu_kernel<<<grid, threads, 0, st>>>(
      yscr, stats, gamma, beta, out, P, Cout, G, chunk_pix);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bfloat16: x (n, H, W, Cin), w (3, 3, Cin, Cout) HWIO, out (n, H, W, Cout),
// bf16 and contiguous; gamma, beta (Cout,) float32. part: float32 scratch of
// n * tiles * Cout * 2, tiles = ceil(H/8) * ceil(W/8); stats: (n, G, 2)
// float32 scratch. kc (1, 2, 4 or 8: input channels per weight window / 16),
// grid and smem come from the wrapper's _conv_plan; `images` orders a
// block's items (1 for K3, K for K4), n % images == 0. Anything else is
// cudaErrorInvalidValue and nothing is launched. Returns cudaGetLastError().
int conv3x3_gn_silu_bf16(const void* x, const void* w, const void* gamma, const void* beta,
                         void* out, void* part, void* stats, int n, int H, int W, int Cin,
                         int Cout, int G, int kc, int images, int grid, int smem, float eps,
                         void* stream) {
  if (images < 1 || n % images != 0 || G < 1 || Cout % G != 0)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* pt = static_cast<float*>(part);
  auto* sts = static_cast<float*>(stats);
  const auto st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto launch) {
    return (int)launch(xb, wb, g, b, o, pt, sts, n, H, W, Cin, Cout, G, images, grid, smem, eps,
                       st);
  };
  switch (kc) {
    case 1: return run(tc::launch<1>);
    case 2: return run(tc::launch<2>);
    case 4: return run(tc::launch<4>);
    case 8: return run(tc::launch<8>);
    default: return (int)cudaErrorInvalidValue;
  }
}

// float32: the same function on the CUDA cores, `images` images per conv
// block (1 for K3, K for K4; n % images == 0, else cudaErrorInvalidValue and
// nothing is launched). yscr: (n, H, W, Cout) float32 scratch. part: float32
// scratch of n * max(tiles, chunks) * Cout * 2. stats: (n, G, 2) float32.
int conv3x3_gn_silu_f32(const void* x, const void* w, const void* gamma, const void* beta,
                        void* out, void* yscr, void* part, void* stats, int n, int H, int W,
                        int Cin, int Cout, int G, int chunk_pix, int chunks, int threads,
                        int images, float eps, void* stream) {
  if (images < 1 || n % images != 0) return (int)cudaErrorInvalidValue;
  return (int)launch_f32(static_cast<const float*>(x), static_cast<const float*>(w),
                         static_cast<const float*>(gamma), static_cast<const float*>(beta),
                         static_cast<float*>(out), static_cast<float*>(yscr),
                         static_cast<float*>(part), static_cast<float*>(stats), n, H, W, Cin,
                         Cout, G, chunk_pix, chunks, threads, images, eps,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
