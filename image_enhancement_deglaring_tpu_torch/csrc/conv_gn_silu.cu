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
// 8, against a few MB of input and output: in bf16 on the tensor cores that
// is about as many microseconds of compute as of memory, so a kernel that
// reaches either roof is near its bound. This first form computes the conv on
// the CUDA cores (f32 FMA), so it is bound by its own issue rate, well above
// either roof; mma.sync/wgmma with TMA-fed tiles are later work.
//
// Design: a block computes an 8x8 pixel tile for 64 output channels. Input
// channels stream through shared memory in chunks of 16: a (10, 10, 16)
// input tile with its 1-pixel halo (zero outside the image) and the
// (9, 16, 64) weight slice, both widened to f32. Each of the 256 threads
// holds 4 pixels x 4 channels of f32 accumulators per image.
//
// K4 is the Hopper reading of the TPU's "fewer, fatter grid steps": one
// block owns its output tile across K images (up to 8 at a time, KR below),
// so each weight chunk is staged in shared memory once for all of them
// where K3 stages it once per (image, tile); the threads hold KR sets of
// accumulators. Per image the arithmetic is K3's to the instruction: the
// same chunk order, tap order and per-thread FMA chain, and the same
// epilogue. K3 is the KR = 1 instance of the same kernel, so K4's output
// equals K3's bit for bit. The price is the grid: K images per block is K
// times fewer blocks, and at the enc4/bottleneck shapes K >= 4 leaves fewer
// blocks than the card has SMs; the TPU, whose grid runs in order on one
// core, had no such cost.
//
// Per-image statistics span the whole image, which no block sees, so the
// GroupNorm runs as four more launches on the same stream: the conv's
// epilogue writes per-tile per-channel sums (fixed-order, no atomics), a
// finalize folds them into the group mean, a centred pass sums (y - mean)^2,
// a second finalize gives rstd, and the apply pass writes the output. The
// TPU kept the pre-norm tensor in on-chip memory; this form writes it to an
// f32 scratch and reads it twice more. Removing that traffic is later work.
#include "gn_common.cuh"

namespace {

constexpr int kTile = 8;     // output tile is kTile x kTile pixels
constexpr int kTco = 64;     // output channels per block
constexpr int kCk = 16;      // input channels per shared-memory chunk
constexpr int kThreads = 256;

// Grid (tiles, Cout / 64, n / images); each block runs its tile for the
// images n0 .. n0 + images - 1, KR at a time. For K3 (KR = 1) the bounds ask
// for two blocks per SM: without them ptxas gives it 80 registers and
// spills; with them it takes 96-99 and spills nothing.
template <typename T, int KR>
__global__ void __launch_bounds__(kThreads, KR == 1 ? 2 : 1)
conv3x3_partials_kernel(const T* __restrict__ x, const T* __restrict__ w,
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
        if (gco < Cout && gc < Cin) v = gnk::to_f32(w[((size_t)k * Cin + gc) * Cout + gco]);
        s_w[k][c][co] = v;
      }
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        if (k < kr) {
          const T* xn = x + (size_t)(n0 + k0 + k) * H * W * Cin;
          for (int i = t; i < (kTile + 2) * (kTile + 2) * kCk; i += kThreads) {
            const int c = i % kCk, pix = i / kCk;
            const int px = pix % (kTile + 2), py = pix / (kTile + 2);
            const int gy = ty0 + py - 1, gx = tx0 + px - 1, gc = ci0 + c;
            float v = 0.f;
            if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < Cin)
              v = gnk::to_f32(xn[((size_t)gy * W + gx) * Cin + gc]);
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

template <typename T, int KR>
cudaError_t launch_conv(const T* x, const T* w, float* yscr, float* part, int n,
                        int H, int W, int Cin, int Cout, int tiles_x, int tiles,
                        int images, cudaStream_t st) {
  const dim3 grid(tiles, (Cout + kTco - 1) / kTco, n / images);
  conv3x3_partials_kernel<T, KR><<<grid, kThreads, 0, st>>>(
      x, w, yscr, part, H, W, Cin, Cout, tiles_x, tiles, images);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* x, const T* w, const float* gamma, const float* beta,
                   T* out, float* yscr, float* part, float* stats, int n, int H,
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
    err = launch_conv<T, 1>(x, w, yscr, part, n, H, W, Cin, Cout, tiles_x, tiles, 1, st);
  else if (images == 2)
    err = launch_conv<T, 2>(x, w, yscr, part, n, H, W, Cin, Cout, tiles_x, tiles, 2, st);
  else if (images <= 4)
    err = launch_conv<T, 4>(x, w, yscr, part, n, H, W, Cin, Cout, tiles_x, tiles, images, st);
  else
    err = launch_conv<T, 8>(x, w, yscr, part, n, H, W, Cin, Cout, tiles_x, tiles, images, st);
  if (err != cudaSuccess) return err;
  gnk::gn_finalize_kernel<<<n, fin, 0, st>>>(part, stats, tiles, Cout, G, denom,
                                             eps, gnk::kMeanOnly);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const dim3 grid(chunks, n);
  const size_t smem = 2 * (size_t)threads * sizeof(float);
  gnk::channel_partials_kernel<float, gnk::kCentred><<<grid, threads, smem, st>>>(
      yscr, stats, part, P, Cout, G, chunk_pix, chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gnk::gn_finalize_kernel<<<n, fin, 0, st>>>(part, stats, chunks, Cout, G, denom,
                                             eps, gnk::kRstdCentred);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  gnk::gn_apply_silu_kernel<float, T><<<grid, threads, 0, st>>>(
      yscr, stats, gamma, beta, out, P, Cout, G, chunk_pix);
  return cudaGetLastError();
}

int dispatch(const void* x, const void* w, const void* gamma, const void* beta,
             void* out, void* yscr, void* part, void* stats, int n, int H, int W,
             int Cin, int Cout, int G, int chunk_pix, int chunks, int threads,
             int images, float eps, int dtype, void* stream) {
  if (images < 1 || n % images != 0) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  auto* ys = static_cast<float*>(yscr);
  auto* pt = static_cast<float*>(part);
  auto* sts = static_cast<float*>(stats);
  if (dtype == 0)
    return (int)launch(static_cast<const float*>(x), static_cast<const float*>(w), g,
                       b, static_cast<float*>(out), ys, pt, sts, n, H, W, Cin, Cout,
                       G, chunk_pix, chunks, threads, images, eps, st);
  if (dtype == 1)
    return (int)launch(static_cast<const __nv_bfloat16*>(x),
                       static_cast<const __nv_bfloat16*>(w), g, b,
                       static_cast<__nv_bfloat16*>(out), ys, pt, sts, n, H, W, Cin,
                       Cout, G, chunk_pix, chunks, threads, images, eps, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: (n, H, W, Cin), w: (3, 3, Cin, Cout) HWIO, out: (n, H, W, Cout), all of
// one dtype (0 = float32, 1 = bfloat16), contiguous. gamma, beta: (Cout,)
// float32. yscr: (n, H, W, Cout) float32 scratch. part: float32 scratch of
// n * max(tiles, chunks) * Cout * 2, tiles = ceil(H/8) * ceil(W/8).
// stats: (n, G, 2) float32 scratch. Returns cudaGetLastError().
int conv3x3_gn_silu(const void* x, const void* w, const void* gamma,
                    const void* beta, void* out, void* yscr, void* part,
                    void* stats, int n, int H, int W, int Cin, int Cout, int G,
                    int chunk_pix, int chunks, int threads, float eps, int dtype,
                    void* stream) {
  return dispatch(x, w, gamma, beta, out, yscr, part, stats, n, H, W, Cin, Cout, G,
                  chunk_pix, chunks, threads, 1, eps, dtype, stream);
}

// The same with `images` images per conv block (K4); n % images == 0, else
// cudaErrorInvalidValue and nothing is launched.
int conv3x3_gn_silu_batched(const void* x, const void* w, const void* gamma,
                            const void* beta, void* out, void* yscr, void* part,
                            void* stats, int n, int H, int W, int Cin, int Cout,
                            int G, int chunk_pix, int chunks, int threads,
                            int images, float eps, int dtype, void* stream) {
  return dispatch(x, w, gamma, beta, out, yscr, part, stats, n, H, W, Cin, Cout, G,
                  chunk_pix, chunks, threads, images, eps, dtype, stream);
}

}  // extern "C"
