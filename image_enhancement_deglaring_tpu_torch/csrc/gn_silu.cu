// GroupNorm + SiLU on NHWC activations, for Hopper (sm_90a).
//
// Replaces two TPU kernels of image_enhancement_deglaring_tpu/ops/pallas_kernels.py:
//   gn_silu_flat  <- _gn_silu_flat_kernel via _fused_gn_silu_flat (K1), the
//                    (N, H, W*C) row-tiled form used at every U-Net level;
//   gn_silu_nhwc  <- _gn_silu_kernel via _fused_gn_silu_pallas (K2), the
//                    (1, TH, W, C) block form used where K1 is not eligible.
// Both compute the same function on the same NHWC memory: per (image, group)
// f32 sum and sum of squares, var = E[x^2] - mean^2, then y = x*a + b with
// a = rstd*gamma, b = beta - mean*a, out = y * sigmoid(y). So they share one
// body and keep their own entry points, as the two TPU functions do.
//
// Bound on the H100: bytes. About ten operations per element against 2 or 4
// bytes, far below the card's operations-per-byte balance.
//
// Design: the TPU carried its sums across a sequential grid; here blocks run
// in parallel, so the work is three launches on one stream: per-chunk
// per-channel partial sums (no float atomics, so the result is
// deterministic), a per-(image, group) finalize, and one fused apply pass
// (one read, one write). The input is read twice (partials, apply); a
// one-read form that keeps a chunk resident across a grid-wide barrier is
// later work.
#include "gn_common.cuh"

namespace {

cudaError_t dispatch(const void* x, const void* gamma, const void* beta, void* y,
                     void* part, void* stats, int n, int P, int C, int G,
                     int chunk_pix, int chunks, int threads, float eps,
                     int dtype, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  auto* pt = static_cast<float*>(part);
  auto* sts = static_cast<float*>(stats);
  if (dtype == 0)
    return gnk::launch_gn_silu(static_cast<const float*>(x), g, b,
                               static_cast<float*>(y), pt, sts, n, P, C, G,
                               chunk_pix, chunks, threads, eps, st);
  if (dtype == 1)
    return gnk::launch_gn_silu(static_cast<const __nv_bfloat16*>(x), g, b,
                               static_cast<__nv_bfloat16*>(y), pt, sts, n, P, C,
                               G, chunk_pix, chunks, threads, eps, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, y: (n, P, C) NHWC contiguous, dtype 0 = float32, 1 = bfloat16.
// gamma, beta: (C,) float32. part: (n, chunks, C, 2) float32 scratch.
// stats: (n, G, 2) float32 scratch. Returns cudaGetLastError().
int gn_silu_flat(const void* x, const void* gamma, const void* beta, void* y,
                 void* part, void* stats, int n, int P, int C, int G,
                 int chunk_pix, int chunks, int threads, float eps, int dtype,
                 void* stream) {
  return (int)dispatch(x, gamma, beta, y, part, stats, n, P, C, G, chunk_pix,
                       chunks, threads, eps, dtype, stream);
}

int gn_silu_nhwc(const void* x, const void* gamma, const void* beta, void* y,
                 void* part, void* stats, int n, int P, int C, int G,
                 int chunk_pix, int chunks, int threads, float eps, int dtype,
                 void* stream) {
  return (int)dispatch(x, gamma, beta, y, part, stats, n, P, C, G, chunk_pix,
                       chunks, threads, eps, dtype, stream);
}

}  // extern "C"
